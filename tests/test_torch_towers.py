"""The port's vision and text towers against the JAX package's, in fp32 at
a tiny size (2 layers, width 64, 2 heads, image 32), with layer-0 and deep
prompts, EOT-truncated and packed text rows.  Weights come from
``mudpt_tpu.models.clip.init_clip_params`` and cross over through
``params_from_numpy``; inputs are numpy-seeded."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudpt_tpu.models import text as JT
from mudpt_tpu.models import vit as JV
from mudpt_tpu.models.clip import CLIPConfig as JCLIPConfig
from mudpt_tpu.models.clip import init_clip_params as jinit
from mudpt_tpu.utils.rng import new_rng

from mudpt_torch.models import text as TT
from mudpt_torch.models import vit as TV
from mudpt_torch.models.convert import params_from_numpy

CFG = JCLIPConfig(
    embed_dim=64, image_resolution=32, vision_layers=2, vision_width=64,
    vision_patch_size=16, transformer_width=64, transformer_heads=2,
    transformer_layers=2,
)
H, N_CTX, N_CLS = 2, 2, 11
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on few cores: keep torch's intra-op
    pool small so these files do not crowd out timing-sensitive tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def params():
    jp = jinit(new_rng(0), CFG)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def test_vit_forward_with_prompts(params):
    jp, tp = params
    rng = np.random.RandomState(0)
    images = rng.randn(3, 32, 32, 3).astype(np.float32)
    layer0 = (rng.randn(N_CTX, 64) * 0.1).astype(np.float32)
    deep = (rng.randn(2, N_CTX, 64) * 0.1).astype(np.float32)  # deeper than the tower
    j = JV.vit_forward(jp["visual"], jnp.asarray(images), patch_size=16, n_head=H,
                       layer0_prompt=jnp.asarray(layer0), deep_prompts=jnp.asarray(deep))
    t = TV.vit_forward(tp["visual"], _t(images), patch_size=16, n_head=H,
                       layer0_prompt=_t(layer0), deep_prompts=_t(deep))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _text_inputs(seed, S):
    rng = np.random.RandomState(seed)
    emb = (rng.randn(N_CLS, S, 64) * 0.1).astype(np.float32)
    eot = rng.randint(1 + N_CTX, 14, N_CLS).astype(np.int32)
    deep = (rng.randn(1, N_CTX, 64) * 0.1).astype(np.float32)
    return emb, eot, deep


@pytest.mark.parametrize("pack", [1, 2, 4])
def test_text_forward_matches_jax(params, pack):
    """Packed rows (G = 2, 4) and unpacked rows give the JAX unpacked
    features within fp32 noise."""
    jp, tp = params
    emb, eot, deep = _text_inputs(1, 16)
    j = JT.text_forward(jp["text"], jnp.asarray(emb), jnp.asarray(eot), n_head=H,
                        deep_prompts=jnp.asarray(deep))
    t = TT.text_forward(tp["text"], _t(emb), _t(eot), n_head=H, deep_prompts=_t(deep),
                        pack=pack)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_text_eot_truncation_matches_full_rows(params):
    """Rows cut to the effective length give the JAX full 77-token rows'
    features: the tower is causal and only the EOT row is read."""
    jp, tp = params
    emb, eot, deep = _text_inputs(2, 77)
    S = TT.effective_text_length(int(eot.max()), 77)
    assert S == 16
    j = JT.text_forward(jp["text"], jnp.asarray(emb), jnp.asarray(eot), n_head=H,
                        deep_prompts=jnp.asarray(deep))
    t = TT.text_forward(tp["text"], _t(emb[:, :S]), _t(eot), n_head=H, deep_prompts=_t(deep))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("n_rows", [1, 7, 16, 64, 100, 1000])
@pytest.mark.parametrize("seq", [16, 24, 80])
def test_pack_and_truncation_rules_match_jax(n_rows, seq):
    assert TT._auto_pack_g(seq, n_rows) == JT._auto_pack_g(seq, n_rows)
    for max_eot in (3, 10, 15, 40, 76):
        assert TT.effective_text_length(max_eot, seq) == JT.effective_text_length(max_eot, seq)
