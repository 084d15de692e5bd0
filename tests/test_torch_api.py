"""``clip_forward`` and ``num_params`` (``models/clip.py``) and the
re-exports of ``mudpt_torch.models`` and ``mudpt_torch.api`` against the
JAX package's: at test-tiny (2 layers, width 64, image 32, the real
vocabulary), JAX's random weights carried over by ``params_from_numpy``,
the same numpy-seeded images and tokenized prompts, in fp32 and bf16."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mudpt_tpu.api as japi
import mudpt_tpu.models as JM
from mudpt_tpu.models import clip as JCLIP
from mudpt_tpu.utils.rng import new_rng

import mudpt_torch.api as tapi
import mudpt_torch.models as TM
from mudpt_torch.models import clip as TCLIP
from mudpt_torch.models.convert import params_from_numpy
from mudpt_torch.tokenizer import tokenize

CFG = TCLIP.TINY_TEST
JCFG = JCLIP.CLIPConfig(**dataclasses.asdict(CFG))
PROMPTS = ["a photo of a cat.", "a photo of a dog.", "a drawing of a red bus.",
           "a blurry photo of the number seven."]
FP32 = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_towers.py:29
# bf16: both packages round at the same points, but the order of fp32
# sums differs and one rounding can move by an ulp and carry through two
# layers, the projection and the cosine (logits are ~14 x a cosine).
# Readings over seeds 0-5: port vs JAX max abs err 0.029-0.044 of logits
# up to 2.1, while each package's bf16 logits lie 0.041-0.076 from its own
# fp32 ones: the bound sits under the bf16 rounding itself.
BF16_ATOL = 2.0 ** -4


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
    jp = JCLIP.init_clip_params(new_rng(0), JCFG)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _inputs(seed):
    images = np.random.RandomState(seed).randn(3, 32, 32, 3).astype(np.float32)
    return images, np.asarray(tokenize(PROMPTS))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_clip_forward_matches_jax(params, dtype, seed):
    jp, tp = params
    images, tokens = _inputs(seed)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16,
                                                                       torch.bfloat16)
    j_img, j_txt = JCLIP.clip_forward(jp, jnp.asarray(images), jnp.asarray(tokens), JCFG,
                                      compute_dtype=jdt)
    with torch.no_grad():
        t_img, t_txt = tapi.clip_forward(tp, torch.from_numpy(images),
                                         torch.from_numpy(tokens).long(), CFG,
                                         compute_dtype=tdt)
    assert t_img.shape == (3, len(PROMPTS)) and t_img.dtype == torch.float32
    assert torch.equal(t_txt, t_img.T)
    tol = FP32 if dtype == "fp32" else dict(rtol=0, atol=BF16_ATOL)
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img, np.float32), **tol)
    np.testing.assert_allclose(t_txt.numpy(), np.asarray(j_txt, np.float32), **tol)


def test_clip_forward_is_the_cosine_of_the_towers(params):
    """The logits are ``cosine_logits`` of the two encoders' fp32 features."""
    _, tp = params
    images, tokens = _inputs(3)
    x, t = torch.from_numpy(images), torch.from_numpy(tokens).long()
    with torch.no_grad():
        logits, _ = TCLIP.clip_forward(tp, x, t, CFG)
        want = TCLIP.cosine_logits(TCLIP.encode_image(tp, x, CFG),
                                   TCLIP.encode_text(tp, t, CFG), tp["logit_scale"])
    assert torch.equal(logits, want)


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-rn"])
def test_num_params_matches_jax(name):
    """Each package's own tree of the preset counts alike (JAX's traced for
    its shapes only)."""
    from mudpt_tpu.trainers.base import _NAMED_CONFIGS

    from mudpt_torch.trainers.base import NAMED_CONFIGS

    jp = jax.eval_shape(lambda: JCLIP.init_clip_params(new_rng(0), _NAMED_CONFIGS[name]))
    tp = TCLIP.init_clip_params(NAMED_CONFIGS[name], torch.Generator().manual_seed(0))
    assert TCLIP.num_params(tp) == JCLIP.num_params(jp) > 0


def test_models_export_the_jax_names():
    """``mudpt_torch.models`` exports the counterpart of each name of
    ``mudpt_tpu.models.__all__``, the converter under the port's own name;
    ``mudpt_torch.utils`` those of ``mudpt_tpu.utils.__all__``."""
    import mudpt_tpu.utils as JU

    import mudpt_torch.utils as TU

    assert TU.__all__ == JU.__all__ and all(getattr(TU, n) for n in TU.__all__)
    renamed = {"torch_state_dict_to_jax": "state_dict_to_params"}
    assert TM.__all__ == [renamed.get(n, n) for n in JM.__all__]
    for name in TM.__all__:
        assert getattr(TM, name) is not None
    assert TM.clip_forward is TCLIP.clip_forward is tapi.clip_forward
    for name in ("clip_forward", "available_models", "download_model", "load", "tokenize",
                 "encode_image", "encode_text", "cosine_logits", "zero_shot_classifier"):
        assert hasattr(japi, name) and hasattr(tapi, name), name
