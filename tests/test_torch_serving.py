"""The whole serving slice at tiny size: the port's ``mudpt_text_features``
+ ``mudpt_image_logits`` + argmax against the JAX package's on the same
frozen, trainable and aux trees (fp32 tight, bf16 within a drift bound),
and the synthetic server's device rule."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudpt_tpu.models.clip import cast_matmul_weights as jcast
from mudpt_tpu.models.clip import init_clip_params as jinit
from mudpt_tpu.trainers import mudpt as JM
from mudpt_tpu.trainers.base import TINY_TEST as JTINY
from mudpt_tpu.trainers.prompt_utils import embed_classnames as jembed
from mudpt_tpu.trainers.prompt_utils import init_linear as jinit_linear
from mudpt_tpu.trainers.prompt_utils import random_ctx as jrandom_ctx
from mudpt_tpu.utils.rng import new_rng

from mudpt_torch.models.clip import TINY_TEST
from mudpt_torch.models.convert import params_from_numpy
from mudpt_torch.trainers import mudpt as TM
from mudpt_torch.trainers.prompt_utils import embed_classnames
from mudpt_torch.utils.synth_step import build_synth_mudpt_server

N_CLS, N_CTX, DEPTH, B = 32, 2, 3, 8  # 32 classes: the port packs G=4 text rows
CLASSNAMES = [f"object number {i}" for i in range(N_CLS)]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on few cores: keep torch's intra-op
    pool small so these files do not crowd out timing-sensitive tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    frozen = jinit(new_rng(0), JTINY)
    ks = jax.random.split(new_rng(1), 8)
    dim, vdim = JTINY.transformer_width, JTINY.vision_width
    trainable = {
        "ctx": jrandom_ctx(ks[0], (N_CTX, dim)),
        "deep_prompts": jrandom_ctx(ks[1], (DEPTH - 1, N_CTX, dim)),
        "embed_projection": jinit_linear(ks[2], dim, vdim),
        "deep_projections": jinit_linear(ks[3], dim, vdim),
        "visual_ctx": jrandom_ctx(ks[4], (N_CTX, vdim)),
        "visual_ctx_deep_prompts": jrandom_ctx(ks[5], (DEPTH - 1, N_CTX, vdim)),
        "visual_ctx_deep_projections": jinit_linear(ks[6], vdim, dim),
    }
    aux = jembed(frozen["text"], CLASSNAMES, N_CTX, "a photo of a").as_device_tree()
    images = np.random.RandomState(0).randn(B, 32, 32, 3).astype(np.float32)
    return frozen, trainable, aux, images


def _serve_jax(frozen, trainable, aux, images, dtype):
    kw = dict(clip_cfg=JTINY, compute_dtype=dtype)
    txt = JM.mudpt_text_features(trainable, frozen, aux, **kw)
    logits = JM.mudpt_image_logits(trainable, frozen, aux, jnp.asarray(images, dtype), txt, **kw)
    return np.asarray(logits, np.float64)


def _serve_port(frozen, trainable, aux, images, dtype):
    frozen, trainable, aux = (params_from_numpy(_np(t), "cpu") for t in (frozen, trainable, aux))
    kw = dict(clip_cfg=TINY_TEST, compute_dtype=dtype)
    with torch.inference_mode():
        txt = TM.mudpt_text_features(trainable, frozen, aux, **kw)
        logits = TM.mudpt_image_logits(trainable, frozen, aux,
                                       torch.from_numpy(images).to(dtype), txt, **kw)
    return logits.double().numpy()


def test_tiny_config_is_the_jax_one():
    assert dataclasses.asdict(TINY_TEST) == dataclasses.asdict(JTINY)


def test_serving_fp32_matches_jax(trees):
    a = _serve_jax(*trees, jnp.float32)
    b = _serve_port(*trees, torch.float32)
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
    assert (a.argmax(-1) == b.argmax(-1)).all()


def test_serving_bf16_tracks_jax(trees):
    """bf16 backbone in both packages.  The port rounds at the Pallas
    kernel's points; XLA on the CPU rounds at its own and may keep fused
    intermediates in fp32, so the two drift apart like two bf16 runs of one
    model: logits within 3% of their largest magnitude (test_precision_drift
    allows 5% between fp32 and bf16), and the same top-1 wherever the JAX
    margin exceeds that drift."""
    frozen, trainable, aux, images = trees
    frozen16 = jcast(frozen, jnp.bfloat16)
    a = _serve_jax(frozen16, trainable, aux, images, jnp.bfloat16)
    b = _serve_port(frozen16, trainable, aux, images, torch.bfloat16)
    drift = np.abs(a - b).max()
    assert drift <= 0.03 * np.abs(a).max(), drift
    top = np.sort(a, axis=-1)
    decisive = top[:, -1] - top[:, -2] > 2 * drift
    assert (a.argmax(-1)[decisive] == b.argmax(-1)[decisive]).all()
    assert (a.argmax(-1) == b.argmax(-1)).mean() >= 0.75


def test_embed_classnames_matches_jax(trees):
    """The port's tokenizer and embedding gather build the JAX aux tree."""
    frozen, _, aux, _ = trees
    tp = params_from_numpy(_np(frozen["text"]), "cpu")
    port = embed_classnames(tp, CLASSNAMES, N_CTX, "a photo of a").as_device_tree()
    for k in ("token_prefix", "token_suffix", "eot_idx"):
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(aux[k]))


def test_params_from_numpy_keeps_bf16_bits():
    x = jnp.asarray(np.random.RandomState(0).randn(5, 7), jnp.bfloat16)
    t = params_from_numpy({"w": np.asarray(x)}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), np.asarray(x).view(np.int16))


def test_synth_server_runs_on_cpu_when_asked():
    st = build_synth_mudpt_server("test-tiny", 4, 10, N_CTX, DEPTH, device="cpu")
    txt = st.text_features(st.trainable, st.params, st.aux)
    assert txt.shape == (10, TINY_TEST.embed_dim) and torch.isfinite(txt.float()).all()
    logits = st.image_logits(st.trainable, st.params, st.aux, st.images, txt)
    preds = st.eval_step_cached(st.trainable, st.params, st.aux, st.images, txt)
    assert preds.dtype == torch.int32
    assert torch.equal(preds, logits.argmax(-1).to(torch.int32))


def test_synth_server_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_synth_mudpt_server("test-tiny", 4, 10, N_CTX, DEPTH)
