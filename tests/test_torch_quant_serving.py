"""The int8 tiers of the whole slice at tiny size, against the JAX package
on the same frozen, trainable and aux trees (Pallas in interpret mode,
``set_block_impl("pallas")`` and ``set_quant_mode``, both restored after):
the served logits under 'int8' and, on JAX's calibrated scales, under
'int8_static'; the port's own calibration of both towers against JAX's;
and the synthetic builders' ``quant`` argument with ``bench.py``'s rules
(the quantization-aware step: ``tests/test_torch_quant_train_step.py``).

Each package quantizes the same values, but XLA multiplies by 1/127 where
the port divides and sums LayerNorm statistics in another order, so now and
then a code moves by one step; in bf16, XLA on the CPU also keeps some
intermediates in fp32 (``tests/test_torch_serving.py``).  The bounds are
stated at each test, with the readings they were set from."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudpt_tpu.models import layers as JL
from mudpt_tpu.models.clip import cast_matmul_weights as jcast
from mudpt_tpu.models.clip import init_clip_params as jinit
from mudpt_tpu.ops import quant_block as JQ
from mudpt_tpu.trainers import mudpt as JM
from mudpt_tpu.trainers.base import TINY_TEST as JTINY
from mudpt_tpu.trainers.prompt_utils import embed_classnames as jembed
from mudpt_tpu.trainers.prompt_utils import init_linear as jinit_linear
from mudpt_tpu.trainers.prompt_utils import random_ctx as jrandom_ctx
from mudpt_tpu.utils.rng import new_rng

from mudpt_torch.models import layers as TL
from mudpt_torch.models.clip import TINY_TEST
from mudpt_torch.models.convert import params_from_numpy
from mudpt_torch.ops import quant_block as TQ
from mudpt_torch.trainers import mudpt as TM
from mudpt_torch.utils import synth_step as TS

N_CLS, N_CTX, DEPTH, B = 32, 2, 3, 8  # 32 classes: both packages pack G=4 text rows
CLASSNAMES = [f"object number {i}" for i in range(N_CLS)]
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on few cores: keep torch's intra-op
    pool small so these files do not crowd out timing-sensitive tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def jax_quant(mode: str):
    """The JAX package's Pallas blocks under quant mode ``mode``."""
    prev_impl, prev_mode = JL._BLOCK_IMPL, JL.quant_mode()
    JL.set_block_impl("pallas")
    JL.set_quant_mode(mode)
    try:
        yield
    finally:
        JL._BLOCK_IMPL = prev_impl
        JL.set_quant_mode(prev_mode)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    return _make_trees()


def _make_trees():
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
    rng = np.random.RandomState(0)
    images = rng.randn(B, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, N_CLS, B).astype(np.int32)
    return frozen, trainable, aux, images, labels


def _frozen_of(frozen, dt_name):
    return frozen if dt_name == "fp32" else jcast(frozen, jnp.bfloat16)


def _jax_kw(jdt):
    return dict(clip_cfg=JTINY, compute_dtype=jdt)


def _calibrate_server_jax(frozen, trainable, aux, images, jdt):
    """``bench.py:280-319``: text features under dynamic int8, the vision
    tower calibrated on the batch with them, the text tower, both attached;
    returns the frozen tree with both ``q8_scales`` leaves."""
    kw = _jax_kw(jdt)
    with jax_quant("int8_static"):
        txt = JM.mudpt_text_features(trainable, frozen, aux, **kw)
        vs = JQ.calibrate(functools.partial(JM.mudpt_image_logits, **kw),
                          trainable, frozen, aux, images, txt)
        ts = JQ.calibrate(functools.partial(JM.mudpt_text_features, **kw), trainable, frozen, aux)
    out = dict(frozen)
    out["visual"] = dict(frozen["visual"], blocks=JQ.attach_scales(frozen["visual"]["blocks"], vs))
    out["text"] = dict(frozen["text"], blocks=JQ.attach_scales(frozen["text"]["blocks"], ts))
    return out, txt


def _serve_jax(frozen, trainable, aux, images, jdt, mode):
    kw = _jax_kw(jdt)
    with jax_quant(mode):
        txt = JM.mudpt_text_features(trainable, frozen, aux, **kw)
        logits = JM.mudpt_image_logits(trainable, frozen, aux, images, txt, **kw)
    return np.asarray(logits, np.float64)


def _serve_port(frozen, trainable, aux, images, tdt, mode):
    frozen, trainable, aux = (params_from_numpy(_np(t), "cpu") for t in (frozen, trainable, aux))
    kw = dict(clip_cfg=TINY_TEST, compute_dtype=tdt)
    with torch.inference_mode(), TL.quantized(mode):
        txt = TM.mudpt_text_features(trainable, frozen, aux, **kw)
        logits = TM.mudpt_image_logits(trainable, frozen, aux,
                                       torch.from_numpy(images).to(tdt), txt, **kw)
    return logits.double().numpy()


# Served logits, port vs JAX, max abs err relative to the largest JAX logit.
# Readings: 'int8' fp32 6.3e-7, bf16 0.026; 'int8_static' fp32 3.1e-7, bf16
# 0.034 (top-1 agreement 0.875).  On the same trees the bf16 tier drifts
# 0.013 between the packages; int8 amplifies that drift, since a value that
# XLA's fp32 intermediates move across a rounding boundary moves by a whole
# step of its grid (1/127 of the row's or the tensor's largest value), and
# the static grid is the coarser.  Bounds: fp32 2^-12, room for a code flip;
# bf16 2^-4, about twice the readings.
LOGITS_TOL = {"fp32": 2.0 ** -12, "bf16": 2.0 ** -4}


def _hold_logits(a, b, dt_name):
    drift = np.abs(a - b).max()
    assert drift <= LOGITS_TOL[dt_name] * np.abs(a).max(), (drift, np.abs(a).max())
    top = np.sort(a, axis=-1)
    decisive = top[:, -1] - top[:, -2] > 2 * drift
    assert (a.argmax(-1)[decisive] == b.argmax(-1)[decisive]).all()
    assert (a.argmax(-1) == b.argmax(-1)).mean() >= 0.75


@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_int8_serving_tracks_jax(trees, dt_name):
    frozen, trainable, aux, images, _ = trees
    tdt, jdt = DTYPES[dt_name]
    frozen = _frozen_of(frozen, dt_name)
    a = _serve_jax(frozen, trainable, aux, jnp.asarray(images, jdt), jdt, "int8")
    b = _serve_port(frozen, trainable, aux, images, tdt, "int8")
    _hold_logits(a, b, dt_name)
    # the tier is not the bf16 one: int8 moves the logits
    plain = _serve_port(frozen, trainable, aux, images, tdt, "none")
    assert np.abs(plain - b).max() > 0


@pytest.mark.parametrize("dt_name", sorted(DTYPES))
def test_int8_static_serving_on_jax_scales(trees, dt_name):
    """Both packages serve on JAX's calibrated scales (crossed over as
    ``q8_scales`` leaves); the port's own calibration of both towers, in
    ``bench.py``'s order, agrees with JAX's: scales within 2^-20 relative in
    fp32 (reading 2.4e-7) and 2^-6 in bf16 (reading 7.8e-3, a bf16 ulp)."""
    frozen, trainable, aux, images, _ = trees
    tdt, jdt = DTYPES[dt_name]
    frozen = _frozen_of(frozen, dt_name)
    jimages = jnp.asarray(images, jdt)
    cal, _ = _calibrate_server_jax(frozen, trainable, aux, jimages, jdt)
    a = _serve_jax(cal, trainable, aux, jimages, jdt, "int8_static")
    b = _serve_port(cal, trainable, aux, images, tdt, "int8_static")
    _hold_logits(a, b, dt_name)
    assert np.abs(_serve_port(frozen, trainable, aux, images, tdt, "int8") - b).max() > 0

    tf, ttr, taux = (params_from_numpy(_np(t), "cpu") for t in (frozen, trainable, aux))
    kw = dict(clip_cfg=TINY_TEST, compute_dtype=tdt)
    with torch.inference_mode(), TL.quantized("int8_static"):
        txt = TM.mudpt_text_features(ttr, tf, taux, **kw)
    vs = TQ.calibrate(functools.partial(TM.mudpt_image_logits, **kw), ttr, tf, taux,
                      torch.from_numpy(images).to(tdt), txt)
    ts = TQ.calibrate(functools.partial(TM.mudpt_text_features, **kw), ttr, tf, taux)
    rtol = 2.0 ** -20 if dt_name == "fp32" else 2.0 ** -6
    for got, tower in ((vs, "visual"), (ts, "text")):
        want = np.asarray(cal[tower]["blocks"]["q8_scales"])
        assert got.shape == want.shape == (2, 4)
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, err_msg=tower)


def test_synth_builders_take_bench_quant_rules():
    """``bench.py:141-147``: the server takes 'int8' / 'int8_static', the
    step 'int8_ste' / 'int8_ste_static'; the other tier and anything else
    raise."""
    for quant in ("int8_ste", "int8_ste_static"):
        with pytest.raises(ValueError, match="TRAINING variant"):
            TS.build_synth_mudpt_server("test-tiny", 4, 10, N_CTX, DEPTH, device="cpu",
                                        quant=quant)
    for quant in ("int8", "int8_static"):
        with pytest.raises(ValueError, match="inference-only"):
            TS.build_synth_mudpt_step("test-tiny", 4, 10, N_CTX, DEPTH, device="cpu",
                                      quant=quant)
    for build in (TS.build_synth_mudpt_server, TS.build_synth_mudpt_step):
        with pytest.raises(ValueError, match="unknown quant"):
            build("test-tiny", 4, 10, N_CTX, DEPTH, device="cpu", quant="int4")


@pytest.mark.parametrize("quant", ["int8", "int8_static"])
def test_synth_int8_server_runs_on_cpu(quant):
    """The int8 server quantizes both towers once (``q8_weights``); the
    static one also calibrates them at build, and its answers differ from
    the dynamic tier's; each serves under its tier and leaves the global
    quant mode as it was."""
    st = TS.build_synth_mudpt_server("test-tiny", 4, 10, N_CTX, DEPTH, device="cpu", quant=quant)
    for tower in ("visual", "text"):
        blocks = st.params[tower]["blocks"]
        assert blocks["q8_weights"]["fc_wq"].dtype == torch.int8
        assert ("q8_scales" in blocks) == (quant == "int8_static")
        if quant == "int8_static":
            assert blocks["q8_scales"].shape == (2, 4) and (blocks["q8_scales"] > 0).all()
    assert (st.calibration_s is not None) == (quant == "int8_static")
    txt = st.text_features(st.trainable, st.params, st.aux)
    logits = st.image_logits(st.trainable, st.params, st.aux, st.images, txt)
    preds = st.eval_step_cached(st.trainable, st.params, st.aux, st.images, txt)
    assert torch.isfinite(logits).all() and logits.shape == (4, 10)
    assert torch.equal(preds, logits.argmax(-1).to(torch.int32))
    assert TL.quant_mode() == "none"
    # the same tier by hand, on the quantized tree
    kw = dict(clip_cfg=st.clip_cfg, compute_dtype=torch.bfloat16)
    with torch.inference_mode(), TL.quantized(quant):
        t2 = TM.mudpt_text_features(st.trainable, st.params, st.aux, **kw)
        l2 = TM.mudpt_image_logits(st.trainable, st.params, st.aux, st.images, t2, **kw)
    assert torch.equal(l2, logits)


@pytest.mark.parametrize("quant", ["int8_ste", "int8_ste_static"])
def test_synth_qat_step_trains_on_cpu(quant):
    st = TS.build_synth_mudpt_step("test-tiny", 4, 10, N_CTX, DEPTH, device="cpu", quant=quant)
    assert ("q8_scales" in st.params["visual"]["blocks"]) == (quant == "int8_ste_static")
    before = [t.detach().clone() for t in TS.leaves(st.trainable)]
    losses = [float(st.train_step(st.images, st.labels)) for _ in range(2)]
    assert all(np.isfinite(losses)), losses
    moved = [not torch.equal(b, t.detach()) for b, t in zip(before, TS.leaves(st.trainable))]
    assert all(moved), moved
    assert TL.quant_mode() == "none"
