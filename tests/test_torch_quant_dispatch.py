"""The port's int8 tiers beyond the forwards (``tests/test_torch_quant_block.py``),
against the JAX package's ``quant_block`` on the same numpy-seeded weights
and inputs: the quantization-aware dx against ``jax.vjp`` under both save
policies, the quant dispatch of ``residual_block`` and its guards, the
inference-only raise, calibration and ``attach_scales``, and the
``q8_scales`` leaf crossing over from a JAX tree.  Tolerances as stated at
each test; the reasons for them in the forwards' file."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudpt_tpu.models import layers as JL
from mudpt_tpu.ops import fused_block as JFB
from mudpt_tpu.ops import quant_block as JQ

from mudpt_torch.models import layers as TL
from mudpt_torch.models.convert import params_from_numpy
from mudpt_torch.models.transformer import transformer_forward
from mudpt_torch.ops import fused_block as TFB
from mudpt_torch.ops import quant_block as TQ
from tests.test_torch_quant_block import (B, D, DTYPES, FWD_TOL, H, S, _block, _cast, _close,
                                          _jax_mask, _layer_case, _np32, _params12, _port)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on few cores: keep torch's intra-op
    pool small so these files do not crowd out timing-sensitive tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def pallas_blocks():
    """The JAX side dispatches to the Pallas kernels (interpret mode)."""
    prev = JL._BLOCK_IMPL
    JL.set_block_impl("pallas")
    yield
    JL._BLOCK_IMPL = prev


# ---------------------------------------------------------------------------
# quantization-aware training: dx against jax.vjp
# ---------------------------------------------------------------------------

# The straight-through dx is the bf16 layer backward over the q8 forward's
# intermediates, so it inherits their differences.  Readings (relative to
# the largest dx / in norm, worst of dynamic and static, both save
# policies): fp32 4.9e-8 / 4.9e-8; bf16 3.2e-3 / 1.6e-3.
DX_TOL = {"fp32": (2.0 ** -12, 2.0 ** -14), "bf16": (2.0 ** -5, 2.0 ** -7)}


@pytest.mark.parametrize("static,save,dt_name", [
    (False, True, "bf16"), (False, False, "bf16"), (True, True, "bf16"), (True, False, "bf16"),
    (False, True, "fp32"), (True, False, "fp32"),
], ids=["dynamic-saved-bf16", "dynamic-recomputed-bf16", "static-saved-bf16",
        "static-recomputed-bf16", "dynamic-saved-fp32", "static-recomputed-fp32"])
def test_qat_dx_matches_jax_vjp(static, save, dt_name):
    causal = True
    jp, jx, tp, tx, amax = _layer_case(12, causal, dt_name, static)
    jargs, targs = _params12(jp), _params12(tp)
    gy = np.random.RandomState(13).randn(B, S, D).astype(np.float32)
    tdt, jdt = DTYPES[dt_name]
    with JFB.saved_acts(save), TFB.saved_acts(save):
        if static:
            fj = lambda xx: JQ.layer_fullblock_q8_ste_static(xx, amax, *jargs, H, causal)  # noqa
            ta = torch.from_numpy(np.array(amax))
            ft = lambda xx: TQ.layer_fullblock_q8_ste_static(xx, ta, *targs, H, causal)  # noqa
        else:
            fj = lambda xx: JQ.layer_fullblock_q8_ste(xx, *jargs, H, causal)  # noqa
            ft = lambda xx: TQ.layer_fullblock_q8_ste(xx, *targs, H, causal)  # noqa
        y_j, vjp = jax.vjp(fj, jx)
        (dx_j,) = vjp(jnp.asarray(gy, jdt))
        txg = tx.clone().requires_grad_(True)
        y_t = ft(txg)
        saved = y_t.grad_fn.saved_tensors[1]
        assert (saved is not None) == save  # the save policy took its route
        (dx_t,) = torch.autograd.grad(y_t, txg, torch.from_numpy(gy).to(tdt))
    _close(y_t.detach(), y_j, *FWD_TOL[dt_name])
    _close(dx_t, dx_j, *DX_TOL[dt_name])
    assert np.abs(_np32(dx_t)).min(axis=-1).max() > 0


def test_qat_recompute_is_bit_identical_to_saving():
    """As ``test_q8_ste_recompute_matches_save_strategy``: saves off rerun
    the same saving chain in the backward, so y and dx are bit-identical."""
    _, _, tp, tx, _ = _layer_case(14, True, "bf16", False)
    gy = torch.from_numpy(np.random.RandomState(15).randn(B, S, D).astype(np.float32)).bfloat16()
    out = []
    for save in (True, False):
        with TFB.saved_acts(save):
            xg = tx.clone().requires_grad_(True)
            y = TQ.layer_fullblock_q8_ste(xg, *_params12(tp), H, True)
            out.append((y.detach(), torch.autograd.grad(y, xg, gy)[0]))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


def test_qat_static_forward_is_the_serving_forward():
    _, _, tp, tx, amax = _layer_case(16, False, "bf16", True)
    ta = torch.from_numpy(np.array(amax))
    xg = tx.clone().requires_grad_(True)
    train = TQ.layer_fullblock_q8_ste_static(xg, ta, *_params12(tp), H, False)
    qp, r = TQ._quantize_layer_static(_params12(tp), ta)
    assert torch.equal(train.detach(), TQ.layer_fullblock_q8_static(tx, *qp, r, H, False))


def test_qat_refuses_trainable_weights():
    _, _, tp, tx, _ = _layer_case(17, False, "fp32", False)
    ps = list(_params12(tp))
    ps[2] = ps[2].clone().requires_grad_(True)
    with pytest.raises(ValueError, match="dx only"):
        TQ.layer_fullblock_q8_ste(tx.clone().requires_grad_(True), *ps, H, False)


# ---------------------------------------------------------------------------
# the dispatch, its guards, and inference-only
# ---------------------------------------------------------------------------

def test_serving_forwards_are_inference_only():
    _, _, tp, tx, amax = _layer_case(18, False, "fp32", True)
    xg = tx.clone().requires_grad_(True)
    y = TQ.layer_fullblock_q8(xg, *TQ._quantize_layer(_params12(tp)), H, False)
    with pytest.raises(NotImplementedError, match="inference-only"):
        y.sum().backward()
    qp, r = TQ._quantize_layer_static(_params12(tp), torch.from_numpy(np.array(amax)))
    y = TQ.layer_fullblock_q8_static(xg, *qp, r, H, False)
    with pytest.raises(NotImplementedError, match="inference-only"):
        y.sum().backward()


def test_residual_block_dispatch_matches_jax(pallas_blocks):
    """Under each quant mode ``residual_block`` runs the tier JAX runs:
    'int8' the dynamic chain; 'int8_static' the static one on a block with
    ``q8_scales`` and, bit-exactly, the dynamic one without; the ste modes
    the same forwards; prepared ``q8_weights`` change nothing."""
    jp, jx, tp, tx, amax = _layer_case(19, False, "fp32", True)
    tp_s = dict(tp, q8_scales=torch.from_numpy(np.array(amax)))
    jp_s = dict(jp, q8_scales=amax)
    prev_j = JL.quant_mode()
    try:
        got = {}
        for mode in ("int8", "int8_static", "int8_ste", "int8_ste_static"):
            JL.set_quant_mode(mode)
            with TL.quantized(mode):
                for label, jb, tb in (("plain", jp, tp), ("scales", jp_s, tp_s)):
                    y = TL.residual_block(tb, tx, H, False)
                    got[mode, label] = y
                    y_prep = TL.residual_block(TQ.quantize_blocks(tb), tx, H, False)
                    assert torch.equal(y_prep, y)
                    if mode in ("int8", "int8_static"):  # the ste forwards: equal below
                        _close(y, JL.residual_block(jb, jx, H, None, False), *FWD_TOL["fp32"])
    finally:
        JL.set_quant_mode(prev_j)
    assert TL.quant_mode() == "none"
    assert torch.equal(got["int8_static", "plain"], got["int8", "plain"])
    assert torch.equal(got["int8_static", "scales"], got["int8_ste_static", "scales"])
    assert torch.equal(got["int8", "scales"], got["int8_ste", "plain"])
    assert not torch.equal(got["int8_static", "scales"], got["int8", "scales"])


def test_quant_guards():
    rng = np.random.RandomState(20)
    tp = params_from_numpy(_block(rng), "cpu")
    x = torch.from_numpy(rng.randn(2, 16, D).astype(np.float32))
    with TL.quantized("int8"):
        with pytest.raises(ValueError, match="int8"):
            TL.residual_block(tp, x, H, torch.zeros(16, 16))  # an additive mask
        wide = params_from_numpy(_block(rng, 1032), "cpu")
        with pytest.raises(ValueError, match="width <= 1024"):
            TL.residual_block(wide, torch.zeros(1, 8, 1032), 8, False)
    with pytest.raises(ValueError, match="quant mode"):
        TL.set_quant_mode("int4")
    assert TL.quant_mode() == "none"


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

# absmax of the plain blocks' tensors: in fp32 the sums run in another
# order (reading 3.6e-7 relative); in bf16 XLA may keep a fused
# intermediate in fp32 before its bf16 rounding, so a site's absmax moves
# by a bf16 ulp or two (reading 6.9e-3 relative)
CALIB_RTOL = {"fp32": 2.0 ** -20, "bf16": 2.0 ** -6}


@pytest.mark.parametrize("dt_name", sorted(DTYPES))
@pytest.mark.parametrize("causal", [False, True], ids=["none", "causal"])
def test_calibrate_matches_jax(causal, dt_name):
    """Site order (LN1 out, MHA out, LN2 out, post-GELU) and values, one
    layer and a two-layer tower, through the capture's plain route."""
    tdt, jdt = DTYPES[dt_name]
    rng = np.random.RandomState(21)
    blocks = [_block(rng) for _ in range(2)]
    jstack = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                    *[_cast(b, jdt) for b in blocks])
    x = jnp.asarray(rng.randn(B, S, D), jdt)
    tstack = _port(jstack)
    tx = params_from_numpy({"x": np.asarray(x)}, "cpu")["x"]

    from mudpt_tpu.models.transformer import transformer_forward as jtf

    mask = _jax_mask(causal)
    want = JQ.calibrate(lambda xx: jtf(jstack, xx, n_head=H, mask=mask, causal=causal), x)
    got = TQ.calibrate(lambda xx: transformer_forward(tstack, xx, n_head=H, causal=causal), tx)
    assert got.shape == (2, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=CALIB_RTOL[dt_name])
    # site 1 of layer 0 by hand: the absmax of the LN1 output
    ln1 = TFB.layer_norm_plain(tx, tstack["ln_1"]["scale"][0], tstack["ln_1"]["bias"][0])
    assert got[0, 0].item() == ln1.float().abs().max().item()


def test_calibration_capture_restores_state():
    sink = []
    with TL.quantized("int8"):
        with pytest.raises(RuntimeError):
            with TL.calibration_capture(sink):
                assert TL.quant_mode() == "none" and TL.calibrating()
                raise RuntimeError("boom")
        assert TL.quant_mode() == "int8" and not TL.calibrating()
    with pytest.raises(ValueError, match="no residual blocks"):
        TQ.calibrate(lambda: torch.zeros(1))


def test_attach_scales_checks_shape():
    rng = np.random.RandomState(22)
    stack = params_from_numpy(jax.tree_util.tree_map(
        lambda *xs: np.stack(xs), *[_block(rng) for _ in range(2)]), "cpu")
    with pytest.raises(ValueError, match="scales shape"):
        TQ.attach_scales(stack, torch.ones(3, 4))
    ok = TQ.attach_scales(stack, torch.ones(2, 4))
    ok2 = TQ.attach_scales(ok, 2 * torch.ones(2, 4, dtype=torch.float64))
    assert ok2["q8_scales"].dtype == torch.float32 and ok2["q8_scales"][0, 0].item() == 2.0
    assert "q8_scales" not in stack


def test_q8_scales_leaf_crosses_over_from_jax():
    """``params_from_numpy`` carries a JAX tree's (L, 4) fp32 ``q8_scales``
    leaf, and each layer reads its (4,) row."""
    rng = np.random.RandomState(23)
    jstack = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                    *[_cast(_block(rng), jnp.float32) for _ in range(2)])
    scales = jnp.asarray(np.abs(rng.randn(2, 4)), jnp.float32)
    jstack = JQ.attach_scales(jstack, scales)
    tstack = _port(jstack)
    assert tstack["q8_scales"].dtype == torch.float32
    np.testing.assert_array_equal(tstack["q8_scales"].numpy(), np.asarray(scales))
    from mudpt_torch.models.transformer import layer_params

    np.testing.assert_array_equal(layer_params(tstack, 1)["q8_scales"].numpy(),
                                  np.asarray(scales[1]))
