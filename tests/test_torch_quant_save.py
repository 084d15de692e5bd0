"""The saving int8 forwards of the port (``mudpt_torch/ops/quant_block.py``,
plain versions on the CPU) against the Pallas kernels
``_layer_fwd_q8_save_kernel`` and ``_layer_fwd_q8_static_save_kernel`` in
interpret mode, every mask spec in fp32 and bf16, and the MLP half op by op
against JAX's helpers.  Inputs and tolerances as in
``tests/test_torch_quant_block.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudpt_tpu.ops import fused_block as JFB
from mudpt_tpu.ops import quant_block as JQ

from mudpt_torch.models.convert import params_from_numpy
from mudpt_torch.ops import quant_block as TQ
from tests.test_torch_quant_block import (B, D, DTYPES, FWD_TOL, H, MASK_IDS, MASKS, S, _close,
                                          _layer_case, _params12)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on few cores: keep torch's intra-op
    pool small so these files do not crowd out timing-sensitive tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# The saved bf16 h takes the excess precision of y1 most directly: nearly
# every code of the fc product's input can move by one, and h differs by
# about a bf16 ulp almost everywhere.  Reading 6.1e-3 in norm, 6.7e-3 of
# the largest value; from the same rounded y1 the op-by-op test below finds
# the port's h bit-equal to JAX's.  Bound:
H_BF16_TOL = (2.0 ** -5, 2.0 ** -6)


@pytest.mark.parametrize("dt_name", sorted(DTYPES))
@pytest.mark.parametrize("causal", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_saving_forward_matches_pallas(static, causal, dt_name):
    """(y, y1, qkv, h) of ``_layer_fwd_q8_save_kernel`` /
    ``_layer_fwd_q8_static_save_kernel``, each held as the forwards are;
    y is bit-equal to the serving forward's (one chain)."""
    jp, jx, tp, tx, amax = _layer_case(11, causal, dt_name, static)
    if static:
        jq, jr = JQ._quantize_layer_static(_params12(jp), amax)
        want = JQ._q8_static_save_forward(jx, jq, jr, H, causal, 4 * D)
        tq, tr = TQ._quantize_layer_static(_params12(tp), torch.from_numpy(np.array(amax)))
        got = TQ.q8_save_forward(tx, tq, H, causal, tr)
        serve = TQ.layer_fullblock_q8_static(tx, *tq, tr, H, causal)
    else:
        want = JQ._q8_save_forward(jx, JQ._quantize_layer(_params12(jp)), H, causal, 4 * D)
        tq = TQ._quantize_layer(_params12(tp))
        got = TQ.q8_save_forward(tx, tq, H, causal)
        serve = TQ.layer_fullblock_q8(tx, *tq, H, causal)
    assert torch.equal(got[0], serve)
    for name, g, w in zip(("y", "y1", "qkv", "h"), got, want):
        assert g.dtype == tx.dtype, name
        _close(g, w, *(H_BF16_TOL if (name, dt_name) == ("h", "bf16") else FWD_TOL[dt_name]))


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_mlp_half_bit_equal_to_jax_ops(static):
    """From the same bf16 y1, JAX's helpers one op at a time (each rounding
    as written: ``_ln_fp32``, the quantizer, ``_q8_matmul`` / the static
    matmul) and the port's plain chain give a bit-equal h; y within the
    bf16 forward bound (g's sigmoid may differ by an fp32 ulp and move a
    code)."""
    jp, jx, tp, tx, amax = _layer_case(11, False, "bf16", static)
    ta = torch.from_numpy(np.array(amax)) if static else None
    if static:
        jq, jr = JQ._quantize_layer_static(_params12(jp), amax)
        tq, tr = TQ._quantize_layer_static(_params12(tp), ta)
        y1 = JQ._q8_static_save_forward(jx, jq, jr, H, False, 4 * D)[1]
    else:
        jq, jr = JQ._quantize_layer(_params12(jp)), None
        tq, tr = TQ._quantize_layer(_params12(tp)), None
        y1 = JQ._q8_save_forward(jx, jq, H, False, 4 * D)[1]
    y1 = y1.reshape(B * S, D)
    xn, _, _ = JFB._ln_fp32(y1, jq[8], jq[9])
    if static:
        xq, xs = jnp.clip(jnp.round(xn * jr[0, 2]), -127, 127).astype(jnp.int8), None
        acc = jax.lax.dot_general(xq, jq[10], (((1,), (0,)), ((), ())),
                                  preferred_element_type=jnp.int32)
        h = acc.astype(jnp.float32) * jq[11] + jq[12].astype(jnp.float32)
    else:
        xq, xs = JQ._quant_rows(xn)
        h = JQ._q8_matmul(xq, xs, jq[10], jq[11], jq[12])
    g = JFB._quick_gelu(h)
    if static:
        gq, gs = jnp.clip(jnp.round(g * jr[0, 3]), -127, 127).astype(jnp.int8), None
        acc = jax.lax.dot_general(gq, jq[13], (((1,), (0,)), ((), ())),
                                  preferred_element_type=jnp.int32)
        out = acc.astype(jnp.float32) * jq[14] + jq[15].astype(jnp.float32)
    else:
        gq, gs = JQ._quant_rows(g)
        out = JQ._q8_matmul(gq, gs, jq[13], jq[14], jq[15])
    y = y1 + out.astype(jnp.bfloat16)
    ty1 = params_from_numpy({"y1": np.asarray(y1)}, "cpu")["y1"]
    tq2, ts2 = TQ.ln_quant_plain(ty1, tq[8], tq[9], tr[2] if static else None)
    np.testing.assert_array_equal(tq2.numpy(), np.asarray(xq))
    ep = "q8s_" if static else "q8_"
    th, tg = TQ.gemm_s8_plain(tq2, ts2, tq[10], tq[11], tq[12], ep + "fc_gelu",
                              r=tr[3] if static else None, save_h=True)
    np.testing.assert_array_equal(th.float().numpy(), np.asarray(h.astype(jnp.bfloat16),
                                                                  np.float32))
    tgq, tgs = (tg, None) if static else TQ.quantize_rows_plain(tg)
    ty = TQ.gemm_s8_plain(tgq, tgs, tq[13], tq[14], tq[15], ep + "residual", extra=ty1)
    _close(ty, y, *FWD_TOL["bf16"])
