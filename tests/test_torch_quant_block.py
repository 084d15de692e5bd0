"""The port's int8 tiers (``mudpt_torch/ops/quant_block.py``, plain PyTorch
versions on the CPU) against the JAX package's ``quant_block`` (Pallas in
interpret mode, as ``tests/test_quant_block.py`` runs it) on the same
numpy-seeded weights and inputs: the weight and row quantizers, each plain
kernel against the JAX helper it replaces, and the two serving q8 layer
forwards for every mask spec in fp32 and bf16 (the saving forwards:
``tests/test_torch_quant_save.py``; the quantization-aware dx, the
dispatch, calibration: ``tests/test_torch_quant_dispatch.py``).

Where the arithmetic is exact (the weight quantizer, the int32 product and
its dequant, the row quantizer given the same scale) the comparison is
bit-equal.  Elsewhere the two sides compute the same fp32 values in another
order: XLA multiplies by 1/127 where the port divides by 127 (IEEE, as
``__fdiv_rn`` on the card), sums LayerNorm statistics in another order and
evaluates sigmoid its own way, so a scale moves by an fp32 ulp and a value
next to a rounding boundary takes the neighbouring code.  Such a flip moves
one element of a projection's input by one step of its row's grid, so the
layer outputs are held to norm and max-error bounds stated at each test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudpt_tpu.models import layers as JL
from mudpt_tpu.ops import fused_block as JFB
from mudpt_tpu.ops import quant_block as JQ

from mudpt_torch.models.convert import params_from_numpy
from mudpt_torch.ops import quant_block as TQ

D, S, H, B = 64, 40, 2, 3
MASKS = [False, True, (8, 6)]
MASK_IDS = ["none", "causal", "packed8_6"]
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on few cores: keep torch's intra-op
    pool small so these files do not crowd out timing-sensitive tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _block(rng, dim=D):
    mk = lambda *s: (rng.randn(*s) * 0.05).astype(np.float32)  # noqa: E731
    return {
        "ln_1": {"scale": (rng.rand(dim) + 0.5).astype(np.float32), "bias": mk(dim)},
        "attn": {"qkv_w": mk(dim, 3 * dim), "qkv_b": mk(3 * dim),
                 "out_w": mk(dim, dim), "out_b": mk(dim)},
        "ln_2": {"scale": (rng.rand(dim) + 0.5).astype(np.float32), "bias": mk(dim)},
        "mlp": {"fc_w": mk(dim, 4 * dim), "fc_b": mk(4 * dim),
                "proj_w": mk(4 * dim, dim), "proj_b": mk(dim)},
    }


def _cast(tree, jdt):
    """A numpy block tree as JAX arrays: matmul weights and biases in jdt,
    LayerNorm parameters fp32."""
    return {k: {n: jnp.asarray(v, jnp.float32 if k.startswith("ln") else jdt)
                for n, v in sub.items()} for k, sub in tree.items()}


def _port(jtree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree), "cpu")


def _params12(p):
    return (p["ln_1"]["scale"], p["ln_1"]["bias"], p["attn"]["qkv_w"], p["attn"]["qkv_b"],
            p["attn"]["out_w"], p["attn"]["out_b"], p["ln_2"]["scale"], p["ln_2"]["bias"],
            p["mlp"]["fc_w"], p["mlp"]["fc_b"], p["mlp"]["proj_w"], p["mlp"]["proj_b"])


def _ref_layer(p, x, mask=None):
    x = x + JL.attention(p["attn"], JL.layer_norm(p["ln_1"], x), H, mask)
    return x + JL.mlp(p["mlp"], JL.layer_norm(p["ln_2"], x))


def _jax_mask(causal):
    if causal is False:
        return None
    if causal is True:
        from mudpt_tpu.models.text import causal_mask

        return causal_mask(S)
    return JFB._causal_mask(S, causal)


def _np32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a.astype(jnp.float32),
                      np.float64)


def _close(got, want, max_of_max, norm):
    """max |err| <= max_of_max x the largest value; ||err|| <= norm x ||want||."""
    got, want = _np32(got), _np32(want)
    err = np.abs(got - want)
    assert err.max() <= max_of_max * np.abs(want).max(), (err.max(), np.abs(want).max())
    assert np.linalg.norm(err) <= norm * np.linalg.norm(want), (
        np.linalg.norm(err) / np.linalg.norm(want))


def _codes_close(got, want, share):
    """int8 codes: none more than one step apart, at most ``share`` differ."""
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    assert np.abs(got - want).max() <= 1
    assert (got != want).mean() <= share, (got != want).mean()


# ---------------------------------------------------------------------------
# quantizers and plain kernels against the JAX helpers
# ---------------------------------------------------------------------------

def test_quantize_cols_bit_equal_to_jax():
    rng = np.random.RandomState(0)
    w = (rng.randn(64, 192) * np.exp(rng.randn(192))).astype(np.float32)
    q, s = JQ.quantize_cols(jnp.asarray(w))
    tq, ts = TQ.quantize_cols(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
    # the kernels' layout: the same codes as (Dout, Din) int8, K-major
    blk = _block(rng)
    qw = TQ.quantize_weights(params_from_numpy(blk, "cpu"))
    for name, group in (("qkv", "attn"), ("out", "attn"), ("fc", "mlp"), ("proj", "mlp")):
        jq, js = JQ.quantize_cols(jnp.asarray(blk[group][f"{name}_w"]))
        np.testing.assert_array_equal(qw[f"{name}_wq"].numpy(), np.asarray(jq).T)
        np.testing.assert_array_equal(qw[f"{name}_ws"].numpy(), np.asarray(js))
        assert qw[f"{name}_wq"].is_contiguous()


def test_quantize_layer_matches_jax():
    """The 16-operand layouts, dynamic and static (scales folded)."""
    rng = np.random.RandomState(1)
    blk = _block(rng)
    jp = _cast(blk, jnp.float32)
    amax = np.abs(rng.randn(4)).astype(np.float32) + 0.5
    jq16 = JQ._quantize_layer(_params12(jp))
    jq16s, jr = JQ._quantize_layer_static(_params12(jp), jnp.asarray(amax))
    tp = _params12(params_from_numpy(blk, "cpu"))
    tq16 = TQ._quantize_layer(tp)
    tq16s, tr = TQ._quantize_layer_static(tp, torch.from_numpy(amax))
    for i in range(16):
        for j, t in ((jq16[i], tq16[i]), (jq16s[i], tq16s[i])):
            t = t.numpy()
            if t.dtype == np.int8:
                t = t.T  # (Dout, Din) in the port
            np.testing.assert_array_equal(t, np.asarray(j), err_msg=str(i))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr).reshape(4))


def test_quant_rows_matches_jax():
    """The row quantizer on the same fp32 rows.  XLA computes the scale as
    amax * (1/127) under jit (as the interpret-mode kernels run), the port
    divides (IEEE); the two scales are at most one fp32 ulp apart, and the
    codes are bit-equal wherever the scales are.  Readings: 5% of the
    scales and 0.02% of the codes differ."""
    rng = np.random.RandomState(2)
    x = (rng.randn(40, 256) * np.exp(rng.randn(40, 1))).astype(np.float32)
    q, s = jax.jit(JQ._quant_rows)(jnp.asarray(x))
    tq, ts = TQ.quantize_rows_plain(torch.from_numpy(x))
    q, s, tq, ts = np.asarray(q), np.asarray(s), tq.numpy(), ts.numpy()
    np.testing.assert_allclose(ts, s, rtol=2.0 ** -23, atol=0)
    same = (ts == s)[:, 0]
    np.testing.assert_array_equal(tq[same], q[same])
    _codes_close(tq, q, share=2.0 ** -8)
    # eagerly (one op at a time) XLA divides too: then all bit-equal
    qe, se = JQ._quant_rows(jnp.asarray(x))
    np.testing.assert_array_equal(tq, np.asarray(qe))
    np.testing.assert_array_equal(ts, np.asarray(se))


def test_quant_rows_static_bit_equal_to_jax():
    """``quant_static`` (quant_block.py:390-392): one multiply, rint."""
    rng = np.random.RandomState(3)
    x = (rng.randn(40, 256) * 3).astype(np.float32)
    r = np.float32(127.0) / np.float32(7.5)
    want = jnp.clip(jnp.round(jnp.asarray(x) * r), -127.0, 127.0).astype(jnp.int8)
    got, s = TQ.quantize_rows_plain(torch.from_numpy(x), torch.tensor(r))
    assert s is None
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.abs(got.numpy()).max() == 127  # the outliers saturate


# the widths of LayerNorm-quant's instances on the card: the text rows
# (512; RN50x4's 640 on the 768 instance) and ViT-B/16's 768
@pytest.mark.parametrize("width", [D, 512, 640, 768])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_ln_quant_matches_jax(static, width):
    """``_ln_fp32`` + the quantizer of its fp32 output, on bf16 rows: codes
    within one step, at most 2^-8 of them differing (the order of the
    statistics' sums; reading: none); scales within 4 fp32 ulps (2^-21
    relative: the row's absmax may move by an ulp and the scale by one
    more; reading: 2 ulps)."""
    rng = np.random.RandomState(4)
    x = jnp.asarray(rng.randn(80, width) * 2, jnp.bfloat16)
    sc = (rng.rand(width) + 0.5).astype(np.float32)
    bi = (rng.randn(width) * 0.1).astype(np.float32)
    xn, _, _ = JFB._ln_fp32(x, jnp.asarray(sc), jnp.asarray(bi))
    r = np.float32(127.0) / np.float32(4.0)
    if static:
        jq = jnp.clip(jnp.round(xn * r), -127.0, 127.0).astype(jnp.int8)
        js = None
    else:
        jq, js = JQ._quant_rows(xn)
    tx = params_from_numpy({"x": np.asarray(x)}, "cpu")["x"]
    tq, ts = TQ.ln_quant_plain(tx, torch.from_numpy(sc), torch.from_numpy(bi),
                               torch.tensor(r) if static else None)
    _codes_close(tq.numpy(), np.asarray(jq), share=2.0 ** -8)
    if not static:
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2.0 ** -21, atol=0)


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_s8_matmul_bit_equal_to_jax(static):
    """``_q8_matmul`` (:79) / ``matmul_static`` (:394): the int32 product is
    exact and each dequant step one rounding, so the fp32 result is
    bit-equal."""
    rng = np.random.RandomState(5)
    a = rng.randint(-127, 128, (40, 256)).astype(np.int8)
    xs = (np.abs(rng.randn(40, 1)) * 0.01 + 1e-3).astype(np.float32)
    w = (rng.randn(256, 128) * 0.05).astype(np.float32)
    wq, ws = JQ.quantize_cols(jnp.asarray(w))
    b = jnp.asarray(rng.randn(128) * 0.1, jnp.bfloat16)
    if static:
        acc = jax.lax.dot_general(jnp.asarray(a), wq, (((1,), (0,)), ((), ())),
                                  preferred_element_type=jnp.int32)
        want = acc.astype(jnp.float32) * ws + b.astype(jnp.float32)
    else:
        want = JQ._q8_matmul(jnp.asarray(a), jnp.asarray(xs), wq, ws, b)
    tb = params_from_numpy({"b": np.asarray(b)}, "cpu")["b"]
    twq = torch.from_numpy(np.asarray(wq).T.copy())
    h, _ = TQ.gemm_s8_plain(torch.from_numpy(a), None if static else torch.from_numpy(xs), twq,
                            torch.from_numpy(np.array(ws)), tb,
                            "q8s_fc_gelu" if static else "q8_fc_gelu", r=torch.tensor(1.0),
                            save_h=True, out_dtype=torch.float32)
    np.testing.assert_array_equal(h.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the q8 layer forwards against the Pallas kernels
# ---------------------------------------------------------------------------

# Readings (worst of the three masks), port vs Pallas, relative to the
# output's largest value / its norm: fp32 1.2e-7 / 4.2e-8 where no code
# moved, and 3.8e-4 / 4.8e-5 where one did (the saving forward's y, causal,
# seed 11, test_torch_quant_save.py: a code of g, whose sigmoid XLA and PyTorch evaluate an fp32 ulp
# apart, moved by one step of its row's grid); bf16 4.0e-3 / 3.6e-3, about
# a bf16 ulp broadly: XLA on the CPU keeps y1 = x + bf16(out) in fp32 into
# LN2 (excess precision), where the Pallas program and the port round it,
# so LN2's codes move (the op-by-op test in test_torch_quant_save.py).  Bounds: fp32 2.5x a
# code flip's reading; bf16 2x the readings:
FWD_TOL = {"fp32": (2.0 ** -10, 2.0 ** -14), "bf16": (2.0 ** -5, 2.0 ** -7)}


def _layer_case(seed, causal, dt_name, static):
    """JAX and port inputs of one layer; static: JAX's calibrated scales."""
    tdt, jdt = DTYPES[dt_name]
    rng = np.random.RandomState(seed)
    blk = _block(rng)
    x = rng.randn(B, S, D).astype(np.float32)
    jp = _cast(blk, jdt)
    jx = jnp.asarray(x, jdt)
    tp = _port(jp)
    tx = params_from_numpy({"x": np.asarray(jx)}, "cpu")["x"]
    amax = None
    if static:
        amax = JQ.calibrate(lambda xx: _ref_layer(jp, xx, _jax_mask(causal)), jx)[0]
    return jp, jx, tp, tx, amax


@pytest.mark.parametrize("dt_name", sorted(DTYPES))
@pytest.mark.parametrize("causal", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_layer_q8_forward_matches_pallas(static, causal, dt_name):
    jp, jx, tp, tx, amax = _layer_case(10, causal, dt_name, static)
    if static:
        jq, jr = JQ._quantize_layer_static(_params12(jp), amax)
        want = JQ.layer_fullblock_q8_static(jx, *jq, jr, H, causal)
        tq, tr = TQ._quantize_layer_static(_params12(tp), torch.from_numpy(np.array(amax)))
        got = TQ.layer_fullblock_q8_static(tx, *tq, tr, H, causal)
    else:
        want = JQ.layer_fullblock_q8(jx, *JQ._quantize_layer(_params12(jp)), H, causal)
        got = TQ.layer_fullblock_q8(tx, *TQ._quantize_layer(_params12(tp)), H, causal)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, *FWD_TOL[dt_name])
