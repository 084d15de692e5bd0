"""The probes of ``tools/`` in the port (``mudpt_torch/ops/probe.py``, plain
PyTorch versions on the CPU) against the JAX tools' own kernels, run in
interpret mode as the JAX package's tests run Pallas.  The tools are not
importable pieces (their kernels are nested in ``main``), so their source is
the oracle: the nested functions ``mm_kernel`` and ``quant_kernel`` of
``tools/probe_int8_mxu.py`` and ``quant_rows``, ``q8_matmul`` and
``layer_kernel`` of ``tools/probe_q8_residual.py`` are found by AST and
executed, dedented, in a namespace holding the names they close over at
test sizes.  The tools stay as they are.

Held: the rate kernel's s8 sums exactly (one case where int32 wraps), its
bf16 sums exactly on small integers and to a stated tolerance otherwise;
each quantizer against the probe's (codes by the ``_codes_close`` rule of
``test_torch_quant_block.py``: XLA multiplies by 1/127 under jit); each of
the six modes' layers against ``layer_kernel``, and q8 and bf16 also
against ``mudpt_tpu``'s ``layer_fullblock_q8`` and ``layer_fullblock``;
the floor's convert against XLA's on out-of-range values and NaN; and the
two entry points, which run with ``--device cpu`` and fail without a card.
"""

import ast
import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mudpt_tpu.ops import fused_block as JFB
from mudpt_tpu.ops import quant_block as JQ

from mudpt_torch.models.convert import params_from_numpy
from mudpt_torch.ops import probe as P
from mudpt_torch.ops import quant_block as TQ

ROOT = Path(__file__).resolve().parent.parent
ITERS, S_MM, D_MM, DO_MM = 16, 8, 256, 32  # the rate kernel's test shapes
B, S, D, H = 2, 16, 64, 2  # the layer's
# the q8 layers, port vs Pallas in bf16: test_torch_quant_block.py's bounds
# (a bf16 ulp broadly, where XLA keeps y1 in fp32 into LN2); the bf16 layer:
# test_torch_fused_block.py's (reading 1.7e-3 in norm)
Q8_TOL, BF16_TOL = (2.0 ** -5, 2.0 ** -7), (2.0 ** -5, 2.0 ** -8)
# q8_static on the probe's unfolded scales: qkv is 8x the layer's and its
# scores 64x, so the softmax's inputs carry 64x the sum-order differences
# and its bf16 probabilities round apart far more often (reading 1.3e-2 in
# norm, the other modes' 1e-3): for timing only, held to 2^-5 in both
Q8_STATIC_TOL = (2.0 ** -5, 2.0 ** -5)
# the rate kernel's bf16 sums: both sides add the same fp32 products, each
# matmul's K terms in its own order (XLA's and PyTorch's CPU kernels), so an
# element moves by a few fp32 ulps of its running sums (reading: 3.4e-8)
MM_BF16_RTOL = 2.0 ** -20


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on few cores: keep torch's intra-op
    pool small so these files do not crowd out timing-sensitive tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def nested(path: str, names: tuple, **scope) -> dict:
    """The functions ``names`` nested in ``main`` of the tool at ``path``,
    executed from their dedented source in a namespace of ``scope``."""
    src = (ROOT / path).read_text()
    main = next(n for n in ast.parse(src).body if isinstance(n, ast.FunctionDef)
                and n.name == "main")
    ns = dict(scope)
    for node in main.body:
        if isinstance(node, ast.FunctionDef) and node.name in names:
            exec(textwrap.dedent(ast.get_source_segment(src, node)), ns)  # noqa: S102
    missing = [n for n in names if n not in ns]
    assert not missing, f"{path}: no nested {missing}"
    return ns


@functools.lru_cache(maxsize=None)
def mxu_kernels() -> dict:
    return nested("tools/probe_int8_mxu.py", ("mm_kernel", "quant_kernel"), jax=jax, jnp=jnp,
                  pl=pl, ITERS=ITERS, S=S_MM, DO=DO_MM)


@functools.lru_cache(maxsize=None)
def q8_kernels() -> dict:
    return nested("tools/probe_q8_residual.py", ("quant_rows", "q8_matmul", "layer_kernel"),
                  jax=jax, jnp=jnp, _ln_fp32=JFB._ln_fp32, _mha_acc=JFB._mha_acc,
                  _quick_gelu=JFB._quick_gelu)


def jax_mm(x, w, g: int, acc_dtype):
    """The tool's ``mm_kernel`` under a grid of g steps, interpreted."""
    f = pl.pallas_call(
        lambda xr, wr, orf: mxu_kernels()["mm_kernel"](xr, wr, orf, acc_dtype=acc_dtype),
        grid=(g,),
        in_specs=[pl.BlockSpec((ITERS, S_MM, D_MM), lambda i: (0, 0, 0)),
                  pl.BlockSpec((D_MM, DO_MM), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((S_MM, DO_MM), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((S_MM, DO_MM), acc_dtype), interpret=True)
    return np.asarray(f(x, w))


def _t(a) -> torch.Tensor:
    return params_from_numpy({"a": np.asarray(a)}, "cpu")["a"]


def test_s8_sums_wrap_as_the_tpu_accumulator():
    """Positive codes: a step's sum passes 5e7 an element, so at G = 64
    every output wraps mod 2^32; the port's sum is the kernel's exactly."""
    rng = np.random.RandomState(0)
    x = rng.randint(100, 128, (ITERS, S_MM, D_MM)).astype(np.int8)
    w = rng.randint(100, 128, (D_MM, DO_MM)).astype(np.int8)
    want = jax_mm(jnp.asarray(x), jnp.asarray(w), 64, jnp.int32)
    got = P.mma_probe(torch.from_numpy(x), torch.from_numpy(w.T.copy()), 64)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    exact = np.einsum("isd,do->so", x.astype(np.int64), w.astype(np.int64)) * 64
    assert (np.abs(exact) >= 2 ** 31).all() and not np.array_equal(exact, want)


def test_s8_sums_without_a_wrap():
    rng = np.random.RandomState(1)
    x = np.clip(np.round(rng.randn(ITERS, S_MM, D_MM) * 10), -127, 127).astype(np.int8)
    w = np.clip(np.round(rng.randn(D_MM, DO_MM) * 10), -127, 127).astype(np.int8)
    want = jax_mm(jnp.asarray(x), jnp.asarray(w), 3, jnp.int32)
    got = P.mma_probe(torch.from_numpy(x), torch.from_numpy(w.T.copy()), 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("integers", [True, False], ids=["integers", "normal"])
def test_bf16_sums_match_the_tpu_kernel(integers):
    """fp32 sums of bf16 products: exact on small integers (every partial
    sum an fp32 integer), else within MM_BF16_RTOL of the largest value."""
    rng = np.random.RandomState(2)
    if integers:
        x, w = (rng.randint(-4, 5, s).astype(np.float32)
                for s in ((ITERS, S_MM, D_MM), (D_MM, DO_MM)))
    else:
        x, w = rng.randn(ITERS, S_MM, D_MM), rng.randn(D_MM, DO_MM)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = jax_mm(jx, jw, 5, jnp.float32)
    got = P.mma_probe(_t(jx), _t(jw).t().contiguous(), 5).numpy()
    if integers:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=MM_BF16_RTOL * np.abs(want).max())


def test_quant_kernel_is_quant_rows():
    """The rate probe's quantize kernel (:56) is the port's dynamic row
    quantizer: the _codes_close rule (XLA's 1/127 under the interpreter's
    jit), codes and scales bit-equal where the scales are."""
    rng = np.random.RandomState(3)
    x = (rng.randn(S_MM * 4, 256) * np.exp(rng.randn(S_MM * 4, 1))).astype(np.float32)
    q, s = pl.pallas_call(mxu_kernels()["quant_kernel"], interpret=True, out_shape=(
        jax.ShapeDtypeStruct(x.shape, jnp.int8),
        jax.ShapeDtypeStruct((x.shape[0], 1), jnp.float32)))(jnp.asarray(x))
    tq, ts = P.quantize_rows_mode(torch.from_numpy(x), "q8")
    _same_where_scales_are(tq.numpy(), ts.numpy(), np.asarray(q), np.asarray(s))


def _same_where_scales_are(tq, ts, q, s):
    np.testing.assert_allclose(ts, s, rtol=2.0 ** -23, atol=0)
    same = (ts == s)[:, 0]
    np.testing.assert_array_equal(tq[same], q[same])
    assert np.abs(tq.astype(np.int32) - q).max() <= 1
    assert (tq != q).mean() <= 2.0 ** -8


@pytest.mark.parametrize("mode", ["q8", "q8_recip", "q8_noclip", "q8_static", "q8_floor"])
def test_quantizers_match_the_probe(mode):
    rng = np.random.RandomState(4)
    x = (rng.randn(64, 256) * np.exp(rng.randn(64, 1))).astype(np.float32)
    if mode == "q8_floor":
        x *= 60  # past the int8 range
    q, s = jax.jit(lambda v: q8_kernels()["quant_rows"](v, mode, P.STATIC_R))(jnp.asarray(x))
    tq, ts = P.quantize_rows_mode(torch.from_numpy(x), mode, torch.tensor(P.STATIC_R))
    if s is None:
        assert ts is None
        np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    else:
        _same_where_scales_are(tq.numpy(), ts.numpy(), np.asarray(q), np.asarray(s))
    if mode == "q8_noclip":  # the clip is redundant: the dynamic codes exactly
        np.testing.assert_array_equal(tq.numpy(), P.quantize_rows_mode_plain(
            torch.from_numpy(x), "q8")[0].numpy())


def test_floor_convert_is_xlas():
    """Out-of-range values saturate, NaN converts to 0, toward zero; torch's
    own convert would wrap (300 -> 44)."""
    v = np.array([300, -300, 127.9, -128.9, 1e30, np.inf, -np.inf, np.nan, 2.7, -2.7, 0.5,
                  -0.5, 128.0, -129.0], np.float32)
    want = np.asarray(jnp.asarray(v).astype(jnp.int8))
    got = P.sat_s8(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)
    assert list(got[:8]) == [127, -128, 127, -128, 127, 127, -128, 0]
    assert torch.tensor([300.0]).to(torch.int8).item() == 44
    q, _ = jax.jit(lambda a: q8_kernels()["quant_rows"](a, "q8_floor", 8.0))(jnp.asarray(v))
    np.testing.assert_array_equal(P.quantize_rows_mode_plain(torch.from_numpy(v), "q8_floor")[0],
                                  np.asarray(q))


def _layer_inputs(seed: int):
    """The probe's 12-tuple in JAX and in the port, numpy-seeded: weights
    and biases bf16 (the JAX probe's fp32 biases at bf16 values, which its
    bf16 layer casts to), LayerNorm parameters fp32; x bf16."""
    rng = np.random.RandomState(seed)
    mk = lambda *s: (rng.randn(*s) * 0.05).astype(np.float32)  # noqa: E731
    blk = {"ln_1": {"scale": (rng.rand(D) + 0.5).astype(np.float32), "bias": mk(D)},
           "attn": {"qkv_w": mk(D, 3 * D), "qkv_b": mk(3 * D), "out_w": mk(D, D),
                    "out_b": mk(D)},
           "ln_2": {"scale": (rng.rand(D) + 0.5).astype(np.float32), "bias": mk(D)},
           "mlp": {"fc_w": mk(D, 4 * D), "fc_b": mk(4 * D), "proj_w": mk(4 * D, D),
                   "proj_b": mk(D)}}
    jblk = {k: {n: jnp.asarray(v, jnp.float32 if k.startswith("ln") else jnp.bfloat16)
                for n, v in sub.items()} for k, sub in blk.items()}
    jx = jnp.asarray(rng.randn(B, S, D), jnp.bfloat16)
    jp = TQ._params12(jblk)
    tp = TQ._params12(params_from_numpy(jax.tree_util.tree_map(np.asarray, jblk), "cpu"))
    return jx, jp, _t(jx), tp


def jax_layer(jx, jp, mode: str):
    """The tool's ``layer_kernel`` in ``mode`` on the probe's quantized
    operands (``quantize_cols`` of each weight, :181-186), interpreted; the
    bf16 mode is the production ``layer_fullblock`` (:199-211)."""
    if mode == "bf16":
        return JFB.layer_fullblock(jx, *jp, H, False)
    (ln1_s, ln1_b, qkv_w, qkv_b, out_w, out_b, ln2_s, ln2_b, fc_w, fc_b, proj_w, proj_b) = jp
    qp = (ln1_s, ln1_b, *JQ.quantize_cols(qkv_w), qkv_b, *JQ.quantize_cols(out_w), out_b,
          ln2_s, ln2_b, *JQ.quantize_cols(fc_w), fc_b, *JQ.quantize_cols(proj_w), proj_b)
    out_shape = jax.ShapeDtypeStruct((B, S, D), jx.dtype)
    return pl.pallas_call(
        functools.partial(q8_kernels()["layer_kernel"], n_head=H, mode=mode,
                          static_r=P.STATIC_R),
        grid=(B,), in_specs=[JFB._row(S, D)] + [JFB._full(*p.shape) for p in qp],
        out_specs=JFB._row_spec_of(out_shape), out_shape=out_shape,
        scratch_shapes=[pltpu.VMEM((S, D), jnp.float32)],
        compiler_params=JFB._COMPILER_PARAMS, interpret=True)(jx, *qp)


def _close(got, want, max_of_max, norm):
    got, want = np.asarray(got.float(), np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    assert np.isfinite(got).all()
    assert err.max() <= max_of_max * np.abs(want).max(), (err.max(), np.abs(want).max())
    assert np.linalg.norm(err) <= norm * np.linalg.norm(want), (
        np.linalg.norm(err) / np.linalg.norm(want))


@pytest.mark.parametrize("mode", P.MODES)
def test_layer_matches_the_probe(mode):
    jx, jp, tx, tp = _layer_inputs(5)
    want = np.asarray(jax_layer(jx, jp, mode).astype(jnp.float32))
    got = P.probe_layer(tx, P.probe_operands(tp, mode), mode, H)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, D)
    _close(got, want, *{"bf16": BF16_TOL, "q8_static": Q8_STATIC_TOL}.get(mode, Q8_TOL))
    if mode in ("q8", "bf16"):  # the production layers of mudpt_tpu, too
        if mode == "q8":
            ref = JQ.layer_fullblock_q8(jx, *JQ._quantize_layer(jp), H, False)
        else:
            ref = JFB.layer_fullblock(jx, *jp, H, False)
        _close(got, np.asarray(ref.astype(jnp.float32)), *(BF16_TOL if mode == "bf16"
                                                           else Q8_TOL))


def test_static_mode_is_the_probes_unfolded_scales():
    """q8_static takes the per-channel weight scales as they are (no site
    scale folded in) and r = 8 at all four sites: the probe's function,
    for timing only; the production static operands differ."""
    _, _, _, tp = _layer_inputs(6)
    qp = P.probe_operands(tp, "q8_static")
    assert len(qp) == 17 and torch.equal(qp[16], torch.full((4,), 8.0))
    dyn = TQ._quantize_layer(tp)
    for i in range(16):
        assert torch.equal(qp[i], dyn[i])


def test_entry_points_run_on_the_cpu_and_refuse_without_a_card(capsys):
    from mudpt_torch.tools import probe_int8_mxu, probe_q8_residual

    rec = probe_int8_mxu.main(["--device", "cpu", "--S", "8", "--D", "32", "--DO", "16",
                               "--iters", "4", "--g1", "1", "--g2", "2", "--rep", "1"])
    out = capsys.readouterr().out
    assert rec["quant_exact"] and rec["device"] == "cpu" and rec["card"] is None
    assert "in-kernel fp32->int8 quant chain: OK (exact)" in out
    assert "int8  G=1:" in out and "bound:" in out
    rec = probe_q8_residual.main(["--device", "cpu", "--B", "1", "--S", "8", "--D", "64",
                                  "--H", "1", "--l1", "1", "--l2", "2", "--rep", "1"])
    out = capsys.readouterr().out
    assert all(rec["finite"].values()) and sorted(rec["per_layer_s"]) == sorted(P.MODES)
    for line in ("q8_floor ", "quant/dequant residual:", "divide -> recip-mul saves:",
                 "bf16 reference:", "bound of a layer:"):
        assert line in out, line
    # no card and no --device: the card is asked for, and refused
    for tool in (probe_int8_mxu, probe_q8_residual):
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            tool.main([])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    cli = subprocess.run([sys.executable, "-m", "mudpt_torch.tools.probe_q8_residual"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert cli.returncode != 0 and "no CUDA device is available" in cli.stderr
