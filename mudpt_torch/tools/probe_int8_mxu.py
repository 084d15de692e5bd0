"""The tensor cores' rate, s8 x s8 -> s32 against bf16 x bf16 -> fp32, and
the in-kernel fp32 -> int8 row quantization (counterpart of
``tools/probe_int8_mxu.py``).

Every grid step of the rate kernel contracts ITERS different x slices
against one W (no step can be folded away); the kernel runs G steps, timed
at two sizes G1 and G2, and the rate is the work over the time between
them, so per-call overhead cancels (``ops/probe.mma_probe``,
``csrc/probe_mma.cu``).  The quantizer is ``quant_block.quantize_rows``,
checked exactly against ``clip(rint(x / s))`` as the JAX probe checks it.
Prints the probe's lines, the bound (the work between G1 and G2 at the
card's dense peaks, 989 TFLOP/s bf16 and 1,979 TOP/s int8) and a yardstick
(``torch.matmul`` and ``torch._int_mm`` on the ITERS slices stacked, one
grid step's operations; the probe itself never calls them).

  python -m mudpt_torch.tools.probe_int8_mxu [--S 384 --D 768 --DO 3072
      --iters 16 --g1 64 --g2 320 --rep 4] [--no-yardstick] [--device cpu]

Without ``--device`` it runs on the card and raises without CUDA; ``--device
cpu`` runs the plain versions (small shapes, for the tests).  Exits 1 when
the quantizer's codes are not exact.
"""

from __future__ import annotations

import argparse
import json
import time

PEAK_BF16_FLOPS, PEAK_INT8_OPS = 989e12, 1979e12  # H100 SXM, dense, at 700 W


def timed(fn, rep: int, on_card: bool) -> float:
    """Seconds a call of ``fn``: one warm-up call, then ``rep`` calls
    between CUDA events (on the card) or the host clock."""
    import torch

    fn()
    if not on_card:
        t0 = time.perf_counter()
        for _ in range(rep):
            fn()
        return (time.perf_counter() - t0) / rep
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rep):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / rep / 1e3


def operands(S: int, D: int, DO: int, iters: int, device, seed: int = 0) -> dict:
    """The probe's operands from a seeded generator on ``device``: x (iters,
    S, D) and W (D, DO) from a normal draw, in bf16 and as int8 codes
    ``clip(rint(10 v))``; W stored transposed, (DO, D), the kernel's K-major
    layout (transposed here, once, outside any timing); x32 the fp32 rows of
    the quantizer check."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    xs32 = torch.randn(iters, S, D, generator=gen, device=device)
    w32 = torch.randn(D, DO, generator=gen, device=device)
    codes = lambda v: torch.round(v * 10).clamp(-127, 127).to(torch.int8)  # noqa: E731
    return {"bf16": (xs32.bfloat16(), w32.bfloat16().t().contiguous()),
            "int8": (codes(xs32), codes(w32).t().contiguous()), "x32": xs32[0].contiguous()}


def rate(xs, wt, g1: int, g2: int, rep: int, on_card: bool) -> tuple:
    """(operations a second, t at G1, t at G2) of the rate kernel."""
    from mudpt_torch.ops import probe

    iters, S, D = xs.shape
    t1 = timed(lambda: probe.mma_probe(xs, wt, g1), rep, on_card)
    t2 = timed(lambda: probe.mma_probe(xs, wt, g2), rep, on_card)
    ops = 2 * S * D * wt.shape[0] * iters * (g2 - g1)
    return (ops / (t2 - t1) if t2 > t1 else float("nan")), t1, t2


def quant_exact(x32) -> bool:
    """``quant_block.quantize_rows`` on x32 against ``clip(rint(x / s))`` at
    its own scales, exactly (``probe_int8_mxu.py:131-136``)."""
    import torch

    from mudpt_torch.ops import quant_block as Q

    q, s = Q.quantize_rows(x32)
    want = torch.round(x32 / s).clamp(-127, 127).to(torch.int8)
    return bool(torch.equal(q, want))


def yardstick(ops: dict, rep: int, on_card: bool) -> dict:
    """Operations a second of torch.matmul (bf16) and torch._int_mm (int8)
    on the ITERS slices stacked, (iters * S, D) x (D, DO): one grid step's
    operations, each product written out rather than summed.  A yardstick
    only; the probe never calls them."""
    import torch

    out = {}
    xs, wt = ops["bf16"]
    n = 2 * xs.shape[0] * xs.shape[1] * xs.shape[2] * wt.shape[0]
    a = xs.reshape(-1, xs.shape[2])
    out["torch.matmul"] = n / timed(lambda: torch.matmul(a, wt.t()), rep, on_card)
    if on_card:
        qa, qwt = ops["int8"][0].reshape(-1, xs.shape[2]), ops["int8"][1]
        out["torch._int_mm"] = n / timed(lambda: torch._int_mm(qa, qwt.t()), rep, on_card)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--S", type=int, default=384)
    ap.add_argument("--D", type=int, default=768)
    ap.add_argument("--DO", type=int, default=3072)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--g1", type=int, default=64)
    ap.add_argument("--g2", type=int, default=320)
    ap.add_argument("--rep", type=int, default=4)
    ap.add_argument("--no-yardstick", action="store_true")
    ap.add_argument("--device", type=str, default=None,
                    help="'cpu' to run the plain versions; default the card")
    args = ap.parse_args(argv)

    from mudpt_torch.utils.device import card, resolve_device

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    ops = operands(args.S, args.D, args.DO, args.iters, dev)
    r_bf16, tb1, tb2 = rate(*ops["bf16"], args.g1, args.g2, args.rep, on_card)
    print(f"bf16  G={args.g1}:{tb1*1e3:7.2f} ms  G={args.g2}:{tb2*1e3:7.2f} ms"
          f"  -> {r_bf16/1e12:6.1f} TFLOP/s")
    r_i8, ti1, ti2 = rate(*ops["int8"], args.g1, args.g2, args.rep, on_card)
    print(f"int8  G={args.g1}:{ti1*1e3:7.2f} ms  G={args.g2}:{ti2*1e3:7.2f} ms"
          f"  -> {r_i8/1e12:6.1f} TOP/s  = {r_i8/r_bf16:.2f}x bf16")
    exact = quant_exact(ops["x32"])
    print(f"in-kernel fp32->int8 quant chain: {'OK (exact)' if exact else 'VALUE MISMATCH'}")
    work = 2 * args.S * args.D * args.DO * args.iters * (args.g2 - args.g1)
    bound = {"bf16": work / PEAK_BF16_FLOPS, "int8": work / PEAK_INT8_OPS}
    print(f"bound: {work:.4g} operations between G={args.g1} and G={args.g2}: "
          f"{bound['bf16']*1e3:.3f} ms at 989 TFLOP/s (bf16; measured {(tb2 - tb1)*1e3:.3f}), "
          f"{bound['int8']*1e3:.3f} ms at 1,979 TOP/s (int8; measured {(ti2 - ti1)*1e3:.3f})")
    record = {"bf16_ops_per_s": r_bf16, "int8_ops_per_s": r_i8, "bf16_s": [tb1, tb2],
              "int8_s": [ti1, ti2], "quant_exact": exact, "bound_s": bound,
              "shape": {"S": args.S, "D": args.D, "DO": args.DO, "iters": args.iters,
                        "g1": args.g1, "g2": args.g2},
              "device": dev.type, "card": card() if on_card else None}
    if not args.no_yardstick:
        record["yardstick_ops_per_s"] = yardstick(ops, args.rep, on_card)
        print("yardstick (not the probe's path): " + ", ".join(
            f"{k} {v/1e12:.1f} T/s" for k, v in record["yardstick_ops_per_s"].items()))
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    raise SystemExit(0 if main()["quant_exact"] else 1)
