"""What the int8 serving layer pays besides its products: one ViT-B layer
under six modes, timed on the card (counterpart of
``tools/probe_q8_residual.py``).

Each mode's time a layer is the difference between chained towers of L1
and L2 layers, over L2 - L1 (constant per-call overhead cancels; chained
layers cannot be folded, each consumes the previous output, and LayerNorm
keeps magnitudes bounded):

  bf16       the production bf16 layer (``fused_block.layer_fullblock``)
  q8         the production dynamic int8 layer (``layer_fullblock_q8``)
  q8_recip   dynamic, quantizing by x * (127 / max) instead of x / (max / 127)
  q8_noclip  dynamic without the clip (the same codes)
  q8_static  the static chain, r = 8.0 at every site, on the unfolded weight
             scales (the JAX probe's function: numerically off, timing only)
  q8_floor   a bare convert for every quantizer, no scale in the products'
             epilogues (meaningless numbers, timing only)

(``ops/probe.probe_layer``; every kernel hand-written, ``csrc/``.)  Reading
the deltas: q8 - q8_floor is what quantizing and dequantizing cost in all;
q8 - q8_recip the IEEE division; q8_recip - q8_static the row max and the
row scale's multiply; q8_static - q8_floor rounding, clipping and the rest
of the converts.  Also prints the bound of one layer (bytes or operations
at the card's peaks, ``chip_smoke.chain_bound``'s count of an unmasked
layer forward).

  python -m mudpt_torch.tools.probe_q8_residual [--B 128 --S 200 --D 768
      --H 12 --l1 4 --l2 16 --rep 6] [--device cpu]

Weights and input come from a seeded generator on the device (weights
0.02 x a normal draw, biases rounded to bf16 once: the JAX probe's bf16
layer casts its fp32 biases so, and the port's q8 chains take them in x's
dtype).  Without ``--device`` it runs on the card and raises without CUDA;
``--device cpu`` runs the plain versions (small shapes, for the tests).
Exits 1 when a tower's output is not finite.
"""

from __future__ import annotations

import argparse
import json

from mudpt_torch.tools.probe_int8_mxu import PEAK_BF16_FLOPS, PEAK_INT8_OPS, timed

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def layer_params(D: int, device, seed: int = 0) -> tuple:
    """The 12 layer parameters (``quant_block._params12`` order): LayerNorm
    scales 1 and biases fp32, weights (Din, Dout) and biases bf16."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    n = lambda *s: torch.randn(*s, generator=gen, device=device) * 0.02  # noqa: E731
    ones = lambda: torch.ones(D, device=device)  # noqa: E731
    bf = torch.bfloat16
    return (ones(), n(D), n(D, 3 * D).to(bf), n(3 * D).to(bf), n(D, D).to(bf), n(D).to(bf),
            ones(), n(D), n(D, 4 * D).to(bf), n(4 * D).to(bf), n(4 * D, D).to(bf), n(D).to(bf))


def layer_bound_s(B: int, S: int, D: int, int8: bool) -> float:
    """The least time of one unmasked layer forward over B blocks of S rows:
    x in and y out and the weights, each once, at 3.35 TB/s; or the
    projections' products (at the int8 peak under ``int8``) and attention's
    two score-sized products at the bf16 peak."""
    M, weights = B * S, 12 * D * D
    t_bytes = (M * D * 2 * 2 + weights * (1 if int8 else 2)) / PEAK_BYTES_PER_S
    proj = 2 * M * weights / (PEAK_INT8_OPS if int8 else PEAK_BF16_FLOPS)
    return max(t_bytes, proj + 4 * M * S * D / PEAK_BF16_FLOPS)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--B", type=int, default=128)
    ap.add_argument("--S", type=int, default=200)
    ap.add_argument("--D", type=int, default=768)
    ap.add_argument("--H", type=int, default=12)
    ap.add_argument("--l1", type=int, default=4)
    ap.add_argument("--l2", type=int, default=16)
    ap.add_argument("--rep", type=int, default=6)
    ap.add_argument("--device", type=str, default=None,
                    help="'cpu' to run the plain versions; default the card")
    args = ap.parse_args(argv)

    import torch

    from mudpt_torch.ops import probe
    from mudpt_torch.utils.device import card, resolve_device

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    B, S, D, H = args.B, args.S, args.D, args.H
    params = layer_params(D, dev)
    x = torch.randn(B, S, D, generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev).to(torch.bfloat16)

    def tower(qp, mode, n_layers):
        y = x
        for _ in range(n_layers):
            y = probe.probe_layer(y, qp, mode, H)
        return y

    macs = S * (3 * D * D + D * D + 8 * D * D) * 2  # the projections' products
    per_layer, towers, finite = {}, {}, {}
    with torch.no_grad():
        for mode in probe.MODES:
            qp = probe.probe_operands(params, mode)
            t1 = timed(lambda: tower(qp, mode, args.l1), args.rep, on_card)
            t2 = timed(lambda: tower(qp, mode, args.l2), args.rep, on_card)
            finite[mode] = bool(torch.isfinite(tower(qp, mode, args.l2).float()).all())
            per_layer[mode] = (t2 - t1) / (args.l2 - args.l1)
            towers[mode] = [t1, t2]
            rate = B * macs / per_layer[mode] / 1e12 if per_layer[mode] > 0 else float("nan")
            print(f"{mode:10s} {per_layer[mode]*1e3:7.3f} ms/layer "
                  f"(L{args.l1}:{t1*1e3:7.2f} L{args.l2}:{t2*1e3:7.2f})  proj-MACs "
                  f"{rate:6.1f} T/s")
    r = per_layer
    deltas = {"q8 - q8_floor": r["q8"] - r["q8_floor"], "q8 - q8_recip": r["q8"] - r["q8_recip"],
              "q8_recip - q8_static": r["q8_recip"] - r["q8_static"],
              "q8_static - q8_floor": r["q8_static"] - r["q8_floor"]}
    share = 100 * deltas["q8 - q8_floor"] / r["q8"] if r["q8"] > 0 else float("nan")
    print(f"\nquant/dequant residual: {deltas['q8 - q8_floor']*1e3:.3f} ms/layer "
          f"({share:.1f}% of the q8 layer)")
    print(f"  divide -> recip-mul saves: {deltas['q8 - q8_recip']*1e3:.3f} ms")
    print(f"  max-reduce + row-scale mul: {deltas['q8_recip - q8_static']*1e3:.3f} ms")
    print(f"  round/clip/convert floor:   {deltas['q8_static - q8_floor']*1e3:.3f} ms")
    print(f"bf16 reference: {r['bf16']*1e3:.3f} ms/layer")
    bound = {"bf16": layer_bound_s(B, S, D, False), "int8": layer_bound_s(B, S, D, True)}
    print(f"bound of a layer: bf16 {bound['bf16']*1e3:.4f} ms, int8 {bound['int8']*1e3:.4f} ms")
    record = {"per_layer_s": per_layer, "towers_s": towers, "deltas_s": deltas,
              "bound_s": bound, "finite": finite,
              "shape": {"B": B, "S": S, "D": D, "H": H, "l1": args.l1, "l2": args.l2},
              "device": dev.type, "card": card() if on_card else None}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    raise SystemExit(0 if all(main()["finite"].values()) else 1)
