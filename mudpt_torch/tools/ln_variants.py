"""What the design choices of the bf16 LayerNorm dx and of LayerNorm-quant
are worth, read on the card by building variants of their sources beside
the kernels:

- ``csrc/layernorm_bwd.cu``'s bf16 kernel at one row a warp (the kernel)
  and two, and at two, four (the kernel) and eight warps a block:
  ``layernorm_bwd``'s ms at every width a path reaches (``LN``: the layers'
  fp32 dxn with a residual, the towers' bf16 dxn without), beside
  ``F.layer_norm``'s backward;
- ``csrc/layernorm_q8.cu`` at one row a warp at a time (the kernel) and
  two; with no instance walking its rows (the kernel's bf16 dynamic and
  ablation instances run a grid of the blocks the card holds at once, each
  warp walking its rows with the next row's x in flight, the others a
  block for every few rows); at four warps a walking block (the kernel:
  eight) and eight a block of rows (the kernel: four); with the scale
  and bias read from global memory where each vector needs them instead of
  staged once a block in shared memory, and with a division for every
  dynamic code (no multiply by the reciprocal first):
  ``ln_quant``'s ms on bf16 and fp32 rows, dynamic and static, and
  ``ln_quant_mode``'s ablations at the probe's rows (``Q8``).

Each case is timed by ``time_ms`` and queued behind a sleeping kernel
(device ms, and the host's us to issue a call); each variant's output is
held bit-equal to the kernel's (a variant changes where rows run, never a
row's arithmetic).  Each variant is the source with one constant replaced,
built by ``nvcc`` with the kernels' flags and called through the public
wrappers (``fused_block.layer_norm_bwd``, ``quant_block.ln_quant``,
``probe.ln_quant_mode``).  One JSON line a case, the card's name and power
limit first.

  python -m mudpt_torch.tools.ln_variants

It runs on the card only, and raises without CUDA.
"""

from __future__ import annotations

import json
import subprocess

from mudpt_torch.tools.f32_variants import build_variants, queued_ms, time_ms

# (source, variant name, text of the kernel, text of the variant)
VARIANTS = (
    ("layernorm_bwd", "bf16: two rows a warp",
     "constexpr int kBf16Rows = 1;", "constexpr int kBf16Rows = 2;"),
    ("layernorm_bwd", "bf16: two warps a block",
     "constexpr int kBf16Warps = 4;", "constexpr int kBf16Warps = 2;"),
    ("layernorm_bwd", "bf16: eight warps a block",
     "constexpr int kBf16Warps = 4;", "constexpr int kBf16Warps = 8;"),
    ("layernorm_q8", "two rows a warp",
     "constexpr int kQ8Rows = 1;", "constexpr int kQ8Rows = 2;"),
    ("layernorm_q8", "no walking grid",
     "constexpr bool kWalk = true;", "constexpr bool kWalk = false;"),
    ("layernorm_q8", "four warps a walking block",
     "constexpr int kWalkWarps = 8;", "constexpr int kWalkWarps = 4;"),
    ("layernorm_q8", "eight warps a block of rows",
     "constexpr int kBlockWarps = 4;", "constexpr int kBlockWarps = 8;"),
    ("layernorm_q8", "the scale and bias read from global memory",
     "constexpr bool kQ8Stage = true;", "constexpr bool kQ8Stage = false;"),
    ("layernorm_q8", "dynamic: a division a code",
     "constexpr bool kRecipFirst = true;", "constexpr bool kRecipFirst = false;"),
)
B16, L14, L336, H = 384 * 199, 384 * 259, 384 * 579, 128 * 259
TEXT = 13 * 128
# the bf16 LayerNorm dx: rows, D, dxn dtype, residual
LN = ((B16, 768, "float32", True), (B16, 768, "bfloat16", False),
      (TEXT, 512, "float32", True), (TEXT, 640, "float32", True),
      (TEXT, 768, "float32", True), (L14, 1024, "float32", True),
      (L14, 1024, "bfloat16", False), (L336, 1024, "float32", True),
      (H, 1280, "float32", True), (H, 2048, "float32", True))
# LayerNorm-quant: rows, D, x dtype, mode
Q8 = ((B16, 768, "bfloat16", "q8"), (B16, 768, "bfloat16", "q8_static"),
      (TEXT, 512, "bfloat16", "q8"), (TEXT, 768, "bfloat16", "q8"),
      (L14, 1024, "bfloat16", "q8"), (L14, 1024, "bfloat16", "q8_static"),
      (B16, 768, "float32", "q8"), (L14, 1024, "float32", "q8"),
      (128 * 200, 768, "bfloat16", "q8_recip"), (128 * 200, 768, "bfloat16", "q8_noclip"),
      (128 * 200, 768, "bfloat16", "q8_floor"))


def _same(a, b) -> bool:
    import torch

    a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


def run_cases(libs: dict, name: str, cases) -> None:
    """Each variant of source ``name`` in ``libs`` on each (case, call,
    library call or None) of ``cases``: ms, device ms, host us, bit-equal
    to the kernel."""
    from mudpt_torch.ops import _build

    kernels = dict(_build._libs)
    try:
        for case, fn, lib_fn in cases:
            ref = fn()
            for (source, variant), lib in libs.items():
                if source != name:
                    continue
                _build._libs[name] = lib
                device, host = queued_ms(fn)
                print(json.dumps({"case": case, "variant": variant, "bit_equal": _same(fn(), ref),
                                  "ms": time_ms(fn, 40), "device_ms": device, "host_us": host}),
                      flush=True)
            _build._libs.update(kernels)
            if lib_fn is not None:
                device, host = queued_ms(lib_fn)
                print(json.dumps({"case": case, "variant": "F.layer_norm backward",
                                  "ms": time_ms(lib_fn, 40), "device_ms": device,
                                  "host_us": host}), flush=True)
            del ref
    finally:
        _build._libs.update(kernels)


def ln_cases(g):
    import torch
    import torch.nn.functional as tf

    from mudpt_torch.ops import fused_block as F

    for rows, D, dxn_name, with_r in LN:
        x = torch.randn(rows, D, generator=g, device="cuda").bfloat16() * 2
        dxn = torch.randn(rows, D, generator=g, device="cuda").to(getattr(torch, dxn_name))
        r = torch.randn(rows, D, generator=g, device="cuda").bfloat16() if with_r else None
        s = torch.randn(D, generator=g, device="cuda") * 0.1 + 1
        xr = x.detach().requires_grad_(True)
        y = tf.layer_norm(xr, (D,), s.bfloat16(), s.bfloat16(), 1e-5)
        g16 = dxn.bfloat16()
        yield (f"layernorm_bwd {rows}x{D} {dxn_name} dxn{' + r' if with_r else ''}",
               lambda: F.layer_norm_bwd(dxn, x, s, r),
               lambda: torch.autograd.grad(y, xr, g16, retain_graph=True))
        del x, dxn, r, xr, y, g16


def q8_cases(g):
    import torch

    from mudpt_torch.ops import fused_block as F
    from mudpt_torch.ops import probe as P

    for rows, D, dtype, mode in Q8:
        x = (torch.randn(rows, D, generator=g, device="cuda") * 2).to(getattr(torch, dtype))
        s = torch.randn(D, generator=g, device="cuda") * 0.1 + 1
        b = torch.randn(D, generator=g, device="cuda") * 0.1
        r = 127.0 / F.layer_norm_plain(x, s, b).float().abs().amax() if mode == "q8_static" \
            else None
        yield (f"layernorm_q8 {rows}x{D} {dtype} {mode}",
               lambda: P.ln_quant_mode(x, s, b, mode, r), None)
        del x, s, b, r


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("ln_variants builds and times CUDA kernels: no card here")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card}), flush=True)
    libs = build_variants(VARIANTS, "ln")
    g = torch.Generator(device="cuda").manual_seed(23)
    run_cases(libs, "layernorm_bwd", ln_cases(g))
    run_cases(libs, "layernorm_q8", q8_cases(g))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
