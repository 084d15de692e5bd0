"""What design choices of the fp32 kernels are worth, read on the card by
building variants of their sources beside the kernels:

- ``csrc/gemm_f32_epilogue.cu`` with the wgmma partial sums added into the
  register fp32 sum every 4 K slices of 32 (the kernel), every 8, and never
  (one wgmma accumulator over the whole K): the relative norm error of the
  ``store_f32`` product against fp64 and against the plain fp32 product
  (TF32 off), at K = 768, 2304, 3072 (the modes' K) and 6144, M = 76,416,
  N = 768, and its ms;
- ``csrc/attention_f32.cu``'s query-major backward kernel with one or two
  warpgroups a block at every block length (the launcher takes one for a
  block of one tile, else two), and its forward kernel likewise:
  ``attention_fwd_f32``'s and
  ``attention_bwd_f32``'s ms at ViT-B/16's vision and text blocks, and
  their relative norm error from the plain version;
- ``csrc/layernorm_bwd.cu``'s fp32 kernel at one row a warp (the kernel)
  and two: ``layernorm_bwd``'s ms (with a residual and without) at ViT-B/16's
  vision rows (76,416 x 768) and text rows (1,664 x 512), the halves' rows
  at D = 1024 (8,288) and the chunked half's at 1280 (1,576), by
  ``time_ms`` and queued behind a sleeping kernel (device ms, and the
  host's us to issue a call), beside ``F.layer_norm``'s backward, and their
  relative norm error from the plain version.

Each variant is the source with one constant or condition replaced, built
by ``nvcc`` with the kernels' flags and called through the public wrappers
(``fused_block.gemm_epilogue``, ``attention_fwd``, ``attention_bwd``,
``layer_norm_bwd``).  One JSON line a case, the card's name and power
limit first.

  python -m mudpt_torch.tools.f32_variants

It runs on the card only, and raises without CUDA.
"""

from __future__ import annotations

import json
import subprocess

# (source, variant name, text of the kernel, text of the variant)
VARIANTS = (
    ("gemm_f32_epilogue", "promote every 8 slices",
     "constexpr int K_PROMOTE = 4;", "constexpr int K_PROMOTE = 8;"),
    ("gemm_f32_epilogue", "never promote",
     "constexpr int K_PROMOTE = 4;", "constexpr int K_PROMOTE = 1 << 30;"),
    ("attention_f32", "one warpgroup a query block",
     "n_t == 1 ? launch_query<1>", "true ? launch_query<1>"),
    ("attention_f32", "two warpgroups a query block",
     "n_t == 1 ? launch_query<1>", "false ? launch_query<1>"),
    ("attention_f32", "forward: one warpgroup a query block",
     "n_t == 1 ? launch_fwd<1", "true ? launch_fwd<1"),
    ("attention_f32", "forward: two warpgroups a query block",
     "n_t == 1 ? launch_fwd<1", "false ? launch_fwd<1"),
    ("layernorm_bwd", "two rows a warp",
     "constexpr int kRegRows = 1;", "constexpr int kRegRows = 2;"),
)
GEMM_K = (768, 2304, 3072, 6144)
GEMM_M, GEMM_N = 384 * 199, 768
ATTN = (("vision", 384, 199, 12, False), ("text causal", 100, 16, 8, True),
        ("text packed (16,16)", 13, 128, 8, (16, 16)))
# ViT-B/16's vision and text rows; the halves' at D = 1024, the chunked half's at 1280
LN = ((384 * 199, 768), (13 * 128, 512), (32 * 259, 1024), (8 * 197, 1280))


def build_variants(variants: tuple = VARIANTS, tag: str = "f32") -> dict:
    """{(source, variant): the bound library}, the sources' own under
    variant "kernel"; every variant of ``variants`` built in parallel, its
    files named by ``tag``."""
    from mudpt_torch.ops import _build

    libs = _build.load()
    out = {(name, "kernel"): libs[name] for name in {v[0] for v in variants}}
    vdir = _build.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, label, old, new) in enumerate(variants):
        text = (_build.CSRC / f"{name}.cu").read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}.cu: {old!r} is not in the source once")
        src, lib = vdir / f"{name}_{tag}{i}.cu", vdir / f"lib{name}_{tag}{i}.so"
        src.write_text(text.replace(old, new))
        procs[(name, label)] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {key} failed to build:\n{log}")
        out[key] = _build._bind(key[0], lib)
    return out


def time_ms(fn, iters: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel(got, ref) -> float:
    """Relative norm error of ``got`` from ``ref``, in fp64."""
    return ((got.double() - ref.double()).norm() / ref.double().norm()).item()


SLEEP_CYCLES = 60_000_000  # ~30 ms of the card's clock: the queue's head start


def queued_ms(fn, iters: int = 10) -> tuple:
    """(device ms, host us) a call of ``fn``, the calls issued while the card
    sleeps, so that it runs them back to back whatever the host's pace."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_us = (time.perf_counter() - t0) * 1e6 / iters
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_us


def time_layernorms(libs: dict, g) -> None:
    """Each layernorm_bwd variant of ``libs`` and F.layer_norm's backward at
    the rows of ``LN``: dx with a residual and without."""
    import torch
    import torch.nn.functional as tf

    from mudpt_torch.ops import _build
    from mudpt_torch.ops import fused_block as F

    kernels = dict(_build._libs)
    for rows, D in LN:
        x = torch.randn(rows, D, generator=g, device="cuda") * 2
        dxn, r = (torch.randn(rows, D, generator=g, device="cuda") for _ in range(2))
        s = torch.randn(D, generator=g, device="cuda") * 0.1 + 1
        xr = x.detach().requires_grad_(True)
        y = tf.layer_norm(xr, (D,), s, s, 1e-5)
        try:
            for what, res in (("dx + r", r), ("dx", None)):
                case = f"layernorm_bwd {what} {rows}x{D}"
                fn = lambda: F.layer_norm_bwd(dxn, x, s, res)  # noqa: E731
                plain = F.layer_norm_bwd_plain(dxn, x, s, res)
                for (name, variant), lib in libs.items():
                    if name != "layernorm_bwd":
                        continue
                    _build._libs[name] = lib
                    device, host = queued_ms(fn)
                    print(json.dumps({"case": case, "variant": variant,
                                      "norm_vs_plain": rel(fn(), plain), "ms": time_ms(fn),
                                      "device_ms": device, "host_us": host}), flush=True)
                _build._libs.update(kernels)
                del plain
            lib_fn = lambda: torch.autograd.grad(y, xr, dxn, retain_graph=True)  # noqa: E731
            device, host = queued_ms(lib_fn)
            print(json.dumps({"case": f"layernorm_bwd dx {rows}x{D}", "variant": "F.layer_norm",
                              "ms": time_ms(lib_fn), "device_ms": device, "host_us": host}),
                  flush=True)
        finally:
            _build._libs.update(kernels)
        del x, dxn, r, xr, y


def main() -> int:
    import torch

    from mudpt_torch.ops import _build
    from mudpt_torch.ops import fused_block as F

    if not torch.cuda.is_available():
        raise RuntimeError("f32_variants builds and times CUDA kernels: no card here")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card}), flush=True)
    libs = build_variants()
    kernels = dict(_build._libs)
    g = torch.Generator(device="cuda").manual_seed(17)
    try:
        time_layernorms(libs, g)
        for k in GEMM_K:
            a = torch.randn(GEMM_M, k, generator=g, device="cuda")
            w = torch.randn(GEMM_N, k, generator=g, device="cuda") * k ** -0.5
            plain = F.gemm_epilogue_plain(a, w, None, "store_f32")
            exact = a.double() @ w.double().t()
            print(json.dumps({"case": f"store_f32 {GEMM_M}x{k}->{GEMM_N}", "variant": "plain",
                              "norm_vs_fp64": rel(plain, exact)}), flush=True)
            for (name, label), lib in libs.items():
                if name != "gemm_f32_epilogue":
                    continue
                _build._libs[name] = lib
                got = F.gemm_epilogue(a, w, None, "store_f32")
                print(json.dumps({
                    "case": f"store_f32 {GEMM_M}x{k}->{GEMM_N}", "variant": label,
                    "norm_vs_fp64": rel(got, exact), "norm_vs_plain": rel(got, plain),
                    "ms": time_ms(lambda: F.gemm_epilogue(a, w, None, "store_f32"))}),
                    flush=True)
            _build._libs.update(kernels)
            del a, w, plain, exact
        for label, B, S, H, causal in ATTN:
            qkv = torch.randn(B, S, 3 * 64 * H, generator=g, device="cuda")
            do = torch.randn(B, S, 64 * H, generator=g, device="cuda") * 0.1
            for entry, fn, plain_fn in (
                    ("attention_fwd_f32", lambda: F.attention_fwd(qkv, H, causal),
                     lambda: F.attention_plain(qkv, H, causal)),
                    ("attention_bwd_f32", lambda: F.attention_bwd(qkv, do, H, causal),
                     lambda: F.attention_bwd_plain(qkv, do, H, causal))):
                plain = plain_fn()
                for (name, variant), lib in libs.items():
                    if name != "attention_f32":
                        continue
                    _build._libs[name] = lib
                    print(json.dumps({
                        "case": f"{entry} {label} {B}x{S} H={H}", "variant": variant,
                        "norm_vs_plain": rel(fn(), plain), "ms": time_ms(fn)}), flush=True)
                _build._libs.update(kernels)
                del plain
            del qkv, do
    finally:
        _build._libs.update(kernels)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
