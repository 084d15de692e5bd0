#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's MuDPT ViT-B/16 serving path on one GPU.

    python3 chip_smoke.py

Phases, each printed with the card's name and power limit:

  1. device   CUDA present; TF32 off for the plain versions.
  2. build    nvcc builds mudpt_torch/csrc/*.cu (parallel, one per source).
  3. kernels  every kernel of the path against its plain PyTorch version at
              the serving shapes, with the kernel's, the plain version's and
              one library call's time (the library call is a yardstick,
              never used by the port), and the bound from bytes and
              operations; then the whole layer chain against its plain
              version at D=768 and D=512.
  4. serving  build_synth_mudpt_server("ViT-B/16", 384, 100, 2, 9) on
              seeded random weights: encode the class text once, answer
              requests of 384 images, count kernel launches, check logits
              against the plain path on the card, report images/s.

The last three lines are one JSON object describing each kernel, the
card's name and power limit, and {"ok": true, "device": {...}}.  Times in
the kernel object are totals over one vision layer's launches at the
serving shapes (LayerNorm twice, the four projections, attention once);
"launches" counts the served path.  Any failed check raises, and the
script exits non-zero without a result; so it does without CUDA, and
outside a checkout of the repository.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12

# Kernel vs plain version: the same rounding points, but a different order
# of fp32 sums and hardware exp, rsqrt and division, so a bf16 rounding
# moves by one ulp only where the fp32 value lies next to a rounding
# boundary.  Each comparison is held to three limits:
MAX_ERR_OF_MAX = 2.0 ** -5  # max |err| <= 4 bf16 ulps of the largest value
NORM_ERR = 2.0 ** -8        # ||err|| <= the bf16 unit roundoff x ||ref||
# share of elements that are not bit-equal, one kernel alone: a rounding
# point moved or a different activation (erf GELU for QuickGELU) changes
# more than one element in sixteen (tests/test_torch_chip_checks.py),
# boundary cases about one in a thousand or fewer
DIFFER_SHARE = 2.0 ** -8
# the served path against the plain path on the card, 12 text or 12 vision
# layers deep, where one-ulp flips propagate
TEXT_MAX_ERR, TEXT_NORM_ERR = 2.0 ** -4, 2.0 ** -5      # text features
LOGITS_MAX_ERR, LOGITS_NORM_ERR = 2.0 ** -3, 2.0 ** -3  # logits, rows centred

BATCH, N_CLS, N_CTX, DEPTH = 384, 100, 2, 9
REQUESTS = 20


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg} | {smi()}", flush=True)


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


def bound(bytes_moved: float, bf16_ops: float, fp32_ops: float = 0.0):
    """(ms, 'bytes' | 'operations'): the least time for the work."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = bf16_ops / PEAK_BF16_FLOPS + fp32_ops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


class Kernel:
    """Totals of one kernel over the launches of one vision layer."""

    def __init__(self, name: str):
        self.name = name
        self.ms = self.plain_ms = self.bound_ms = self.library_ms = 0.0
        self.t_bytes = self.t_ops = 0.0
        self.max_abs_err = 0.0

    def add(self, ms, plain_ms, library_ms, bound_ms, by):
        self.ms += ms
        self.plain_ms += plain_ms
        self.library_ms += library_ms
        self.bound_ms += bound_ms
        if by == "bytes":
            self.t_bytes += bound_ms
        else:
            self.t_ops += bound_ms

    def record(self, launches: int) -> dict:
        return {
            "name": self.name, "route": "cuda",
            "source": f"mudpt_torch/csrc/{self.name}.cu",
            "replaces": "mudpt_tpu/ops/fused_block.py:851",
            "launches": launches, "max_abs_err": self.max_abs_err,
            "ms": self.ms, "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
            "bound_by": "bytes" if self.t_bytes >= self.t_ops else "operations",
            "library_ms": self.library_ms,
        }


def check_close(what: str, got, ref, kernel: Kernel = None, max_limit=MAX_ERR_OF_MAX,
                norm_limit=NORM_ERR, share_limit=DIFFER_SHARE) -> str:
    """Hold ``got`` to ``ref``: max abs error within ``max_limit`` of the
    largest value, relative norm error within ``norm_limit``, and at most
    ``share_limit`` of the elements not bit-equal (None: not held).
    Returns the readings as text."""
    import torch

    if got.is_cuda:
        torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs {tuple(ref.shape)} or non-finite")
    diff = got.float() - ref.float()
    err = diff.abs().max().item()
    norm = (diff.norm() / ref.float().norm()).item()
    share = (got != ref).float().mean().item()
    largest = ref.float().abs().max().item()
    reading = f"err {err:.3g} of max {largest:.3g} norm {norm:.3g} differ {share:.3g}"
    if not err <= max_limit * largest:
        raise AssertionError(f"{what}: {reading}: max abs err over {max_limit} of the largest value")
    if not norm <= norm_limit:
        raise AssertionError(f"{what}: {reading}: relative norm error over {norm_limit}")
    if share_limit is not None and not share <= share_limit:
        raise AssertionError(f"{what}: {reading}: share of differing elements over {share_limit}")
    if kernel is not None:
        kernel.max_abs_err = max(kernel.max_abs_err, err)
    return reading


def phase_kernels(F, kernels: dict) -> None:
    import torch
    import torch.nn.functional as tf

    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

    def rn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    M = BATCH * 199  # vision tokens per request (197 + n_ctx)

    # ---- LayerNorm: vision (2 per layer) and packed text rows
    for rows, D, per_layer in ((M, 768, 2), (13 * 128, 512, 0)):
        x = rn(rows, D, std=2.0)
        s = rn(D, dtype=torch.float32) * 0.1 + 1
        b = rn(D, dtype=torch.float32) * 0.1
        reading = check_close(f"layernorm {rows}x{D}", F.layer_norm_fwd(x, s, b),
                              F.layer_norm_plain(x, s, b), kernels["layernorm_fwd"])
        ms = time_ms(lambda: F.layer_norm_fwd(x, s, b))
        plain = time_ms(lambda: F.layer_norm_plain(x, s, b))
        s16, b16 = s.bfloat16(), b.bfloat16()
        lib = time_ms(lambda: tf.layer_norm(x, (D,), s16, b16, 1e-5))
        bms, by = bound(2 * rows * D * 2 + 2 * D * 4, 0, 8 * rows * D)
        say("kernels", f"layernorm_fwd {rows}x{D}: {reading} ms {ms:.4f} plain {plain:.4f} "
                       f"library(F.layer_norm) {lib:.4f} bound {bms:.4f} ({by})")
        for _ in range(per_layer):
            kernels["layernorm_fwd"].add(ms, plain, lib, bms, by)

    # ---- GEMM with each epilogue at the vision shapes (one of each per layer)
    for K, N, ep in ((768, 2304, "qkv"), (768, 768, "residual"), (768, 3072, "fc_gelu"),
                     (3072, 768, "residual")):
        a = rn(M, K)
        w = rn(K, N, std=K ** -0.5)
        bias = rn(N, std=0.1)
        r = rn(M, N) if ep == "residual" else None
        reading = check_close(f"gemm {K}->{N} {ep}", F.gemm_epilogue(a, w, bias, ep, r),
                              F.gemm_epilogue_plain(a, w, bias, ep, r),
                              kernels["gemm_bf16_epilogue"])
        ms = time_ms(lambda: F.gemm_epilogue(a, w, bias, ep, r))
        plain = time_ms(lambda: F.gemm_epilogue_plain(a, w, bias, ep, r), 3)
        lib = time_ms(lambda: torch.addmm(bias, a, w))
        nbytes = (M * K + K * N + N + M * N * (2 if r is not None else 1)) * 2
        bms, by = bound(nbytes, 2 * M * N * K)
        say("kernels", f"gemm_bf16_epilogue {ep} {M}x{K}->{N}: {reading} ms {ms:.4f} "
                       f"({2 * M * N * K / ms / 1e9:.1f} TFLOP/s) plain {plain:.4f} "
                       f"library(torch.addmm) {lib:.4f} bound {bms:.4f} ({by})")
        kernels["gemm_bf16_epilogue"].add(ms, plain, lib, bms, by)

    # ---- attention: vision (1 per layer), text causal, packed text rows
    cases = (("vision", 384, 199, 12, False, True),
             ("text causal", 100, 16, 8, True, False),
             ("text packed (16,16)", 13, 128, 8, (16, 16), False),
             ("text packed (16,11)", 13, 128, 8, (16, 11), False))
    for label, B, S, H, causal, per_layer in cases:
        D = 64 * H
        qkv = rn(B, S, 3 * D)
        reading = check_close(f"attention {label}", F.attention_fwd(qkv, H, causal),
                              F.attention_plain(qkv, H, causal), kernels["attention_fwd"])
        ms = time_ms(lambda: F.attention_fwd(qkv, H, causal))
        plain = time_ms(lambda: F.attention_plain(qkv, H, causal), 3)
        L, is_causal, valid = F._block_spec(S, causal)
        n = B * (S // L)
        q, k, v = qkv.view(n, L, 3, H, 64).permute(2, 0, 3, 1, 4)
        if isinstance(causal, tuple):
            i = torch.arange(L, device=dev)
            allowed = (i[None, :] <= i[:, None]) & (i[None, :] < valid)
            lib = time_ms(lambda: tf.scaled_dot_product_attention(q, k, v, attn_mask=allowed))
        else:
            lib = time_ms(lambda: tf.scaled_dot_product_attention(q, k, v, is_causal=is_causal))
        pairs = sum(min(r + 1, valid) if is_causal else valid for r in range(L))
        bms, by = bound(4 * B * S * D * 2, 4 * 64 * pairs * n * H, 5 * pairs * n * H)
        say("kernels", f"attention_fwd {label} B={B} S={S} H={H}: {reading} ms {ms:.4f} "
                       f"plain {plain:.4f} library(sdpa) {lib:.4f} bound {bms:.4f} ({by})")
        if per_layer:
            kernels["attention_fwd"].add(ms, plain, lib, bms, by)

    # ---- the whole layer, kernel chain against the plain chain
    for D, B, S, H, causal in ((768, 384, 199, 12, False), (512, 13, 128, 8, (16, 16))):
        x = rn(B, S, D)
        ps = [rn(D, dtype=torch.float32) * 0.1 + 1, rn(D, dtype=torch.float32) * 0.1,
              rn(D, 3 * D, std=D ** -0.5), rn(3 * D, std=0.1), rn(D, D, std=D ** -0.5),
              rn(D, std=0.1), rn(D, dtype=torch.float32) * 0.1 + 1,
              rn(D, dtype=torch.float32) * 0.1, rn(D, 4 * D, std=D ** -0.5),
              rn(4 * D, std=0.1), rn(4 * D, D, std=(4 * D) ** -0.5), rn(D, std=0.1)]
        # a one-ulp flip early in the chain moves later roundings: the
        # share of differing elements is printed, not held
        reading = check_close(f"layer_fullblock D={D}", F.layer_fullblock(x, *ps, H, causal),
                              F.layer_fullblock_plain(x, *ps, H, causal), share_limit=None)
        ms = time_ms(lambda: F.layer_fullblock(x, *ps, H, causal))
        plain = time_ms(lambda: F.layer_fullblock_plain(x, *ps, H, causal), 3)
        say("kernels", f"layer_fullblock D={D} B={B} S={S} mask={causal}: {reading} "
                       f"ms {ms:.4f} plain {plain:.4f}")


def phase_serving(F) -> dict:
    import torch

    from mudpt_torch.models.layers import plain_blocks
    from mudpt_torch.utils.synth_step import build_synth_mudpt_server

    t0 = time.perf_counter()
    st = build_synth_mudpt_server("ViT-B/16", BATCH, N_CLS, N_CTX, DEPTH, seed=0)
    torch.cuda.synchronize()
    say("serving", f"built ViT-B/16 server (random weights, seed 0) in "
                   f"{time.perf_counter() - t0:.2f} s; text rows {tuple(st.aux['token_suffix'].shape)}")
    tr, params, aux, images = st.trainable, st.params, st.aux, st.images
    layers = st.clip_cfg.vision_layers

    # ---- the main path, counted: text encode once, then requests
    F.reset_launches()
    t0 = time.perf_counter()
    txt = st.text_features(tr, params, aux)
    torch.cuda.synchronize()
    t_text = time.perf_counter() - t0
    text_counts = dict(F.LAUNCHES)
    preds = st.eval_step_cached(tr, params, aux, images, txt)  # warm-up request
    torch.cuda.synchronize()
    lat = []
    t_all = time.perf_counter()
    for _ in range(REQUESTS):
        t0 = time.perf_counter()
        preds = st.eval_step_cached(tr, params, aux, images, txt)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    t_all = time.perf_counter() - t_all
    counts = dict(F.LAUNCHES)

    n_req = REQUESTS + 1
    per_layer = {"layernorm_fwd": 2, "gemm_bf16_epilogue": 4, "attention_fwd": 1,
                 "layer_fullblock": 1}
    tl = st.clip_cfg.transformer_layers
    # plus the towers' own LayerNorms: ln_final once; ln_pre, ln_post per request
    want_text = {k: c * tl + (k == "layernorm_fwd") for k, c in per_layer.items()}
    if text_counts != want_text:
        raise AssertionError(f"text encode launches {text_counts} != {want_text}")
    want = {k: want_text[k] + n_req * (c * layers + 2 * (k == "layernorm_fwd"))
            for k, c in per_layer.items()}
    if counts != want:
        raise AssertionError(f"main-path launches {counts} != {want}")
    say("serving", f"launches: text encode {text_counts}; text + {n_req} requests {counts}")

    ips = BATCH * REQUESTS / t_all
    say("serving", f"text encode {t_text * 1e3:.1f} ms (once, {N_CLS} classes); "
                   f"{REQUESTS} requests of {BATCH} images: median {statistics.median(lat) * 1e3:.2f} ms, "
                   f"max {max(lat) * 1e3:.2f} ms; cached-text throughput {ips:.1f} images/s")

    # ---- where one request's device time goes (a separate, traced request)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st.eval_step_cached(tr, params, aux, images, txt)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel = {"gemm_bf16_kernel": 0.0, "attention_fwd_kernel": 0.0,
                 "layernorm_fwd_kernel": 0.0, "other": 0.0}
    others = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops also report their kernels' time
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        key = next((k for k in by_kernel if k in e.key), "other")
        by_kernel[key] += us
        if key == "other" and us > 0:
            others[e.key[:60]] = us
    busy = sum(by_kernel.values())
    if busy > 0:
        share = ", ".join(f"{k} {v / 1e3:.2f} ms ({v / busy:.1%})" for k, v in by_kernel.items())
        say("serving", f"traced request: device busy {busy / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms "
                       f"wall ({1 - busy / wall_us:.1%} idle); {share}")
        top = sorted(others.items(), key=lambda kv: -kv[1])[:6]
        say("serving", "largest other device time: " +
            "; ".join(f"{k} {v / 1e3:.3f} ms" for k, v in top))
    else:
        say("serving", "traced request: the profiler recorded no device time (not measured)")

    # ---- outputs: shape, finiteness, agreement with the plain path on the card
    logits = st.image_logits(tr, params, aux, images, txt)
    with plain_blocks():
        txt_ref = st.text_features(tr, params, aux)
        logits_ref = st.image_logits(tr, params, aux, images, txt_ref)
    torch.cuda.synchronize()
    if txt.shape != (N_CLS, st.clip_cfg.embed_dim) or logits.shape != (BATCH, N_CLS):
        raise AssertionError(f"shapes: text {tuple(txt.shape)}, logits {tuple(logits.shape)}")
    if preds.shape != (BATCH,) or preds.dtype != torch.int32 or not torch.isfinite(logits).all():
        raise AssertionError("predictions or logits malformed")
    if not torch.equal(preds, logits.argmax(-1).to(torch.int32)):
        raise AssertionError("eval_step_cached disagrees with argmax of image_logits")
    # kernels and plain chain round at the same points, but over 12 bf16
    # layers a one-ulp flip grows like any bf16 drift
    t_read = check_close("text features", txt, txt_ref, max_limit=TEXT_MAX_ERR,
                         norm_limit=TEXT_NORM_ERR, share_limit=None)
    # random weights leave the logits of a row close together: the error is
    # held against their spread around the row's mean, not their size
    centred, centred_ref = (t - t.mean(-1, keepdim=True) for t in (logits, logits_ref))
    l_read = check_close("logits, rows centred", centred, centred_ref, max_limit=LOGITS_MAX_ERR,
                         norm_limit=LOGITS_NORM_ERR, share_limit=None)
    drift = (logits - logits_ref).abs().max().item()
    scale = logits_ref.abs().max().item()
    top = logits_ref.topk(2, dim=-1).values
    decisive = (top[:, 0] - top[:, 1]) > 2 * drift
    agree = (logits.argmax(-1) == logits_ref.argmax(-1))
    say("serving", f"vs plain path on the card: text features {t_read}; logits, rows centred "
                   f"{l_read}; logits max abs err {drift:.4g} of max {scale:.4g}; top-1 agreement "
                   f"{agree.float().mean().item():.4f}; {int(decisive.sum())} decisive rows, "
                   f"{int(agree[decisive].sum())} equal")
    # and the bound of tests/test_precision_drift.py: 5% of the largest
    # magnitude, every top-1 whose margin exceeds the drift equal, 75% agreement
    if drift > 0.05 * scale or not agree[decisive].all() or agree.float().mean() < 0.75:
        raise AssertionError(f"logits vs plain path: drift {drift} (scale {scale}), "
                             f"agreement {agree.float().mean().item()}")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "mudpt_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no mudpt_torch package beside {__file__}", file=sys.stderr)
        return 3
    sys.path.insert(0, str(root))
    from mudpt_torch.ops import _build
    from mudpt_torch.ops import fused_block as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    say("device", f"{kind}; torch {torch.__version__} CUDA {torch.version.cuda}; "
                  f"{torch.cuda.device_count()} device(s)")

    _build.load()
    regs = {name: [ln.strip() for ln in log.splitlines() if "registers" in ln]
            for name, log in _build.build_logs.items()}
    say("build", f"{len(_build.SIGNATURES)} kernel sources built in "
                 f"{_build.build_seconds:.2f} s; ptxas: {json.dumps(regs)}")

    kernels = {name: Kernel(name) for name in _build.SIGNATURES}
    phase_kernels(F, kernels)
    counts = phase_serving(F)

    print(json.dumps({"kernels": [k.record(counts[k.name]) for k in kernels.values()]}))
    print(smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
