#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's MuDPT serving paths and train steps on one
GPU: ViT-B/16 and ViT-L/14.

    python3 chip_smoke.py

Phases, each printed with the card's name and power limit:

  1. device   CUDA present; TF32 off for the plain versions.
  2. build    nvcc builds mudpt_torch/csrc/*.cu (parallel, one per source).
  3. kernels  every kernel against its plain PyTorch version at the shapes
              of the ViT-B/16 serving path and train step, with the
              kernel's, the plain version's and one library call's time (the
              library call is a yardstick, never used by the port), and the
              bound from bytes and operations; then the whole layer against
              its plain version at D=768 and D=512, forward alone and
              forward with backward.
  4. serving  build_synth_mudpt_server("ViT-B/16", 384, 100, 2, 9) on
              seeded random weights: encode the class text once, answer
              requests of 384 images, count kernel launches, check logits
              against the plain path on the card, report images/s.
  5. train    build_synth_mudpt_step("ViT-B/16", 384, 100, 2, 9): one step's
              loss and gradients of the ten trainable leaves against the
              plain path on the card, warm-up and timed steps (launches
              counted per step, losses finite), images/s, and a traced step.
  6. kernels ViT-L/14   the same at the ViT-L/14 shapes (vision 1024 wide,
              259 tokens, 16 heads; text 768 wide, 12 heads), the two
              recompute epilogues, attention_bwd at its longest block, and
              the four half-block chains, forward alone and forward with
              backward, qkv and h saved and recomputed.
  7. serving ViT-L/14   as 4, for build_synth_mudpt_server("ViT-L/14", ...).
  8. train ViT-L/14     gradients against the plain path and an fp32 plain
              step at batch 32, twice: the vision MLP recomputing h, then
              2,560 classes, whose text tower trains with saves off; then
              timed steps at batch 384 (the vision MLP recomputes h there),
              launches per step, peak device memory and a traced step.

The last three lines are one JSON object describing each kernel, the
card's name and power limit, and {"ok": true, "device": {...}}.  Times in
the kernel object are totals over one vision layer's launches in the
ViT-B/16 train step (LayerNorm twice, the eight projections, attention once,
each way), and under "vit_l14" in the ViT-L/14 train step (LayerNorm three
times, nine projections); "launches" counts the ViT-B/16 train step's timed
run, "launches_by_path" each path's.  Any failed check raises, and the
script exits non-zero without a result; so it does without CUDA, and
outside a checkout of the repository.
"""

from __future__ import annotations

import json
import math
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
# point moved or a different activation (erf GELU for QuickGELU; in the
# backward, ds from bf16(p), QuickGELU' of the unrounded h, a rounding
# before the residual) changes more than one element in sixteen
# (tests/test_torch_chip_checks.py), boundary cases about one in a thousand
# or fewer
DIFFER_SHARE = 2.0 ** -8
# the served path against the plain path on the card, 12 text or 12 vision
# layers deep, where one-ulp flips propagate
TEXT_MAX_ERR, TEXT_NORM_ERR = 2.0 ** -4, 2.0 ** -5      # text features
LOGITS_MAX_ERR, LOGITS_NORM_ERR = 2.0 ** -3, 2.0 ** -3  # logits, rows centred

# fp32 outputs (the GEMM's store_f32): the sum order alone moves the last
# bits of nearly every element, so no bit-equal share is held; the error is
# that of fp32 sums of K bf16 products
F32_MAX_ERR, F32_NORM_ERR = 2.0 ** -15, 2.0 ** -16
# the layer's dx against the plain chain: seven kernels deep, where one-ulp
# flips of bf16 intermediates propagate (limits under PERF.md Findings)
LAYER_DX_MAX_ERR, LAYER_DX_NORM_ERR = 2.0 ** -5, 2.0 ** -7
# one train step's gradients of the trainable leaves against the plain path
# on the card, both towers deep (relative norm error per leaf) and the loss.
# The gradient limit holds at 12 layers (ViT-B/16's towers); bf16 rounding
# adds up over the layers like a random walk, so a deeper tower's limit
# grows with the square root of its depth: ViT-L/14's 24 vision layers,
# 2^-4 x sqrt(2) (readings under PERF.md Findings, tools/torch_grad_noise.py)
GRAD_NORM_ERR, LOSS_REL_ERR = 2.0 ** -4, 2.0 ** -12
GRAD_DEPTH = 12
# and the kernels' gradients no further from the fp32 ones than this times
# the plain bf16 path's
GRAD_FP32_RATIO = 1.5

BATCH, N_CLS, N_CTX, DEPTH = 384, 100, 2, 9
REQUESTS = 20
WARMUP_STEPS, TIMED_STEPS = 3, 10
# ViT-L/14 gradient checks: an fp32 plain step at batch 384 would not fit
# the card; 2,560 classes x 16 tokens = 40,960 text row-tokens, where the
# text tower trains with saves off (models/text._text_saves_off)
GRAD_BATCH, SAVES_OFF_N_CLS = 32, 2560

TPU = "mudpt_tpu/ops/fused_block.py"
FWD = f"{TPU}:851 _layer_fwd_nosave_kernel, :831 _layer_fwd_kernel"
BWD = f"{TPU}:868 _layer_bwd_kernel"
ATTN_FWD = ":318 _attn_fwd_kernel, :326 _attn_fwd_save_kernel"
MLP_FWD = ":403 _mlp_fwd_kernel, :415 _mlp_fwd_save_kernel"
ATTN_BWD = ":369 _attn_bwd_save_kernel, :358 _attn_bwd_kernel"
MLP_BWD = ":451 _mlp_bwd_save_kernel, :444 _mlp_bwd_kernel"
REPLACES = {
    "layernorm_fwd": f"{FWD}, {ATTN_FWD}, {MLP_FWD}, :358 _attn_bwd_kernel, "
                     ":444 _mlp_bwd_kernel",
    "gemm_bf16_epilogue": f"{FWD}, :868 _layer_bwd_kernel, {ATTN_FWD}, {MLP_FWD}, "
                          f"{ATTN_BWD}, {MLP_BWD}",
    "attention_fwd": f"{FWD}, {ATTN_FWD}",
    "layernorm_bwd": f"{BWD}, {ATTN_BWD}, {MLP_BWD}",
    "attention_bwd": f"{BWD}, {ATTN_BWD}",
}

# kernel launches of one layer on each route of models/layers.residual_block
# (the half-block routes count the Functions of both halves)
_HALVES = dict(attn_halfblock=1, mlp_halfblock=1)
_HALVES_TRAIN = dict(_HALVES, attn_halfblock_bwd=1, mlp_halfblock_bwd=1,
                     attention_fwd=1, attention_bwd=1, layernorm_bwd=2)
ROUTES = {
    # no gradient: the no-save forwards
    "full": dict(layernorm_fwd=2, gemm_bf16_epilogue=4, attention_fwd=1, layer_fullblock=1),
    "half": dict(_HALVES, layernorm_fwd=2, gemm_bf16_epilogue=4, attention_fwd=1),
    # training, forward and backward: the whole layer (saves on, D <= 768);
    # the halves with qkv and h saved; with h recomputed (LN2 and the fc
    # product again); with saves off (LN1 and the qkv product again too)
    "full_train": dict(layernorm_fwd=2, gemm_bf16_epilogue=8, attention_fwd=1,
                       layernorm_bwd=2, attention_bwd=1, layer_fullblock=1,
                       layer_fullblock_bwd=1),
    "half_train": dict(_HALVES_TRAIN, layernorm_fwd=2, gemm_bf16_epilogue=8),
    "half_train_recompute_h": dict(_HALVES_TRAIN, layernorm_fwd=3, gemm_bf16_epilogue=9),
    "half_train_saves_off": dict(_HALVES_TRAIN, layernorm_fwd=4, gemm_bf16_epilogue=10),
}


def expect(keys, *parts) -> dict:
    """Launches of a path: the sum of (count, route or dict) parts, over
    every key of the launch counter."""
    out = dict.fromkeys(keys, 0)
    for n, route in parts:
        for k, v in (ROUTES[route] if isinstance(route, str) else route).items():
            out[k] += n * v
    return out


def tower_lns(fwd: int, bwd: int = 0) -> dict:
    """The towers' own LayerNorms (ln_pre, ln_post, ln_final)."""
    return dict(layernorm_fwd=fwd, layernorm_bwd=bwd)


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
    """Totals of one kernel over the launches of one vision layer of the
    train step (forward and backward)."""

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

    def times(self) -> dict:
        return {"ms": self.ms, "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
                "bound_by": "bytes" if self.t_bytes >= self.t_ops else "operations",
                "library_ms": self.library_ms}

    def record(self, launches: dict, vit_l: "Kernel") -> dict:
        return {
            "name": self.name, "route": "cuda",
            "source": f"mudpt_torch/csrc/{self.name}.cu",
            "replaces": REPLACES[self.name],
            "launches": launches["train_step"], "launches_by_path": launches,
            "max_abs_err": max(self.max_abs_err, vit_l.max_abs_err),
            **self.times(), "vit_l14": vit_l.times(),
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


# the kernels' shapes on each model's paths; the last field of a case: its
# launches in one vision layer of the train step
M_B, M_L = BATCH * 199, BATCH * 259  # vision tokens per batch: 197 or 257 + n_ctx
SHAPES = {
    "ViT-B/16": dict(
        tag="kernels",
        ln=((M_B, 768, 2), (13 * 128, 512, 0)),
        gemm=(("qkv", M_B, 768, 2304, 1), ("residual", M_B, 768, 768, 1),
              ("fc_gelu", M_B, 768, 3072, 0), ("fc_gelu_save", M_B, 768, 3072, 1),
              ("residual", M_B, 3072, 768, 1), ("gelu_bwd", M_B, 768, 3072, 1),
              ("store_f32", M_B, 3072, 768, 1), ("store_bf16", M_B, 768, 768, 1),
              ("store_f32", M_B, 2304, 768, 1)),
        ln_bwd=((M_B, 768, "float32", True, 2), (13 * 128, 512, "float32", True, 0),
                (M_B, 768, "bfloat16", False, 0)),
        attn=(("vision", 384, 199, 12, False, True), ("text causal", 100, 16, 8, True, False),
              ("text packed (16,16)", 13, 128, 8, (16, 16), False),
              ("text packed (16,11)", 13, 128, 8, (16, 11), False)),
    ),
    # the train step at batch 384 recomputes the vision MLP's h: LN2 and the
    # fc product run again in the backward, which stores QuickGELU'(h32)
    # (fc_gelu_grad) for the g.proj_w^T product to apply (mul_f32)
    "ViT-L/14": dict(
        tag="kernels ViT-L/14",
        ln=((M_L, 1024, 3), (13 * 128, 768, 0)),
        gemm=(("qkv", M_L, 1024, 3072, 1), ("residual", M_L, 1024, 1024, 1),
              ("fc_gelu", M_L, 1024, 4096, 1), ("fc_gelu_save", M_L, 1024, 4096, 0),
              ("residual", M_L, 4096, 1024, 1), ("fc_gelu_grad", M_L, 1024, 4096, 1),
              ("mul_f32", M_L, 1024, 4096, 1), ("gelu_bwd", M_L, 1024, 4096, 0),
              ("store_f32", M_L, 4096, 1024, 1), ("store_bf16", M_L, 1024, 1024, 1),
              ("store_f32", M_L, 3072, 1024, 1)),
        ln_bwd=((M_L, 1024, "float32", True, 2), (13 * 128, 768, "float32", True, 0),
                (M_L, 1024, "bfloat16", False, 0)),
        attn=(("vision", 384, 259, 16, False, True),
              ("text packed (16,16)", 13, 128, 12, (16, 16), False),
              ("longest block", 8, 384, 16, False, False)),
    ),
}


def randn_fn(seed: int):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(dtype)
    return rn


def phase_kernels(F, kernels: dict, model: str):
    """Every kernel at the model's shapes; returns the seeded generator,
    which the layer checks go on drawing from."""
    import torch
    import torch.nn.functional as tf

    spec = SHAPES[model]
    tag = spec["tag"]
    rn = randn_fn(0)

    # ---- LayerNorm: vision (per layer as the last field) and packed text rows
    for rows, D, per_layer in spec["ln"]:
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
        say(tag, f"layernorm_fwd {rows}x{D}: {reading} ms {ms:.4f} plain {plain:.4f} "
                       f"library(F.layer_norm) {lib:.4f} bound {bms:.4f} ({by})")
        for _ in range(per_layer):
            kernels["layernorm_fwd"].add(ms, plain, lib, bms, by)

    # ---- GEMM with each epilogue at the vision shapes.  The forward
    # epilogues take W (K, N); the backward ones W (N, K), read transposed
    for ep, M, K, N, per_layer in spec["gemm"]:
        w_nk = F.EPILOGUES[ep][1]
        a = rn(M, K)
        w = rn(N, K, std=K ** -0.5) if w_nk else rn(K, N, std=K ** -0.5)
        bias = rn(N, std=0.1) if ep in F._BIASED else None
        extra = None
        if ep == "residual":
            extra = rn(M, N)
        elif ep == "gelu_bwd":
            extra = rn(M, N, std=2.0)  # a saved pre-activation
        elif ep == "mul_f32":  # QuickGELU' of an fp32 pre-activation
            extra = F.quick_gelu_grad(rn(M, N, std=2.0, dtype=torch.float32))
        got = F.gemm_epilogue(a, w, bias, ep, extra)
        ref = F.gemm_epilogue_plain(a, w, bias, ep, extra)
        if ep == "fc_gelu_save":
            reading = "h " + check_close(f"gemm {ep} h", got[0], ref[0], kernels["gemm_bf16_epilogue"])
            reading += "; a " + check_close(f"gemm {ep} a", got[1], ref[1],
                                            kernels["gemm_bf16_epilogue"])
        elif ep in F._F32_OUT:
            reading = check_close(f"gemm {K}->{N} {ep}", got, ref, kernels["gemm_bf16_epilogue"],
                                  max_limit=F32_MAX_ERR, norm_limit=F32_NORM_ERR, share_limit=None)
        else:
            reading = check_close(f"gemm {K}->{N} {ep}", got, ref, kernels["gemm_bf16_epilogue"])
        del got, ref
        ms = time_ms(lambda: F.gemm_epilogue(a, w, bias, ep, extra))
        plain = time_ms(lambda: F.gemm_epilogue_plain(a, w, bias, ep, extra), 3)
        if w_nk:
            lib = time_ms(lambda: torch.matmul(a, w.t()))
            lib_name = "torch.matmul(a, W.t())"
        else:
            lib = time_ms(lambda: torch.addmm(bias, a, w))
            lib_name = "torch.addmm"
        out_bytes = {"store_f32": 4, "fc_gelu_save": 4, "fc_gelu_grad": 4}.get(ep, 2)
        extra_bytes = 0 if extra is None else extra.element_size()
        nbytes = (M * K + K * N) * 2 + M * N * (out_bytes + extra_bytes)
        bms, by = bound(nbytes + (N * 2 if bias is not None else 0), 2 * M * N * K)
        say(tag, f"gemm_bf16_epilogue {ep} {M}x{K}->{N}: {reading} ms {ms:.4f} "
                       f"({2 * M * N * K / ms / 1e9:.1f} TFLOP/s) plain {plain:.4f} "
                       f"library({lib_name}) {lib:.4f} bound {bms:.4f} ({by})")
        for _ in range(per_layer):
            kernels["gemm_bf16_epilogue"].add(ms, plain, lib, bms, by)
        del a, w, extra

    # ---- LayerNorm dx: the layer's two (fp32 dxn, with a residual), at the
    # vision shape (2 per layer) and the packed text rows; a tower LayerNorm
    # (bf16 dxn, no residual) at the vision shape
    for rows, D, dxn_name, with_r, per_layer in spec["ln_bwd"]:
        dxn_dt = getattr(torch, dxn_name)
        x = rn(rows, D, std=2.0)
        dxn = rn(rows, D, dtype=dxn_dt)
        s = rn(D, dtype=torch.float32) * 0.1 + 1
        r = rn(rows, D) if with_r else None
        reading = check_close(f"layernorm_bwd {rows}x{D}", F.layer_norm_bwd(dxn, x, s, r),
                              F.layer_norm_bwd_plain(dxn, x, s, r), kernels["layernorm_bwd"])
        ms = time_ms(lambda: F.layer_norm_bwd(dxn, x, s, r))
        plain = time_ms(lambda: F.layer_norm_bwd_plain(dxn, x, s, r))
        xr = x.detach().requires_grad_(True)
        y = tf.layer_norm(xr, (D,), s.bfloat16(), s.bfloat16(), 1e-5)
        g16 = dxn.bfloat16()
        lib = time_ms(lambda: torch.autograd.grad(y, xr, g16, retain_graph=True))
        nbytes = rows * D * (dxn.element_size() + 2 + 2 + (2 if with_r else 0)) + D * 4
        bms, by = bound(nbytes, 0, 15 * rows * D)
        say(tag, f"layernorm_bwd {rows}x{D} dxn {dxn_name} residual {with_r}: "
                       f"{reading} ms {ms:.4f} plain {plain:.4f} library(F.layer_norm "
                       f"backward) {lib:.4f} bound {bms:.4f} ({by})")
        for _ in range(per_layer):
            kernels["layernorm_bwd"].add(ms, plain, lib, bms, by)
        del x, dxn, r, xr, y, g16

    # ---- attention: vision (1 per layer), text causal, packed text rows;
    # forward, then backward from a seeded upstream gradient
    for label, B, S, H, causal, per_layer in spec["attn"]:
        D = 64 * H
        qkv = rn(B, S, 3 * D)
        L, is_causal, valid = F._block_spec(S, causal)
        n = B * (S // L)
        pairs = sum(min(r + 1, valid) if is_causal else valid for r in range(L))
        q, k, v = (t.detach().requires_grad_(True)
                   for t in qkv.view(n, L, 3, H, 64).permute(2, 0, 3, 1, 4))
        if isinstance(causal, tuple):
            i = torch.arange(L, device=qkv.device)
            allowed = (i[None, :] <= i[:, None]) & (i[None, :] < valid)
            sdpa = lambda: tf.scaled_dot_product_attention(q, k, v, attn_mask=allowed)  # noqa: E731
        else:
            sdpa = lambda: tf.scaled_dot_product_attention(q, k, v, is_causal=is_causal)  # noqa: E731

        reading = check_close(f"attention {label}", F.attention_fwd(qkv, H, causal),
                              F.attention_plain(qkv, H, causal), kernels["attention_fwd"])
        ms = time_ms(lambda: F.attention_fwd(qkv, H, causal))
        plain = time_ms(lambda: F.attention_plain(qkv, H, causal), 3)
        with torch.no_grad():
            lib = time_ms(sdpa)
        bms, by = bound(4 * B * S * D * 2, 4 * 64 * pairs * n * H, 5 * pairs * n * H)
        say(tag, f"attention_fwd {label} B={B} S={S} H={H}: {reading} ms {ms:.4f} "
                       f"plain {plain:.4f} library(sdpa) {lib:.4f} bound {bms:.4f} ({by})")
        if per_layer:
            kernels["attention_fwd"].add(ms, plain, lib, bms, by)

        do = rn(B, S, D, std=0.1)
        reading = check_close(f"attention_bwd {label}", F.attention_bwd(qkv, do, H, causal),
                              F.attention_bwd_plain(qkv, do, H, causal), kernels["attention_bwd"])
        ms = time_ms(lambda: F.attention_bwd(qkv, do, H, causal))
        plain = time_ms(lambda: F.attention_bwd_plain(qkv, do, H, causal), 3)
        out = sdpa()
        do4 = do.view(n, L, H, 64).permute(0, 2, 1, 3)
        lib = time_ms(lambda: torch.autograd.grad(out, (q, k, v), do4, retain_graph=True))
        bms, by = bound(7 * B * S * D * 2, 5 * 2 * 64 * pairs * n * H, 8 * pairs * n * H)
        say(tag, f"attention_bwd {label} B={B} S={S} H={H}: {reading} ms {ms:.4f} "
                       f"plain {plain:.4f} library(sdpa backward) {lib:.4f} bound {bms:.4f} ({by})")
        if per_layer:
            kernels["attention_bwd"].add(ms, plain, lib, bms, by)
        del qkv, q, k, v, do, do4, out
    return rn


def layer_params(rn, D: int) -> list:
    """The twelve weights of a layer at width D, seeded."""
    import torch

    return [rn(D, dtype=torch.float32) * 0.1 + 1, rn(D, dtype=torch.float32) * 0.1,
            rn(D, 3 * D, std=D ** -0.5), rn(3 * D, std=0.1), rn(D, D, std=D ** -0.5),
            rn(D, std=0.1), rn(D, dtype=torch.float32) * 0.1 + 1,
            rn(D, dtype=torch.float32) * 0.1, rn(D, 4 * D, std=D ** -0.5),
            rn(4 * D, std=0.1), rn(4 * D, D, std=(4 * D) ** -0.5), rn(D, std=0.1)]


def phase_layer_chains(F, rn) -> None:
    import torch

    # ---- the whole layer, kernel chain against the plain chain: the no-save
    # forward, then the saving forward with the backward (LayerFullblockFn).
    # The main path's row counts are multiples of the GEMM's 128-row tile;
    # the unpacked causal text rows (1,600) also reach its masked last tile
    for D, B, S, H, causal in ((768, 384, 199, 12, False), (512, 13, 128, 8, (16, 16)),
                               (512, 100, 16, 8, True)):
        x = rn(B, S, D)
        ps = layer_params(rn, D)
        # a one-ulp flip early in the chain moves later roundings: the
        # share of differing elements is printed, not held
        reading = check_close(f"layer_fullblock D={D}", F.layer_fullblock(x, *ps, H, causal),
                              F.layer_fullblock_plain(x, *ps, H, causal), share_limit=None)
        ms = time_ms(lambda: F.layer_fullblock(x, *ps, H, causal))
        plain = time_ms(lambda: F.layer_fullblock_plain(x, *ps, H, causal), 3)
        say("kernels", f"layer_fullblock D={D} B={B} S={S} mask={causal}: {reading} "
                       f"ms {ms:.4f} plain {plain:.4f}")

        xg = x.detach().requires_grad_(True)
        gy = rn(B, S, D)

        def step(plain_fns):
            y = F.layer_fullblock(xg, *ps, H, causal, plain=plain_fns)
            return y, torch.autograd.grad(y, xg, gy)[0]

        (y, dx), (y_ref, dx_ref) = step(False), step(True)
        r_y = check_close(f"layer_fullblock save D={D} y", y, y_ref, share_limit=None)
        r_dx = check_close(f"layer_fullblock D={D} dx", dx, dx_ref, max_limit=LAYER_DX_MAX_ERR,
                           norm_limit=LAYER_DX_NORM_ERR, share_limit=None)
        del y, dx, y_ref, dx_ref
        ms = time_ms(lambda: step(False))
        plain = time_ms(lambda: step(True), 3)
        say("kernels", f"layer_fullblock forward-save + backward D={D} B={B} S={S} "
                       f"mask={causal}: y {r_y}; dx {r_dx}; ms {ms:.4f} plain {plain:.4f}")
        del x, xg, gy, ps


def phase_halfblock_chains(F) -> None:
    """The four half-block chains against their plain versions: each half's
    forward alone, then its forward with the backward, qkv or h saved and
    recomputed; at the ViT-L/14 vision shape and at the packed text rows of
    2,560 classes, which train with saves off."""
    import torch

    tag = SHAPES["ViT-L/14"]["tag"]
    rn = randn_fn(2)
    for label, B, S, D, H, causal in (("vision", BATCH, 259, 1024, 16, False),
                                      ("text packed", SAVES_OFF_N_CLS // 8, 128, 768, 12,
                                       (16, 16))):
        x = rn(B, S, D)
        ps = layer_params(rn, D)
        halves = {"attn": (F.attn_halfblock, F.attn_halfblock_plain, ps[:6], (H, causal)),
                  "mlp": (F.mlp_halfblock, F.mlp_halfblock_plain, ps[6:], ())}
        serve_ms, train_ms = {}, {}
        for half, (fn, plain_fn, p, extra) in halves.items():
            reading = check_close(f"{half}_halfblock {label}", fn(x, *p, *extra),
                                  plain_fn(x, *p, *extra), share_limit=None)
            ms = time_ms(lambda: fn(x, *p, *extra))
            plain = time_ms(lambda: plain_fn(x, *p, *extra), 3)
            serve_ms[half] = (ms, plain)
            say(tag, f"{half}_halfblock {label} B={B} S={S} D={D} mask={causal}: {reading} "
                     f"ms {ms:.4f} plain {plain:.4f}")
            xg = x.detach().requires_grad_(True)
            gy = rn(B, S, D)
            for save in (True, False):
                def step(plain_fns):
                    F.set_save_mlp_wide("1" if save else "0")
                    with F.saved_acts(save):
                        y = fn(xg, *p, *extra, plain=plain_fns)
                    F.set_save_mlp_wide("auto")
                    if (y.grad_fn.saved_tensors[-1] is not None) != save:
                        raise AssertionError(f"{half}_halfblock save={save}: wrong backward")
                    return y, torch.autograd.grad(y, xg, gy)[0]

                (y, dx), (y_ref, dx_ref) = step(False), step(True)
                what = f"{half}_halfblock {label} {'save' if save else 'recompute'}"
                r_y = check_close(f"{what} y", y, y_ref, share_limit=None)
                r_dx = check_close(f"{what} dx", dx, dx_ref, max_limit=LAYER_DX_MAX_ERR,
                                   norm_limit=LAYER_DX_NORM_ERR, share_limit=None)
                del y, dx, y_ref, dx_ref
                ms = time_ms(lambda: step(False), 5)
                plain = time_ms(lambda: step(True), 2)
                train_ms[half, save] = (ms, plain)
                kept = {"attn": "qkv", "mlp": "h"}[half]
                say(tag, f"{half}_halfblock forward + backward {label}, {kept} "
                         f"{'saved' if save else 'recomputed'}: y {r_y}; dx {r_dx}; "
                         f"ms {ms:.4f} plain {plain:.4f}")
            del xg, gy
        if label == "vision":
            # one vision layer of the serving path, and of the train step at
            # batch 384 (qkv saved, h recomputed)
            fwd = [sum(v[i] for v in serve_ms.values()) for i in (0, 1)]
            trn = [train_ms["attn", True][i] + train_ms["mlp", False][i] for i in (0, 1)]
            say(tag, f"one ViT-L/14 vision layer: forward ms {fwd[0]:.4f} plain {fwd[1]:.4f}; "
                     f"train step's forward + backward ms {trn[0]:.4f} plain {trn[1]:.4f}")
        del x, ps


def traced(phase: str, fn, cats_of) -> None:
    """Run ``fn`` once under the profiler and print where the device time
    went: ``cats_of(prof)`` gives ({category: us}, {kernel: us}, {other: us})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cats, by_kernel, others = cats_of(prof)
    busy = sum(cats.values())
    what = "request" if phase.startswith("serving") else "step"
    if busy <= 0:
        say(phase, f"traced {what}: the profiler recorded no device time (not measured)")
        return
    share = ", ".join(f"{k} {v / 1e3:.2f} ms ({v / busy:.1%})" for k, v in cats.items())
    say(phase, f"traced {what}: device busy {busy / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms "
               f"wall ({1 - busy / wall_us:.1%} idle); {share}")
    if by_kernel:
        say(phase, "by kernel: " + "; ".join(
            f"{k} {v / 1e3:.3f} ms" for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])))
    top = sorted(others.items(), key=lambda kv: -kv[1])[:8]
    say(phase, "largest other device time: " + "; ".join(f"{k} {v / 1e3:.3f} ms" for k, v in top))


def serving_time_by_kernel(prof) -> tuple:
    """({kernel or "other": device us}, {}, {other kernel: us}) of a request."""
    import torch

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
    return by_kernel, {}, others


def phase_serving(F, model: str) -> dict:
    import torch

    from mudpt_torch.models.layers import plain_blocks
    from mudpt_torch.utils.synth_step import build_synth_mudpt_server

    phase = "serving" if model == "ViT-B/16" else f"serving {model}"
    t0 = time.perf_counter()
    st = build_synth_mudpt_server(model, BATCH, N_CLS, N_CTX, DEPTH, seed=0)
    torch.cuda.synchronize()
    say(phase, f"built {model} server (random weights, seed 0) in "
               f"{time.perf_counter() - t0:.2f} s; text rows {tuple(st.aux['token_suffix'].shape)}")
    tr, params, aux, images = st.trainable, st.params, st.aux, st.images
    cfg = st.clip_cfg

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

    # the text tower (D <= 768, saves on) runs whole layers, plus ln_final;
    # a request runs the vision tower's layers (whole at D <= 768, halves
    # above), plus ln_pre and ln_post
    n_req = REQUESTS + 1
    vision = "full" if cfg.vision_width <= F.FULLBLOCK_MAX_WIDTH else "half"
    want_text = expect(F.LAUNCHES, (cfg.transformer_layers, "full"), (1, tower_lns(1)))
    if text_counts != want_text:
        raise AssertionError(f"text encode launches {text_counts} != {want_text}")
    want = expect(F.LAUNCHES, (1, want_text), (n_req * cfg.vision_layers, vision),
                  (n_req, tower_lns(2)))
    if counts != want:
        raise AssertionError(f"main-path launches {counts} != {want}")
    per_request = expect(F.LAUNCHES, (cfg.vision_layers, vision), (1, tower_lns(2)))
    say(phase, f"launches: text encode {text_counts}; per request "
               f"{ {k: v for k, v in per_request.items() if v} }; text + {n_req} requests {counts}")

    ips = BATCH * REQUESTS / t_all
    say(phase, f"text encode {t_text * 1e3:.1f} ms (once, {N_CLS} classes); "
               f"{REQUESTS} requests of {BATCH} images: median {statistics.median(lat) * 1e3:.2f} ms, "
               f"max {max(lat) * 1e3:.2f} ms; cached-text throughput {ips:.1f} images/s")

    # ---- where one request's device time goes (a separate, traced request)
    traced(phase, lambda: st.eval_step_cached(tr, params, aux, images, txt),
           serving_time_by_kernel)

    # ---- outputs: shape, finiteness, agreement with the plain path on the card
    logits = st.image_logits(tr, params, aux, images, txt)
    with plain_blocks():
        txt_ref = st.text_features(tr, params, aux)
        logits_ref = st.image_logits(tr, params, aux, images, txt_ref)
    torch.cuda.synchronize()
    if txt.shape != (N_CLS, cfg.embed_dim) or logits.shape != (BATCH, N_CLS):
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
    say(phase, f"vs plain path on the card: text features {t_read}; logits, rows centred "
               f"{l_read}; logits max abs err {drift:.4g} of max {scale:.4g}; top-1 agreement "
               f"{agree.float().mean().item():.4f}; {int(decisive.sum())} decisive rows, "
               f"{int(agree[decisive].sum())} equal")
    # and the bound of tests/test_precision_drift.py: 5% of the largest
    # magnitude, every top-1 whose margin exceeds the drift equal, 75% agreement
    if drift > 0.05 * scale or not agree[decisive].all() or agree.float().mean() < 0.75:
        raise AssertionError(f"logits vs plain path: drift {drift} (scale {scale}), "
                             f"agreement {agree.float().mean().item()}")
    return counts


def to_float(tree):
    """A parameter tree with every floating tensor in fp32."""
    if isinstance(tree, dict):
        return {k: to_float(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


def device_time_by_kernel(prof) -> tuple:
    """({category: device us}, {other kernel: us}) from a profiler run:
    the forward kernels, the backward kernels (the GEMM by its epilogue's
    template argument), and everything else."""
    import re

    import torch

    cats = {"forward kernels": 0.0, "backward kernels": 0.0, "other": 0.0}
    by_kernel, others = {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops also report their kernels' time
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        gemm = re.search(r"gemm_bf16_kernel<(\d)>", e.key)
        if gemm:
            name, bwd = f"gemm_bf16_kernel<{gemm.group(1)}>", int(gemm.group(1)) >= 4
        else:
            name = next((k for k in ("layernorm_fwd_kernel", "attention_fwd_kernel",
                                     "layernorm_bwd_kernel", "attention_bwd_kernel")
                         if k in e.key), None)
            bwd = name is not None and "bwd" in name
        if name is None:
            cats["other"] += us
            if us > 0:
                others[e.key[:60]] = others.get(e.key[:60], 0.0) + us
            continue
        cats["backward kernels" if bwd else "forward kernels"] += us
        by_kernel[name] = by_kernel.get(name, 0.0) + us
    return cats, by_kernel, others


def grad_limit(cfg) -> float:
    """The gradient limit at the depth of the model's deeper tower."""
    depth = max(cfg.vision_layers, cfg.transformer_layers, GRAD_DEPTH)
    return GRAD_NORM_ERR * math.sqrt(depth / GRAD_DEPTH)


def grad_check(F, st, phase: str, label: str, want: dict) -> None:
    """One step's loss and gradients of the trainable leaves from the same
    starting state: the kernels (their launches held to ``want``), the plain
    versions on the card and, to show how far bf16 alone moves them, the
    plain versions in fp32 on the same values (TF32 off)."""
    import torch

    from mudpt_torch.models.layers import plain_blocks
    from mudpt_torch.trainers.mudpt import mudpt_forward
    from mudpt_torch.utils.synth_step import leaves, nll_loss

    tr = leaves(st.trainable)
    names = [f"{k}/{kk}" if isinstance(v, dict) else k
             for k, v in st.trainable.items() for kk in (v if isinstance(v, dict) else [None])]
    F.reset_launches()
    loss = st.loss_fn(st.images, st.labels)
    grads = torch.autograd.grad(loss, tr)
    if dict(F.LAUNCHES) != want:
        raise AssertionError(f"{label}: launches {dict(F.LAUNCHES)} != {want}")
    with plain_blocks():
        loss_ref = st.loss_fn(st.images, st.labels)
        grads_ref = torch.autograd.grad(loss_ref, tr)
        params32 = to_float(st.params)
        logits32 = mudpt_forward(st.trainable, params32, st.aux, st.images.float(),
                                 clip_cfg=st.clip_cfg, compute_dtype=torch.float32)
        grads32 = torch.autograd.grad(nll_loss(logits32, st.labels), tr)
        del params32, logits32
    torch.cuda.synchronize()
    loss, loss_ref = loss.item(), loss_ref.item()
    rel = abs(loss - loss_ref) / abs(loss_ref)
    worst = worst_ratio = 0.0
    parts = []
    for name, gk, gp, g32 in zip(names, grads, grads_ref, grads32):
        if not (torch.isfinite(gk).all() and gk.shape == gp.shape):
            raise AssertionError(f"gradient of {name}: non-finite or misshapen")
        err = ((gk - gp).norm() / gp.norm()).item()
        k32, p32 = (((g - g32).norm() / g32.norm()).item() for g in (gk, gp))
        worst, worst_ratio = max(worst, err), max(worst_ratio, k32 / p32)
        parts.append(f"{name} {err:.3g} ({k32:.3g} / {p32:.3g})")
    limit = grad_limit(st.clip_cfg)
    say(phase, f"{label} vs plain path on the card: loss {loss:.6f} vs {loss_ref:.6f} "
               f"(rel {rel:.3g}); gradient relative norm errors, kernels vs plain, limit "
               f"{limit:.4g} (kernels vs fp32 / plain vs fp32): " + ", ".join(parts))
    if not (rel <= LOSS_REL_ERR and worst <= limit and worst_ratio <= GRAD_FP32_RATIO):
        raise AssertionError(f"{label} vs plain path: loss rel err {rel} (limit "
                             f"{LOSS_REL_ERR}), worst gradient norm err {worst} (limit "
                             f"{limit}), worst ratio of distances to fp32 "
                             f"{worst_ratio} (limit {GRAD_FP32_RATIO})")


def step_launches(F, cfg, text_route: str, vision_route: str) -> dict:
    """Launches of one train step: both towers' layers, and ln_pre,
    ln_post, ln_final forward and backward."""
    return expect(F.LAUNCHES, (cfg.transformer_layers, text_route),
                  (cfg.vision_layers, vision_route), (1, tower_lns(3, 3)))


def phase_train(F, model: str) -> dict:
    import torch

    from mudpt_torch.utils.synth_step import build_synth_mudpt_step, leaves

    phase = "train" if model == "ViT-B/16" else f"train {model}"
    if model == "ViT-L/14":
        # ---- gradients at batch 32, where an fp32 plain step fits: the
        # vision MLP recomputing h (its "0" mode), then 2,560 classes, whose
        # text tower trains with saves off while the vision MLP saves h
        F.set_save_mlp_wide("0")
        try:
            st = build_synth_mudpt_step(model, GRAD_BATCH, N_CLS, N_CTX, DEPTH, seed=0)
            grad_check(F, st, phase, f"one step at batch {GRAD_BATCH}, h recomputed",
                       step_launches(F, st.clip_cfg, "full_train", "half_train_recompute_h"))
        finally:
            F.set_save_mlp_wide("auto")
        del st
        st = build_synth_mudpt_step(model, GRAD_BATCH, SAVES_OFF_N_CLS, N_CTX, DEPTH, seed=0)
        grad_check(F, st, phase, f"one step at batch {GRAD_BATCH}, {SAVES_OFF_N_CLS} classes "
                                 "(text saves off, h saved)",
                   step_launches(F, st.clip_cfg, "half_train_saves_off", "half_train"))
        del st
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    st = build_synth_mudpt_step(model, BATCH, N_CLS, N_CTX, DEPTH, seed=0)
    torch.cuda.synchronize()
    tr = leaves(st.trainable)
    cfg = st.clip_cfg
    say(phase, f"built {model} train step (random weights, seed 0) in "
               f"{time.perf_counter() - t0:.2f} s; {len(tr)} trainable leaves, "
               f"{sum(t.numel() for t in tr)} values")
    # the text tower (768 wide or less, 100 classes) saves and runs whole
    # layers; the vision tower too at ViT-B; at ViT-L its halves, the MLP's
    # h over the row-token budget at batch 384, so recomputed
    if cfg.vision_width <= F.FULLBLOCK_MAX_WIDTH:
        vision_route = "full_train"
    elif F.wide_mlp_save(BATCH * cfg.vision_seq_len + BATCH * N_CTX):
        vision_route = "half_train"
    else:
        vision_route = "half_train_recompute_h"
    per_step = step_launches(F, cfg, "full_train", vision_route)
    if model == "ViT-B/16":
        grad_check(F, st, phase, "one step", per_step)

    # ---- the main path, counted: warm-up, then timed steps
    for _ in range(WARMUP_STEPS):
        st.train_step(st.images, st.labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    F.reset_launches()
    step_s, losses, after = [], [], [dict(F.LAUNCHES)]
    t_all = time.perf_counter()
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        losses.append(st.train_step(st.images, st.labels))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        after.append(dict(F.LAUNCHES))
    t_all = time.perf_counter() - t_all
    counts = after[-1]
    losses = [v.item() for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")

    for i in range(TIMED_STEPS):
        got = {k: after[i + 1][k] - after[i][k] for k in per_step}
        if got != per_step:
            raise AssertionError(f"train step {i}: launches {got} != {per_step}")
    say(phase, f"launches per step ({vision_route} vision layers): "
               f"{ {k: v for k, v in per_step.items() if v} }; over {TIMED_STEPS} steps: {counts}")
    ips = BATCH * TIMED_STEPS / t_all
    say(phase, f"{TIMED_STEPS} steps of {BATCH} images: median "
               f"{statistics.median(step_s) * 1e3:.2f} ms, max {max(step_s) * 1e3:.2f} ms; "
               f"training throughput {ips:.1f} images/s; losses {losses[0]:.5f} .. "
               f"{losses[-1]:.5f}; peak device memory over the timed steps "
               f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    # ---- where one step's device time goes (a separate, traced step)
    traced(phase, lambda: st.train_step(st.images, st.labels), device_time_by_kernel)
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
    regs = {name: [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln]
            for name, log in _build.build_logs.items()}
    say("build", f"{len(_build.SIGNATURES)} kernel sources built in "
                 f"{_build.build_seconds:.2f} s; ptxas: {json.dumps(regs)}")

    kernels = {name: Kernel(name) for name in _build.SIGNATURES}
    kernels_l = {name: Kernel(name) for name in _build.SIGNATURES}
    paths = {}

    def run(phase: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        say(phase, f"phase done in {time.perf_counter() - t0:.1f} s")
        return out

    rn = run("kernels", phase_kernels, F, kernels, "ViT-B/16")
    run("kernels", phase_layer_chains, F, rn)
    paths["serving"] = run("serving", phase_serving, F, "ViT-B/16")
    paths["train_step"] = run("train", phase_train, F, "ViT-B/16")
    run("kernels ViT-L/14", phase_kernels, F, kernels_l, "ViT-L/14")
    run("kernels ViT-L/14", phase_halfblock_chains, F)
    paths["serving_vit_l14"] = run("serving ViT-L/14", phase_serving, F, "ViT-L/14")
    paths["train_step_vit_l14"] = run("train ViT-L/14", phase_train, F, "ViT-L/14")

    print(json.dumps({"kernels": [
        k.record({path: counts[k.name] for path, counts in paths.items()}, kernels_l[k.name])
        for k in kernels.values()]}))
    print(smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
