#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's MuDPT serving paths and train steps on one
GPU, ViT-B/16, ViT-L/14 and ViT-L/14@336px, and its chunked MLP half-block.

    python3 chip_smoke.py
    python3 chip_smoke.py --times-of ROOT   # only the kernel times of the
                                            # checkout at ROOT (A/B of two trees)

Phases, each printed with the card's name and power limit:

  1. device   CUDA present; TF32 off for the plain versions.
  2. build    nvcc builds mudpt_torch/csrc/*.cu (parallel, one per source).
  3. kernels  every kernel against its plain PyTorch version at the shapes
              of the ViT-B/16 serving path and train step, with the
              kernel's, the plain version's and one library call's time (the
              library call is a yardstick, never used by the port), and the
              bound from bytes and operations, and each GEMM epilogue and
              attention_bwd launched twice on the same inputs, bit-equal;
              attention_fwd and attention_bwd at every block length from 16
              to 1,024 rows (their tiles resident and streamed), every mask
              spec, attention_fwd's both output forms; then the whole layer
              against its plain version at D=768 and D=512, forward alone
              and forward with backward.
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
              recompute epilogues, attention at 8 blocks of 384 rows, and
              the four half-block chains, forward alone and forward with
              backward, qkv and h saved and recomputed.
  7. serving ViT-L/14   as 4, for build_synth_mudpt_server("ViT-L/14", ...).
  8. train ViT-L/14     gradients against the plain path and an fp32 plain
              step at batch 32, twice: the vision MLP recomputing h, then
              2,560 classes, whose text tower trains with saves off; then
              timed steps at batch 384 (the vision MLP recomputes h there),
              launches per step, peak device memory and a traced step.
  8b. kernels ViT-L/14@336px, serving ViT-L/14@336px, train ViT-L/14@336px
              every kernel at the 336px shapes (577 + n_ctx = 579 vision
              rows, M = 384 x 579 = 222,336: LayerNorm, every GEMM mode of
              the step, attention_fwd and attention_bwd beside SDPA), then
              serving as 4, then the train step as 8: gradients against the
              plain path and fp32 at batch 32 with h recomputed, timed steps
              at batch 384, the vision saves reckoned, peak memory.
  9. kernels int8   the int8 kernels against their plain versions at the
              ViT-B/16 shapes (LayerNorm-quant, the row quantizer with a
              probe of exact ties, every s8 GEMM epilogue with torch._int_mm
              as its yardstick, attention_fwd's fp32 output), then the four
              int8 layer chains: the dynamic and the static forward, the
              saving forwards, and the quantization-aware forward with its
              backward, activations saved and recomputed.
 10. serving int8, serving int8_static   as 4, with quant="int8" and
              "int8_static" (calibrated at build), and the top-1 agreement
              with the bf16 tier on the same weights printed.
 11. train int8_ste, train int8_ste_static   as 5, quantization-aware.
 12. kernels chunked   mlp_halfblock_chunked, the MLP half streamed over
              hidden-dim chunks: LayerNorm forward and dx at D = 1024 and
              1280; each GEMM of its chain at ViT-L/14's chunk (the fc
              weight's column chunk read in place, y and the fp32 dxn
              updated in place); then the op against its plain version,
              forward and forward with backward, launches per call held, at
              ViT-L/14's vision MLP (K = 8 chunks), ViT-B/16's (K = 2) and
              D = 1280 (K = 10), timed beside mlp_halfblock at ViT-L/14.

The last three lines are one JSON object describing each kernel, the
card's name and power limit, and {"ok": true, "device": {...}}.  Times in
the kernel object are totals over one vision layer's launches in the
ViT-B/16 train step (LayerNorm twice, the eight projections, attention once,
each way), under "vit_l14" and "vit_l14_336px" in the ViT-L/14 and
ViT-L/14@336px train steps (LayerNorm three times, nine projections),
under "int8" attention_fwd's fp32
output in the int8 request; the int8 kernels' totals are over one vision
layer of the int8 request, under "int8_static" of the int8_static request;
under "chunked" one call of the chunked MLP half's forward and backward at
ViT-L/14 (LayerNorm twice, 40 products, LayerNorm dx once).  "launches"
counts the main path's run ("main_path": the ViT-B/16 train step, or the
int8 request), "launches_by_path" each path's.  Any failed
check raises, and the script exits non-zero without a result; so it does
without CUDA, and outside a checkout of the repository.
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
PEAK_INT8_OPS = 1979e12

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
# the chunked MLP half's y against the plain chain: rounded after each chunk
# as the plain chain rounds, so only one-ulp flips of the chunks' sums
# differ (readings 2.8e-4-4.6e-4); y rounded once after the fp32 sum of all
# chunks, the half-block's rounding, reads 5.0e-3
# (tests/test_torch_chip_checks.py)
CHUNK_Y_NORM_ERR = 2.0 ** -10
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
# the plain bf16 path's (the worst leaf).  Derived by
# tools/torch_grad_noise.py --ratio as the mean + 4 standard deviations of
# that ratio over eight seeds of each ViT-B/16 check (bf16, int8_ste,
# int8_ste_static at batch 384), rounded up to a tenth: 24 cases, mean
# 1.0547, sd 0.0595, largest 1.2118 (PERF.md).  The ViT-L/14 checks at batch
# 32 spread wider, as wide with the first port's attention_fwd as with the
# key-tiled one (16 cases each, one call: mean 1.1694 and 1.1818, sd 0.1504
# and 0.1748, largest 1.6162 and 1.5520; seed 0, this script's case,
# 1.24-1.41 as the kernels' rounding changed), the worst leaf being the
# one whose plain-vs-fp32 distance is least: the same rule gives 1.8 and
# 1.9
GRAD_FP32_RATIO, GRAD_FP32_RATIO_L14 = 1.3, 1.9

# int8 codes of the quantizing kernels against their plain versions.  The
# row quantizer and the s8 GEMM's qkv and residual epilogues compute the
# plain version's arithmetic exactly and are held bit-equal.  LayerNorm's
# statistics sum in another order and QuickGELU's exp is the card's, so
# there a code moves by one step where the fp32 value lies next to a
# rounding boundary: codes within one step, at most this share differing
CODE_STEP, CODE_SHARE = 1, 2.0 ** -8
# LayerNorm-quant's row scales: the row's absmax moves by an fp32 ulp or two
LN_SCALE_ERR = 2.0 ** -20
# the attention output in fp32 (the int8 layers quantize it unrounded): the
# card's exp moves a bf16 probability by an ulp now and then, and the fp32
# sums run in another order, so no element is held bit-equal; its codes are
ATTN_F32_MAX_ERR, ATTN_F32_NORM_ERR = 2.0 ** -5, 2.0 ** -12

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
CHUNK_FWD, CHUNK_BWD = ":477 _mlp_chunk_fwd_kernel", ":500 _mlp_chunk_bwd_kernel"
Q8 = ("mudpt_tpu/ops/quant_block.py:89 _layer_fwd_q8_kernel, :178 _layer_fwd_q8_save_kernel, "
      ":377 _layer_fwd_q8_static_kernel, :563 _layer_fwd_q8_static_save_kernel")
REPLACES = {
    "layernorm_fwd": f"{FWD}, {ATTN_FWD}, {MLP_FWD}, :358 _attn_bwd_kernel, "
                     f":444 _mlp_bwd_kernel, {CHUNK_FWD}, {CHUNK_BWD}",
    "gemm_bf16_epilogue": f"{FWD}, :868 _layer_bwd_kernel, {ATTN_FWD}, {MLP_FWD}, "
                          f"{ATTN_BWD}, {MLP_BWD}, {CHUNK_FWD}, {CHUNK_BWD}",
    "attention_fwd": f"{FWD}, {ATTN_FWD}; {Q8}",
    "layernorm_bwd": f"{BWD}, {ATTN_BWD}, {MLP_BWD}, {CHUNK_BWD}",
    "attention_bwd": f"{BWD}, {ATTN_BWD}",
    "layernorm_q8": Q8,
    "gemm_s8_epilogue": Q8,
    "quant_rows": Q8,
}
# the int8 kernels, whose times in the kernel object are those of one
# vision layer of the ViT-B/16 int8 request, and whose launches are that path's
Q8_KERNELS = ("layernorm_q8", "gemm_s8_epilogue", "quant_rows")
# the chunked MLP half's kernels, whose times under "chunked" are those of
# one call of its forward and backward at ViT-L/14's vision MLP
CHUNKED_KERNELS = ("layernorm_fwd", "gemm_bf16_epilogue", "layernorm_bwd")

# kernel launches of one layer on each route of models/layers.residual_block
# (the half-block routes count the Functions of both halves)
_HALVES = dict(attn_halfblock=1, mlp_halfblock=1)
_HALVES_TRAIN = dict(_HALVES, attn_halfblock_bwd=1, mlp_halfblock_bwd=1,
                     attention_fwd=1, attention_bwd=1, layernorm_bwd=2)
_Q8_BWD = dict(gemm_bf16_epilogue=4, layernorm_bwd=2, attention_bwd=1,
               layer_fullblock_q8_ste_bwd=1)
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
    # the int8 layer chains: dynamic (the attention output and g quantized
    # by quant_rows) and static (g quantized in the fc product's epilogue);
    # quantization-aware training adds PR 2's bf16 layer backward
    "q8": dict(layernorm_q8=2, gemm_s8_epilogue=4, attention_fwd=1, quant_rows=2,
               layer_fullblock_q8=1),
    "q8s": dict(layernorm_q8=2, gemm_s8_epilogue=4, attention_fwd=1, quant_rows=1,
                layer_fullblock_q8_static=1),
    "q8_train": dict(layernorm_q8=2, gemm_s8_epilogue=4, attention_fwd=1, quant_rows=2,
                     layer_fullblock_q8_ste=1, **_Q8_BWD),
    "q8s_train": dict(layernorm_q8=2, gemm_s8_epilogue=4, attention_fwd=1, quant_rows=1,
                      layer_fullblock_q8_ste_static=1, **_Q8_BWD),
}
# each tier's layer route, serving and training
Q8_ROUTES = {"int8": "q8", "int8_static": "q8s", "int8_ste": "q8_train",
             "int8_ste_static": "q8s_train"}


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


SLEEP_CYCLES = 60_000_000  # ~30 ms of the card's clock: the queue's head start


def queued_ms(fn, iters: int = 10) -> tuple:
    """(device ms, host us) a call of ``fn``: the calls are issued while the
    card sleeps, so that it runs them back to back whatever the host's pace
    (``time_ms`` reads the slower of the two); host us, the time to issue
    one call."""
    import torch

    fn()
    torch.cuda.synchronize()
    asleep, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    asleep.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if host_ms >= asleep.elapsed_time(start):
        raise AssertionError(f"issuing {iters} calls took {host_ms:.2f} ms, longer than the sleep")
    return start.elapsed_time(end) / iters, host_ms * 1e3 / iters


def bound(bytes_moved: float, bf16_ops: float, fp32_ops: float = 0.0, int8_ops: float = 0.0):
    """(ms, 'bytes' | 'operations'): the least time for the work."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = bf16_ops / PEAK_BF16_FLOPS + fp32_ops / PEAK_FP32_FLOPS + int8_ops / PEAK_INT8_OPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


class Kernel:
    """Totals of one kernel over the launches of one vision layer of a path
    (the train step's forward and backward, or an int8 request)."""

    def __init__(self, name: str):
        self.name = name
        self.ms = self.plain_ms = self.bound_ms = 0.0
        self.library_ms = None  # None while no launch has a library yardstick
        self.t_bytes = self.t_ops = 0.0
        self.max_abs_err = 0.0

    def add(self, ms, plain_ms, library_ms, bound_ms, by):
        self.ms += ms
        self.plain_ms += plain_ms
        if library_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + library_ms
        self.bound_ms += bound_ms
        if by == "bytes":
            self.t_bytes += bound_ms
        else:
            self.t_ops += bound_ms

    def times(self) -> dict:
        return {"ms": self.ms, "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
                "bound_by": "bytes" if self.t_bytes >= self.t_ops else "operations",
                "library_ms": self.library_ms}

    def record(self, launches: dict, main_path: str, **more: "Kernel") -> dict:
        """The kernel's JSON entry: its times, those of ``more`` under their
        keys, and its launches on ``main_path``."""
        return {
            "name": self.name, "route": "cuda",
            "source": f"mudpt_torch/csrc/{self.name}.cu",
            "replaces": REPLACES[self.name],
            "launches": launches[main_path], "main_path": main_path,
            "launches_by_path": launches,
            "max_abs_err": max([self.max_abs_err] + [k.max_abs_err for k in more.values()]),
            **self.times(), **{key: k.times() for key, k in more.items()},
        }


def check_close(what: str, got, ref, kernel: Kernel = None, max_limit=MAX_ERR_OF_MAX,
                norm_limit=NORM_ERR, share_limit=DIFFER_SHARE, abs_limit=None) -> str:
    """Hold ``got`` to ``ref``: max abs error within ``max_limit`` of the
    largest value (or within ``abs_limit``, where given), relative norm
    error within ``norm_limit``, and at most ``share_limit`` of the
    elements not bit-equal (None: not held).  Returns the readings as text."""
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
    if abs_limit is not None:
        if not err <= abs_limit:
            raise AssertionError(f"{what}: {reading}: max abs err over {abs_limit}")
    elif not err <= max_limit * largest:
        raise AssertionError(f"{what}: {reading}: max abs err over {max_limit} of the largest value")
    if not norm <= norm_limit:
        raise AssertionError(f"{what}: {reading}: relative norm error over {norm_limit}")
    if share_limit is not None and not share <= share_limit:
        raise AssertionError(f"{what}: {reading}: share of differing elements over {share_limit}")
    if kernel is not None:
        kernel.max_abs_err = max(kernel.max_abs_err, err)
    return reading


def check_codes(what: str, got, ref, kernel: Kernel = None) -> str:
    """int8 codes within one step of the plain version's, at most
    ``CODE_SHARE`` of them differing."""
    return check_close(what, got, ref, kernel, abs_limit=CODE_STEP, share_limit=CODE_SHARE)


def check_equal(what: str, got, ref, kernel: Kernel = None) -> str:
    """Bit-equal to the plain version."""
    return check_close(what, got, ref, kernel, abs_limit=0, norm_limit=0, share_limit=0)


# the kernels' shapes on each model's paths; the last field of a case: its
# launches in one vision layer of the train step
M_B, M_L = BATCH * 199, BATCH * 259  # vision tokens per batch: 197 or 257 + n_ctx
M_336 = BATCH * 579                   # 577 + n_ctx at 336px
# ViT-L/14's vision GEMMs; the train step at batch 384 recomputes the vision
# MLP's h: LN2 and the fc product run again in the backward, which stores
# QuickGELU'(h32) (fc_gelu_grad) for the g.proj_w^T product to apply (mul_f32)
_L14_GEMM = (("qkv", M_L, 1024, 3072, 1), ("residual", M_L, 1024, 1024, 1),
             ("fc_gelu", M_L, 1024, 4096, 1), ("fc_gelu_save", M_L, 1024, 4096, 0),
             ("residual", M_L, 4096, 1024, 1), ("fc_gelu_grad", M_L, 1024, 4096, 1),
             ("mul_f32", M_L, 1024, 4096, 1), ("gelu_bwd", M_L, 1024, 4096, 0),
             ("store_f32", M_L, 4096, 1024, 1), ("store_bf16", M_L, 1024, 1024, 1),
             ("store_f32", M_L, 3072, 1024, 1))
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
    "ViT-L/14": dict(
        tag="kernels ViT-L/14",
        ln=((M_L, 1024, 3), (13 * 128, 768, 0)),
        gemm=_L14_GEMM,
        ln_bwd=((M_L, 1024, "float32", True, 2), (13 * 128, 768, "float32", True, 0),
                (M_L, 1024, "bfloat16", False, 0)),
        attn=(("vision", 384, 259, 16, False, True),
              ("text packed (16,16)", 13, 128, 12, (16, 16), False),
              ("384 rows", 8, 384, 16, False, False)),
    ),
    # ViT-L/14@336px: the same towers on a 24 x 24 grid, 577 + n_ctx vision
    # rows; the train step at batch 384 recomputes the vision MLP's h as
    # ViT-L/14's does
    "ViT-L/14@336px": dict(
        tag="kernels ViT-L/14@336px",
        ln=((M_336, 1024, 3),),
        gemm=tuple((ep, M_336, K, N, n) for ep, _, K, N, n in _L14_GEMM),
        ln_bwd=((M_336, 1024, "float32", True, 2), (M_336, 1024, "bfloat16", False, 0)),
        attn=(("vision", 384, 579, 16, False, True),),
    ),
}


def randn_fn(seed: int):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(dtype)
    return rn


def check_ln_fwd(F, rn, tag: str, rows: int, D: int, kernel: Kernel, per_layer: int) -> None:
    """layernorm_fwd at (rows, D) against its plain version, timed beside
    F.layer_norm, added ``per_layer`` times to ``kernel``'s totals."""
    import torch
    import torch.nn.functional as tf

    x = rn(rows, D, std=2.0)
    s = rn(D, dtype=torch.float32) * 0.1 + 1
    b = rn(D, dtype=torch.float32) * 0.1
    reading = check_close(f"layernorm {rows}x{D}", F.layer_norm_fwd(x, s, b),
                          F.layer_norm_plain(x, s, b), kernel)
    ms = time_ms(lambda: F.layer_norm_fwd(x, s, b))
    plain = time_ms(lambda: F.layer_norm_plain(x, s, b))
    s16, b16 = s.bfloat16(), b.bfloat16()
    lib = time_ms(lambda: tf.layer_norm(x, (D,), s16, b16, 1e-5))
    bms, by = bound(2 * rows * D * 2 + 2 * D * 4, 0, 8 * rows * D)
    say(tag, f"layernorm_fwd {rows}x{D}: {reading} ms {ms:.4f} plain {plain:.4f} "
             f"library(F.layer_norm) {lib:.4f} bound {bms:.4f} ({by})")
    for _ in range(per_layer):
        kernel.add(ms, plain, lib, bms, by)


def check_ln_bwd(F, rn, tag: str, rows: int, D: int, dxn_name: str, with_r: bool,
                 kernel: Kernel, per_layer: int) -> None:
    """layernorm_bwd at (rows, D) against its plain version, timed beside
    F.layer_norm's backward, added ``per_layer`` times to ``kernel``."""
    import torch
    import torch.nn.functional as tf

    dxn_dt = getattr(torch, dxn_name)
    x = rn(rows, D, std=2.0)
    dxn = rn(rows, D, dtype=dxn_dt)
    s = rn(D, dtype=torch.float32) * 0.1 + 1
    r = rn(rows, D) if with_r else None
    reading = check_close(f"layernorm_bwd {rows}x{D}", F.layer_norm_bwd(dxn, x, s, r),
                          F.layer_norm_bwd_plain(dxn, x, s, r), kernel)
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
        kernel.add(ms, plain, lib, bms, by)


def check_gemm(F, tag: str, ep: str, a, w, bias, extra, kernel: Kernel, per_layer: int,
               out=None, note: str = "") -> None:
    """The GEMM with epilogue ``ep`` against its plain version, timed beside
    one library product, added ``per_layer`` times to ``kernel``.  ``out``:
    the fp32 accumulator of ``add_f32`` (each side adds into a copy); for
    ``chunk_residual``, ``out`` given means y in place, the kernel writing
    into the copy of ``extra`` that it reads."""
    import torch

    w_nk = F.EPILOGUES[ep][1]
    M, K = a.shape
    N = w.shape[0] if w_nk else w.shape[1]
    def launch(schedule="auto"):
        if ep == "add_f32":
            return F._gemm_epilogue(a, w, bias, ep, extra, out.clone(), schedule)
        if out is not None:
            y = extra.clone()
            return F._gemm_epilogue(a, w, bias, ep, y, y, schedule)
        return F._gemm_epilogue(a, w, bias, ep, extra, None, schedule)

    got = launch()
    if ep == "add_f32":
        ref = F.gemm_epilogue_plain(a, w, bias, ep, extra, out.clone())
    else:
        ref = F.gemm_epilogue_plain(a, w, bias, ep, extra)
    # two launches on the same inputs give the same bits (no atomics), and
    # so does every schedule: each output sums its K slices in one order
    for schedule in F._GEMM_SCHEDULES:
        again = launch(schedule)
        for x, y in zip(got if ep == "fc_gelu_save" else (got,),
                        again if ep == "fc_gelu_save" else (again,)):
            check_equal(f"gemm {K}->{N} {ep}, launched again ({schedule})", x, y)
        del again
    if ep == "fc_gelu_save":
        reading = "h " + check_close(f"gemm {ep} h", got[0], ref[0], kernel)
        reading += "; a " + check_close(f"gemm {ep} a", got[1], ref[1], kernel)
    elif ep in F._F32_OUT:
        reading = check_close(f"gemm {K}->{N} {ep}", got, ref, kernel,
                              max_limit=F32_MAX_ERR, norm_limit=F32_NORM_ERR, share_limit=None)
    else:
        reading = check_close(f"gemm {K}->{N} {ep}", got, ref, kernel)
    del got, ref
    # timed in place where the epilogue writes in place (the sums only grow);
    # then each schedule beside the one the shape selects, in an order and
    # its reverse (the card slows as it warms under back-to-back products)
    ms = time_ms(lambda: F.gemm_epilogue(a, w, bias, ep, extra, out))
    schedules = F._GEMM_SCHEDULES[1:]
    by_schedule = dict.fromkeys(schedules, 0.0)
    for sch in schedules + schedules[::-1]:
        by_schedule[sch] += time_ms(
            lambda: F._gemm_epilogue(a, w, bias, ep, extra, out, sch)) / 2
    by_schedule = ", ".join(f"{k} {v:.4f}" for k, v in by_schedule.items())
    plain = time_ms(lambda: F.gemm_epilogue_plain(a, w, bias, ep, extra, out), 3)
    if w_nk:
        lib = time_ms(lambda: torch.matmul(a, w.t()))
        lib_name = "torch.matmul(a, W.t())"
    elif bias is None:
        lib = time_ms(lambda: torch.matmul(a, w))
        lib_name = "torch.matmul"
    else:
        lib = time_ms(lambda: torch.addmm(bias, a, w))
        lib_name = "torch.addmm"
    out_bytes = {"store_f32": 4, "fc_gelu_save": 4, "fc_gelu_grad": 4, "add_f32": 4}.get(ep, 2)
    # add_f32 reads the fp32 accumulator it writes
    extra_bytes = 4 if ep == "add_f32" else 0 if extra is None else extra.element_size()
    nbytes = (M * K + K * N) * 2 + M * N * (out_bytes + extra_bytes)
    bms, by = bound(nbytes + (N * 2 if bias is not None else 0), 2 * M * N * K)
    say(tag, f"gemm_bf16_epilogue {ep} {M}x{K}->{N}{note}: {reading} ms {ms:.4f} "
             f"({2 * M * N * K / ms / 1e9:.1f} TFLOP/s) plain {plain:.4f} "
             f"library({lib_name}) {lib:.4f} bound {bms:.4f} ({by}); schedules: {by_schedule}")
    for _ in range(per_layer):
        kernel.add(ms, plain, lib, bms, by)


def launch_profile(fn, symbol: str = None) -> str:
    """What CUPTI records of one launch in ``fn`` (the kernel whose name
    holds ``symbol``, else the longest): grid, block, registers a thread and
    shared memory a block, read from the profiler's trace (written under
    build/ and removed), and the warps an SM holds at those figures (64 K
    registers and 228 KB of shared memory an SM, 1 KB of it reserved a
    block).  CUPTI's stall reasons are not recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            torch.no_grad():
        fn()
        torch.cuda.synchronize()
    path = Path(__file__).resolve().parent / "build" / "launch_profile.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text()).get("traceEvents", [])
              if e.get("cat") == "kernel" and (symbol is None or symbol in e.get("name", ""))]
    path.unlink()
    if not events:
        return "not recorded"
    e = max(events, key=lambda e: e.get("dur", 0))
    a = e.get("args", {})
    try:
        threads = a["block"][0] * a["block"][1] * a["block"][2]
        regs, smem = a["registers per thread"], a["shared memory"]
    except (KeyError, TypeError, IndexError):
        return f"{e['name'][:48]}: no launch figures"
    blocks = min(65536 // (regs * threads), 233472 // (smem + 1024), 2048 // threads, 32)
    return (f"{e['name'][:48]}: {e.get('dur')} us, grid {a.get('grid')}, {threads} threads, "
            f"{regs} registers, {smem} B shared: {blocks} blocks, "
            f"{blocks * threads // 32} warps an SM")


def gemm_operands(F, rn, ep: str, M: int, K: int, N: int) -> tuple:
    """Seeded (a, W, bias, second operand) of a GEMM epilogue: the forward
    epilogues take W (K, N), the backward ones W (N, K), read transposed."""
    import torch

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
    return a, w, bias, extra


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
        check_ln_fwd(F, rn, tag, rows, D, kernels["layernorm_fwd"], per_layer)

    # ---- GEMM with each epilogue at the vision shapes
    for ep, M, K, N, per_layer in spec["gemm"]:
        a, w, bias, extra = gemm_operands(F, rn, ep, M, K, N)
        check_gemm(F, tag, ep, a, w, bias, extra, kernels["gemm_bf16_epilogue"], per_layer)
        del a, w, extra

    # ---- LayerNorm dx: the layer's two (fp32 dxn, with a residual), at the
    # vision shape (2 per layer) and the packed text rows; a tower LayerNorm
    # (bf16 dxn, no residual) at the vision shape
    for rows, D, dxn_name, with_r, per_layer in spec["ln_bwd"]:
        check_ln_bwd(F, rn, tag, rows, D, dxn_name, with_r, kernels["layernorm_bwd"], per_layer)

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
        got = F.attention_bwd(qkv, do, H, causal)
        reading = check_close(f"attention_bwd {label}", got,
                              F.attention_bwd_plain(qkv, do, H, causal), kernels["attention_bwd"])
        # no float atomics: a second launch gives the same bits
        check_equal(f"attention_bwd {label}, launched twice", got,
                    F.attention_bwd(qkv, do, H, causal))
        del got
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


# each vision tower's attention block: model, rows, heads
ATTN_PROFILE_SHAPES = (("ViT-B/16", 199, 12), ("ViT-L/14", 259, 16), ("ViT-L/14@336px", 579, 16))


def phase_attention_profiles(F) -> None:
    """CUPTI's launch figures of attention_fwd and of SDPA at each vision
    tower's block.  Run early: in the later phases the profiler's trace
    held no kernel events."""
    import torch.nn.functional as tf

    rn = randn_fn(9)
    for model, S, H in ATTN_PROFILE_SHAPES:
        qkv = rn(BATCH, S, 3 * 64 * H)
        q, k, v = qkv.view(BATCH, S, 3, H, 64).permute(2, 0, 3, 1, 4)
        say("kernels", f"launch profile {model} {BATCH} x {S}, {H} heads: attention_fwd "
                       f"{launch_profile(lambda: F.attention_fwd(qkv, H), 'attention_fwd')}; "
                       f"sdpa {launch_profile(lambda: tf.scaled_dot_product_attention(q, k, v))}")
        del qkv, q, k, v
    # attention_bwd's two kernels at the text tower's causal 16-row blocks
    qkv, do = rn(100, 16, 3 * 64 * 8), rn(100, 16, 64 * 8, std=0.1)
    say("kernels", "launch profile text causal 100 x 16, 8 heads: attention_bwd " + "; ".join(
        launch_profile(lambda: F.attention_bwd(qkv, do, 8, True), sym)
        for sym in ("attn_bwd_query_kernel", "attn_bwd_key_kernel")))

# the attention kernels' block lengths: one query and key tile (<= 64 rows),
# the tiles resident (attention_fwd to 768 rows, attention_bwd to 640) and
# streamed past that
ATTN_SWEEP_S = (16, 40, 64, 128, 199, 259, 384, 579, 769, 1024)


def phase_attention_sweep(F) -> None:
    """attention_fwd and attention_bwd against their plain versions at every
    block length of the models and past the resident limits, every mask
    spec (none, causal, packed (S, S - 7) and (16, 11)), attention_fwd's
    both output forms; 4 sequences of 2 heads each."""
    rn = randn_fn(8)
    for S in ATTN_SWEEP_S:
        readings = []
        for mask in (False, True, (S, S - 7), (16, 11)):
            if S % mask[0] if isinstance(mask, tuple) else False:
                continue
            qkv = rn(4, S, 3 * 128)
            do = rn(4, S, 128, std=0.1)
            check_close(f"attention_bwd S={S} mask={mask}", F.attention_bwd(qkv, do, 2, mask),
                        F.attention_bwd_plain(qkv, do, 2, mask))
            readings.append(f"{mask}/bwd")
            for f32 in (False, True):
                what = f"attention_fwd S={S} mask={mask} {'fp32' if f32 else 'bf16'}"
                got, ref = F.attention_fwd(qkv, 2, mask, f32), F.attention_plain(qkv, 2, mask, f32)
                if f32:
                    check_close(what, got, ref, max_limit=ATTN_F32_MAX_ERR,
                                norm_limit=ATTN_F32_NORM_ERR, share_limit=None)
                else:
                    check_close(what, got, ref)
                readings.append(f"{mask}/{'f32' if f32 else 'bf16'}")
        say("kernels", f"attention S={S}: within limits for {', '.join(readings)}")


def layer_params(rn, D: int) -> list:
    """The twelve weights of a layer at width D, seeded."""
    import torch

    return [rn(D, dtype=torch.float32) * 0.1 + 1, rn(D, dtype=torch.float32) * 0.1,
            rn(D, 3 * D, std=D ** -0.5), rn(3 * D, std=0.1), rn(D, D, std=D ** -0.5),
            rn(D, std=0.1), *mlp_params(rn, D)]


def mlp_params(rn, D: int) -> list:
    """The six weights of an MLP half at width D (hidden 4D), seeded."""
    import torch

    return [rn(D, dtype=torch.float32) * 0.1 + 1, rn(D, dtype=torch.float32) * 0.1,
            rn(D, 4 * D, std=D ** -0.5), rn(4 * D, std=0.1), rn(4 * D, D, std=(4 * D) ** -0.5),
            rn(D, std=0.1)]


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


# the int8 kernels' cases at the ViT-B/16 shapes; the last two fields of a
# case: its launches in one vision layer of the int8 and of the int8_static
# request.  LayerNorm-quant: rows, D, static
Q8_LN = ((M_B, 768, False, 2, 0), (M_B, 768, True, 0, 2), (13 * 128, 512, False, 0, 0))
# the row quantizer: rows, X (the attention output, g), static
Q8_ROWS = ((M_B, 768, False, 1, 0), (M_B, 3072, False, 1, 0), (M_B, 768, True, 0, 1))
# the s8 GEMM: epilogue, M, K, N, h saved (the quantization-aware forward)
Q8_GEMM = (("q8_qkv", M_B, 768, 2304, False, 1, 0), ("q8_residual", M_B, 768, 768, False, 1, 0),
           ("q8_fc_gelu", M_B, 768, 3072, False, 1, 0), ("q8_fc_gelu", M_B, 768, 3072, True, 0, 0),
           ("q8_residual", M_B, 3072, 768, False, 1, 0), ("q8s_qkv", M_B, 768, 2304, False, 0, 1),
           ("q8s_residual", M_B, 768, 768, False, 0, 1),
           ("q8s_fc_gelu", M_B, 768, 3072, False, 0, 1), ("q8s_fc_gelu", M_B, 768, 3072, True, 0, 0),
           ("q8s_residual", M_B, 3072, 768, False, 0, 1))
# fp32 operations of the GEMM's epilogue per output element (dequant, bias,
# conversion or residual add; QuickGELU's exp and division counted as one each)
Q8_EPILOGUE_OPS = {"qkv": 4, "residual": 5, "fc_gelu": 9}
# every s8 epilogue at M, K, N that are no multiples of the kernel's tile
S8_RAGGED = tuple((f"{kind}_{ep}", save) for kind in ("q8", "q8s")
                  for ep, save in (("qkv", False), ("residual", False), ("fc_gelu", False),
                                   ("fc_gelu", True)))
S8_RAGGED_MKN = (1000, 80, 784)


def _per_layer(kernels: tuple, counts: tuple, *times) -> None:
    for k, n in zip(kernels, counts):
        for _ in range(n):
            k.add(*times)


def s8_case(Q, rn, ep: str, M: int, K: int, N: int, save: bool, kern: Kernel = None) -> tuple:
    """One s8 GEMM epilogue against its plain version on seeded operands:
    (the call's arguments, the reading).  qkv, residual and the saved h are
    held bit-equal, g within F32_MAX_ERR, the static codes within a step."""
    import torch

    one = lambda v: torch.full((), v, dtype=torch.float32, device="cuda")  # noqa: E731
    static = ep.startswith("q8s_")
    x32 = rn(M, K, dtype=torch.float32)
    wq, ws = Q.quantize_cols(rn(K, N, std=K ** -0.5))
    wq = wq.t().contiguous()
    if static:  # per-tensor codes, the site's dequant factor folded into ws
        amax = x32.abs().amax()
        a, xs = Q.quantize_rows_plain(x32, one(127.0) / amax)[0], None
        ws = ws * (amax / 127.0)
    else:
        a, xs = Q.quantize_rows_plain(x32)
    del x32
    bias = rn(N, std=0.1)
    extra = rn(M, N) if ep.endswith("residual") else None
    r = None
    if ep == "q8s_fc_gelu":
        v = Q._s8_matmul(a, wq) * ws + bias.float()
        r = one(127.0) / (v * torch.sigmoid(1.702 * v)).abs().amax()
        del v
    args = (a, xs, wq, ws, bias, ep, extra, r, save)
    got, ref = Q.gemm_s8(*args), Q.gemm_s8_plain(*args)
    what = f"gemm_s8 {ep} {M}x{K}->{N}"
    reading = ""
    if save:
        reading = "h " + check_equal(f"{what} h", got[0], ref[0], kern) + "; "
        got, ref = got[1], ref[1]
    if ep == "q8_fc_gelu":
        reading += "g " + check_close(f"{what} g", got, ref, kern, max_limit=F32_MAX_ERR,
                                      norm_limit=F32_NORM_ERR, share_limit=None)
        # g's codes, as quant_rows (held on its own above) would make them
        reading += "; g's codes " + check_codes(f"{what} g's codes",
                                                 Q.quantize_rows_plain(got)[0],
                                                 Q.quantize_rows_plain(ref)[0])
    elif ep == "q8s_fc_gelu":
        reading += "codes " + check_codes(what, got, ref, kern)
    else:
        reading += check_equal(what, got, ref, kern)
    return args, reading


def phase_kernels_int8(F, Q, kq: dict, kqs: dict) -> None:
    """Every int8 kernel against its plain version at the ViT-B/16 shapes:
    LayerNorm-quant, the row quantizer (with a probe of exact ties), each
    s8 GEMM epilogue, and attention_fwd's fp32 output."""
    import torch
    import torch.nn.functional as tf

    tag = "kernels int8"
    rn = randn_fn(4)
    one = lambda v: torch.full((), v, dtype=torch.float32, device="cuda")  # noqa: E731

    for rows, D, static, n_dyn, n_st in Q8_LN:
        x = rn(rows, D, std=2.0)
        s = rn(D, dtype=torch.float32) * 0.1 + 1
        b = rn(D, dtype=torch.float32) * 0.1
        r = one(127.0) / F.layer_norm_plain(x, s, b).float().abs().amax() if static else None
        (q, sc), (q_ref, sc_ref) = Q.ln_quant(x, s, b, r), Q.ln_quant_plain(x, s, b, r)
        reading = check_codes(f"layernorm_q8 {rows}x{D}", q, q_ref, kq["layernorm_q8"])
        if not static:
            reading += "; scales " + check_close(f"layernorm_q8 {rows}x{D} scales", sc, sc_ref,
                                                 max_limit=LN_SCALE_ERR, norm_limit=LN_SCALE_ERR,
                                                 share_limit=None)
        ms = time_ms(lambda: Q.ln_quant(x, s, b, r))
        plain = time_ms(lambda: Q.ln_quant_plain(x, s, b, r), 3)
        bms, by = bound(rows * D * 3 + rows * 4 + 2 * D * 4, 0, 12 * rows * D)
        say(tag, f"layernorm_q8 {rows}x{D} {'static' if static else 'dynamic'}: {reading} "
                 f"ms {ms:.4f} plain {plain:.4f} library none bound {bms:.4f} ({by})")
        _per_layer((kq["layernorm_q8"], kqs["layernorm_q8"]), (n_dyn, n_st), ms, plain, None,
                   bms, by)
        del x, q, q_ref

    for rows, X, static, n_dyn, n_st in Q8_ROWS:
        x = rn(rows, X, dtype=torch.float32)
        r = one(127.0) / x.abs().amax() if static else None
        (q, sc), (q_ref, sc_ref) = Q.quantize_rows(x, r), Q.quantize_rows_plain(x, r)
        reading = check_equal(f"quant_rows {rows}x{X}", q, q_ref, kq["quant_rows"])
        if not static:
            reading += "; scales " + check_equal(f"quant_rows {rows}x{X} scales", sc, sc_ref)
        ms = time_ms(lambda: Q.quantize_rows(x, r))
        plain = time_ms(lambda: Q.quantize_rows_plain(x, r), 3)
        bms, by = bound(rows * X * 5 + rows * 4, 0, 5 * rows * X)
        say(tag, f"quant_rows {rows}x{X} {'static' if static else 'dynamic'}: {reading} "
                 f"ms {ms:.4f} plain {plain:.4f} library none bound {bms:.4f} ({by})")
        _per_layer((kq["quant_rows"], kqs["quant_rows"]), (n_dyn, n_st), ms, plain, None, bms, by)
        del x, q, q_ref
    # exact ties, rint's half-to-even: rows of k + 1/2 whose largest value is
    # 127, so the dynamic scale is 1 and x / s lands on the tie; static r = 1
    k = torch.randint(-127, 127, (64, 768), device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(5))
    ties = k.float() + 0.5
    ties[:, 0] = 127.0
    for r in (None, one(1.0)):
        reading = check_equal("quant_rows ties", Q.quantize_rows(ties, r)[0],
                              Q.quantize_rows_plain(ties, r)[0], kq["quant_rows"])
        say(tag, f"quant_rows 64x768 of exact ties, {'static' if r is not None else 'dynamic'}: "
                 f"{reading}")

    for ep, M, K, N, save, n_dyn, n_st in Q8_GEMM:
        static = ep.startswith("q8s_")
        kern = kq["gemm_s8_epilogue"] if not static else kqs["gemm_s8_epilogue"]
        args, reading = s8_case(Q, rn, ep, M, K, N, save, kern)
        a, wq, extra = args[0], args[2], args[6]
        ms = time_ms(lambda: Q.gemm_s8(*args))
        plain = time_ms(lambda: Q.gemm_s8_plain(*args), 3)
        lib = time_ms(lambda: torch._int_mm(a, wq.t()))  # the yardstick: int32 out, no epilogue
        out_bytes = {"q8_fc_gelu": 4, "q8s_fc_gelu": 1}.get(ep, 2)
        nbytes = (M * K + N * K + M * N * (out_bytes + (2 if extra is not None or save else 0))
                  + (0 if static else M * 4) + N * 6)
        e_ops = Q8_EPILOGUE_OPS[ep.split("_", 1)[1]] - static
        bms, by = bound(nbytes, 0, e_ops * M * N, 2 * M * N * K)
        say(tag, f"gemm_s8_epilogue {ep}{' save h' if save else ''} {M}x{K}->{N}: {reading} "
                 f"ms {ms:.4f} ({2 * M * N * K / ms / 1e9:.1f} TOP/s) plain {plain:.4f} "
                 f"library(torch._int_mm) {lib:.4f} "
                 f"bound {bms:.4f} ({by})")
        _per_layer((kq["gemm_s8_epilogue"], kqs["gemm_s8_epilogue"]), (n_dyn, n_st), ms, plain,
                   lib, bms, by)
        del a, wq, extra, args
    # the ragged tile edges (tiles of 128 rows, 256 columns, 128 of K): the
    # product's K tail and the rows past M arrive as TMA's zeros, the
    # columns past N are cut from the ws and bias loads and the stores
    for ep, save in S8_RAGGED:
        M, K, N = S8_RAGGED_MKN
        _, reading = s8_case(Q, rn, ep, M, K, N, save)
        say(tag, f"gemm_s8_epilogue {ep}{' save h' if save else ''} {M}x{K}->{N}: {reading}")

    # attention's fp32 output, the int8 layers' accumulator, and its codes
    for label, B, S, H, causal, per_layer in (("vision", BATCH, 199, 12, False, 1),
                                              ("text packed (16,16)", 13, 128, 8, (16, 16), 0)):
        D = 64 * H
        qkv = rn(B, S, 3 * D)
        got, ref = F.attention_fwd(qkv, H, causal, True), F.attention_plain(qkv, H, causal, True)
        reading = check_close(f"attention_fwd fp32 {label}", got, ref, kq["attention_fwd"],
                              max_limit=ATTN_F32_MAX_ERR, norm_limit=ATTN_F32_NORM_ERR,
                              share_limit=None)
        reading += "; codes " + check_codes(f"attention_fwd fp32 {label} codes",
                                            Q.quantize_rows_plain(got)[0],
                                            Q.quantize_rows_plain(ref)[0])
        del got, ref
        ms = time_ms(lambda: F.attention_fwd(qkv, H, causal, True))
        plain = time_ms(lambda: F.attention_plain(qkv, H, causal, True), 3)
        L, is_causal, valid = F._block_spec(S, causal)
        n = B * (S // L)
        pairs = sum(min(i + 1, valid) if is_causal else valid for i in range(L))
        q, k_, v = qkv.view(n, L, 3, H, 64).permute(2, 0, 3, 1, 4)
        mask = None
        if isinstance(causal, tuple):
            i = torch.arange(L, device=qkv.device)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] < valid)
        lib = time_ms(lambda: tf.scaled_dot_product_attention(q, k_, v, attn_mask=mask))
        bms, by = bound(B * S * D * (3 * 2 + 4), 4 * 64 * pairs * n * H, 5 * pairs * n * H)
        say(tag, f"attention_fwd fp32 out {label} B={B} S={S} H={H}: {reading} ms {ms:.4f} "
                 f"plain {plain:.4f} library(sdpa, bf16 out) {lib:.4f} bound {bms:.4f} ({by})")
        if per_layer:
            kq["attention_fwd"].add(ms, plain, lib, bms, by)
        del qkv, q, k_, v


def q8_block(ps: list) -> dict:
    """The twelve layer weights as a block's parameter tree."""
    names = (("ln_1", "scale"), ("ln_1", "bias"), ("attn", "qkv_w"), ("attn", "qkv_b"),
             ("attn", "out_w"), ("attn", "out_b"), ("ln_2", "scale"), ("ln_2", "bias"),
             ("mlp", "fc_w"), ("mlp", "fc_b"), ("mlp", "proj_w"), ("mlp", "proj_b"))
    blk = {}
    for (group, name), p in zip(names, ps):
        blk.setdefault(group, {})[name] = p
    return blk


def phase_q8_chains(F, Q, layers) -> None:
    """The four int8 layer chains against their plain versions at the
    ViT-B/16 vision shape and the packed text rows: the dynamic and the
    static serving forward, the saving forwards, and the quantization-aware
    forward with its backward, h and qkv saved and recomputed."""
    import torch

    tag = "kernels int8"
    rn = randn_fn(6)
    for label, B, S, D, H, causal in (("vision", BATCH, 199, 768, 12, False),
                                      ("text packed", 13, 128, 512, 8, (16, 16))):
        x = rn(B, S, D)
        ps = layer_params(rn, D)
        blk = q8_block(ps)
        amax = Q.calibrate(lambda: layers.residual_block(blk, x, H, causal))[0]
        qw = Q.quantize_weights(blk)
        qp = Q._quantize_layer(ps, qw)
        qps, r = Q._quantize_layer_static(ps, amax, qw)
        serve = {}
        for tier, fn, ops in (("int8", Q.layer_fullblock_q8, (*qp,)),
                              ("int8_static", Q.layer_fullblock_q8_static, (*qps, r))):
            y, y_ref = fn(x, *ops, H, causal), fn(x, *ops, H, causal, plain=True)
            reading = check_close(f"{tier} layer {label}", y, y_ref, share_limit=None)
            serve[tier] = y
            ms = time_ms(lambda: fn(x, *ops, H, causal))
            plain = time_ms(lambda: fn(x, *ops, H, causal, plain=True), 2)
            say(tag, f"{tier} layer {label} B={B} S={S} D={D} mask={causal}: {reading} "
                     f"ms {ms:.4f} plain {plain:.4f}")
            rs = None if tier == "int8" else r
            got = Q.q8_save_forward(x, qps if rs is not None else qp, H, causal, rs)
            ref = Q.q8_save_forward(x, qps if rs is not None else qp, H, causal, rs, plain=True)
            check_equal(f"{tier} saving forward {label}: y vs the serving forward", got[0], y)
            readings = [f"{n} " + check_close(f"{tier} saving forward {label} {n}", g, w,
                                              share_limit=None)
                        for n, g, w in zip(("y", "y1", "qkv", "h"), got, ref)]
            say(tag, f"{tier} saving forward {label}: " + "; ".join(readings))
            del y, y_ref, got, ref

        xg = x.detach().requires_grad_(True)
        gy = rn(B, S, D)
        for tier in ("int8_ste", "int8_ste_static"):
            for save in (True, False):
                def step(plain_fns):
                    with F.saved_acts(save):
                        if tier == "int8_ste":
                            y = Q.layer_fullblock_q8_ste(xg, *ps, H, causal, plain_fns, qw)
                        else:
                            y = Q.layer_fullblock_q8_ste_static(xg, amax, *ps, H, causal,
                                                                plain_fns, qw)
                    if (y.grad_fn.saved_tensors[1] is not None) != save:
                        raise AssertionError(f"{tier} save={save}: wrong route")
                    return y, torch.autograd.grad(y, xg, gy)[0]

                (y, dx), (y_ref, dx_ref) = step(False), step(True)
                what = f"{tier} {label} {'saved' if save else 'recomputed'}"
                served = serve["int8" if tier == "int8_ste" else "int8_static"]
                check_equal(f"{what}: y vs the serving forward", y.detach(), served)
                r_y = check_close(f"{what} y", y, y_ref, share_limit=None)
                r_dx = check_close(f"{what} dx", dx, dx_ref, max_limit=LAYER_DX_MAX_ERR,
                                   norm_limit=LAYER_DX_NORM_ERR, share_limit=None)
                del y, dx, y_ref, dx_ref
                ms = time_ms(lambda: step(False), 5)
                plain = time_ms(lambda: step(True), 1)
                say(tag, f"{what} forward + backward: y {r_y}; dx {r_dx}; ms {ms:.4f} "
                         f"plain {plain:.4f}")
        del x, xg, gy, ps, blk, qw, qp, qps, serve


# the chunked MLP half (mlp_halfblock_chunked): its kernels at ViT-L/14's
# vision rows and chunk (D 1024, hidden 4096 in 8 chunks of 512), per call
# of its forward and backward; then the op at three shapes: ViT-L/14's
# vision MLP, ViT-B/16's (2 chunks of 1536) and one width above 1024, the
# ViT family's next (ViT-H/14's 1280, 10 chunks of 512: a shape, not a
# model of the repository), at batch 128
M_H = 128 * 259
CHUNK_D, CHUNK_DH = 1024, 4096
CHUNKED = (("ViT-L/14", BATCH, 259, 1024), ("ViT-B/16", BATCH, 199, 768),
           ("D=1280", 128, 259, 1280))


def chunked_launches(K: int) -> tuple:
    """Launches of one call of the chunked MLP half over K chunks: the
    forward (LN, then the fc and proj products of each chunk) and the
    backward (LN again; per chunk fc_gelu_grad, mul_f32 and the dxn
    product; LN dx)."""
    return (dict(layernorm_fwd=1, gemm_bf16_epilogue=2 * K, mlp_halfblock_chunked=1),
            dict(layernorm_fwd=1, gemm_bf16_epilogue=3 * K, layernorm_bwd=1,
                 mlp_halfblock_chunked_bwd=1))


def phase_kernels_chunked(F, kc: dict) -> dict:
    """The chunked MLP half: LayerNorm forward and dx at D = 1024 and 1280;
    each GEMM of its chain at ViT-L/14's chunk, the fc weight's column
    chunk read in place (strided rows); then the op against its plain
    version at the three CHUNKED shapes, forward and forward + backward,
    launches per call asserted, and its time beside mlp_halfblock's at
    ViT-L/14.  Returns the launches of the op's forward and of its backward
    at ViT-L/14 ({path: counts})."""
    import torch

    tag = "kernels chunked"
    rn = randn_fn(7)
    D, Dh = CHUNK_D, CHUNK_DH
    c = F._pick_chunk(Dh, D)
    K = Dh // c
    # LayerNorm: twice per call (the forward's and the backward's), dx once
    check_ln_fwd(F, rn, tag, M_L, D, kc["layernorm_fwd"], 2)
    check_ln_fwd(F, rn, tag, M_H, 1280, kc["layernorm_fwd"], 0)
    check_ln_bwd(F, rn, tag, M_L, D, "float32", True, kc["layernorm_bwd"], 1)
    check_ln_bwd(F, rn, tag, M_H, 1280, "float32", True, kc["layernorm_bwd"], 0)

    # the chain's GEMMs at the second chunk (a column chunk off the start of
    # fc_w, 16-byte aligned): per call K each, the first chunk's proj and
    # dxn products once, the others' K - 1 times
    kern = kc["gemm_bf16_epilogue"]
    cols = slice(c, 2 * c)
    fc_w, fc_b = rn(D, Dh, std=D ** -0.5), rn(Dh, std=0.1)
    proj_w, proj_b = rn(Dh, D, std=Dh ** -0.5), rn(D, std=0.1)
    xn, x, g = rn(M_L, D), rn(M_L, D), rn(M_L, D)
    act, dh = rn(M_L, c), rn(M_L, c)
    factor = F.quick_gelu_grad(rn(M_L, c, std=2.0, dtype=torch.float32))
    dxn = rn(M_L, D, dtype=torch.float32)
    chunk = f", W a column chunk of ({D}, {Dh})"
    check_gemm(F, tag, "fc_gelu", xn, fc_w[:, cols], fc_b[cols], None, kern, K, note=chunk)
    check_gemm(F, tag, "chunk_residual", act, proj_w[cols], proj_b, x, kern, 1,
               note=", first chunk: r = x, + proj_b")
    check_gemm(F, tag, "chunk_residual", act, proj_w[cols], None, x, kern, K - 1, out=x,
               note=", y in place")
    check_gemm(F, tag, "fc_gelu_grad", xn, fc_w[:, cols], fc_b[cols], None, kern, K, note=chunk)
    check_gemm(F, tag, "mul_f32", g, proj_w[cols], None, factor, kern, K)
    check_gemm(F, tag, "store_f32", dh, fc_w[:, cols], None, None, kern, 1, note=chunk)
    check_gemm(F, tag, "add_f32", dh, fc_w[:, cols], None, None, kern, K - 1, out=dxn,
               note=chunk + ", into the fp32 dxn")
    del fc_w, fc_b, proj_w, proj_b, xn, x, g, act, dh, factor, dxn

    paths = {}
    for label, B, S, D in CHUNKED:
        K = 4 * D // F._pick_chunk(4 * D, D)
        n_fwd, n_bwd = chunked_launches(K)
        x = rn(B, S, D)
        ps = mlp_params(rn, D)
        F.reset_launches()
        y = F.mlp_halfblock_chunked(x, *ps)
        if dict(F.LAUNCHES) != expect(F.LAUNCHES, (1, n_fwd)):
            raise AssertionError(f"mlp_halfblock_chunked {label}: launches {dict(F.LAUNCHES)}")
        reading = check_close(f"mlp_halfblock_chunked {label} y", y,
                              F.mlp_halfblock_chunked_plain(x, *ps), norm_limit=CHUNK_Y_NORM_ERR,
                              share_limit=None)
        del y
        ms = time_ms(lambda: F.mlp_halfblock_chunked(x, *ps))
        plain = time_ms(lambda: F.mlp_halfblock_chunked_plain(x, *ps), 3)
        say(tag, f"mlp_halfblock_chunked {label} B={B} S={S} D={D} K={K}: {reading} "
                 f"ms {ms:.4f} plain {plain:.4f}")

        xg = x.detach().requires_grad_(True)
        gy = rn(B, S, D)

        def step(plain_fns):
            y = F.mlp_halfblock_chunked(xg, *ps, plain=plain_fns)
            return y, torch.autograd.grad(y, xg, gy)[0]

        F.reset_launches()
        y = F.mlp_halfblock_chunked(xg, *ps)
        counts_f = dict(F.LAUNCHES)
        F.reset_launches()
        dx = torch.autograd.grad(y, xg, gy)[0]
        counts_b = dict(F.LAUNCHES)
        if counts_f != expect(F.LAUNCHES, (1, n_fwd)) or counts_b != expect(F.LAUNCHES, (1, n_bwd)):
            raise AssertionError(f"mlp_halfblock_chunked {label}: launches forward {counts_f}, "
                                 f"backward {counts_b}")
        y_ref, dx_ref = step(True)
        r_y = check_close(f"mlp_halfblock_chunked {label} y (saving forward)", y, y_ref,
                          norm_limit=CHUNK_Y_NORM_ERR, share_limit=None)
        r_dx = check_close(f"mlp_halfblock_chunked {label} dx", dx, dx_ref,
                           max_limit=LAYER_DX_MAX_ERR, norm_limit=LAYER_DX_NORM_ERR,
                           share_limit=None)
        del y, dx, y_ref, dx_ref
        ms_t = time_ms(lambda: step(False), 5)
        plain_t = time_ms(lambda: step(True), 2)
        say(tag, f"mlp_halfblock_chunked forward + backward {label}: y {r_y}; dx {r_dx}; "
                 f"ms {ms_t:.4f} plain {plain_t:.4f}; launches per call: forward "
                 f"{ {k: v for k, v in counts_f.items() if v} }, backward "
                 f"{ {k: v for k, v in counts_b.items() if v} }")
        if label == "ViT-L/14":
            paths["mlp_halfblock_chunked"], paths["mlp_halfblock_chunked_bwd"] = counts_f, counts_b
            # the monolithic half's chain on the same inputs, h recomputed
            # in its backward as the chunked op recomputes h32
            half_f = time_ms(lambda: F.mlp_halfblock(x, *ps))
            F.set_save_mlp_wide("0")
            try:
                half_t = time_ms(lambda: torch.autograd.grad(F.mlp_halfblock(xg, *ps), xg, gy), 5)
            finally:
                F.set_save_mlp_wide("auto")
            say(tag, f"at ViT-L/14: forward chunked {ms:.4f} ms, mlp_halfblock {half_f:.4f} ms; "
                     f"forward + backward chunked {ms_t:.4f} ms, mlp_halfblock (h recomputed) "
                     f"{half_t:.4f} ms")
        del x, xg, gy, ps
    return paths


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

    by_kernel = {"gemm_bf16_kernel": 0.0, "gemm_s8_kernel": 0.0,
                 "attention_fwd_wgmma_kernel": 0.0,
                 "layernorm_fwd_kernel": 0.0, "layernorm_q8_kernel": 0.0,
                 "quant_rows_kernel": 0.0, "other": 0.0}
    others = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops also report their kernels' time
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        key = next((k for k in by_kernel if k in e.key), "other")
        by_kernel[key] += us
        if key == "other" and us > 0:
            others[e.key[:60]] = us
    return {k: v for k, v in by_kernel.items() if v or k == "other"}, {}, others


def phase_name(kind: str, model: str, quant: str) -> str:
    return " ".join([kind] + ([model] if model != "ViT-B/16" else [])
                    + ([quant] if quant != "none" else []))


def phase_serving(F, model: str, quant: str = "none") -> dict:
    import torch

    from mudpt_torch.models.layers import plain_blocks
    from mudpt_torch.trainers.mudpt import mudpt_image_logits, mudpt_text_features
    from mudpt_torch.utils.synth_step import build_synth_mudpt_server

    phase = phase_name("serving", model, quant)
    t0 = time.perf_counter()
    st = build_synth_mudpt_server(model, BATCH, N_CLS, N_CTX, DEPTH, seed=0, quant=quant)
    torch.cuda.synchronize()
    say(phase, f"built {model} server (random weights, seed 0, quant {quant}) in "
               f"{time.perf_counter() - t0:.2f} s; text rows {tuple(st.aux['token_suffix'].shape)}")
    if st.quantize_s is not None:
        say(phase, f"both towers' weights quantized once, per output channel into (Dout, Din) "
                   f"int8: {st.quantize_s * 1e3:.2f} ms")
    if st.calibration_s is not None:
        say(phase, f"calibration (text encoded under int8, then both towers' activation "
                   f"absmax on the plain route) {st.calibration_s:.3f} s")
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
    text = "full"
    if quant != "none":  # every layer of both towers runs the tier's int8 chain
        vision = text = Q8_ROUTES[quant]
    want_text = expect(F.LAUNCHES, (cfg.transformer_layers, text), (1, tower_lns(1)))
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
    if quant != "none":
        # printed, not held: how often int8 serving picks the bf16 tier's class
        kw = dict(clip_cfg=cfg, compute_dtype=torch.bfloat16)
        with torch.inference_mode():
            txt16 = mudpt_text_features(tr, params, aux, **kw)
            logits16 = mudpt_image_logits(tr, params, aux, images, txt16, **kw)
        same = (logits.argmax(-1) == logits16.argmax(-1)).float().mean().item()
        say(phase, f"top-1 agreement with the bf16 tier on the same weights: {same:.4f}; "
                   f"logits max abs difference {(logits - logits16).abs().max().item():.4g}")
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
        gemm = re.search(r"gemm_bf16_kernel<(\d+), (\d+)>", e.key)
        if gemm:  # <epilogue, schedule>; epilogues 0-3 and 9 are the forward ones
            mode = int(gemm.group(1))
            name, bwd = f"gemm_bf16_kernel<{mode}, {gemm.group(2)}>", mode >= 4 and mode != 9
        else:
            name = next((k for k in ("layernorm_fwd_kernel", "attention_fwd_wgmma_kernel",
                                     "layernorm_bwd_kernel", "attn_bwd_query_kernel",
                                     "attn_bwd_key_kernel",
                                     "gemm_s8_kernel", "layernorm_q8_kernel",
                                     "quant_rows_kernel")
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
    ratio_limit = GRAD_FP32_RATIO_L14 if st.clip_cfg.vision_layers > GRAD_DEPTH else GRAD_FP32_RATIO
    say(phase, f"{label} vs plain path on the card: loss {loss:.6f} vs {loss_ref:.6f} "
               f"(rel {rel:.3g}); gradient relative norm errors, kernels vs plain, limit "
               f"{limit:.4g} (kernels vs fp32 / plain vs fp32): " + ", ".join(parts)
               + f"; worst ratio {worst_ratio:.4f} (limit {ratio_limit})")
    if not (rel <= LOSS_REL_ERR and worst <= limit and worst_ratio <= ratio_limit):
        raise AssertionError(f"{label} vs plain path: loss rel err {rel} (limit "
                             f"{LOSS_REL_ERR}), worst gradient norm err {worst} (limit "
                             f"{limit}), worst ratio of distances to fp32 "
                             f"{worst_ratio} (limit {ratio_limit})")


def step_launches(F, cfg, text_route: str, vision_route: str) -> dict:
    """Launches of one train step: both towers' layers, and ln_pre,
    ln_post, ln_final forward and backward."""
    return expect(F.LAUNCHES, (cfg.transformer_layers, text_route),
                  (cfg.vision_layers, vision_route), (1, tower_lns(3, 3)))


def phase_train(F, model: str, quant: str = "none") -> dict:
    import torch

    from mudpt_torch.utils.synth_step import build_synth_mudpt_step, leaves

    phase = phase_name("train", model, quant)
    if model in ("ViT-L/14", "ViT-L/14@336px"):
        # ---- gradients at batch 32, where an fp32 plain step fits: the
        # vision MLP recomputing h (its "0" mode), as at batch 384; then, at
        # ViT-L/14, 2,560 classes, whose text tower trains with saves off
        # while the vision MLP saves h (the 336px text tower is the same)
        F.set_save_mlp_wide("0")
        try:
            st = build_synth_mudpt_step(model, GRAD_BATCH, N_CLS, N_CTX, DEPTH, seed=0)
            grad_check(F, st, phase, f"one step at batch {GRAD_BATCH}, h recomputed",
                       step_launches(F, st.clip_cfg, "full_train", "half_train_recompute_h"))
        finally:
            F.set_save_mlp_wide("auto")
        del st
        if model == "ViT-L/14":
            st = build_synth_mudpt_step(model, GRAD_BATCH, SAVES_OFF_N_CLS, N_CTX, DEPTH, seed=0)
            grad_check(F, st, phase, f"one step at batch {GRAD_BATCH}, {SAVES_OFF_N_CLS} "
                                     "classes (text saves off, h saved)",
                       step_launches(F, st.clip_cfg, "half_train_saves_off", "half_train"))
            del st
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    st = build_synth_mudpt_step(model, BATCH, N_CLS, N_CTX, DEPTH, seed=0, quant=quant)
    torch.cuda.synchronize()
    tr = leaves(st.trainable)
    cfg = st.clip_cfg
    say(phase, f"built {model} train step (random weights, seed 0, quant {quant}) in "
               f"{time.perf_counter() - t0:.2f} s; {len(tr)} trainable leaves, "
               f"{sum(t.numel() for t in tr)} values")
    if st.quantize_s is not None:
        say(phase, f"both towers' weights quantized once: {st.quantize_s * 1e3:.2f} ms")
    if st.calibration_s is not None:
        say(phase, f"calibration (both towers' activation absmax on the plain route) "
                   f"{st.calibration_s:.3f} s")
    # the text tower (768 wide or less, 100 classes) saves and runs whole
    # layers; the vision tower too at ViT-B; at ViT-L its halves, the MLP's
    # h over the row-token budget at batch 384, so recomputed.  Under a
    # quantization-aware tier every layer saves and runs its int8 chain
    text_route = "full_train"
    if quant != "none":
        vision_route = text_route = Q8_ROUTES[quant]
    elif cfg.vision_width <= F.FULLBLOCK_MAX_WIDTH:
        vision_route = "full_train"
    elif F.wide_mlp_save(BATCH * cfg.vision_seq_len + BATCH * N_CTX):
        vision_route = "half_train"
    else:
        vision_route = "half_train_recompute_h"
    per_step = step_launches(F, cfg, text_route, vision_route)
    if model == "ViT-B/16":
        grad_check(F, st, phase, "one step", per_step)
    if vision_route.startswith("half_train"):
        # what the vision tower saves for its backward, reckoned: per layer
        # x (the attention half's input), qkv and y1 (the MLP half's input)
        # in bf16, and h where it is saved
        rows = BATCH * (cfg.vision_seq_len + N_CTX)
        per_layer = rows * cfg.vision_width * (5 + (4 if vision_route == "half_train" else 0)) * 2
        say(phase, f"vision saves reckoned: {per_layer / 1e9:.3f} GB a layer, "
                   f"{cfg.vision_layers * per_layer / 1e9:.2f} GB over {cfg.vision_layers} layers "
                   f"({rows} rows of {cfg.vision_width})")

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


AB_ITERS = 40  # launches a kernel time of --times-of averages


def kernel_times(F) -> dict:
    """ms per launch of every GEMM epilogue and attention_bwd case of
    SHAPES (the three vision towers' paths and the text shapes) on seeded
    inputs, through the public wrappers only, so that two trees' kernels
    can be timed in one call (``--times-of``).  attention_bwd also by
    ``queued_ms``: its text shapes take microseconds, where the host's
    pace can set ``time_ms``.  A block length that a package refuses (an
    attention_bwd with a row cap) is left out."""
    import torch

    rn = randn_fn(11)
    times = {}
    for model, spec in SHAPES.items():
        for ep, M, K, N, _ in spec["gemm"]:
            key = f"gemm_bf16_epilogue {ep} {M}x{K}->{N}"
            if key in times:
                continue
            a, w, bias, extra = gemm_operands(F, rn, ep, M, K, N)
            times[key] = time_ms(lambda: F.gemm_epilogue(a, w, bias, ep, extra), AB_ITERS)
            del a, w, bias, extra
        for label, B, S, H, causal, _ in spec["attn"]:
            L = F._block_spec(S, causal)[0]
            key = f"attention_bwd {model} {label} {B}x{S} H={H}"
            if L > getattr(F, "ATTN_BWD_MAX_BLOCK", L) or key in times:
                continue
            qkv, do = rn(B, S, 3 * 64 * H), rn(B, S, 64 * H, std=0.1)
            times[key] = time_ms(lambda: F.attention_bwd(qkv, do, H, causal), AB_ITERS)
            times[key + " device"], times[key + " host us"] = queued_ms(
                lambda: F.attention_bwd(qkv, do, H, causal), AB_ITERS)
            del qkv, do
        torch.cuda.empty_cache()
    return times


def times_of(root: Path) -> int:
    """``python3 chip_smoke.py --times-of ROOT``: the kernel times of the
    mudpt_torch package of the checkout at ROOT (its kernels built there),
    one JSON line.  Run on two trees in turns (parent, change, change,
    parent) in one call to compare their kernels on one card."""
    import torch

    sys.path.insert(0, str(root))
    from mudpt_torch.ops import _build
    from mudpt_torch.ops import fused_block as F

    if Path(F.__file__).resolve().parents[2] != root:
        raise AssertionError(f"imported {F.__file__}, not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    print(json.dumps({"times_of": str(root), "card": smi(), "ms": kernel_times(F)}), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if sys.argv[1:2] == ["--times-of"]:
        root = Path(sys.argv[2]).resolve()
    if not (root / "mudpt_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no mudpt_torch package in {root}", file=sys.stderr)
        return 3
    if sys.argv[1:2] == ["--times-of"]:
        return times_of(root)
    sys.path.insert(0, str(root))
    from mudpt_torch.models import layers
    from mudpt_torch.ops import _build
    from mudpt_torch.ops import fused_block as F
    from mudpt_torch.ops import quant_block as Q

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

    bf16_names = [name for name in _build.SIGNATURES if name not in Q8_KERNELS]
    kernels = {name: Kernel(name) for name in bf16_names}
    kernels_l = {name: Kernel(name) for name in bf16_names}
    # one vision layer of the int8 request (attention_fwd's fp32 output
    # mode with them) and of the int8_static request
    kernels_q = {name: Kernel(name) for name in (*Q8_KERNELS, "attention_fwd")}
    kernels_qs = {name: Kernel(name) for name in Q8_KERNELS}
    # one call of the chunked MLP half's forward and backward at ViT-L/14
    kernels_c = {name: Kernel(name) for name in CHUNKED_KERNELS}
    # one vision layer of the ViT-L/14@336px train step
    kernels_336 = {name: Kernel(name) for name in bf16_names}
    paths = {}

    def run(phase: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        say(phase, f"phase done in {time.perf_counter() - t0:.1f} s")
        return out

    rn = run("kernels", phase_kernels, F, kernels, "ViT-B/16")
    run("kernels", phase_attention_profiles, F)
    run("kernels", phase_attention_sweep, F)
    run("kernels", phase_layer_chains, F, rn)
    paths["serving"] = run("serving", phase_serving, F, "ViT-B/16")
    paths["train_step"] = run("train", phase_train, F, "ViT-B/16")
    run("kernels ViT-L/14", phase_kernels, F, kernels_l, "ViT-L/14")
    run("kernels ViT-L/14", phase_halfblock_chains, F)
    paths["serving_vit_l14"] = run("serving ViT-L/14", phase_serving, F, "ViT-L/14")
    paths["train_step_vit_l14"] = run("train ViT-L/14", phase_train, F, "ViT-L/14")
    run("kernels ViT-L/14@336px", phase_kernels, F, kernels_336, "ViT-L/14@336px")
    paths["serving_vit_l14_336px"] = run("serving ViT-L/14@336px", phase_serving, F,
                                         "ViT-L/14@336px")
    paths["train_step_vit_l14_336px"] = run("train ViT-L/14@336px", phase_train, F,
                                            "ViT-L/14@336px")
    run("kernels int8", phase_kernels_int8, F, Q, kernels_q, kernels_qs)
    run("kernels int8", phase_q8_chains, F, Q, layers)
    for quant in ("int8", "int8_static"):
        paths[f"serving_{quant}"] = run(f"serving {quant}", phase_serving, F, "ViT-B/16", quant)
    for quant in ("int8_ste", "int8_ste_static"):
        paths[f"train_step_{quant}"] = run(f"train {quant}", phase_train, F, "ViT-B/16", quant)
    paths.update(run("kernels chunked", phase_kernels_chunked, F, kernels_c))

    def by_path(name: str) -> dict:
        return {path: counts[name] for path, counts in paths.items()}

    records = [k.record(by_path(name), "train_step", vit_l14=kernels_l[name],
                        vit_l14_336px=kernels_336[name],
                        **({"int8": kernels_q[name]} if name in kernels_q else {}),
                        **({"chunked": kernels_c[name]} if name in kernels_c else {}))
               for name, k in kernels.items()]
    records += [kernels_q[name].record(by_path(name), "serving_int8", int8_static=kernels_qs[name])
                for name in Q8_KERNELS]
    print(json.dumps({"kernels": records}))
    print(smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
