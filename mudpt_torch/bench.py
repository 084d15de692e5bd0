"""Benchmark of the port: MuDPT prompt-tuning train throughput or cached-text
serving throughput (images/s) on one device, one JSON line
(counterpart of ``bench.py``).

    python -m mudpt_torch.bench [--mode train|eval] [--model ViT-B/16]
        [--batch 384] [--n-cls 100] [--n-ctx 2] [--depth 9] [--steps 20]
        [--warmup 3] [--remat auto|selective|full|none]
        [--quant none|int8|int8_static|int8_ste|int8_ste_static]
        [--input resident|threads|tfdata|grain] [--n-jpegs 2048]
        [--device cuda|cpu]

It drives ``utils/synth_step.build_synth_mudpt_step`` (``--mode train``:
random weights from seed 0; ``--input resident`` trains on one
device-resident batch, each step's loss fetched to the host; ``threads``,
``tfdata`` or ``grain`` decode a JPEG set of ``--n-jpegs`` seed-0 noise
images at 256 px, written once under the temporary directory, through that
loader's training transforms, and copy each batch from pinned host memory to
the device while the step before it runs, the last step's loss fetched; the
line then adds ``h2d_mb_per_sec``, the rate of full-batch copies from pinned
memory alone; the loader decodes with ``MUDPT_BENCH_WORKERS`` threads or
processes, 16 by default, as ``bench.py:190-246``, ``:449-480``) or
``build_synth_mudpt_server`` (``--mode eval``: the class text encoded once,
then one vision pass per batch, its predictions fetched to the host, against
re-encoding the text every batch).
``--remat`` sets ``models/transformer.set_remat_mode`` for the run (the
previous mode is restored after it): ``auto`` is ``none`` on the kernel
route and, under ``PERF.BLOCK xla``, ``none`` at batch <= 96, else ``full``
(``bench.py:374-388``); ``--mode eval`` runs ``none`` (``:263-265``).
The line carries ``bench.py``'s ``metric``, ``value`` and ``unit`` and its
FLOP accounts (``bench.py:340-346``, ``:511-559``): ``model_*`` counts the
algorithmic FLOPs (forward and dx-only backward, no recompute), ``exec_*``
adds what the port's blocks recompute, each over the H100's dense peak
(989e12 bf16, 1979e12 int8 for the int8 serving tiers).  The train line's
``vs_baseline`` is images/s over ``A100_BASELINE_IPS``, ``bench.py:45``'s
estimate of the reference's PyTorch MuDPT on one A100 (BASELINE.md).  It adds the
device's name and, on the card, its name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them.  On the CPU (``--device cpu``, the plain versions) the FLOP rates and
shares are null: they are device metrics.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time

import numpy as np
import torch

from mudpt_torch.data.datum import Datum
from mudpt_torch.data.grain_pipeline import GrainLoader
from mudpt_torch.data.loader import DataLoader
from mudpt_torch.data.tfdata import TFDataLoader
from mudpt_torch.data.transforms import TrainTransform
from mudpt_torch.models import transformer
from mudpt_torch.models.layers import QUANT_MODES, resolve_block_impl
from mudpt_torch.models.text import _text_saves_off
from mudpt_torch.ops import fused_block
from mudpt_torch.utils.device import card, resolve_device
from mudpt_torch.utils.synth_step import (MODELS, build_synth_mudpt_server,
                                          build_synth_mudpt_step)

INPUTS = ("resident", "threads", "tfdata", "grain")
# H100 SXM published dense peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
# bench.py:45: the reference's PyTorch MuDPT on one A100-80G, estimated
# images/s (BASELINE.md's addendum), the denominator of vs_baseline
A100_BASELINE_IPS = 850.0
REMATS = ("auto", "selective", "full", "none")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m mudpt_torch.bench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=["train", "eval"], default="train")
    ap.add_argument("--model", choices=list(MODELS), default="ViT-B/16")
    ap.add_argument("--batch", type=int, default=384)
    ap.add_argument("--n-cls", type=int, default=100)
    ap.add_argument("--n-ctx", type=int, default=2)
    ap.add_argument("--depth", type=int, default=9)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--remat", choices=REMATS, default="auto")
    ap.add_argument("--quant", choices=QUANT_MODES, default="none")
    ap.add_argument("--input", choices=INPUTS, default="resident",
                    help="resident: one device-resident batch every step; threads, tfdata "
                    "or grain: decode a synthetic JPEG set through that input pipeline")
    ap.add_argument("--n-jpegs", type=int, default=2048)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    # bench.py:139-155
    if args.mode == "eval" and args.input != "resident":
        ap.error("--mode eval supports --input resident only")
    if args.quant in ("int8", "int8_static") and args.mode != "eval":
        ap.error(f"--quant {args.quant} is inference-only; use with --mode eval (the "
                 "quantized blocks have no backward); for training, --quant int8_ste is "
                 "the straight-through variant")
    if args.quant.startswith("int8_ste") and args.mode != "train":
        ap.error(f"--quant {args.quant} is the TRAINING variant; for serving use --quant "
                 "int8 (identical forward, no save writes)")
    if args.steps < 1:
        ap.error("--steps must be at least 1")
    if args.input != "resident" and args.batch > args.n_jpegs:
        # a tfdata epoch would hold no batch, and the others a padded one
        ap.error(f"--input {args.input}: --batch {args.batch} exceeds the synthetic set "
                 f"(--n-jpegs {args.n_jpegs}) — raise --n-jpegs")
    return args


def tower_fwd_flops(n_seq: int, n_layers: int, d: int, rows: int) -> float:
    """Forward matmul FLOPs of a tower (``bench.py:511-513``)."""
    return (12 * d * d + 4 * n_seq * d) * 2 * n_seq * n_layers * rows


def tower_bwd_dx_flops(n_seq: int, n_layers: int, d: int, rows: int) -> float:
    """dx-only backward: every linear again, the two S-wide head products
    twice (``bench.py:515-519``)."""
    return (12 * d * d + 8 * n_seq * d) * 2 * n_seq * n_layers * rows


def resolve_remat(remat: str, batch: int) -> str:
    """The REMAT mode of ``--remat`` (``bench.py:374-386``): ``auto`` is
    'none' on the kernel route (its layers save what their backward
    reads), and on the XLA route 'none' up to batch 96, else 'full'."""
    if remat != "auto":
        return remat
    if resolve_block_impl() == "pallas":
        return "none"
    return "none" if batch <= 96 else "full"


def train_flops(cfg, batch: int, n_cls: int, n_ctx: int, text_seq: int,
                remat: str = "none") -> tuple:
    """(model FLOPs, executed FLOPs) of one train step: executed adds the
    products the port's blocks run again in the backward: the fc product
    where a vision MLP recomputes h (768 < D, over the row-token budget),
    the qkv and fc products where the text tower trains with saves off;
    under REMAT 'full' each tower's whole forward (every layer runs again
    in the backward), under 'selective' the XLA route's attention products
    (its scores and probs recomputed; the kernel route recomputes
    nothing more)."""
    vis_seq = cfg.vision_seq_len + n_ctx
    vis = (cfg.vision_layers, cfg.vision_width, batch)
    txt = (cfg.transformer_layers, cfg.transformer_width, n_cls)
    model = (tower_fwd_flops(vis_seq, *vis) + tower_bwd_dx_flops(vis_seq, *vis)
             + tower_fwd_flops(text_seq, *txt) + tower_bwd_dx_flops(text_seq, *txt))
    recompute = 0.0
    d = cfg.vision_width
    if d > fused_block.FULLBLOCK_MAX_WIDTH and not fused_block.wide_mlp_save(batch * vis_seq):
        recompute += 4 * d * d * 2 * vis_seq * cfg.vision_layers * batch
    if _text_saves_off(n_cls, -(-text_seq // 8) * 8):
        d = cfg.transformer_width
        recompute += 7 * d * d * 2 * text_seq * cfg.transformer_layers * n_cls
    if remat == "full":
        recompute += tower_fwd_flops(vis_seq, *vis) + tower_fwd_flops(text_seq, *txt)
    elif remat == "selective" and resolve_block_impl() == "xla":
        for S, (L, D, rows) in ((vis_seq, vis), (text_seq, txt)):
            recompute += 4 * S * D * 2 * S * L * rows
    return model, model + recompute


def synth_jpegs(n: int, n_cls: int, side: int = 256) -> list:
    """``n`` seed-0 noise JPEGs (quality 85), written once under the
    temporary directory and reused: noise decodes at the worst cost, through
    the whole decode, crop, flip and normalize path (``bench.py:190-218``)."""
    from PIL import Image

    root = os.path.join(tempfile.gettempdir(), f"mudpt_bench_jpegs_{n}x{side}")
    marker = os.path.join(root, ".complete")
    if not os.path.exists(marker):
        os.makedirs(root, exist_ok=True)
        rng = np.random.RandomState(0)
        for i in range(n):
            arr = rng.randint(0, 256, (side, side, 3), np.uint8)
            Image.fromarray(arr).save(os.path.join(root, f"{i}.jpg"), quality=85)
        with open(marker, "w") as f:
            f.write("ok")
    return [Datum(impath=os.path.join(root, f"{i}.jpg"), label=i % n_cls,
                  classname=f"object number {i % n_cls}") for i in range(n)]


def build_pipeline_loader(pipeline: str, items, batch: int, size: int, *,
                          workers: int = 16, seed: int = 0):
    """The named input pipeline over ``items``, shuffled, training
    transforms, whole batches (``bench.py:221-246``)."""
    if pipeline == "tfdata":
        return TFDataLoader(items, batch, size=size, is_train=True, shuffle=True,
                            drop_last=True, seed=seed, num_workers=workers)
    tf = TrainTransform(size=size)
    if pipeline == "grain":
        return GrainLoader(items, tf, batch, shuffle=True, drop_last=True, seed=seed)
    return DataLoader(items, tf, batch, shuffle=True, drop_last=True, num_workers=workers)


def _loader_batches(args, size: int, dev: torch.device):
    """(images, labels) on the device from the input pipeline, endlessly,
    each batch cast to bf16 on the host and copied from pinned memory on
    torch's current stream; and the H2D rate of a full batch (None off the
    card)."""
    loader = build_pipeline_loader(args.input, synth_jpegs(args.n_jpegs, args.n_cls),
                                   args.batch, size,
                                   workers=int(os.environ.get("MUDPT_BENCH_WORKERS", "16")))

    def host(b) -> tuple:
        images = torch.from_numpy(b["image"]).to(torch.bfloat16)
        labels = torch.from_numpy(b["label"]).long()
        if dev.type == "cuda":
            images, labels = images.pin_memory(), labels.pin_memory()
        return images, labels

    def batches():
        while True:
            for b in loader:
                images, labels = host(b)
                yield (images.to(dev, non_blocking=True), labels.to(dev, non_blocking=True))

    h2d_mb_s = None
    if dev.type == "cuda":
        sample = host(next(iter(loader)))[0]
        reps = 3
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            sample.to(dev, non_blocking=True)
            torch.cuda.synchronize(dev)
        h2d_mb_s = sample.numel() * sample.element_size() * reps / (time.perf_counter() - t0) / 1e6
    return batches(), h2d_mb_s


def run_train(args, dev: torch.device) -> dict:
    st = build_synth_mudpt_step(args.model, args.batch, args.n_cls, args.n_ctx, args.depth,
                                device=dev, seed=0, quant=args.quant)
    h2d_mb_s = None
    if args.input == "resident":
        for _ in range(args.warmup):
            float(st.train_step(st.images, st.labels))
        t0 = time.perf_counter()
        # each step's loss fetched to the host before the next, as a training
        # loop that logs every step
        losses = [float(st.train_step(st.images, st.labels)) for _ in range(args.steps)]
        dt = time.perf_counter() - t0
    else:
        it, h2d_mb_s = _loader_batches(args, st.clip_cfg.image_resolution, dev)
        for _ in range(args.warmup):
            loss = st.train_step(*next(it))
        float(loss)
        # prefetch-1: the next batch decodes and starts its copy while this
        # step's kernels run (as trainers/base._device_prefetch)
        t0 = time.perf_counter()
        nxt = next(it)
        losses = []
        for i in range(args.steps):
            losses.append(st.train_step(*nxt))
            if i + 1 < args.steps:
                nxt = next(it)
        losses = [float(v) for v in losses]
        dt = time.perf_counter() - t0
    final_loss = losses[-1]
    if not all(map(math.isfinite, losses)):
        raise FloatingPointError(f"non-finite loss in the benchmark: {losses}")
    text_seq = int(st.aux["token_suffix"].shape[1]) + 1 + args.n_ctx
    model, executed = train_flops(st.clip_cfg, args.batch, args.n_cls, args.n_ctx, text_seq,
                                  transformer.remat_mode())
    qlabel = {"int8_ste": "int8-ste", "int8_ste_static": "int8-ste-static"}.get(args.quant, "bf16")
    source = "" if args.input == "resident" else f", input {args.input}"
    return {
        "metric": (f"MuDPT {args.model} prompt-tuning train throughput ({qlabel}, batch "
                   f"{args.batch}, n_cls {args.n_cls}, depth {args.depth}{source})"),
        "value": round(args.batch * args.steps / dt, 2),
        "unit": "images/sec/chip",
        "vs_baseline": round(args.batch * args.steps / dt / A100_BASELINE_IPS, 3),
        "remat": transformer.remat_mode(),
        "step_ms": round(dt / args.steps * 1e3, 3),
        "final_loss": final_loss,
        **_device_metrics(dev, model_tflops_per_sec=(model * args.steps / dt / 1e12, 2),
                          model_mfu=(model * args.steps / dt / PEAK_BF16_FLOPS, 3),
                          exec_tflops_per_sec=(executed * args.steps / dt / 1e12, 2),
                          hw_utilization=(executed * args.steps / dt / PEAK_BF16_FLOPS, 3)),
        **({} if args.input == "resident" else
           {"input": args.input,
            "h2d_mb_per_sec": None if h2d_mb_s is None else round(h2d_mb_s, 1)}),
    }


def run_eval(args, dev: torch.device) -> dict:
    st = build_synth_mudpt_server(args.model, args.batch, args.n_cls, args.n_ctx, args.depth,
                                  device=dev, seed=0, quant=args.quant)
    tr, params, aux, images = st.trainable, st.params, st.aux, st.images
    txt = st.text_features(tr, params, aux)

    def cached():
        return st.eval_step_cached(tr, params, aux, images, txt)

    def per_batch_text():
        return st.eval_step_cached(tr, params, aux, images, st.text_features(tr, params, aux))

    def images_per_s(fn) -> float:
        """Each batch's predictions fetched to the host before the next, as
        a server answers requests."""
        for _ in range(max(1, args.warmup)):
            fn().cpu()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            fn().cpu()
        return args.batch * args.steps / (time.perf_counter() - t0)

    ips, ips_full = images_per_s(cached), images_per_s(per_batch_text)
    cfg = st.clip_cfg
    img_fwd = tower_fwd_flops(cfg.vision_seq_len + args.n_ctx, cfg.vision_layers,
                              cfg.vision_width, args.batch)
    quantized = args.quant.startswith("int8")
    peak = PEAK_INT8_OPS if quantized else PEAK_BF16_FLOPS
    qlabel = {"int8": "int8", "int8_static": "int8-static"}.get(args.quant, "bf16")
    return {
        "metric": (f"MuDPT {args.model} inference throughput ({qlabel}, batch {args.batch}, "
                   f"n_cls {args.n_cls}, cached text features)"),
        "value": round(ips, 2),
        "unit": "images/sec/chip",
        "request_ms": round(args.batch / ips * 1e3, 3),
        "uncached_img_per_sec": round(ips_full, 2),
        "speedup_vs_per_batch_text": round(ips / ips_full, 3),
        **_device_metrics(dev, model_mfu=(img_fwd * ips / args.batch / peak, 3)),
    }


def _device_metrics(dev: torch.device, **readings) -> dict:
    """Rates and shares of the card's peak, each (value, digits), rounded;
    null off the card."""
    return {k: round(v, n) if dev.type == "cuda" else None for k, (v, n) in readings.items()}


def main(argv=None) -> dict:
    """Run the benchmark; print and return its JSON record."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    prev = transformer.remat_mode()
    transformer.set_remat_mode("none" if args.mode == "eval"
                               else resolve_remat(args.remat, args.batch))
    try:
        record = run_eval(args, dev) if args.mode == "eval" else run_train(args, dev)
    finally:
        transformer.set_remat_mode(prev)
    record["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    record["card"] = card() if dev.type == "cuda" else None
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
