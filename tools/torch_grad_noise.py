#!/usr/bin/env python3
"""How far bf16 alone moves the MuDPT train step's gradients, on one GPU.

    python3 tools/torch_grad_noise.py            # the depth and batch cases
    python3 tools/torch_grad_noise.py --ratio    # the fp32-ratio spread
    python3 tools/torch_grad_noise.py --ratio ViT-L/14   # of one model's checks
    python3 tools/torch_grad_noise.py --zoo [CoCoOp ...]  # the [zoo] checks' spread

For each case (model, batch, micro-batches, seed) it computes one step's
gradients of the ten trainable leaves three ways from the same state: the
port's kernels, the kernels' plain versions in bf16, and the plain versions
in fp32 (TF32 off); micro-batches sum their gradients into the batch's.  It
prints, per case, the worst and mean relative norm distance between the
kernels and the plain path, each one's worst distance to fp32, and the fp32
step's peak device memory.  The vision MLP recomputes h (mode "0").  "L12"
is ViT-L/14 cut to 12 vision layers: the width of ViT-L at the depth of
ViT-B/16, to tell the two apart.

With ``--ratio`` it runs the gradient checks of ``chip_smoke.py`` over
eight seeds each: ViT-B/16 at batch 384 under bf16 and the two
quantization-aware tiers, and ViT-L/14 at batch 32 with the vision MLP
recomputing h and with 2,560 classes (the text tower's saves off).  It
prints per case the worst ratio over the leaves of the kernels' distance
to fp32 to the plain path's, then, per model, the spread of those
ratios: their mean, standard deviation and largest value, and the limit
mean + 4 standard deviations, rounded up to a tenth (``chip_smoke.py``'s
GRAD_FP32_RATIO for ViT-B/16).  Model names after ``--ratio`` keep only
their cases.  Each case also names the leaf of its worst ratio with that
leaf's two distances to fp32, and the smallest plain-vs-fp32 distance over
the leaves.

With ``--zoo`` it runs ``chip_smoke.py``'s ``[zoo]`` gradient check of
each trainer that trains (the trainer built through the port's CLI from
its YAML, its first batch) over eight seeds (``--seed``: the prompts'
initialization and the batch; the backbone's random weights stay seed 0),
and prints per trainer the spread of the worst ratio and of the worst
kernels-vs-plain distance, each with its mean + 4 sd limit (the ratio's
rounded up to a tenth, the distance's to a power of two): the source of
``chip_smoke.ZOO_GRAD_LIMITS``.  Labels after
``--zoo`` keep only their trainers.
"""

import dataclasses
import math
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from mudpt_torch.models.layers import plain_blocks  # noqa: E402
from mudpt_torch.ops import fused_block as F  # noqa: E402
from mudpt_torch.trainers.mudpt import mudpt_forward  # noqa: E402
from mudpt_torch.utils import synth_step as TS  # noqa: E402

CASES = (("ViT-L/14", 32, 1, 0), ("ViT-L/14", 32, 1, 1), ("ViT-B/16", 32, 1, 0),
         ("L12", 32, 1, 0), ("ViT-L/14", 64, 2, 0), ("ViT-L/14", 128, 4, 0),
         ("ViT-L/14", 256, 8, 0))
# (model, batch, classes, quant, the vision MLP's h-save mode)
RATIO_CASES = (("ViT-B/16", 384, 100, "none", "auto"), ("ViT-B/16", 384, 100, "int8_ste", "auto"),
               ("ViT-B/16", 384, 100, "int8_ste_static", "auto"),
               ("ViT-L/14", 32, 100, "none", "0"), ("ViT-L/14", 32, 2560, "none", "auto"))
RATIO_SEEDS = range(8)


def leaf_names(tree: dict, prefix: str = "") -> list:
    """The dotted key paths of :func:`synth_step.leaves`' tensors, in its order."""
    out = []
    for k, v in tree.items():
        out.extend(leaf_names(v, f"{prefix}{k}.") if isinstance(v, dict) else [prefix + k])
    return out


def to_float(tree):
    if isinstance(tree, dict):
        return {k: to_float(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


def grads_of(st, tr, chunks: int, fp32: bool):
    c = st.images.shape[0] // chunks
    acc = [torch.zeros_like(t) for t in tr]
    params32 = to_float(st.params) if fp32 else None
    for i in range(chunks):
        im, lb = st.images[i * c:(i + 1) * c], st.labels[i * c:(i + 1) * c]
        if fp32:
            logits = mudpt_forward(st.trainable, params32, st.aux, im.float(),
                                   clip_cfg=st.clip_cfg, compute_dtype=torch.float32)
            loss = TS.nll_loss(logits, lb)
        else:
            loss = st.loss_fn(im, lb)
        for a, g in zip(acc, torch.autograd.grad(loss / chunks, tr)):
            a += g
    return acc


def run(model: str, batch: int, chunks: int, seed: int, quant: str = "none",
        n_cls: int = 100) -> float:
    """Prints the case's readings; returns the worst ratio over the leaves
    of the kernels' distance to fp32 to the plain path's."""
    t0 = time.time()
    st = TS.build_synth_mudpt_step(model, batch, n_cls, 2, 9, seed=seed, quant=quant)
    tr = TS.leaves(st.trainable)
    gk = grads_of(st, tr, chunks, False)
    with plain_blocks():
        gp = grads_of(st, tr, chunks, False)
        torch.cuda.reset_peak_memory_stats()
        g32 = grads_of(st, tr, chunks, True)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    dist = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    kp = [dist(a, b) for a, b in zip(gk, gp)]
    k32 = [dist(a, c) for a, c in zip(gk, g32)]
    p32 = [dist(b, c) for b, c in zip(gp, g32)]
    ratio, i = max((a / b, i) for i, (a, b) in enumerate(zip(k32, p32)))
    print(f"{model} {quant} {n_cls} classes batch {batch} in {chunks} micro-batches, seed "
          f"{seed}: kernels vs "
          f"plain worst {max(kp):.4f} mean {sum(kp) / len(kp):.4f}; kernels vs fp32 worst "
          f"{max(k32):.4f}; plain vs fp32 worst {max(p32):.4f} least {min(p32):.4f}; worst "
          f"ratio to fp32 {ratio:.4f} at {leaf_names(st.trainable)[i]} (kernels {k32[i]:.4f}, "
          f"plain {p32[i]:.4f}); fp32 step peak {peak:.1f} GiB; {time.time() - t0:.1f} s",
          flush=True)
    return ratio


def ratio_spread(models: list) -> None:
    ratios = {}
    for model, batch, n_cls, quant, mlp_mode in RATIO_CASES:
        if models and model not in models:
            continue
        F.set_save_mlp_wide(mlp_mode)
        for seed in RATIO_SEEDS:
            ratios.setdefault(model, []).append(run(model, batch, 1, seed, quant, n_cls))
            torch.cuda.empty_cache()
    F.set_save_mlp_wide("0")
    for model, rs in ratios.items():
        mean, sd = statistics.mean(rs), statistics.stdev(rs)
        limit = math.ceil((mean + 4 * sd) * 10) / 10
        print(f"{model}: worst ratio to fp32 over {len(rs)} cases: mean {mean:.4f}, sd "
              f"{sd:.4f}, largest {max(rs):.4f}; mean + 4 sd rounded up to a tenth: "
              f"{limit:.1f}", flush=True)


def zoo_spread(labels: list) -> None:
    import shutil
    import tempfile

    import chip_smoke as C

    root = Path(__file__).resolve().parent.parent
    tmp = tempfile.mkdtemp(prefix="mudpt_grad_noise_")
    try:
        for label, trainer, yaml, more in C.ZOO:
            if trainer.startswith("Zeroshot") or (labels and label not in labels):
                continue
            ratios, worsts = [], []
            for seed in RATIO_SEEDS:
                t0 = time.time()
                tr = C.zoo_trainer(root, trainer, yaml, more + ("SEED", str(seed)),
                                   f"{tmp}/{label}_{seed}")
                st, _ = C.zoo_step_case(tr)
                r = C.grad_readings(F, st)
                ratios.append(r["worst_ratio"])
                worsts.append(r["worst"])
                print(f"{label} seed {seed}: worst ratio to fp32 {r['worst_ratio']:.4f}, worst "
                      f"kernels vs plain {r['worst']:.4f}; " + ", ".join(r["parts"][:6])
                      + f"; {time.time() - t0:.1f} s", flush=True)
                del tr, st
                torch.cuda.empty_cache()
            for what, xs, rounded in (
                    ("worst ratio to fp32", ratios,
                     lambda v: f"rounded up to a tenth {math.ceil(v * 10) / 10:.1f}"),
                    ("worst kernels vs plain", worsts,
                     lambda v: f"rounded up to a power of two 2^{math.ceil(math.log2(v))}")):
                mean, sd = statistics.mean(xs), statistics.stdev(xs)
                print(f"{label}: {what} over {len(xs)} seeds: mean {mean:.4f}, sd {sd:.4f}, "
                      f"largest {max(xs):.4f}; mean + 4 sd {mean + 4 * sd:.4f}, "
                      f"{rounded(mean + 4 * sd)}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_grad_noise: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    TS.MODELS["L12"] = dataclasses.replace(TS.MODELS["ViT-L/14"], vision_layers=12)
    F.set_save_mlp_wide("0")
    args = sys.argv[1:]
    if args[:1] == ["--ratio"]:
        ratio_spread(args[1:])
    elif args[:1] == ["--zoo"]:
        zoo_spread(args[1:])
    else:
        for case in CASES:
            run(*case)
            torch.cuda.empty_cache()
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
