#!/usr/bin/env python3
"""How far bf16 alone moves the MuDPT train step's gradients, on one GPU.

    python3 tools/torch_grad_noise.py

For each case (model, batch, micro-batches, seed) it computes one step's
gradients of the ten trainable leaves three ways from the same state: the
port's kernels, the kernels' plain versions in bf16, and the plain versions
in fp32 (TF32 off); micro-batches sum their gradients into the batch's.  It
prints, per case, the worst and mean relative norm distance between the
kernels and the plain path, each one's worst distance to fp32, and the fp32
step's peak device memory.  The vision MLP recomputes h (mode "0").  "L12"
is ViT-L/14 cut to 12 vision layers: the width of ViT-L at the depth of
ViT-B/16, to tell the two apart.
"""

import dataclasses
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


def run(model: str, batch: int, chunks: int, seed: int) -> None:
    t0 = time.time()
    st = TS.build_synth_mudpt_step(model, batch, 100, 2, 9, seed=seed)
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
    print(f"{model} batch {batch} in {chunks} micro-batches, seed {seed}: kernels vs plain "
          f"worst {max(kp):.4f} mean {sum(kp) / len(kp):.4f}; kernels vs fp32 worst "
          f"{max(k32):.4f}; plain vs fp32 worst {max(p32):.4f}; fp32 step peak "
          f"{peak:.1f} GiB; {time.time() - t0:.1f} s", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_grad_noise: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    TS.MODELS["L12"] = dataclasses.replace(TS.MODELS["ViT-L/14"], vision_layers=12)
    F.set_save_mlp_wide("0")
    for case in CASES:
        run(*case)
        torch.cuda.empty_cache()
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
