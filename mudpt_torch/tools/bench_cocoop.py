"""CoCoOp train-step timing at ImageNet scale (counterpart of
``tools/bench_cocoop.py``): the reference loops n_cls text encodes per image
in Python; the port encodes each instance's class rows through the text
tower as one batch, chunked (``trainers/cocoop.cocoop_forward``).

Times the whole step (forward, backward, one SGD step at lr 2e-3, momentum
0.9) at 1,000 classes on seeded random weights (bf16 backbone), each step's
loss fetched to the host; ``--mode eval`` times the forward and the argmax
(CoCoOp serving: instance-conditional prompts take no text cache).  One
JSON line, the JAX tool's keys.

  python -m mudpt_torch.tools.bench_cocoop [--batch 8] [--n-cls 1000] [--steps 8]
      [--chunk 0] [--mode train|eval] [--quant none|int8|int8_ste]
      [--text-trunc auto|0] [--device cpu]

``--text-trunc 0`` runs the full 77-token class rows (the JAX tool's
``MUDPT_TPU_TEXT_TRUNC=0`` A/B; ``PERF.TEXT_TRUNC``); the switch is restored
when the run ends.  ``--quant int8`` (eval) serves the int8 backbone,
``int8_ste`` (train) trains against it.  Without ``--device`` it runs on the
card and raises when CUDA is absent.
"""

from __future__ import annotations

import argparse
import functools
import json
import time

# the benched backbone (the JAX tool's VIT_B16); tests swap it for a tiny one
MODEL = "ViT-B/16"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m mudpt_torch.tools.bench_cocoop",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n-cls", type=int, default=1000)
    ap.add_argument("--n-ctx", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--chunk", type=int, default=0,
                    help="ENCODE_CHUNK: 0 auto, -1 never, N instances")
    ap.add_argument("--mode", choices=["train", "eval"], default="train",
                    help="eval = forward + argmax only (CoCoOp serving: "
                    "instance-conditional prompts cannot use a text cache)")
    ap.add_argument("--quant", choices=["none", "int8", "int8_ste"], default="none",
                    help="int8 (eval mode): the int8 backbone; int8_ste (train mode): "
                    "quantization-aware prompt tuning")
    ap.add_argument("--text-trunc", choices=["auto", "0"], default="auto",
                    help="auto: EOT-truncated class rows; 0: the full 77 tokens")
    ap.add_argument("--device", default=None, help="'cpu' for the plain versions; "
                    "default the card")
    args = ap.parse_args(argv)
    if args.quant == "int8" and args.mode != "eval":
        ap.error("--quant int8 is inference-only; use with --mode eval "
                 "(--quant int8_ste is the training variant)")
    if args.quant == "int8_ste" and args.mode != "train":
        ap.error("--quant int8_ste is the training variant; for serving use --quant int8")
    return args


def _build(args, dev):
    """Weights, class bank, trainable tree, images and labels from seeds."""
    import torch

    from mudpt_torch.models.clip import cast_matmul_weights, init_clip_params, leaves
    from mudpt_torch.ops.quant_block import quantize_blocks
    from mudpt_torch.trainers.prompt_utils import embed_classnames, init_linear, random_ctx
    from mudpt_torch.utils.rng import new_rng
    from mudpt_torch.utils.synth_step import MODELS

    cfg = MODELS[MODEL]
    params = cast_matmul_weights(init_clip_params(cfg, new_rng(0, dev)), torch.bfloat16)
    if args.quant != "none":  # the towers' weights quantized once, as a trainer's build
        for tower in ("visual", "text"):
            params[tower]["blocks"] = quantize_blocks(params[tower]["blocks"])
    aux = embed_classnames(params["text"], [f"object number {i}" for i in range(args.n_cls)],
                           args.n_ctx, " ".join(["X"] * args.n_ctx)).as_device_tree()
    g = new_rng(1, dev)
    trainable = {
        "ctx": random_ctx(g, (args.n_ctx, cfg.transformer_width)),
        "meta_net": {"linear1": init_linear(g, cfg.embed_dim, cfg.embed_dim // 16),
                     "linear2": init_linear(g, cfg.embed_dim // 16, cfg.transformer_width)},
    }
    for t in leaves(trainable):
        t.requires_grad_(True)
    res = cfg.image_resolution
    images = torch.randn(args.batch, res, res, 3, generator=new_rng(2, dev),
                         device=dev).to(torch.bfloat16)
    labels = torch.arange(args.batch, device=dev) % args.n_cls
    return cfg, params, aux, trainable, images, labels


def run(args) -> dict:
    import torch

    from mudpt_torch.models.clip import leaves
    from mudpt_torch.models.layers import quantized
    from mudpt_torch.trainers.cocoop import cocoop_forward
    from mudpt_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg, params, aux, trainable, images, labels = _build(args, dev)
    fwd = functools.partial(cocoop_forward, clip_cfg=cfg, compute_dtype=torch.bfloat16,
                            encode_chunk=args.chunk)
    if args.mode == "eval":
        @torch.no_grad()
        def step():
            with quantized(args.quant):
                return int(fwd(trainable, params, aux, images).argmax(-1)[0])

        qlabel, what = ("int8" if args.quant == "int8" else "bf16"), "per-instance text encode"
    else:
        optimizer = torch.optim.SGD(leaves(trainable), lr=2e-3, momentum=0.9)
        losses = []

        def step():
            optimizer.zero_grad(set_to_none=True)
            with quantized(args.quant):
                logits = fwd(trainable, params, aux, images)
                loss = torch.nn.functional.cross_entropy(logits.float(), labels)
                loss.backward()
            optimizer.step()
            losses.append(float(loss.detach()))  # the host fetch ends the step

        qlabel = "int8-ste" if args.quant == "int8_ste" else "bf16"
        what = "chunked text encode"
    for _ in range(args.warmup):
        step()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step()
    dt = time.perf_counter() - t0
    record = {
        "metric": (f"CoCoOp {MODEL} {args.mode} step ({qlabel}, batch {args.batch}, "
                   f"n_cls {args.n_cls}, {what})"),
        "value": round(dt / args.steps * 1e3, 3),
        "unit": "ms/step",
        "img_per_sec": round(args.batch / (dt / args.steps), 2),
        "text_trunc": args.text_trunc,
        "encode_chunk": args.chunk,
    }
    if args.mode == "train":
        record["final_loss"] = losses[-1]
    return record


def main(argv=None) -> dict:
    from mudpt_torch.models import text

    args = parse_args(argv)
    prev = text.text_truncate()
    text.set_text_truncate(args.text_trunc != "0")
    try:
        record = run(args)
    finally:
        text.set_text_truncate(prev != "0")
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
