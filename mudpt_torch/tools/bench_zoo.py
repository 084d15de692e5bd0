"""Train-step throughput of every registered prompt-tuning method, one JSON
line each (counterpart of ``tools/bench_zoo.py``).

Each method is built through ``build_trainer`` on the in-memory synthetic
dataset (random weights, the trainer's default PREC, bf16) and its train
step, or with ``--mode eval`` its serving path (the class text encoded once
where the method allows, the argmax on the device), is timed on one
device-resident batch: the first step alone (``first_step_s``: the kernels'
first launches), the warm-up, then the timed steps queued and the last
loss fetched to the host, which bounds them.

  python -m mudpt_torch.tools.bench_zoo                      # every method
  python -m mudpt_torch.tools.bench_zoo --trainers CoOp VPT  # a subset
  python -m mudpt_torch.tools.bench_zoo --model test-tiny --batch 8 --n-cls 4 \\
      --size 32 --steps 2 --device cpu                       # the CPU, seconds

VPT and MPT train against the build-time static text cache (the vision
tower only, a step); CoOp, MuDPT, UMuDPT and UUMuDPT encode the class
prompts every step; CoCoOp encodes them for each instance
(``mudpt_torch.tools.bench_cocoop`` for its ImageNet-scale regimes).
Trailing KEY VALUE pairs override the config of every method.  Without
``--device`` it runs on the card and raises when CUDA is absent; a method
that raises prints its error and the others go on.
"""

from __future__ import annotations

import argparse
import json
import time

ZOO = (
    ("CoOp", {}),
    ("CoCoOp", {}),
    ("VPT", dict(VISUAL_PROMPT_DEPTH=9, DEEP_VISUAL_N_CTX=2)),
    ("MPT", dict(VISUAL_PROMPT_DEPTH=9, DEEP_VISUAL_N_CTX=2, TEXT_PROMPT_DEPTH=9,
                 DEEP_TEXT_N_CTX=2)),
    ("MuDPT", {}),
    ("UMuDPT", {}),
    ("UUMuDPT", {}),
)


def build(name: str, extra: dict, args):
    """The trainer ``name`` on the synthetic dataset (``bench_zoo.py:50-85``)."""
    from mudpt_torch.config import default_config, merge_from_list
    from mudpt_torch.trainers.base import NAMED_CONFIGS, build_trainer

    cfg = default_config()
    cfg.TRAINER.NAME = name
    cfg.MODEL.BACKBONE.NAME = args.model
    cfg.MODEL.BACKBONE.PATH = "random"
    cfg.DATASET.NAME = "Synthetic"
    cfg.DATASET.SYNTHETIC_NUM_CLASSES = args.n_cls
    cfg.DATASET.SYNTHETIC_PER_CLASS = max(1, -(-(args.batch * 2) // args.n_cls))
    cfg.INPUT.SIZE = (args.size, args.size)
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = args.batch
    cfg.DATALOADER.TEST.BATCH_SIZE = args.batch
    cfg.DATALOADER.NUM_WORKERS = 4
    cfg.OUTPUT_DIR = ""
    hp = cfg.trainer_params(name)
    if hp is not None:
        bb = NAMED_CONFIGS.get(args.model)
        for k, v in extra.items():
            if bb is not None and k == "VISUAL_PROMPT_DEPTH":
                v = min(v, bb.vision_layers)
            if bb is not None and k == "TEXT_PROMPT_DEPTH":
                v = min(v, bb.transformer_layers)
            setattr(hp, k, v)
        if hasattr(hp, "N_CTX") and name in ("CoOp", "CoCoOp"):
            hp.N_CTX = args.n_ctx
    if args.opts:
        merge_from_list(cfg, args.opts)
    return build_trainer(cfg, devices=args.device)


def bench_one(name: str, extra: dict, args) -> dict:
    from mudpt_torch.parallel.mesh import shard_batch

    tr = build(name, extra, args)
    batch = tr._device_batch(shard_batch(tr.mesh, next(iter(tr.dm.train_loader)),
                                         tr.dm.host_sharded))
    if args.mode == "eval":
        # the serving path evaluate() runs, without a build-time static
        # text cache in aux
        aux = {k: v for k, v in tr.aux.items() if k != "static_text_features"}
        text_fn = getattr(tr, "_text_features", None)
        if text_fn is not None:
            txt = text_fn(tr.trainable, tr.frozen, aux)

            def step():
                return tr._eval_step_cached(tr.trainable, tr.frozen, aux, batch["image"], txt)
        else:
            def step():
                return tr._eval_step(tr.trainable, tr.frozen, aux, batch["image"])

        t_first = time.perf_counter()
        step().cpu()  # the host fetch bounds the first call
        first_s = time.perf_counter() - t_first
        for _ in range(max(0, args.warmup - 1)):
            step().cpu()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            preds = step()
        preds.cpu()  # bounds the queued steps
        dt = time.perf_counter() - t0
        return {
            "trainer": name,
            "mode": "eval",
            "img_per_sec": round(args.batch * args.steps / dt, 1),
            "ms_per_step": round(dt / args.steps * 1e3, 3),
            "text_cached": text_fn is not None or tr.model_inference is not None,
            "first_step_s": round(first_s, 3),
        }

    def step():
        return tr._train_step(batch)[0]

    t_first = time.perf_counter()
    loss = float(step())  # the host fetch bounds the first step
    first_s = time.perf_counter() - t_first
    for _ in range(max(0, args.warmup - 1)):
        loss = float(step())
    t0 = time.perf_counter()
    for _ in range(args.steps):
        loss_dev = step()
    loss = float(loss_dev)  # the last loss bounds every queued step
    dt = time.perf_counter() - t0
    return {
        "trainer": name,
        "img_per_sec": round(args.batch * args.steps / dt, 1),
        "ms_per_step": round(dt / args.steps * 1e3, 3),
        "static_text_cache": bool(getattr(tr, "static_text", False)),
        "first_step_s": round(first_s, 3),
        "final_loss": round(loss, 4),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m mudpt_torch.tools.bench_zoo",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="ViT-B/16")
    ap.add_argument("--batch", type=int, default=384)
    ap.add_argument("--n-cls", type=int, default=100)
    ap.add_argument("--n-ctx", type=int, default=2)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--trainers", nargs="+", default=None)
    ap.add_argument("--mode", choices=["train", "eval"], default="train",
                    help="train: the train step; eval: the serving path (cached text "
                    "features, the argmax on the device); ZeroshotCLIP(2) are eval-only "
                    "and benched when --trainers names them")
    ap.add_argument("--device", default=None, help="'cpu' for the plain versions; "
                    "default the card")
    args, opts = ap.parse_known_args(argv)
    if args.steps < 1:
        ap.error("--steps must be >= 1")
    bad = [o for o in opts if o.startswith("-")]
    if bad:
        ap.error(f"unknown flags {bad}; config overrides are KEY VALUE pairs")
    args.opts = opts
    if args.device is None:
        from mudpt_torch.utils.device import resolve_device

        resolve_device(None)  # the card, or raise before any method is built

    zoo = list(ZOO)
    if args.mode == "eval" and args.trainers:
        zoo += [(n, {}) for n in ("ZeroshotCLIP", "ZeroshotCLIP2") if n in args.trainers]
    rows = {}
    for name, extra in zoo:
        if args.trainers and name not in args.trainers:
            continue
        try:
            row = bench_one(name, extra, args)
        except Exception as e:  # report and go on: one method's fault must not
            row = {"trainer": name, "error": f"{type(e).__name__}: {e}"[:200]}
        print(json.dumps({"metric": f"{name} {args.model} {args.mode} throughput "
                                    f"(batch {args.batch}, n_cls {args.n_cls})", **row}),
              flush=True)
        rows[name] = row
    return rows


if __name__ == "__main__":
    import sys

    sys.exit(1 if any("error" in r for r in main().values()) else 0)
