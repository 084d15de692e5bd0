"""Host-side input-pipeline throughput: decode -> augment -> batch, no
device (counterpart of ``tools/bench_input.py``).

Isolates the host half of a loader-fed step (JPEG decode, random resized
crop and flip, normalize, batch assembly) on ``mudpt_torch.bench``'s
synthetic JPEG set (``synth_jpegs``: seed-0 noise at 256 px, written once
under the temporary directory) through ``bench.build_pipeline_loader``:

  python -m mudpt_torch.tools.bench_input --pipeline threads --workers 16
  python -m mudpt_torch.tools.bench_input --pipeline tfdata
  python -m mudpt_torch.tools.bench_input --pipeline threads grain tfdata

One JSON line per pipeline: images/s sustained over ``--steps`` batches
after ``--warmup`` batches, and whether that keeps up with the port's
train step (:data:`TRAIN_STEP_IMAGES_PER_S`).  grain and tfdata decode in worker
processes: a script that calls :func:`main` with them needs an
``if __name__ == "__main__":`` guard.
"""

from __future__ import annotations

import argparse
import json
import time

PIPELINES = ("threads", "tfdata", "grain")
# the ViT-B/16 train step at batch 384, python -m mudpt_torch.bench, on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 5)
TRAIN_STEP_IMAGES_PER_S = 4375.28


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m mudpt_torch.tools.bench_input",
                                description=__doc__.split("\n")[0])
    p.add_argument("--pipeline", nargs="+", choices=PIPELINES, default=["threads"])
    p.add_argument("--batch", type=int, default=384)
    p.add_argument("--n-jpegs", type=int, default=2048)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--workers", type=int, default=16,
                   help="decode threads (threads) or processes (tfdata)")
    args = p.parse_args(argv)
    if args.batch > args.n_jpegs:
        p.error("--batch exceeds --n-jpegs")
    return args


def run(pipeline: str, args) -> dict:
    import numpy as np

    from mudpt_torch.bench import build_pipeline_loader, synth_jpegs

    loader = build_pipeline_loader(pipeline, synth_jpegs(args.n_jpegs, n_cls=100, side=256),
                                   args.batch, args.size, workers=args.workers)

    def batches():
        while True:
            for b in loader:
                # touch the decoded array so a lazy pipeline cannot defer work
                yield np.asarray(b["image"])

    it = batches()
    for _ in range(args.warmup):
        next(it)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        next(it)
    ips = args.batch * args.steps / (time.perf_counter() - t0)
    return {
        "metric": (f"input pipeline host throughput ({pipeline}, batch {args.batch}, "
                   f"{args.size}px random-resized-crop)"),
        "value": round(ips, 1),
        "unit": "images/sec",
        "keeps_up_with_train_step": ips >= TRAIN_STEP_IMAGES_PER_S,
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    out = {}
    for pipeline in args.pipeline:
        out[pipeline] = run(pipeline, args)
        print(json.dumps(out[pipeline]), flush=True)
    return out


if __name__ == "__main__":
    main()
