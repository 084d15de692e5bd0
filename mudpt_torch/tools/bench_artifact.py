"""Serving throughput of an exported artifact (counterpart of
``tools/bench_artifact.py``): the end-to-end check that a program runs, not
just deserializes, on the device.

The timed loop feeds one device-resident batch (the leaves are resident
from load), so it measures the artifact's compute path; the calls are
queued and synchronized once at the end.  One JSON line: the JAX tool's
keys, plus the device and, on the card, its name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them.

  python -m mudpt_torch.tools.bench_artifact --artifact serving/my_model \\
      [--batch N] [--steps 20] [--warmup 3] [--device cpu]

A pinned artifact's batch comes from meta.json; a symbolic one needs
``--batch``.  Without ``--device`` it runs on the card.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--artifact", required=True)
    ap.add_argument("--batch", type=int, default=0,
                    help="serving batch (default: the artifact's pinned batch; "
                    "required for symbolic-batch artifacts)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--device", type=str, default=None,
                    help="'cpu' to serve on the CPU; default the card")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from mudpt_torch import serving
    from mudpt_torch.utils.device import card

    clf = serving.load(args.artifact, device=args.device)
    batch = args.batch or clf.meta.get("batch")
    if not batch:
        ap.error("symbolic-batch artifact: pass --batch")
    res = clf.meta["preprocess"]["resize_then_center_crop"]
    images = torch.from_numpy(
        np.random.RandomState(0).randn(batch, res, res, 3).astype(np.float32)).to(clf.device)

    def sync():
        if clf.device.type == "cuda":
            torch.cuda.synchronize()

    for _ in range(max(1, args.warmup)):  # >= 1: the first call loads the kernels
        logits = clf.forward(images)
    sync()
    if not torch.isfinite(logits).all():
        raise SystemExit("the artifact's logits are not finite")
    t0 = time.perf_counter()
    for _ in range(args.steps):
        logits = clf.forward(images)
    sync()
    dt = time.perf_counter() - t0
    on_card = clf.device.type == "cuda"
    record = {
        "metric": (f"serving-artifact throughput ({clf.meta.get('block_impl', 'xla')}, "
                   f"batch {batch}, n_cls {len(clf.classnames or [])}, {clf.device.type})"),
        "value": round(batch * args.steps / dt, 2),
        "unit": "images/sec/chip",
        "ms_per_batch": round(dt / args.steps * 1e3, 2),
        "finite": bool(torch.isfinite(logits).all()),
        "device": torch.cuda.get_device_name(clf.device) if on_card else "cpu",
        "card": card() if on_card else None,
    }
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
