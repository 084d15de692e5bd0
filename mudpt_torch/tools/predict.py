"""Offline batch inference against a serving artifact (counterpart of
``tools/predict.py``).

Decodes images with the preprocessing recorded in the artifact's meta.json
(resize -> center-crop -> CLIP normalize, the port's ``EvalTransform``),
batches them, and writes one JSON line per image:

  python -m mudpt_torch.tools.predict --artifact serving/mudpt_caltech \\
      --images img1.jpg img2.jpg ... [--image_dir DIR] \\
      [--batch 64] [--top_k 5] [--output preds.jsonl] [--device cpu]

Needs no trainer and no checkpoint, only the artifact directory
(``mudpt_torch/serving.py``).  Without ``--device`` it serves on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--artifact", type=str, required=True)
    p.add_argument("--images", type=str, nargs="*", default=[])
    p.add_argument("--image_dir", type=str, default="")
    p.add_argument("--batch", type=int, default=None,
                   help="default: the artifact's pinned batch, else 64")
    p.add_argument("--top_k", type=int, default=5)
    p.add_argument("--output", type=str, default="", help="JSONL path (default: stdout)")
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' to serve on the CPU; default the card")
    args = p.parse_args(argv)
    if not args.images and not args.image_dir:
        p.error("give --images and/or --image_dir")
    return args


def main(args) -> None:
    import numpy as np
    from PIL import Image

    from mudpt_torch import serving
    from mudpt_torch.data.transforms import EvalTransform

    clf = serving.load(args.artifact, device=args.device)
    pre = clf.meta["preprocess"]
    tf = EvalTransform(size=pre["resize_then_center_crop"], mean=tuple(pre["mean"]),
                       std=tuple(pre["std"]))
    names = clf.classnames
    top_k = min(args.top_k, len(names)) if names else args.top_k

    paths = list(args.images)
    if args.image_dir:
        paths += sorted(os.path.join(args.image_dir, f) for f in os.listdir(args.image_dir)
                        if f.lower().endswith(IMG_EXTS))
    if not paths:
        raise SystemExit(f"no images found under {args.image_dir!r}")

    batch = args.batch or clf.meta.get("batch") or 64
    pinned = clf.meta.get("batch")
    if pinned is not None and batch != pinned:
        raise SystemExit(
            f"artifact was exported with a pinned batch of {pinned}; --batch {batch} "
            "cannot be served: re-export or drop --batch"
        )

    out = open(args.output, "w") if args.output else sys.stdout
    try:
        for start in range(0, len(paths), batch):
            chunk = paths[start:start + batch]
            imgs = np.stack([np.asarray(tf(Image.open(p).convert("RGB")), np.float32)
                             for p in chunk])
            if len(chunk) < batch and pinned is not None:
                # a pinned artifact serves exactly `batch` rows: pad the tail
                # and drop the padded rows from the output below
                pad = batch - len(chunk)
                imgs = np.concatenate([imgs, np.zeros_like(imgs[:1]).repeat(pad, 0)])
            logits = clf.predict(imgs)[:len(chunk)]
            probs = np.exp(logits - logits.max(-1, keepdims=True))
            probs /= probs.sum(-1, keepdims=True)
            order = np.argsort(-logits, axis=-1)[:, :top_k]
            for p, pr, od in zip(chunk, probs, order):
                rec = {
                    "image": p,
                    "pred": int(od[0]),
                    "top_k": [{"label": int(i), **({"classname": names[i]} if names else {}),
                               "prob": round(float(pr[i]), 6)} for i in od],
                }
                out.write(json.dumps(rec) + "\n")
    finally:
        if args.output:
            out.close()
    print(f"# predicted {len(paths)} images", file=sys.stderr)


if __name__ == "__main__":
    main(parse_args())
