"""Zero-shot accuracy validation against published CLIP numbers
(counterpart of ``tools/validate_zeroshot.py``).

The zero-shot path is the framework's parity oracle (SURVEY.md §4): with
real OpenAI weights, a fault in the port of the backbone shows as a
zero-shot accuracy deviation before any training exists.  This tool runs
ZeroshotCLIP over the given datasets and compares top-1 against the
published CLIP ViT-B/16 numbers (Radford et al. 2021, Table 9 / CoOp paper
Table 1, the references the MuDPT paper benchmarks against).

  python -m mudpt_torch.tools.validate_zeroshot --dataset_root ~/data \\
      --backbone_path ~/.cache/clip/ViT-B-16.pt \\
      [KEY VALUE config overrides ...] \\
      [--datasets caltech101 oxford_pets ...] [--tolerance 1.0] [--device cpu]

(place KEY VALUE overrides before --datasets: its greedy nargs would
swallow them otherwise, and the tool stops with an error if that happens).
Without ``--device`` it runs on the card and raises when CUDA is absent.

The exit code is 0 iff every measured accuracy is within tolerance of the
published value; ``main(argv)`` returns it.
"""

from __future__ import annotations

import argparse
import os
import sys

# Published zero-shot top-1 for CLIP ViT-B/16 with the hand-crafted single
# template (CoOp, IJCV 2022, Table 1 "zero-shot CLIP"; prompt templates
# identical to trainers/templates.py CUSTOM_TEMPLATES).
PUBLISHED_VIT_B16 = {
    "imagenet": 66.7,
    "caltech101": 92.9,
    "oxford_pets": 89.1,
    "stanford_cars": 65.3,
    "oxford_flowers": 71.3,
    "food101": 86.1,
    "fgvc_aircraft": 24.7,
    "sun397": 62.6,
    "dtd": 44.3,
    "eurosat": 47.6,
    "ucf101": 66.8,
}


def _repo() -> str:
    """The checkout holding ``configs/`` (this file is mudpt_torch/tools/)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def dataset_config(dataset: str, dataset_root: str, backbone: str, backbone_path: str,
                   opts=()):
    """The config the tool evaluates ``dataset`` under: the defaults, the
    dataset's YAML, ZeroshotCLIP on the full splits, no output directory,
    then the KEY VALUE ``opts``."""
    from mudpt_torch.config import default_config, merge_from_file, merge_from_list

    cfg = default_config()
    merge_from_file(cfg, os.path.join(_repo(), "configs", "datasets", f"{dataset}.yaml"))
    cfg.TRAINER.NAME = "ZeroshotCLIP"
    cfg.DATASET.ROOT = dataset_root
    cfg.DATASET.NUM_SHOTS = -1
    cfg.MODEL.BACKBONE.NAME = backbone
    cfg.MODEL.BACKBONE.PATH = backbone_path
    cfg.OUTPUT_DIR = ""
    if opts:
        merge_from_list(cfg, list(opts))
    return cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mudpt_torch.tools.validate_zeroshot",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset_root", required=True)
    ap.add_argument("--backbone_path", default="")
    ap.add_argument("--backbone", default="ViT-B/16")
    ap.add_argument("--datasets", nargs="+", default=sorted(PUBLISHED_VIT_B16))
    ap.add_argument("--tolerance", type=float, default=1.0,
                    help="max |measured - published| in accuracy points")
    ap.add_argument("--device", default=None, help="'cpu' for the plain versions; "
                    "default the card")
    # trailing KEY VALUE config overrides: taken from the unparsed leftovers
    # (an argparse.REMAINDER positional after --datasets nargs='+' would be
    # swallowed BY --datasets and silently dropped)
    args, opts = ap.parse_known_args(argv)
    bad = [o for o in opts if o.startswith("-")]
    if bad:
        ap.error(f"unknown flags {bad}; config overrides are KEY VALUE pairs")
    swallowed = [d for d in args.datasets if d.isupper() and "." in d]
    if swallowed:
        ap.error(
            f"--datasets swallowed config override keys {swallowed}: put "
            "KEY VALUE overrides BEFORE --datasets"
        )

    from mudpt_torch.trainers.base import build_trainer

    failures = []
    for dataset in args.datasets:
        cfg = dataset_config(dataset, args.dataset_root, args.backbone, args.backbone_path, opts)
        trainer = build_trainer(cfg, devices=args.device)
        acc = trainer.test()["accuracy"]
        published = PUBLISHED_VIT_B16.get(dataset)
        if published is None:
            print(f"{dataset}: measured {acc:.2f} (no published value)")
            continue
        delta = acc - published
        status = "OK" if abs(delta) <= args.tolerance else "FAIL"
        print(f"{dataset}: measured {acc:.2f} published {published:.2f} "
              f"delta {delta:+.2f} [{status}]")
        if status == "FAIL":
            failures.append(dataset)

    if failures:
        print(f"\nFAILED: {failures}")
        return 1
    print("\nAll zero-shot accuracies within tolerance.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
