"""The resumable accuracy protocol in one command (counterpart of
``tools/run_protocol.py``), over the port's trainers:

  1. zeroshot    ZeroshotCLIP over the 11 datasets, beside the published
                 CLIP ViT-B/16 zero-shot accuracies (with real weights).
  2. fewshot     NUM_SHOTS-shot prompt tuning (default MuDPT) a dataset and
                 a seed, the final test accuracy.
  3. base2new    train on the base half of the classes, evaluate the
                 checkpoint on the base and the new halves; the summary
                 reports base, new and their harmonic mean H.
  4. domain_gen  train on the source dataset (imagenet), evaluate the
                 checkpoint on the four ImageNet shift variants.
  5. parse       everything into ``protocol_summary.json`` (and a printed
                 table): mean and std over seeds a stage and a dataset,
                 beside published values where known.

Each (stage, dataset, seed) unit writes ``protocol_result.json`` into its
output directory and is skipped on a rerun when that file exists: stop it
anywhere, rerun the same command, and it goes on.

  python -m mudpt_torch.tools.run_protocol --dataset_root ~/data \
      --backbone_path ~/.cache/clip/ViT-B-16.pt --output_root output/protocol \
      --seeds 1 2 3

The synthetic dry run (the in-memory Synthetic dataset, the test-tiny
backbone, random weights, one seed) runs every stage, the checkpoint
transfer, the skip on a rerun and the summary:

  python -m mudpt_torch.tools.run_protocol --synthetic --output_root DIR --device cpu

``--published table.json`` maps ``{"fewshot": {dataset: acc}, "base2new_h":
{dataset: h}}`` to compare against.  ``main`` returns the summary; the exit
code is 0 iff every available comparison is within ``--tolerance``.
Without ``--device`` it runs on the card and raises when CUDA is absent.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from statistics import mean, stdev

STAGES = ("zeroshot", "fewshot", "base2new", "domain_gen", "parse")
DATASETS = [
    "imagenet", "caltech101", "oxford_pets", "stanford_cars",
    "oxford_flowers", "food101", "fgvc_aircraft", "sun397", "dtd",
    "eurosat", "ucf101",
]
SHIFT_VARIANTS = ["imagenetv2", "imagenet_sketch", "imagenet_a", "imagenet_r"]
_RESULT = "protocol_result.json"
# Published zero-shot top-1 of CLIP ViT-B/16 with the hand-crafted single
# template (CoOp, IJCV 2022, Table 1 "zero-shot CLIP"), the table of
# ``tools/validate_zeroshot.py``
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


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mudpt_torch.tools.run_protocol", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset_root", default="")
    ap.add_argument("--output_root", required=True)
    ap.add_argument("--backbone", default="ViT-B/16")
    ap.add_argument("--backbone_path", default="")
    ap.add_argument("--trainer", default="MuDPT",
                    help="prompt-tuning method for stages 2-4")
    ap.add_argument("--trainer_config", default="",
                    help="trainer YAML (default: the reference MuDPT "
                    "config configs/trainers/MuDPT/vit_b16_bz4_ep10_"
                    "nctx2_depth9.yaml)")
    ap.add_argument("--datasets", nargs="+", default=None)
    ap.add_argument("--seeds", type=int, nargs="+", default=None)
    ap.add_argument("--shots", type=int, default=16)
    ap.add_argument("--stages", nargs="+", choices=STAGES, default=list(STAGES))
    ap.add_argument("--tolerance", type=float, default=1.0,
                    help="max |measured - published| accuracy points")
    ap.add_argument("--published", default="",
                    help="JSON file of published tables to compare against")
    ap.add_argument("--synthetic", action="store_true",
                    help="synthetic dry-run: tiny backbone, in-memory "
                    "dataset, 1 seed — proves the plumbing end to end")
    ap.add_argument("--device", default=None, help="'cpu' for the plain versions; "
                    "default the card")
    args = ap.parse_args(argv)
    if args.synthetic:
        args.datasets = args.datasets or ["synthetic"]
        args.seeds = args.seeds or [1]
        args.backbone = "test-tiny"
        args.backbone_path = "random"
        args.shots = min(args.shots, 2)
    else:
        args.datasets = args.datasets or DATASETS
        args.seeds = args.seeds or [1, 2, 3]
    return args


def _repo():
    """The checkout holding ``configs/`` (this file is mudpt_torch/tools/)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _build_cfg(args, dataset, seed, subsample="all", shots=None,
               trainer=None, output_dir=""):
    from mudpt_torch.config import default_config, merge_from_file

    cfg = default_config()
    merge_from_file(
        cfg, os.path.join(_repo(), "configs", "datasets", f"{dataset}.yaml")
    )
    trainer = trainer or args.trainer
    if trainer not in ("ZeroshotCLIP", "ZeroshotCLIP2"):
        tc = args.trainer_config or os.path.join(
            _repo(), "configs", "trainers", "MuDPT",
            "vit_b16_bz4_ep10_nctx2_depth9.yaml",
        )
        if not args.synthetic:
            merge_from_file(cfg, tc)
        elif args.trainer_config:
            merge_from_file(cfg, args.trainer_config)
    cfg.TRAINER.NAME = trainer
    cfg.SEED = seed
    cfg.DATASET.ROOT = args.dataset_root
    cfg.DATASET.NUM_SHOTS = shots if shots is not None else args.shots
    cfg.DATASET.SUBSAMPLE_CLASSES = subsample
    cfg.MODEL.BACKBONE.NAME = args.backbone
    cfg.MODEL.BACKBONE.PATH = args.backbone_path
    cfg.OUTPUT_DIR = output_dir
    if args.synthetic:
        cfg.INPUT.SIZE = (32, 32)
        cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 8
        cfg.DATALOADER.TEST.BATCH_SIZE = 8
        cfg.DATALOADER.NUM_WORKERS = 2
        cfg.OPTIM.MAX_EPOCH = 1
        cfg.OPTIM.WARMUP_EPOCH = 0
        hp = cfg.trainer_params(trainer) if trainer not in (
            "ZeroshotCLIP", "ZeroshotCLIP2") else None
        if hp is not None and hasattr(hp, "PREC"):
            hp.PREC = "fp32"
    return cfg


def _unit_dir(args, *parts) -> str:
    return os.path.join(args.output_root, *map(str, parts))


def _done(unit: str):
    p = os.path.join(unit, _RESULT)
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return None


def _record(unit: str, result: dict) -> dict:
    os.makedirs(unit, exist_ok=True)
    tmp = os.path.join(unit, _RESULT + ".tmp")
    with open(tmp, "w") as f:
        json.dump(result, f, indent=1)
    os.replace(tmp, os.path.join(unit, _RESULT))
    return result


def _run_unit(unit: str, label: str, fn):
    prior = _done(unit)
    if prior is not None:
        print(f"[skip] {label} (done: {prior.get('accuracy', '?')})")
        return prior
    print(f"[run ] {label}")
    return _record(unit, fn())


def _load_for_eval(trainer, model_dir: str):
    epoch = trainer._resolve_checkpoint_epoch(model_dir)
    trainer.load_model(model_dir, epoch=epoch)


def stage_zeroshot(args, results):
    from mudpt_torch.trainers import build_trainer

    for dataset in args.datasets:
        unit = _unit_dir(args, "zeroshot", dataset)

        def run(dataset=dataset, unit=unit):
            cfg = _build_cfg(args, dataset, seed=1, shots=-1,
                             trainer="ZeroshotCLIP", output_dir=unit)
            res = build_trainer(cfg, devices=args.device).test()
            out = {"stage": "zeroshot", "dataset": dataset,
                   "accuracy": res["accuracy"], "macro_f1": res["macro_f1"]}
            pub = PUBLISHED_VIT_B16.get(dataset)
            if pub is not None and args.backbone_path not in ("", "random"):
                out["published"] = pub
                out["delta"] = res["accuracy"] - pub
            return out

        results.append(_run_unit(unit, f"zeroshot/{dataset}", run))


def stage_fewshot(args, results):
    from mudpt_torch.trainers import build_trainer

    for dataset in args.datasets:
        for seed in args.seeds:
            unit = _unit_dir(args, "fewshot", dataset, f"seed_{seed}")

            def run(dataset=dataset, seed=seed, unit=unit):
                cfg = _build_cfg(args, dataset, seed, output_dir=unit)
                # train() would otherwise end with after_train()'s own full
                # test pass — the explicit evaluate() below is the one this
                # unit records, so skip the duplicate
                cfg.TEST.NO_TEST = True
                tr = build_trainer(cfg, devices=args.device)
                tr.train()
                res = tr.evaluate(tr.dm.test_loader)
                return {"stage": "fewshot", "dataset": dataset, "seed": seed,
                        "shots": cfg.DATASET.NUM_SHOTS,
                        "accuracy": res["accuracy"]}

            results.append(
                _run_unit(unit, f"fewshot/{dataset}/seed_{seed}", run)
            )


def stage_base2new(args, results):
    from mudpt_torch.trainers import build_trainer

    for dataset in args.datasets:
        for seed in args.seeds:
            train_unit = _unit_dir(args, "base2new", dataset, f"seed_{seed}",
                                   "train_base")

            def run_base(dataset=dataset, seed=seed, unit=train_unit):
                cfg = _build_cfg(args, dataset, seed, subsample="base",
                                 output_dir=unit)
                cfg.TEST.NO_TEST = True  # the explicit evaluate() is the record
                tr = build_trainer(cfg, devices=args.device)
                tr.train()
                res = tr.evaluate(tr.dm.test_loader)
                return {"stage": "base2new", "split": "base",
                        "dataset": dataset, "seed": seed,
                        "accuracy": res["accuracy"]}

            results.append(
                _run_unit(train_unit,
                          f"base2new/{dataset}/seed_{seed}/base", run_base)
            )

            new_unit = _unit_dir(args, "base2new", dataset, f"seed_{seed}",
                                 "test_new")

            def run_new(dataset=dataset, seed=seed, unit=new_unit,
                        model_dir=train_unit):
                # the transfer reload: fresh class buffers for the NEW half,
                # learned prompts restored (reference test_base2new.sh:40-44)
                cfg = _build_cfg(args, dataset, seed, subsample="new",
                                 output_dir=unit)
                tr = build_trainer(cfg, devices=args.device)
                _load_for_eval(tr, model_dir)
                res = tr.test()
                return {"stage": "base2new", "split": "new",
                        "dataset": dataset, "seed": seed,
                        "accuracy": res["accuracy"]}

            results.append(
                _run_unit(new_unit,
                          f"base2new/{dataset}/seed_{seed}/new", run_new)
            )


def stage_domain_gen(args, results):
    from mudpt_torch.trainers import build_trainer

    source = "synthetic" if args.synthetic else "imagenet"
    variants = args.datasets if args.synthetic else SHIFT_VARIANTS
    for seed in args.seeds:
        train_unit = _unit_dir(args, "domain_gen", f"seed_{seed}", source)

        def run_src(seed=seed, unit=train_unit):
            cfg = _build_cfg(args, source, seed, output_dir=unit)
            cfg.TEST.NO_TEST = True  # the explicit evaluate() is the record
            tr = build_trainer(cfg, devices=args.device)
            tr.train()
            res = tr.evaluate(tr.dm.test_loader)
            return {"stage": "domain_gen", "split": f"source:{source}",
                    "seed": seed, "accuracy": res["accuracy"]}

        results.append(
            _run_unit(
                train_unit, f"domain_gen/seed_{seed}/train_{source}", run_src
            )
        )

        for variant in variants:
            v_unit = _unit_dir(args, "domain_gen", f"seed_{seed}", f"eval_{variant}")

            def run_var(variant=variant, seed=seed, unit=v_unit,
                        model_dir=train_unit):
                cfg = _build_cfg(args, variant, seed, shots=-1,
                                 output_dir=unit)
                tr = build_trainer(cfg, devices=args.device)
                _load_for_eval(tr, model_dir)
                res = tr.test()
                return {"stage": "domain_gen", "split": variant,
                        "seed": seed, "accuracy": res["accuracy"]}

            results.append(
                _run_unit(
                    v_unit, f"domain_gen/seed_{seed}/eval_{variant}", run_var
                )
            )


def _harmonic(a: float, b: float) -> float:
    return 2 * a * b / (a + b) if (a + b) else 0.0


def stage_parse(args, results) -> dict:
    """Aggregate: mean +/- std over seeds, base2new H, published deltas."""
    from collections import defaultdict

    # re-read everything from disk so parse works standalone on a
    # partially- or previously-run tree
    found = []
    for root, _, files in os.walk(args.output_root):
        if _RESULT in files:
            with open(os.path.join(root, _RESULT)) as f:
                found.append(json.load(f))

    summary = {"n_units": len(found)}
    zs = {r["dataset"]: r for r in found if r.get("stage") == "zeroshot"}
    if zs:
        summary["zeroshot"] = {
            d: {k: r[k] for k in ("accuracy", "published", "delta") if k in r}
            for d, r in sorted(zs.items())
        }

    by = defaultdict(list)
    for r in found:
        if r.get("stage") == "fewshot":
            by[r["dataset"]].append(r["accuracy"])
    if by:
        summary["fewshot"] = {
            d: {"mean": mean(v), "std": stdev(v) if len(v) > 1 else 0.0,
                "n_seeds": len(v)}
            for d, v in sorted(by.items())
        }

    b2n = defaultdict(dict)
    for r in found:
        if r.get("stage") == "base2new":
            b2n[(r["dataset"], r["seed"])][r["split"]] = r["accuracy"]
    if b2n:
        per_ds = defaultdict(lambda: {"base": [], "new": [], "H": []})
        for (d, _), splits in b2n.items():
            if "base" in splits and "new" in splits:
                per_ds[d]["base"].append(splits["base"])
                per_ds[d]["new"].append(splits["new"])
                per_ds[d]["H"].append(_harmonic(splits["base"], splits["new"]))
        summary["base2new"] = {
            d: {k: mean(v) for k, v in agg.items() if v}
            for d, agg in sorted(per_ds.items())
        }

    dg = defaultdict(list)
    for r in found:
        if r.get("stage") == "domain_gen":
            dg[r["split"]].append(r["accuracy"])
    if dg:
        summary["domain_gen"] = {
            s: {"mean": mean(v), "n_seeds": len(v)} for s, v in sorted(dg.items())
        }

    failures = []
    if args.published:
        with open(args.published) as f:
            published = json.load(f)
        comp = {}
        for d, pub in published.get("fewshot", {}).items():
            got = summary.get("fewshot", {}).get(d)
            if got:
                delta = got["mean"] - pub
                comp[f"fewshot/{d}"] = {"published": pub, "delta": delta}
                if abs(delta) > args.tolerance:
                    failures.append(f"fewshot/{d}")
        for d, pub in published.get("base2new_h", {}).items():
            got = summary.get("base2new", {}).get(d, {}).get("H")
            if got is not None:
                delta = got - pub
                comp[f"base2new_h/{d}"] = {"published": pub, "delta": delta}
                if abs(delta) > args.tolerance:
                    failures.append(f"base2new_h/{d}")
        summary["published_comparison"] = comp
    for d, r in (summary.get("zeroshot") or {}).items():
        if "delta" in r and abs(r["delta"]) > args.tolerance:
            failures.append(f"zeroshot/{d}")
    summary["failures"] = failures

    os.makedirs(args.output_root, exist_ok=True)
    out = os.path.join(args.output_root, "protocol_summary.json")
    with open(out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"\n=== protocol summary ({out}) ===")
    print(json.dumps(summary, indent=1))
    return summary


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.device is None:
        from mudpt_torch.utils.device import resolve_device

        resolve_device(None)  # the card, or raise before the first unit
    results = []
    if "zeroshot" in args.stages:
        stage_zeroshot(args, results)
    if "fewshot" in args.stages:
        stage_fewshot(args, results)
    if "base2new" in args.stages:
        stage_base2new(args, results)
    if "domain_gen" in args.stages:
        stage_domain_gen(args, results)
    return stage_parse(args, results) if "parse" in args.stages else {}


if __name__ == "__main__":
    sys.exit(1 if main().get("failures") else 0)
