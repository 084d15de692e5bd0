"""One gloo rank of ``tests/test_torch_multirank.py`` on the CPU, and the
helpers both sides run: a tiny trainer on the synthetic dataset, a few
train steps on given global batches (each rank takes its rows), the test
confusion matrix and a checkpoint round trip.

    python -m tests.torch_multirank_worker RANK WORLD PORT JOB.json

Each case of the job writes ``<out>/<name>-rank<RANK>.npz``.  Imports torch
and the port only: a rank starts in a second or two.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np
import torch

FILES = ("configs/datasets/synthetic.yaml", "configs/trainers/test/tiny.yaml")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build(trainer: str, out: str, *opts: str):
    """A tiny fp32 trainer (test-tiny, 32 px) on the CPU."""
    from mudpt_torch.config import load_config
    from mudpt_torch.trainers.base import build_trainer

    more = ["TRAINER.COCOOP.PREC", "fp32"] if trainer == "CoCoOp" else []
    cfg = load_config(*(os.path.join(ROOT, f) for f in FILES),
                      opts=["TRAINER.NAME", trainer, "OUTPUT_DIR", out, *more, *opts])
    return build_trainer(cfg, devices="cpu")


def names(tree: dict, prefix: str = "") -> list:
    out = []
    for k, v in tree.items():
        out += names(v, f"{prefix}{k}/") if isinstance(v, dict) else [prefix + k]
    return out


def digest(tr) -> str:
    """The trainable leaves' bytes, hashed: equal across ranks iff the
    replicas are bit-equal."""
    from mudpt_torch.models.clip import leaves

    h = hashlib.sha256()
    for t in leaves(tr.trainable):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def cross_weights(tr, path: str) -> None:
    """Place the JAX trainer's trees (``frozen/``, ``aux/``, ``trainable/``
    keys of an npz) into the port's trainer and rebuild its optimizer."""
    from mudpt_torch.models.convert import params_from_numpy

    trees: dict = {}
    with np.load(path) as f:
        for key in f.files:
            node = trees
            *parts, leaf = key.split("/")
            for p in parts:
                node = node.setdefault(p, {})
            node[leaf] = f[key]
    tr.place(frozen=params_from_numpy(trees["frozen"], "cpu"),
             aux_class_tree=params_from_numpy(trees["aux"], "cpu"), aux_repl=None,
             trainable=params_from_numpy(trees["trainable"], "cpu"))
    tr._build_train_state()


def run_steps(tr, batches: list) -> dict:
    """Train steps on global batches, each rank on its rows: the global
    losses and accuracies, the first step's gradients (summed over the
    mesh), the trainable leaves after the last step and their digest after
    every step."""
    from mudpt_torch.models.clip import leaves
    from mudpt_torch.parallel.mesh import shard_batch

    rec = {"losses": [], "accs": [], "digests": []}
    keys = names(tr.trainable)
    for i, batch in enumerate(batches):
        loss, acc = tr._train_step(tr._device_batch(shard_batch(tr.mesh, batch)))
        rec["losses"].append(float(loss))
        rec["accs"].append(float(acc))
        rec["digests"].append(digest(tr))
        if i == 0:
            rec.update({f"grad/{k}": p.grad.detach().numpy().copy()
                        for k, p in zip(keys, tr._params)})
    rec.update({f"prompt/{k}": t.detach().numpy().copy()
                for k, t in zip(keys, leaves(tr.trainable))})
    return rec


def confusion(tr) -> np.ndarray:
    """The test split's confusion matrix as ``evaluate`` sums it."""
    from mudpt_torch.trainers import base

    kept = []
    build = base.build_evaluator

    def keep(*a, **k):
        kept.append(build(*a, **k))
        return kept[-1]

    base.build_evaluator = keep
    try:
        tr.evaluate(tr.dm.test_loader)
    finally:
        base.build_evaluator = build
    return kept[0]._conf


def checkpoint_round_trip(tr) -> float:
    """Save on the primary, load on every rank: the loaded leaves' sum."""
    from mudpt_torch.models.clip import leaves

    tr.save_model()
    with torch.no_grad():
        for t in leaves(tr.trainable):
            t.zero_()
    tr.load_model(tr.cfg.OUTPUT_DIR, epoch=tr.epoch + 1)
    return float(sum(t.detach().double().sum() for t in leaves(tr.trainable)))


def run_case(case: dict, out: str) -> dict:
    """One case of a job: build, optionally cross weights, then the steps
    on the case's batches or ``train()`` through the loaders."""
    tr = build(case["trainer"], out, *case["opts"])
    if case.get("weights"):
        cross_weights(tr, case["weights"])
    rec = {}
    if case.get("batches"):
        with np.load(case["batches"]) as f:
            n = len({k.split("/")[0] for k in f.files})
            batches = [{k: f[f"{i}/{k}"] for k in ("image", "label", "valid")}
                       for i in range(n)]
        rec.update(run_steps(tr, batches))
    else:
        tr.train()
        rec["digests"] = [digest(tr)]
    rec["conf"] = confusion(tr)
    rec["ckpt_sum"] = checkpoint_round_trip(tr)
    rec["n_cls_padded"] = tr.n_cls_padded
    return rec


def main(argv) -> int:
    rank, world, port, job = int(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from mudpt_torch.parallel.multihost import maybe_initialize_distributed

    maybe_initialize_distributed("gloo")
    with open(job) as f:
        spec = json.load(f)
    try:
        for case in spec["cases"]:
            rec = run_case(case, os.path.join(spec["out"], case["name"]))
            np.savez(os.path.join(spec["out"], f"{case['name']}-rank{rank}.npz"),
                     **{k: np.asarray(v) for k, v in rec.items()})
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
