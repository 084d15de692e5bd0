"""Gloo ranks on the CPU against one process: MuDPT's first two steps on
meshes (2,1) and (1,2) (losses, the first step's gradients, the prompts
after the second step, each to 1e-5 as ``tests/test_sharding_equivalence.py``
holds the JAX package's meshes), the replicas bit-equal after every step,
the test confusion matrix summed over the data group (each test image
counted once), a checkpoint saved by rank 0 and loaded on every rank
(``tests/test_multihost.py:170-178``), a class count that the model axis
does not divide (5 classes padded to 6, the padded classes masked), and a
host-sharded run through ``train()`` (DATALOADER.HOST_SHARD on: each data
index decodes its own items) in lockstep.  The (2,2) mesh, against the JAX
package's too, and CoCoOp on it are in ``tests/test_torch_mesh.py``."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests import torch_multirank_worker as W

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def save_batches(tr, path: str, steps: int = STEPS) -> str:
    """The trainer's first ``steps`` global batches, as the worker reads them."""
    out = {}
    for i, b in enumerate(tr.dm.train_loader):
        if i == steps:
            break
        out.update({f"{i}/{k}": v for k, v in b.items()})
    np.savez(path, **out)
    return path


def run_ranks(world: int, out: Path, cases: list, timeout: int = 240) -> list:
    """The job on ``world`` gloo ranks (fresh processes); each rank's
    records by case name."""
    job = out / "job.json"
    job.write_text(json.dumps({"out": str(out), "cases": cases}))
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_multirank_worker", str(r), str(world), str(port),
         str(job)], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [{c["name"]: dict(np.load(out / f"{c['name']}-rank{r}.npz")) for c in cases}
            for r in range(world)]


def rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(b).max(), 1e-30))


def hold_steps(ranks: list, ref: dict) -> None:
    """Every rank's losses, first-step gradients and final prompts against
    one process's, to TOL; the replicas bit-equal after every step."""
    for rec in ranks:
        np.testing.assert_allclose(rec["losses"], ref["losses"], rtol=0, atol=TOL)
        np.testing.assert_allclose(rec["accs"], ref["accs"], rtol=0, atol=1e-6)
        for k in ref:
            if k.startswith(("grad/", "prompt/")):
                assert rec[k].shape == ref[k].shape, k
                assert rel(rec[k], ref[k]) <= TOL, (k, rel(rec[k], ref[k]))
        assert list(rec["digests"]) == list(ranks[0]["digests"])  # replicas bit-equal


def hold_confusion(ranks: list, ref: dict, n_test: int, same_prompts: bool) -> None:
    """Each test image counted once on every rank; with the prompts of one
    process, its scores (a near-tie may fall the other way for one image)."""
    for rec in ranks:
        assert int(rec["conf"].sum()) == int(ref["conf"].sum()) == n_test
        assert np.array_equal(rec["conf"], ranks[0]["conf"])
        assert not same_prompts or np.abs(rec["conf"] - ref["conf"]).sum() <= 2


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One job of two ranks: (2,1) and (1,2) on stored batches, then the
    host-sharded (2,1) run through train(); the one-process references."""
    tmp = tmp_path_factory.mktemp("world2")
    b4 = save_batches(W.build("MuDPT", str(tmp / "b4")), str(tmp / "b4.npz"))
    five = ["DATASET.SYNTHETIC_NUM_CLASSES", "5"]
    b5 = save_batches(W.build("MuDPT", str(tmp / "b5"), *five), str(tmp / "b5.npz"))
    cases = [
        dict(name="d2", trainer="MuDPT", batches=b4,
             opts=["PARALLEL.DATA", "2", "DATALOADER.HOST_SHARD", "off"]),
        dict(name="m2", trainer="MuDPT", batches=b5, opts=["PARALLEL.MODEL", "2", *five]),
        dict(name="hs", trainer="MuDPT", batches=None,
             opts=["PARALLEL.DATA", "2", "DATALOADER.HOST_SHARD", "on"]),
    ]
    ranks = run_ranks(2, tmp, cases)
    refs = {"d2": W.run_case(dict(cases[0], opts=[]), str(tmp / "ref_d2")),
            "m2": W.run_case(dict(cases[1], opts=five), str(tmp / "ref_m2")),
            "hs": W.run_case(dict(cases[2], opts=[]), str(tmp / "ref_hs"))}
    return ranks, refs, tmp


def _case(world2, name):
    ranks, refs, _ = world2
    return [r[name] for r in ranks], refs[name]


def test_data_parallel_steps_match_one_process(world2):
    ranks, ref = _case(world2, "d2")
    hold_steps(ranks, ref)


def test_class_parallel_steps_match_one_process_with_padded_classes(world2):
    """5 classes over a model axis of 2: the class buffers pad to 6 rows,
    and the padded class takes no part in the loss."""
    ranks, ref = _case(world2, "m2")
    assert all(int(r["n_cls_padded"]) == 6 for r in ranks) and int(ref["n_cls_padded"]) == 5
    hold_steps(ranks, ref)


@pytest.mark.parametrize("name,n_test", [("d2", 16), ("m2", 20), ("hs", 16)])
def test_confusion_counts_each_test_image_once(world2, name, n_test):
    """The host-sharded run trained on other batches than one process."""
    ranks, ref = _case(world2, name)
    hold_confusion(ranks, ref, n_test, same_prompts=name != "hs")


@pytest.mark.parametrize("name", ["d2", "m2", "hs"])
def test_checkpoint_saved_on_rank0_loads_on_every_rank(world2, name):
    ranks, _ = _case(world2, name)
    sums = [float(r["ckpt_sum"]) for r in ranks]
    assert sums[0] == sums[1] and np.isfinite(sums[0]) and sums[0] != 0.0


def test_host_sharded_train_runs_in_lockstep(world2):
    """HOST_SHARD on: each data index decodes half the items, in batches of
    half the global batch; both ranks end bit-equal, after as many steps
    as one process takes, and the epoch's checkpoint is written once."""
    ranks, _ = _case(world2, "hs")
    assert ranks[0]["digests"][0] == ranks[1]["digests"][0]
    out = world2[2] / "hs"
    with open(out / "metrics.jsonl") as f:
        steps0 = [json.loads(x)["step"] for x in f if '"kind": "train"' in x]
    with open(out / "metrics.jsonl-host1") as f:
        steps1 = [json.loads(x)["step"] for x in f if '"kind": "train"' in x]
    assert steps0 == steps1 == [4]  # 32 items, batches of 8: the last step logged
    assert sorted(p.name for p in (out / "MultimodalDeepPromptTuning").iterdir()) \
        == ["model.pth.tar-1", "model.pth.tar-1.json"]
