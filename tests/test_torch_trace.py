"""``TRAIN.PROFILE_DIR``: the trainer traces batch 1 of epoch 0, as the JAX
package does (``mudpt_tpu/trainers/base.py:780-781``), in a window opened
before batch 0, whose step runs as the profiler's warmup (its events
dropped).  On the CPU at tiny size: one trace file whose recorded window
holds exactly one train step's ops, for a fresh epoch and for a run
resumed at batch 1; no file where the JAX package traces nothing (a run
resumed past batch 1, a one-batch epoch, a run preempted after batch 0).
The step time a print logs is the host clock's mean since the last print,
with no synchronize a step."""

import collections
import glob
import json
import os
import signal
from types import SimpleNamespace

import pytest
import torch

from mudpt_torch.config import load_config
from mudpt_torch.trainers import base
from mudpt_torch.trainers.base import build_trainer

FILES = ("configs/datasets/synthetic.yaml", "configs/trainers/test/tiny.yaml")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _trainer(out, prof, *more):
    opts = ["TRAINER.NAME", "MuDPT", "OUTPUT_DIR", str(out), "TRAIN.PROFILE_DIR", str(prof),
            "TEST.NO_TEST", "True", *more]
    tr = build_trainer(load_config(*FILES, opts=opts), devices="cpu")
    step = tr._train_step

    def marked_step(batch):
        # a mark a step, named by the steps taken before it (the batch's
        # index in epoch 0, also in a resumed run)
        with torch.profiler.record_function(f"train_step_{tr.global_step}"):
            return step(batch)

    tr._train_step = marked_step
    return tr


def _preempt_after(tr, n_steps):
    step = tr._train_step

    def preempting_step(batch):
        out = step(batch)
        if tr.global_step == n_steps - 1:  # the n-th batch is about to finish
            os.kill(os.getpid(), signal.SIGTERM)  # the trainer's handler sets the flag
        return out

    tr._train_step = preempting_step


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _ops(events):
    return collections.Counter(e["name"] for e in events if e.get("cat") == "cpu_op")


def _marks(events):
    """The step marks and the profiler's own step annotations: a window
    after one warmup step is the profiler's step 1."""
    return sorted(e["name"] for e in events if e.get("cat") == "user_annotation"
                  and e["name"].startswith(("train_step_", "ProfilerStep#")))


def _one_step_ops(tr, tmp_path):
    """The ops of one more train step, traced alone."""
    batch = tr._device_batch(next(iter(tr.dm.train_loader)))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tr._train_step(batch)
    prof.export_chrome_trace(str(tmp_path / "alone.json"))
    return _ops(_events(tmp_path / "alone.json"))


def _check_window(prof_dir, tr, tmp_path):
    (trace,) = glob.glob(f"{prof_dir}/trace-*.json")
    events = _events(trace)
    assert _marks(events) == ["ProfilerStep#1", "train_step_1"]
    assert _ops(events) == _one_step_ops(tr, tmp_path)


def test_fresh_epoch_traces_batch_1(tmp_path):
    tr = _trainer(tmp_path / "out", tmp_path / "prof")
    tr.train()
    assert len(tr.dm.train_loader) == 4 and tr.global_step == 4
    _check_window(tmp_path / "prof", tr, tmp_path)


def test_run_resumed_at_batch_1_traces_it(tmp_path):
    """Preempted after batch 0: the window closes in its warmup and writes
    nothing; the run resumed at batch 1 traces batch 1."""
    part = _trainer(tmp_path / "out", tmp_path / "prof")
    _preempt_after(part, 1)
    part.train()
    assert os.path.exists(tmp_path / "out" / part.model_name / "model-preempt.pth.tar")
    assert not glob.glob(f"{tmp_path}/prof/trace-*.json")
    resumed = _trainer(tmp_path / "out", tmp_path / "prof", "RESUME", str(tmp_path / "out"))
    resumed.train()
    assert resumed.global_step == 4
    _check_window(tmp_path / "prof", resumed, tmp_path)


def test_run_resumed_past_batch_1_traces_nothing(tmp_path):
    """Preempted after batch 1: that run traced batch 1; the run resumed at
    batch 2 traces no step, as the JAX package's."""
    part = _trainer(tmp_path / "out", tmp_path / "prof")
    _preempt_after(part, 2)
    part.train()
    _check_window(tmp_path / "prof", part, tmp_path)
    resumed = _trainer(tmp_path / "out", tmp_path / "prof2", "RESUME", str(tmp_path / "out"))
    resumed.train()
    assert resumed.global_step == 4 and not glob.glob(f"{tmp_path}/prof2/trace-*.json")


def test_one_batch_epoch_traces_nothing(tmp_path):
    tr = _trainer(tmp_path / "out", tmp_path / "prof", "DATALOADER.TRAIN_X.BATCH_SIZE", "64")
    tr.train()
    assert len(tr.dm.train_loader) == 1 and not glob.glob(f"{tmp_path}/prof/trace-*.json")


def test_window_edge_idles_the_card_only(monkeypatch):
    """``window_edge`` (the trainer's recorded window, at both edges):
    on a card it synchronizes, then lets the card sit idle for
    ``WINDOW_EDGE_S``; on the CPU it does nothing."""
    from mudpt_torch.utils import profiling

    calls = []
    monkeypatch.setattr(profiling.torch.cuda, "synchronize", lambda d: calls.append(("sync", d)))
    monkeypatch.setattr(profiling.time, "sleep", lambda s: calls.append(("sleep", s)))
    profiling.window_edge(torch.device("cpu"))
    assert calls == []
    card = torch.device("cuda", 0)
    profiling.window_edge(card)
    assert calls == [("sync", card), ("sleep", profiling.WINDOW_EDGE_S)]


def test_step_time_is_the_host_mean_since_the_last_print(tmp_path, monkeypatch):
    """At ``TRAIN.PRINT_FREQ 2`` the 4-batch epoch logs two step times, each
    the mean of its 2 steps on the host clock, which is read at the epoch's
    start and after each print's loss fetch only; no step synchronizes."""
    out = tmp_path / "out"
    opts = ["TRAINER.NAME", "MuDPT", "OUTPUT_DIR", str(out), "TRAIN.PRINT_FREQ", "2",
            "TEST.NO_TEST", "True"]
    tr = build_trainer(load_config(*FILES, opts=opts), devices="cpu")
    reads = iter([10.0, 10.5, 13.0])
    monkeypatch.setattr(base, "time", SimpleNamespace(perf_counter=lambda: next(reads),
                                                      time=base.time.time))
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: syncs.append(a))
    tr.train()
    assert len(tr.dm.train_loader) == 4 and tr.global_step == 4
    with open(out / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    logged = [(r["step"], r["step_time"], r["imgs_per_sec"]) for r in rows if r["kind"] == "train"]
    assert logged == [(2, 0.25, 32.0), (4, 1.25, 6.4)]
    assert syncs == [] and next(reads, None) is None
