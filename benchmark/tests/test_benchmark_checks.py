"""The comparison that decides ``correct`` fails what it has to fail.

On the CPU, at tiny widths, with each cell's own limits: a run of the whole
harness (set-up, window, reference, judgement; only the look for a card is
skipped) is correct, and comes out not correct with its timed path broken
underneath (a step that leaves the state unchanged, a step on half of its
batch, an answer altered where it is produced, half of a request answered
from the other half's pixels) and with the control in the
program's place (the reference rounded to the precision below the cell's).
On the card, the control at each cell's own size, three seeds each."""

import json

import pytest
import torch

from benchmark import calibrate, cells, check, run, spec
from benchmark.tests.conftest import CELLS, tiny_cell

CPU = torch.device("cpu")
SEEDS = (1, 2, 3)


def _run(kind, fault=None, **config):
    return run.run_cell(tiny_cell(kind, **config), 2 ** 31 + 99, 0.2, False, CPU, fault=fault)


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_a_sound_run_is_correct(kind):
    result = _run(kind)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(spec.load(CELLS[kind]).limits)


@pytest.mark.parametrize("kind,fault", [("train", "state_unchanged"), ("train", "half_batch"),
                                        ("serve", "altered_answer"), ("serve", "half_request"),
                                        ("serve_int8", "altered_answer"),
                                        ("serve_int8", "half_request")])
def test_a_broken_timed_path_is_not_correct(kind, fault):
    assert not _run(kind, fault)["correct"]


# widths at which the tiny model's bf16 (int8) route is far enough from fp8
# (int4); the serving controls compare 100 classes (the cells 100 and 1,000)
WIDER = {"vision_width": 128, "transformer_width": 128, "vision_layers": 4}
CONTROL = {"train": {}, "serve": WIDER, "serve_int8": WIDER}


@pytest.mark.parametrize("kind", sorted(CELLS))
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_is_not_correct(kind, seed):
    cell = tiny_cell(kind, **CONTROL[kind])
    if kind != "train":
        cell.traffic = dict(cell.traffic, n_cls=100)
    r = calibrate.readings(cell, seed, 0.0, CPU, control=True, faults=False)
    assert check.judge(r["program"], cell.limits)[0]
    assert not check.judge(r["control"], cell.limits)[0]


WORKLOADS = sorted(w["name"] for w in
                   json.loads((spec.ROOT / "BENCHMARK.json").read_text())["workloads"])


@pytest.mark.card
@pytest.mark.parametrize("name", WORKLOADS)
def test_the_control_is_not_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their own sizes")
    cell = spec.load(name)
    dev = torch.device("cuda", 0)
    for seed in SEEDS:
        r = calibrate.readings(cell, 2 ** 31 + seed, 0.0, dev, control=True, faults=False)
        cells.free()
        assert check.judge(r["program"], cell.limits)[0], r["program"]
        assert not check.judge(r["control"], cell.limits)[0], r["control"]
