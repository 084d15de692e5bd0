"""The port's spans (``utils/profiling.span``): ``record_function`` ranges
named ``mudpt.prompts``, ``mudpt.text``, ``mudpt.vision`` and
``mudpt.logits``, entered only while a profiler session records.  On the
CPU at tiny size: no span without a profiler; under one, each span once a
step of ``mudpt_forward`` (the prompts' twice, and once more inside
``compose_prompts``), nested as the code nests them; each backward op's
``Sequence number`` leads to a forward op inside a span; CoOp's step and
the zero-shot trainer's encodes show the tower spans too."""

import collections
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from mudpt_torch.config import load_config
from mudpt_torch.trainers.base import build_trainer
from mudpt_torch.trainers.mudpt import mudpt_forward
from mudpt_torch.utils import profiling
from mudpt_torch.utils import synth_step as TS

FILES = ("configs/datasets/synthetic.yaml", "configs/trainers/test/tiny.yaml")
SPANS = ("mudpt.prompts", "mudpt.text", "mudpt.vision", "mudpt.logits")
EVALUATE = "autograd::engine::evaluate_function:"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def step():
    """A tiny MuDPT step on the CPU: bf16 towers, fp32 prompts."""
    st = TS.build_synth_mudpt_step("test-tiny", 4, 10, 2, 2, device="cpu")
    st.loss_fn(st.images, st.labels).backward()  # once untraced, as a warm-up
    return st


def _trace(fn, tmp_path, name="t.json"):
    """The complete events of a CPU profile of ``fn()``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    prof.export_chrome_trace(str(tmp_path / name))
    with open(tmp_path / name) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _spans(events):
    return [e for e in events if e.get("cat") == "user_annotation"
            and e["name"].startswith(profiling.SPAN_PREFIX)]


def _inside(e, outer) -> bool:
    return outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]


def _innermost_span(e, spans):
    held = [s for s in spans if s["tid"] == e["tid"] and _inside(e, s)]
    return min(held, key=lambda s: s["dur"])["name"] if held else None


def test_no_profiler_enters_no_record_function(monkeypatch, step):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    assert not torch.autograd._profiler_enabled()
    step.loss_fn(step.images, step.labels).backward()
    with profiling.span("mudpt.vision"):
        pass
    assert entered == []
    # the control: under a session every span enters one
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("mudpt.vision"):
            pass
        step.loss_fn(step.images, step.labels)
    assert entered[0] == "mudpt.vision" and set(entered[1:]) == set(SPANS)


def test_each_span_once_a_step_nested_as_the_code(tmp_path, step):
    def two_steps():
        for i in range(2):
            with record_function(f"step{i}"):
                step.loss_fn(step.images, step.labels).backward()

    events = _trace(two_steps, tmp_path)
    spans = _spans(events)
    for i in range(2):
        mark = next(e for e in events if e["name"] == f"step{i}")
        mine = sorted((s for s in spans if _inside(s, mark)), key=lambda s: s["ts"])
        names = collections.Counter(s["name"] for s in mine)
        assert names == {"mudpt.prompts": 3, "mudpt.text": 1, "mudpt.vision": 1,
                         "mudpt.logits": 1}, names
        # the text side's prompts (compose_prompts inside them), the text
        # tower, the vision side's prompts, the vision tower, the logits
        outer = [s for s in mine if _innermost_span(s, [o for o in mine if o is not s]) is None]
        assert [s["name"] for s in outer] == ["mudpt.prompts", "mudpt.text", "mudpt.prompts",
                                              "mudpt.vision", "mudpt.logits"]
        assert _inside(mine[1], mine[0]) and mine[1]["name"] == "mudpt.prompts"


def test_every_backward_op_leads_to_a_span(tmp_path, step):
    """A backward op carries the number of the forward op it differentiates;
    a node made after its op (``CopySlices``) takes the next number, so the
    forward op is the one with the largest number not above it."""
    def one_step():
        with record_function("forward"):
            logits = mudpt_forward(step.trainable, step.params, step.aux, step.images,
                                   clip_cfg=step.clip_cfg, compute_dtype=torch.bfloat16)
        TS.nll_loss(logits, step.labels).backward()

    events = _trace(one_step, tmp_path)
    spans = _spans(events)
    fwd_range = next(e for e in events if e["name"] == "forward")
    evals = [e for e in events if e["name"].startswith(EVALUATE)
             and "Sequence number" in e.get("args", {})]
    forward = {}
    for e in sorted(events, key=lambda e: e["ts"]):
        seq = e.get("args", {}).get("Sequence number")
        if (e.get("cat") == "cpu_op" and seq is not None and not e["name"].startswith(EVALUATE)
                and not any(_inside(e, b) for b in evals)):
            forward.setdefault(seq, e)
    numbers = sorted(forward)
    led = collections.Counter()
    for b in evals:
        seq = b["args"]["Sequence number"]
        op = forward[max(n for n in numbers if n <= seq)]
        if not _inside(op, fwd_range):
            continue  # the loss's, which no span holds
        span = _innermost_span(op, spans)
        assert span in SPANS, (b["name"], op["name"])
        led[span] += 1
    assert all(led[s] > 0 for s in SPANS), led


def _trainer(tmp_path, name, *more):
    opts = ["TRAINER.NAME", name, "OUTPUT_DIR", str(tmp_path / name), *more]
    return build_trainer(load_config(*FILES, opts=opts), devices="cpu")


def test_coop_step_shows_the_tower_spans(tmp_path):
    tr = _trainer(tmp_path, "CoOp", "TRAINER.COOP.PREC", "fp32")
    batch = tr._device_batch(next(iter(tr.dm.train_loader)))
    names = collections.Counter(s["name"] for s in _spans(
        _trace(lambda: tr._train_step(batch), tmp_path)))
    assert names == {"mudpt.prompts": 1, "mudpt.text": 1, "mudpt.vision": 1,
                     "mudpt.logits": 1}, names


def test_zeroshot_encodes_show_the_tower_spans(tmp_path):
    events = _trace(lambda: _trainer(tmp_path, "ZeroshotCLIP"), tmp_path, "build.json")
    assert collections.Counter(s["name"] for s in _spans(events)) == {"mudpt.text": 1}
    tr = _trainer(tmp_path, "ZeroshotCLIP")
    images = tr._device_batch(next(iter(tr.dm.test_loader)))["image"]
    events = _trace(lambda: tr._eval_step(tr.trainable, tr.frozen, tr.aux, images), tmp_path)
    assert collections.Counter(s["name"] for s in _spans(events)) == {"mudpt.vision": 1}
