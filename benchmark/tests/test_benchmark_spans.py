"""The program's spans read from a small hand-made Chrome trace: device
operations by the span that launched them (the backward's by its forward
op's sequence number, a ``CopySlices`` node by the op before it), idle gaps
inside and outside spans, and the four readers of ``benchmark/spans.py``."""

import json
import os
from types import SimpleNamespace

import pytest

from benchmark import cells, spans, tracing
from benchmark.metrics import read

MAIN, AUTOGRAD, OTHER, DEVICE = 7, 8, 9, 99


def _x(cat, name, ts, dur, tid, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def _launch(ts, tid, corr):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 0.5, tid, correlation=corr)


def _kernel(ts, dur, corr, cat="kernel", name="gemm_bf16_kernel<0, 2>"):
    return _x(cat, name, ts, dur, DEVICE, correlation=corr)


def _eval(node, ts, dur, seq=None):
    args = {} if seq is None else {"Sequence number": seq}
    return _x("cpu_op", f"{spans.EVALUATE} {node}", ts, dur, AUTOGRAD, **args)


EVENTS = [
    _x("user_annotation", tracing.WINDOW, 1000, 100, MAIN),
    # forward on the window's thread: text [1000, 1020) with an in-place
    # copy (number 10), vision [1030, 1050) with the prompts inside it and a
    # custom Function (12), the loss (13) outside any span, logits at the end
    _x("user_annotation", "mudpt.text", 1000, 20, MAIN),
    _x("cpu_op", "aten::copy_", 1002, 5, MAIN, **{"Sequence number": 10}),
    _launch(1003, MAIN, 1),
    _x("user_annotation", "mudpt.vision", 1030, 20, MAIN),
    _x("user_annotation", "mudpt.prompts", 1032, 5, MAIN),
    _launch(1033, MAIN, 2),
    _x("cpu_op", "LayerFullblockFn", 1040, 5, MAIN, **{"Sequence number": 12}),
    _launch(1041, MAIN, 3),
    _x("cpu_op", "aten::nll_loss", 1055, 3, MAIN, **{"Sequence number": 13}),
    _launch(1056, MAIN, 4),
    _x("user_annotation", "mudpt.logits", 1094, 3, MAIN),
    _launch(1095, MAIN, 9),
    # the backward on the autograd engine's thread
    _eval("NllLossBackward0", 1058, 2, 13),
    _launch(1059, AUTOGRAD, 7),
    _eval("LayerFullblockFnBackward", 1060, 10, 12),
    _x("cpu_op", "LayerFullblockFnBackward", 1060.5, 9, AUTOGRAD, **{"Sequence number": 12}),
    _launch(1061, AUTOGRAD, 5),
    _eval("torch::autograd::CopySlices", 1072, 8, 11),
    # the node's own op inside it carries 11 too: no forward op
    _x("cpu_op", "torch::autograd::CopySlices", 1072.5, 7, AUTOGRAD,
       **{"Sequence number": 11}),
    _launch(1073, AUTOGRAD, 6),
    _eval("torch::autograd::AccumulateGrad", 1082, 3),
    _x("cuda_runtime", "cudaMemcpyAsync", 1083, 0.5, AUTOGRAD, correlation=8),
    # a span on another thread holds no idle of the window
    _x("user_annotation", "mudpt.text", 1050, 7, OTHER),
    # the device: text 10 + 4, prompts 4, vision 8 + 6, logits 2 (cut at the
    # window's end), no span 2 + 1 + 2; one kernel before the window
    _kernel(1005, 10, 1), _kernel(1034, 4, 2), _kernel(1042, 8, 3), _kernel(1057, 2, 4),
    _kernel(1060, 1, 7), _kernel(1062, 6, 5), _kernel(1074, 4, 6),
    _kernel(1084, 2, 8, cat="gpu_memcpy", name="Memcpy DtoD"), _kernel(1098, 10, 9),
    _kernel(900, 50, 1),
]


def _write(path, events):
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_device_time_by_span(tmp_path):
    window_s, a = spans.attribute(_write(tmp_path / "t.json", EVENTS))
    assert window_s == pytest.approx(100e-6)
    assert a.busy_s == pytest.approx(39e-6)
    assert a.device_s == pytest.approx({"mudpt.text": 14e-6, "mudpt.vision": 14e-6,
                                        "mudpt.prompts": 4e-6, "mudpt.logits": 2e-6,
                                        spans.NO_SPAN: 5e-6})


def test_idle_inside_and_outside_spans(tmp_path):
    """Gaps: [1000, 1005) in text; [1015, 1034) in text to 1020 and vision
    from 1030; [1038, 1042) in vision; [1050, 1057) in no span of the window's
    thread; [1059, 1060) in the loss's backward; [1061, 1062) and [1068, 1070)
    in vision's backward, [1070, 1072) in none, [1072, 1074) and [1078, 1080)
    in CopySlices (text); [1080, 1084) in none; [1086, 1098) in logits for
    [1094, 1097): 5 + 9 + 4 + 1 + 2 + 2 + 2 + 3 = 28 us of 61 idle."""
    _, a = spans.attribute(_write(tmp_path / "t.json", EVENTS))
    assert a.program_idle_s == pytest.approx(28e-6)
    assert 1 - a.busy_s / a.window_s == pytest.approx(0.61)


def test_a_trace_without_spans_gives_none(tmp_path):
    """The parent's program emits no span: every new reader reads None."""
    plain = [e for e in EVENTS if not e["name"].startswith(spans.SPAN_PREFIX)]
    window_s, a = spans.attribute(_write(tmp_path / "t.json", plain))
    assert window_s == pytest.approx(100e-6) and a is None
    no_window = [e for e in EVENTS if e["name"] != tracing.WINDOW]
    assert spans.attribute(_write(tmp_path / "w.json", no_window)) == (None, None)


def _run(path, units):
    return SimpleNamespace(trace=tracing.read_trace(path), traced_units=units)


def test_the_four_readers(tmp_path, monkeypatch):
    monkeypatch.setattr(cells, "TRACE_DIR", str(tmp_path))
    path = _write(tmp_path / "cell.json", EVENTS)
    os.utime(path, (1, 1))
    # a newer trace of another window (another cell's run) is passed over
    _write(tmp_path / "other.json", [dict(EVENTS[0], dur=200)] + EVENTS[1:])
    run = _run(path, 2)
    assert read("text_ms_per_step.train", run, "train") == pytest.approx(1e3 * 14e-6 / 2)
    assert read("vision_ms_per_step.train", run, "train") == pytest.approx(1e3 * 14e-6 / 2)
    assert read("program_idle_share.train", run, "train") == pytest.approx(28.0)
    assert read("program_idle_share.serve", run, "serve") == pytest.approx(28.0)
    assert read("program_idle_share.serve", run, "train") is None


def test_the_readers_read_none_without_spans_or_trace(tmp_path, monkeypatch):
    monkeypatch.setattr(cells, "TRACE_DIR", str(tmp_path))
    plain = [e for e in EVENTS if not e["name"].startswith(spans.SPAN_PREFIX)]
    run = _run(_write(tmp_path / "cell.json", plain), 2)
    for name, mode in (("text_ms_per_step.train", "train"),
                       ("vision_ms_per_step.train", "train"),
                       ("program_idle_share.train", "train"),
                       ("program_idle_share.serve", "serve")):
        assert read(name, run, mode) is None
        assert read(name, SimpleNamespace(trace=None, traced_units=0), mode) is None
