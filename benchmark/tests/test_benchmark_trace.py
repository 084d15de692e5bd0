"""The trace reader on a small hand-made Chrome trace: overlapping and idle
device spans, a kernel outside the window, host operations around gaps."""

import json

import pytest

from benchmark import tracing
from benchmark.metrics import reader


def _trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW, "ts": 1000, "dur": 100,
         "tid": 7},
        {"ph": "X", "cat": "cpu_op", "name": "ProfilerStep#1", "ts": 990, "dur": 120, "tid": 7},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1000, "dur": 15, "tid": 7},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1002, "dur": 3,
         "tid": 7},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 1050, "dur": 30, "tid": 7},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 1060,
         "dur": 20, "tid": 7},
        {"ph": "X", "cat": "cpu_op", "name": "other thread", "ts": 1000, "dur": 100, "tid": 8},
        # device: [1010, 1030) two overlapping kernels, [1040, 1060) gemm,
        # a copy [1070, 1080), a kernel running past the window's end
        {"ph": "X", "cat": "kernel", "name": "gemm_bf16_kernel<0, 2>", "ts": 1010, "dur": 15},
        {"ph": "X", "cat": "kernel", "name": "attention_fwd_wgmma_kernel", "ts": 1020, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_bf16", "ts": 1040, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 1070, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "layernorm_fwd_kernel", "ts": 1095, "dur": 25},
        {"ph": "X", "cat": "kernel", "name": "before", "ts": 900, "dur": 50},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return tracing.read_trace(str(path))


def test_window_busy_idle_and_launches(tmp_path):
    t = _trace(tmp_path)
    assert t.window_s == pytest.approx(100e-6)
    # union: [1010, 1030) + [1040, 1060) + [1070, 1080) + [1095, 1100) = 55 us
    assert t.busy_s == pytest.approx(55e-6)
    assert t.idle_share() == pytest.approx(0.45)
    assert t.launches == 4                     # kernels starting in the window
    assert t.family_s(reader("gemm_roofline.train").PATTERNS) == pytest.approx(35e-6)
    assert t.family_s(reader("attention_roofline.train").PATTERNS) == pytest.approx(10e-6)


def test_breakdown(tmp_path):
    t = _trace(tmp_path)
    assert t.device_ops[0] == ["layernorm_fwd_kernel", pytest.approx(25e-6)]
    idle = dict(t.idle_gaps)
    # gaps: [1000, 1010) in aten::mm; [1060, 1070) in the synchronize inside
    # aten::copy_; [1030, 1040) and [1080, 1095) in no host op
    assert idle["aten::mm"] == pytest.approx(10e-6)
    assert idle["cudaStreamSynchronize"] == pytest.approx(10e-6)
    assert idle["python"] == pytest.approx(25e-6)
    assert "ProfilerStep#1" not in idle and "other thread" not in idle


def test_a_trace_without_device_work_reads_nothing(tmp_path):
    path = tmp_path / "cpu.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW, "ts": 0, "dur": 10}]}))
    assert tracing.read_trace(str(path)) is None
