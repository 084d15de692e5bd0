"""Spans and an optional trace window (counterpart of
``mudpt_tpu/utils/profiling.py``).

:func:`span` names a part of the program (``mudpt.vision``, ``mudpt.text``,
``mudpt.prompts``, ``mudpt.logits``) in a ``torch.profiler`` trace, on the
trace's own clock; with no profiler recording it does nothing.
:func:`profile_trace` records a ``torch.profiler`` trace (host and CUDA
activity) into ``TRAIN.PROFILE_DIR`` as a Chrome trace file, after warmup
steps of its own where the caller steps it.
:func:`device_time_by_kernel` turns a trace into device time by kernel of
``mudpt_torch/csrc``, :func:`kernel_launches` a written trace into the
launches of each, and :func:`top_ops` into its ops by self time.
"""

from __future__ import annotations

import contextlib
import os
import re
import time
from typing import Optional

import torch

SPAN_PREFIX = "mudpt."
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` named ``name`` while a profiler session records
    (``torch.autograd._profiler_enabled()``: off outside a session and in a
    schedule's warmup step), else a no-op context, so a run without a
    profiler pays a flag's read, not a ``record_function``.  A span goes
    around forward code only: the profiler gives each backward op the
    ``Sequence number`` of the forward op it differentiates, so a reader
    maps backward work to the span of its forward op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


# the card's idle time at each edge of a recorded window
WINDOW_EDGE_S = 0.005


def window_edge(device: torch.device) -> None:
    """At an edge of a recorded window (right after ``prof.step()`` opens
    it, and before it closes), let the card sit idle for ``WINDOW_EDGE_S``.
    The collection keeps the device activity whose timestamps, mapped onto
    the host's clock, fall inside the window, so a kernel run within
    microseconds of an edge can be left out: in ``chip_smoke.py``'s long
    process on an H100 a trainer's trace lacked one of a step's 51
    ``layernorm_fwd`` launches, the step's first kernels running on a card
    synchronized just before the window opened."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        time.sleep(WINDOW_EDGE_S)


@contextlib.contextmanager
def profile_trace(logdir: Optional[str], warmup: int = 0):
    """Trace host and CUDA activity into ``<logdir>/trace-<time>.json``
    when ``logdir`` is set, and yield the profiler; else no-op (None).

    With ``warmup`` the caller runs that many steps first, each ended by
    ``prof.step()`` after a synchronize: the CUDA activity collection is
    enabled during them and their events are dropped, so it is on before
    the recorded window (every step after) begins.  A window opened bare
    starts the collection with its first launch, and inside
    ``chip_smoke.py``'s long process on an H100 such a window lost 6-7 of
    a step's first 72 forward launches.  A window closed before its warmup
    ended recorded nothing and writes no file."""
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    steps = schedule(wait=0, warmup=warmup, active=1 << 30) if warmup else None
    with profile(activities=activities, schedule=steps) as prof:
        yield prof
    if prof.step_num >= warmup:
        prof.export_chrome_trace(os.path.join(logdir, f"trace-{time.time_ns()}.json"))


# the kernels of mudpt_torch/csrc by the name the profiler gives them (the
# GEMMs by their template arguments, below)
KERNELS = ("layernorm_fwd_kernel", "attention_fwd_wgmma_kernel", "layernorm_bwd_kernel",
           "layernorm_bwd_f32_kernel", "attn_bwd_query_kernel", "attn_bwd_key_kernel",
           "gemm_s8_kernel", "layernorm_q8_kernel", "quant_rows_kernel", "attn_fwd_tc_kernel",
           "probe_mma_kernel", "attn_bwd_query_tc_kernel", "attn_bwd_key_tc_kernel")


def _step_mark(e) -> bool:
    """The profiler's own step annotation (``ProfilerStep#N`` under a
    schedule) or a :func:`span`, each of which also spans the device's
    kernels: not an op."""
    return e.key.startswith(("ProfilerStep", SPAN_PREFIX))


def _self_device_us(e) -> float:
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))


def kernel_name(key: str) -> tuple:
    """(the name :func:`device_time_by_kernel` gives a kernel of
    ``mudpt_torch/csrc``, None for any other kernel; whether it runs in the
    backward) of a profiler kernel name."""
    gemm = re.search(r"gemm_bf16_kernel<(\d+), (\d+)>", key)
    gemm32 = re.search(r"gemm_f32_kernel<(true|false)>", key)
    if gemm:  # <epilogue, schedule>; epilogues 0-3 and 9 are the forward ones
        mode = int(gemm.group(1))
        return f"gemm_bf16_kernel<{mode}, {gemm.group(2)}>", mode >= 4 and mode != 9
    if gemm32:  # <W_NK>: W read transposed in the backward epilogues
        return f"gemm_f32_kernel<{gemm32.group(1)}>", gemm32.group(1) == "true"
    name = next((k for k in KERNELS if k in key), None)
    return name, name is not None and "bwd" in name


def kernel_launches(trace_path: str) -> dict:
    """{kernel of ``mudpt_torch/csrc``, named as :func:`kernel_name` names
    it: launches} in a Chrome trace that :func:`profile_trace` wrote (its
    events of category ``kernel``)."""
    import json

    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "kernel":
            name = kernel_name(e.get("name", ""))[0]
            if name is not None:
                out[name] = out.get(name, 0) + 1
    return out


def device_time_by_kernel(prof) -> tuple:
    """({category: device us}, {kernel: us}, {other kernel: us}) from a
    profiler run: the forward kernels, the backward kernels (the GEMM by
    its epilogue's template argument), and everything else."""
    import torch

    cats = {"forward kernels": 0.0, "backward kernels": 0.0, "other": 0.0}
    by_kernel, others = {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or _step_mark(e):
            continue  # host-side ops also report their kernels' time
        us = _self_device_us(e)
        name, bwd = kernel_name(e.key)
        if name is None:
            cats["other"] += us
            if us > 0:
                others[e.key[:60]] = others.get(e.key[:60], 0.0) + us
            continue
        cats["backward kernels" if bwd else "forward kernels"] += us
        by_kernel[name] = by_kernel.get(name, 0.0) + us
    return cats, by_kernel, others


def top_ops(prof, device: bool) -> list:
    """[(op, self us, occurrences)] by self time, the largest first: the
    device's kernels (``device``), else the host's ops."""
    import torch

    rows = []
    for e in prof.key_averages():
        if device:
            if e.device_type != torch.autograd.DeviceType.CUDA or _step_mark(e):
                continue
            us = _self_device_us(e)
        else:
            us = e.self_cpu_time_total
        if us > 0:
            rows.append((e.key, us, e.count))
    return sorted(rows, key=lambda r: -r[1])
