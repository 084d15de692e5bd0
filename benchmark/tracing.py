"""The traced part of a run: a ``torch.profiler`` window and its reading.

:func:`traced` records host and CUDA activity over a callable.  The
profiler's collection is switched on during one warm-up call whose events
are dropped (a window opened bare can lose its first launches), and the card
idles :data:`WINDOW_EDGE_S` at each edge of the recorded window (a kernel
within microseconds of an edge can be left out of it).  The recorded window
is the host span of a ``record_function`` named :data:`WINDOW`, which ends
after a synchronize.  This is the port's ``utils/profiling.profile_trace``
and ``window_edge``, frozen here.

:func:`read_trace` turns the Chrome trace into a :class:`Trace`: the device
operations (kernels, copies, fills) inside the window, the union of their
intervals (busy time; the rest of the window is idle), the kernel launches,
device time by kernel family, the top operations, and the idle gaps by the
host operation that was running when each began.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

WINDOW = "benchmark_window"
WINDOW_EDGE_S = 0.005
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


def traced(run_window: Callable[[], None], warmup: Callable[[], None], device, path: str) -> str:
    """Trace ``run_window()`` after ``warmup()`` into the Chrome trace
    ``path``; returns the path."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def edge():
        sync()
        time.sleep(WINDOW_EDGE_S)

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        warmup()
        sync()
        prof.step()
        edge()
        with record_function(WINDOW):
            run_window()
            sync()
        edge()
        prof.step()
    return path


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    launches: int
    names: List[str]                 # of the kernels in the window, one per launch
    durations: List[float]           # seconds, one per launch
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def family_s(self, patterns: Sequence[str]) -> float:
        """Device seconds of the kernels whose lowercased name holds any of
        ``patterns``."""
        pats = tuple(p.lower() for p in patterns)
        return sum(d for n, d in zip(self.names, self.durations)
                   if any(p in n.lower() for p in pats))


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _short(name: str, limit: int = 96) -> str:
    name = re.sub(r"\s+", " ", name)
    return name if len(name) <= limit else name[:limit - 3] + "..."


def read_trace(path: str, top: int = 10) -> Optional[Trace]:
    """The window of a trace written by :func:`traced`; None when it holds
    no window or no device operation in it (a run without the card)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    marks = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not marks:
        return None
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e
           and w0 <= float(e["ts"]) < w1]
    if not dev:
        return None
    spans = [(float(e["ts"]), min(float(e["ts"]) + float(e["dur"]), w1)) for e in dev]
    busy = _union(spans)
    busy_us = sum(b - a for a, b in busy)
    kernels = [e for e in dev if e["cat"] == "kernel"]
    by_name: Dict[str, float] = defaultdict(float)
    for e in dev:
        by_name[_short(e["name"])] += float(e["dur"]) * 1e-6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e
            and e.get("tid") == marks[0].get("tid") and e.get("name") != WINDOW
            and not e.get("name", "").startswith("ProfilerStep")]
    return Trace(
        window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6, launches=len(kernels),
        names=[e["name"] for e in kernels], durations=[float(e["dur"]) * 1e-6 for e in kernels],
        device_ops=[[k, v] for k, v in device_ops],
        idle_gaps=_idle_by_host(busy, w0, w1, host, top),
    )


def _idle_by_host(busy, w0: float, w1: float, host: list, top: int):
    """Idle seconds of the window summed by the innermost host operation
    running when each gap began ('python' where none ran: the host was in
    the harness's or the program's Python between operations)."""
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in host)
    out: Dict[str, float] = defaultdict(float)
    stack: list = []      # the host spans open at the sweep's time, outermost first
    i = 0
    for a, b in gaps:
        while i < len(ops) and ops[i][0] <= a:
            while stack and stack[-1][1] <= ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] <= a:
            stack.pop()
        out[_short(stack[-1][2]) if stack else "python"] += (b - a) * 1e-6
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:top]]
