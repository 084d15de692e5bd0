"""The program's spans in a traced window: which part of the port each device
operation and each idle stretch of the card belongs to.

The port names its parts with ``mudpt_torch/utils/profiling.span``
(``mudpt.vision``, ``mudpt.text``, ``mudpt.prompts``, ``mudpt.logits``):
``record_function`` ranges, ``user_annotation`` events of the same Chrome
trace as the kernels, so on the trace's own clock.  :func:`attribute` reads a
trace that :func:`benchmark.tracing.traced` wrote:

- a device operation (kernel, copy, fill) of the window belongs to the
  innermost span that holds its launch: the ``cuda_runtime`` or
  ``cuda_driver`` event with the same ``correlation``, on the thread that
  launched it;
- a launch in no span but inside an ``autograd::engine::evaluate_function``
  op (the backward, which the autograd engine runs on a thread of its own)
  belongs to the span that held the forward op whose ``Sequence number``
  that op carries: the forward op with the largest number not above it,
  since a node made after its op (``CopySlices``, an in-place write into a
  slice) takes the next number, which no op carries;
- an idle stretch of the window (no device operation running) belongs to
  the program while a span is open on the window's thread, or while an
  ``evaluate_function`` op that belongs to a span runs on any thread.

The rest of the device time, and of the idle, is the harness's: the loss,
the optimizer, the answers' copy, the loop.  A trace with no span (a port
that emits none) gives no attribution.
"""

from __future__ import annotations

import dataclasses
import functools
import glob
import json
import os
from bisect import bisect_right
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from benchmark import cells
from benchmark.tracing import DEVICE_CATS, WINDOW, _union

SPAN_PREFIX = "mudpt."
EVALUATE = "autograd::engine::evaluate_function:"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NO_SPAN = ""                     # the label of device work that no span holds


@dataclasses.dataclass
class Attribution:
    window_s: float
    busy_s: float
    device_s: Dict[str, float]   # device seconds in the window by span; NO_SPAN: in none
    program_idle_s: float        # idle seconds of the window that belong to a span


def _overlap(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> float:
    """The length of the intersection of two unions of disjoint, sorted
    intervals."""
    out, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        out += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _sweep(containers: list, points: list) -> list:
    """For each point (ts, key) of one thread, the innermost span and the
    innermost ``evaluate_function`` op's number (or None) among
    ``containers`` (ts, end, kind, value) of that thread, which nest:
    [(key, span, seq)]."""
    items = sorted([(c[0], 0, -c[1], c) for c in containers]
                   + [(p[0], 1, 0.0, p) for p in points], key=lambda t: t[:3])
    stack, out = [], []
    for ts, is_point, _, item in items:
        while stack and stack[-1][1] <= ts:
            stack.pop()
        if not is_point:
            stack.append(item)
            continue
        span = next((c[3] for c in reversed(stack) if c[2] == "span"), None)
        seq = next((c[3] for c in reversed(stack) if c[2] == "eval"), None)
        out.append((item[1], span, seq))
    return out


def attribute(path: str) -> Tuple[Optional[float], Optional[Attribution]]:
    """(the window's seconds, its attribution) of the Chrome trace ``path``;
    (None, None) without a window, the attribution None without a span or a
    device operation in the window."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    marks = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not marks:
        return None, None
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    window_s, main = (w1 - w0) * 1e-6, marks[0].get("tid")
    containers = defaultdict(list)   # tid -> [(ts, end, "span" | "eval", name | seq)]
    points = defaultdict(list)       # tid -> [(ts, ("fwd", seq) | ("launch", correlation))]
    device = []
    for e in events:
        if "dur" not in e:
            continue
        cat, name, tid = e.get("cat"), e.get("name", ""), e.get("tid")
        ts, args = float(e["ts"]), e.get("args", {})
        if cat in DEVICE_CATS:
            if w0 <= ts < w1:
                device.append((ts, min(ts + float(e["dur"]), w1), args.get("correlation")))
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            containers[tid].append((ts, ts + float(e["dur"]), "span", name))
        elif cat == "cpu_op" and "Sequence number" in args:
            seq = args["Sequence number"]
            if name.startswith(EVALUATE):
                containers[tid].append((ts, ts + float(e["dur"]), "eval", seq))
            else:
                points[tid].append((ts, ("fwd", seq)))
        elif cat in LAUNCH_CATS and "correlation" in args:
            points[tid].append((ts, ("launch", args["correlation"])))
    if not device or not any(c[2] == "span" for cs in containers.values() for c in cs):
        return window_s, None
    fwd: Dict[int, Optional[str]] = {}   # a forward op's sequence number -> its span
    launch: Dict[int, tuple] = {}        # correlation -> (span, seq) of its launch
    for tid in set(containers) | set(points):
        for (kind, key), span, seq in _sweep(containers[tid], points[tid]):
            if kind == "launch":
                launch[key] = (span, seq)
            elif seq is None:                # a backward node's own op is no forward op
                fwd.setdefault(key, span)
    numbers = sorted(fwd)

    def span_of(seq) -> Optional[str]:
        """The span of the forward op that backward op ``seq`` differentiates."""
        i = bisect_right(numbers, seq) if seq is not None else 0
        return fwd[numbers[i - 1]] if i else None

    def label(corr) -> str:
        span, seq = launch.get(corr, (None, None))
        return span or span_of(seq) or NO_SPAN

    device_s: Dict[str, float] = defaultdict(float)
    for a, b, corr in device:
        device_s[label(corr)] += (b - a) * 1e-6
    busy = _union([(a, b) for a, b, _ in device])
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    program = _union([(max(a, w0), min(b, w1)) for tid, cs in containers.items()
                      for a, b, kind, v in cs if min(b, w1) > max(a, w0)
                      and (tid == main if kind == "span" else span_of(v) is not None)])
    return window_s, Attribution(
        window_s=window_s, busy_s=sum(b - a for a, b in busy) * 1e-6, device_s=dict(device_s),
        program_idle_s=_overlap(gaps, program) * 1e-6)


@functools.lru_cache(maxsize=4)
def _attribute_file(path: str, mtime_ns: int, size: int):
    return attribute(path)


def of_run(run) -> Optional[Attribution]:
    """The attribution of the traced window of ``run`` (a
    :class:`benchmark.cells.Program` of this process): the newest trace in
    ``cells.TRACE_DIR`` whose window is ``run.trace``'s; None where the run
    has no trace or its trace no span."""
    if run.trace is None:
        return None
    paths = sorted(glob.glob(os.path.join(cells.TRACE_DIR, "*.json")), key=os.path.getmtime,
                   reverse=True)
    for path in paths:
        st = os.stat(path)
        window_s, found = _attribute_file(path, st.st_mtime_ns, st.st_size)
        if window_s == run.trace.window_s:
            return found
    return None


def device_ms_per_unit(run, span: str) -> Optional[float]:
    """Device milliseconds a step or request of the operations ``span``
    launched, forward and backward."""
    a = of_run(run)
    return None if a is None else 1e3 * a.device_s.get(span, 0.0) / run.traced_units


def program_idle_share(run) -> Optional[float]:
    """% of the traced window in which the card idled while the program's
    own host path ran (a span open, or its backward dispatched)."""
    a = of_run(run)
    return None if a is None else 100 * a.program_idle_s / a.window_s
