"""Step timing and an optional trace window (counterpart of
``mudpt_tpu/utils/profiling.py``).

:class:`StepTimer` is the JAX package's EMA step timer, except that it
synchronizes the device before each reading: a CUDA call returns before the
card has finished, so a host clock without it times the enqueue.
:func:`profile_trace` records a ``torch.profiler`` trace (host and CUDA
activity) into ``TRAIN.PROFILE_DIR`` as a Chrome trace file.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional, Union

import torch


def _sync(device: Optional[torch.device]) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


class StepTimer:
    """Tracks per-step wall time + images/sec with a warmup-aware EMA."""

    def __init__(self, ema: float = 0.9, device: Optional[Union[str, torch.device]] = None):
        self._ema = ema
        self._device = torch.device(device) if device is not None else None
        self._avg: Optional[float] = None
        self._last = None
        self._t0 = None
        self._count = 0

    def start(self) -> None:
        _sync(self._device)
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        _sync(self._device)
        dt = time.perf_counter() - self._t0
        self._last = dt
        self._count += 1
        # the first step carries one-time costs (kernel builds, allocator
        # growth): never let it into the average; seed from step 2
        if self._count == 1:
            return dt
        if self._avg is None:
            self._avg = dt
        else:
            self._avg = self._ema * self._avg + (1 - self._ema) * dt
        return dt

    @property
    def avg(self) -> float:
        if self._avg is not None:
            return self._avg
        return self._last or 0.0

    def throughput(self, items: int) -> float:
        a = self.avg
        return items / a if a else 0.0


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """Trace host and CUDA activity into ``<logdir>/trace-<time>.json``
    when ``logdir`` is set, else no-op."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace-{time.time_ns()}.json"))
