"""Per-layer metrics: one reader a metric, ``<metric name>.py`` in this
directory, found by the name ``BENCHMARK.json`` gives it.  A reader has
``MODE`` (the kind of cell it reads, 'train' or 'serve') and ``read(run)``,
which takes a :class:`benchmark.cells.Program` and returns the number, or
None where the run has nothing for it to read.  ``work.py`` counts the
model's operations and bytes from shapes."""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def reader(name: str):
    """The reader module of metric ``name``."""
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.readers.{name}",
                                                  HERE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(name: str, run, mode: str):
    """Metric ``name`` of a run of a ``mode`` cell, or None."""
    mod = reader(name)
    return mod.read(run) if mod.MODE == mode else None
