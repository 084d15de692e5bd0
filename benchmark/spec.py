"""A cell's description, found by name from ``BENCHMARK.json``.

A cell ``<config>.<traffic>`` of ``workloads`` names a configuration of
``configs`` (its ``file``, the sizes as run) and a traffic mix, the file
``benchmark/workloads/<traffic>.json``; its limits are
``benchmark/limits/<cell>.json``.  Its metrics are the ``end_to_end`` ones
with no ``workloads`` key or with the cell in it, and the ``per_layer`` ones
that list the cell, or that list no cells and move one of its end-to-end
metrics.  Each per-layer metric has its reader,
``benchmark/metrics/<metric>.py``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = ROOT) -> Cell:
    bench = _read(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", ())
                 or ("workloads" not in m and m["moves"] in moved)]
    limits_path = root / "benchmark" / "limits" / f"{name}.json"
    return Cell(name=name, chips=int(w["chips"]), config=_read(root / conf["file"]),
                traffic=_read(root / "benchmark" / "workloads" / f"{w['traffic']}.json"),
                limits=_read(limits_path) if limits_path.exists() else {},
                end_to_end=e2e, per_layer=per_layer)
