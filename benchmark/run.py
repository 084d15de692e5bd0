"""Run one cell of the benchmark of ``mudpt_torch`` once, on the card.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic, limits and metrics are found by name
(``benchmark/spec.py``).  Set-up makes the weights and inputs from the seed
on the card, drives the program's first steps or one request of each size,
and ends at the first timed step; ``setup_s`` counts from the process's
start.  The window then runs ``--seconds``.  With ``--trace 0`` the result
holds the cell's end-to-end metrics; with ``--trace 1`` the first half of
the window runs untraced (``mfu.*``), then a fixed stretch is traced with
``torch.profiler`` for the other per-layer metrics.  Once the window has
closed, the peak memory is read, the program's state is freed and the plain
reference is run on the same inputs; the comparison decides ``correct``.

The last line of standard output is one JSON object; the numbers compared,
each with its limit, are the last lines of standard error and the last key
of that object.  Without a CUDA card (or with fewer than the cell asks for)
it exits with 2 and prints no result; if ``jax``, ``jaxlib``, ``flax`` or
``mudpt_tpu`` is loaded once the window has closed, with 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mudpt_tpu")
GIB = 1 << 30


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m benchmark.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one, whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_caches(root) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own nvcc builds land in ``build/mudpt_torch_kernels``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(root / "build" / "cache" / sub)


def run_cell(cell, seed: int, seconds: float, trace: bool, dev, t_start: float = T_START,
             fault=None) -> dict:
    """One run of ``cell``: the result object, its ``checks`` last.
    ``fault`` (``cells.program_*``) is for checking the comparison."""
    import torch

    from benchmark import cells, check, metrics

    mode = cell.traffic["mode"]
    prog = cells.PROGRAMS[mode](cell, seed, seconds, trace, dev, t_start, fault=fault)
    dev = torch.device(dev)
    # the program's state is gone with its function's frame; the reference
    # runs after the peak was read
    cells.free()
    numbers = cells.compare(cell, seed, prog.readings, dev)
    correct, checks = check.judge(numbers, cell.limits)
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": cell.chips, "memory_peak_bytes": prog.peak_bytes}
    result = {"correct": correct, "attempted": prog.units + prog.traced_units, "failed": 0}
    if trace:
        values = {m["name"]: metrics.read(m["name"], prog, mode) for m in cell.per_layer}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.per_layer if values[m["name"]] is not None}
        if prog.trace is not None:
            device.update(busy_s=prog.trace.busy_s, window_s=prog.trace.window_s)
            result["breakdown"] = {"device_ops": prog.trace.device_ops,
                                   "idle_gaps": prog.trace.idle_gaps}
    else:
        e2e = {"setup_s": prog.setup_s, "peak_gib": prog.peak_bytes / GIB}
        if mode == "train":
            e2e["train_images_per_s"] = prog.images / prog.timed_s
        else:
            e2e["serve_images_per_s"] = prog.images / prog.timed_s
            e2e["serve_p95_ms"] = 1e3 * cells.p95(prog.latencies)
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["device"] = device
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    from benchmark import spec

    cell = spec.load(args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); found {have}", file=sys.stderr)
        return 2
    set_caches(spec.ROOT)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    loaded = forbidden_modules()
    if loaded:
        print(f"loaded in the measured process: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
