"""The readings the limits of ``benchmark/limits/<cell>.json`` are set from,
over many seeds in one process: for each seed the numbers of
:mod:`benchmark.check` for the program as the cell runs it, for the control
and for the faults a run can have, each against the same reference.

    python -m benchmark.calibrate --workload <cell> --seeds <n> [<n> ...]
        [--seconds 0] [--no-control] [--faults] [--out <file.jsonl>]

The control is the reference put in the program's place and rounded to the
precision below the cell's (``cells.CONTROL_QUANT``): fp8 e4m3 on a bf16
cell, int4 on an int8 cell, at the products an int8 tier rounds.
The faults: a training step on half of its batch ('half_batch'; a step that
leaves the state unchanged reads 1 on ``change_gap`` by construction and is
not run); a served answer altered where it is produced ('altered_answer'),
a request's second half of images answered from its first half's pixels
('half_request').
Training needs no window (``--seconds 0`` runs one loss group); serving
runs one cycle of request sizes.  One JSON line a seed; a training cell's
carries each leaf's gaps (``check.train_detail``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import cells, check, run, spec


FAULTS = {"train": ("half_batch",), "serve": ("altered_answer", "half_request")}


def readings(cell, seed: int, seconds: float, dev, control: bool, faults: bool) -> dict:
    mode, tier = cell.traffic["mode"], cell.traffic["tier"]
    prog_fn = cells.PROGRAMS[mode]
    prog = prog_fn(cell, seed, seconds, False, dev, time.perf_counter())
    out = {"seed": seed, "setup_s": prog.setup_s, "peak_gib": prog.peak_bytes / 2 ** 30}
    cells.free()
    t_ref = time.perf_counter()
    if mode == "train":
        ref = cells.reference_train(cell, seed, dev, cells.REF_QUANT[tier])
    else:
        requests = [(n, off) for _, n, off, _, _ in prog.readings["requests"]]
        ref = cells.reference_serve(cell, seed, dev, requests, cells.REF_QUANT[tier])
    out["reference_s"] = time.perf_counter() - t_ref
    out["program"] = cells.compare(cell, seed, prog.readings, dev, ref)
    if mode == "train":
        out["detail"] = {"program": check.train_detail(prog.readings, ref)}
    del prog
    cells.free()
    if control:
        low_quant = cells.CONTROL_QUANT[tier]
        if mode == "train":
            low = cells.reference_train(cell, seed, dev, low_quant)
            out["control"] = cells.compare(cell, seed, low, dev, ref)
            out["detail"]["control"] = check.train_detail(low, ref)
        else:
            by_req = cells.reference_serve(cell, seed, dev, requests, low_quant)
            low = {"requests": [(0, n, off, by_req[(n, off)], by_req[(n, off)].argmax(-1))
                                for n, off in requests]}
            out["control"] = cells.compare(cell, seed, low, dev, ref)
        cells.free()
    for name in FAULTS[mode] if faults else ():
        bad = prog_fn(cell, seed, seconds, False, dev, time.perf_counter(), fault=name)
        out[name] = cells.compare(cell, seed, bad.readings, dev, ref)
        del bad
        cells.free()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.calibrate",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = spec.load(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    run.set_caches(spec.ROOT)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        line = json.dumps({"workload": cell.name, **readings(cell, seed, args.seconds, dev,
                                                              not args.no_control, args.faults)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
