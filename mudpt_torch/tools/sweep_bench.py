"""Throughput sweep of the MuDPT train step over batch, REMAT, block route
and save policy (counterpart of ``tools/sweep_bench.py``).

  python -m mudpt_torch.tools.sweep_bench B:REMAT:BLOCK[:SAVE] [more specs...]
      [--device cpu]

e.g. ``384:none:pallas:save 384:none:pallas:reco``.  REMAT is none,
selective or full; BLOCK pallas (the kernel chains), auto or xla; SAVE
``save`` keeps qkv and h for the backward, anything else recomputes them
(default ``save``; BLOCK defaults to xla, as in the JAX tool).  Each spec
builds ``utils/synth_step.build_synth_mudpt_step`` at ViT-B/16, 100
classes, n_ctx 2, depth 9 on seeded random weights, takes two warm-up
steps and times ten, the last loss fetched to the host.  Each prints the
JAX tool's line, then one JSON line; a spec that raises prints FAILED and
the sweep goes on.  The policy the sweep set is restored when it ends.
Without ``--device`` it runs on the card and raises when CUDA is absent.
"""

from __future__ import annotations

import argparse
import json
import time

MODEL, N_CLS, N_CTX, DEPTH = "ViT-B/16", 100, 2, 9
WARMUP, TIMED = 2, 10


def run(spec: str, device) -> dict:
    from mudpt_torch.models import layers, transformer
    from mudpt_torch.ops import fused_block
    from mudpt_torch.utils.synth_step import build_synth_mudpt_step

    parts = spec.split(":")
    B, remat = int(parts[0]), parts[1]
    block = parts[2] if len(parts) > 2 else "xla"
    save = parts[3] if len(parts) > 3 else "save"
    row = {"spec": spec, "B": B, "remat": remat, "block": block, "save": save}
    head = f"B={B} remat={remat} block={block} save={save}"
    try:
        layers.set_block_impl(block)
        transformer.set_remat_mode(remat)
        fused_block.set_save_acts(save == "save")
        st = build_synth_mudpt_step(MODEL, B, N_CLS, N_CTX, DEPTH, device=device)
        for _ in range(WARMUP):
            loss = st.train_step(st.images, st.labels)
        float(loss)
        t0 = time.perf_counter()
        for _ in range(TIMED):
            loss = st.train_step(st.images, st.labels)
        lv = float(loss)
        dt = time.perf_counter() - t0
        row.update(img_per_sec=B * TIMED / dt, ms_per_step=dt / TIMED * 1e3, loss=lv)
        print(f"{head}: {row['img_per_sec']:.1f} img/s ({row['ms_per_step']:.1f} ms/step, "
              f"loss {lv:.3f})", flush=True)
    except Exception as e:  # the JAX tool reports a failed spec and goes on
        row["error"] = f"{type(e).__name__} {str(e)[:140]}"
        print(f"{head}: FAILED {row['error']}", flush=True)
    print(json.dumps({"metric": f"MuDPT {MODEL} train step sweep (n_cls {N_CLS})", **row}),
          flush=True)
    return row


def main(argv=None) -> dict:
    from mudpt_torch.models import layers, transformer
    from mudpt_torch.ops import fused_block
    from mudpt_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(prog="python -m mudpt_torch.tools.sweep_bench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("specs", nargs="+", help="B:REMAT:BLOCK[:SAVE]")
    ap.add_argument("--device", default=None, help="'cpu' for the plain versions; "
                    "default the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    prev = (layers.block_impl(), transformer.remat_mode(), fused_block.save_acts_enabled())
    try:
        rows = [run(spec, dev) for spec in args.specs]
    finally:
        layers.set_block_impl(prev[0])
        transformer.set_remat_mode(prev[1])
        fused_block.set_save_acts(prev[2])
    return {"results": rows}


if __name__ == "__main__":
    import sys

    sys.exit(1 if any("error" in r for r in main()["results"]) else 0)
