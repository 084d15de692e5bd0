"""Profile the MuDPT train step and print its ops by self time
(counterpart of ``tools/profile_step.py``).

Runs the step ``python -m mudpt_torch.bench`` times
(``utils/synth_step.build_synth_mudpt_step``: seeded random weights, bf16
backbone) under ``torch.profiler`` (``utils/profiling.profile_trace``,
which also writes the Chrome trace into ``--outdir``): one step to warm
up, one inside the profiler whose events are dropped, then ``--steps``
traced steps, whose every launch the trace holds.  Then it prints the
top ops by self device time, as the JAX tool prints xprof's
``framework_op_stats``, and the device time by kernel of
``mudpt_torch/csrc`` (``utils/profiling.device_time_by_kernel``).  The last
line is one JSON object of the same readings.

  python -m mudpt_torch.tools.profile_step [--model ViT-B/16] [--batch 192]
      [--n-cls 1000] [--n-ctx 2] [--depth 9] [--steps 3] [--top 25]
      [--outdir DIR] [--device cpu]

On the CPU (``--device cpu``, the plain versions) there is no device
time: the table ranks the host's ops by their self time instead.  Without
``--device`` it runs on the card and raises when CUDA is absent.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile


def main(argv=None) -> dict:
    from mudpt_torch.utils.device import resolve_device
    from mudpt_torch.utils.profiling import device_time_by_kernel, profile_trace, top_ops
    from mudpt_torch.utils.synth_step import MODELS, build_synth_mudpt_step

    ap = argparse.ArgumentParser(prog="python -m mudpt_torch.tools.profile_step",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=list(MODELS), default="ViT-B/16")
    ap.add_argument("--batch", type=int, default=192)
    ap.add_argument("--n-cls", type=int, default=1000)
    ap.add_argument("--n-ctx", type=int, default=2)
    ap.add_argument("--depth", type=int, default=9)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--outdir", default=os.path.join(tempfile.gettempdir(), "mudpt_profile"))
    ap.add_argument("--device", default=None, help="'cpu' for the plain versions; "
                    "default the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"

    st = build_synth_mudpt_step(args.model, args.batch, args.n_cls, args.n_ctx, args.depth,
                                device=dev)
    print("warmup...", flush=True)
    # the kernels' first launches and the allocator's growth
    float(st.train_step(st.images, st.labels))
    print("tracing...", flush=True)
    # a second warmup step inside the profiler, its events dropped: the CUDA
    # activity collection is on before the traced steps' first launch
    with profile_trace(args.outdir, warmup=1) as prof:
        float(st.train_step(st.images, st.labels))
        prof.step()
        for _ in range(args.steps):
            loss = st.train_step(st.images, st.labels)
        float(loss)

    rows = top_ops(prof, device=on_card)
    total = sum(us for _, us, _ in rows)
    where = "device" if on_card else "host (no device on the CPU)"
    print(f"{where} total self-time: {total / 1e3:.1f} ms over {args.steps} steps")
    print(f"{'op':64s} {'self_ms':>9s} {'%':>6s} {'occ':>6s}")
    for name, us, occ in rows[:args.top]:
        print(f"{name[:64]:64s} {us / 1e3:9.2f} {100 * us / max(total, 1):6.1f} {occ:6d}")
    record = {
        "metric": (f"MuDPT {args.model} train step profile (batch {args.batch}, n_cls "
                   f"{args.n_cls}, depth {args.depth}, {args.steps} steps)"),
        "self_time": "device" if on_card else "host",
        "total_ms": total / 1e3,
        "steps": args.steps,
        "top": [{"op": name, "self_ms": us / 1e3, "share": us / max(total, 1),
                 "occurrences": occ} for name, us, occ in rows[:args.top]],
        "by_kernel_ms": None,
        "trace_dir": args.outdir,
        "final_loss": float(loss),
    }
    if on_card:
        cats, by_kernel, _ = device_time_by_kernel(prof)
        record["by_kernel_ms"] = {k: v / 1e3 for k, v in {**cats, **by_kernel}.items()}
        print("by kernel: " + "; ".join(f"{k} {v:.3f} ms" for k, v in sorted(
            record["by_kernel_ms"].items(), key=lambda kv: -kv[1])))
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
