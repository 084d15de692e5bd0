"""``python -m mudpt_torch.bench`` on the CPU (the kernels' plain versions)
at test-tiny size, both modes and the three loader inputs: one JSON line
with ``metric``, ``value`` and ``unit``, the device named, and no device
metric claimed for a CPU run; the flag combinations it refuses."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from mudpt_torch import bench

ROOT = Path(__file__).resolve().parent.parent
TINY = ["--model", "test-tiny", "--device", "cpu", "--batch", "4", "--n-cls", "8",
        "--depth", "2", "--steps", "2", "--warmup", "1"]


def _bench(*argv, tmp=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    if tmp is not None:  # the synthetic JPEG set is written under TMPDIR
        env["TMPDIR"] = str(tmp)
        env["MUDPT_BENCH_WORKERS"] = "2"
    return subprocess.run([sys.executable, "-m", "mudpt_torch.bench", *argv],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)


@pytest.mark.parametrize("mode,quant", [("train", "none"), ("eval", "none")])
def test_bench_prints_one_json_line(mode, quant):
    out = _bench("--mode", mode, "--quant", quant, *TINY)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, out.stdout
    rec = json.loads(lines[0])
    assert rec["unit"] == "images/sec/chip" and rec["value"] > 0
    kind = "prompt-tuning train" if mode == "train" else "inference"
    assert rec["metric"].startswith(f"MuDPT test-tiny {kind} throughput (bf16, batch 4")
    assert rec["device"] == "cpu" and rec["card"] is None
    assert rec["model_mfu"] is None and "vs_baseline" not in rec
    if mode == "train":
        assert rec["hw_utilization"] is None and rec["exec_tflops_per_sec"] is None


def test_flop_accounts():
    """The model FLOPs are bench.py's; executed adds the recomputed fc
    product of a ViT-L/14 vision MLP over the row-token budget."""
    from mudpt_torch.models.clip import VIT_B16, VIT_L14

    model, executed = bench.train_flops(VIT_B16, 384, 100, 2, 16)
    vis = bench.tower_fwd_flops(199, 12, 768, 384) + bench.tower_bwd_dx_flops(199, 12, 768, 384)
    txt = bench.tower_fwd_flops(16, 12, 512, 100) + bench.tower_bwd_dx_flops(16, 12, 512, 100)
    assert model == executed == vis + txt
    assert bench.tower_fwd_flops(199, 12, 768, 1) == (12 * 768 ** 2 + 4 * 199 * 768) * 2 * 199 * 12
    model, executed = bench.train_flops(VIT_L14, 384, 100, 2, 16)
    assert executed - model == 4 * 1024 ** 2 * 2 * 259 * 24 * 384


@pytest.mark.parametrize("source", ["threads", "grain", "tfdata"])
def test_bench_input_pipeline(tmp_path, source):
    """``--input``: the train step fed from the loader over seed-0 noise
    JPEGs written once under TMPDIR; the line names the input and gives
    no H2D reading off the card."""
    out = _bench("--input", source, "--n-jpegs", "12", *TINY, tmp=tmp_path)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, out.stdout
    rec = json.loads(lines[0])
    assert rec["metric"].endswith(f"depth 2, input {source})") and rec["value"] > 0
    assert rec["input"] == source and rec["h2d_mb_per_sec"] is None and rec["card"] is None
    assert len(list((tmp_path / "mudpt_bench_jpegs_12x256").glob("*.jpg"))) == 12


@pytest.mark.parametrize("argv", [["--mode", "train", "--quant", "int8"],
                                  ["--mode", "eval", "--quant", "int8_ste"],
                                  ["--steps", "0"],
                                  ["--mode", "eval", "--input", "grain"],
                                  ["--input", "tfdata", "--batch", "64", "--n-jpegs", "32"]])
def test_bad_flag_combinations_exit(argv, capsys):
    with pytest.raises(SystemExit):
        bench.parse_args(argv)
    if "--input" in argv:  # bench.py:139-155's two refusals
        err = capsys.readouterr().err
        assert ("supports --input resident only" in err) or ("raise --n-jpegs" in err)
