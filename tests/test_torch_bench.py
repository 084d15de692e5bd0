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
    assert rec["model_mfu"] is None
    # bench.py's train line carries vs_baseline (images/s over its A100
    # estimate), its eval line does not
    assert ("vs_baseline" in rec) == (mode == "train")
    if mode == "train":
        assert rec["hw_utilization"] is None and rec["exec_tflops_per_sec"] is None
        assert rec["vs_baseline"] == pytest.approx(rec["value"] / 850.0, abs=1e-3)


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


def _in_process(capsys, *argv):
    rec = bench.main([*argv, *TINY])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    return rec


def test_remat_full_matches_none(capsys):
    """``--remat full`` recomputes every layer in the backward: the same
    final loss, bit for bit, as ``--remat none``; each line names its
    mode, carries vs_baseline, and no device rate off the card."""
    from mudpt_torch.models import transformer

    recs = {m: _in_process(capsys, "--remat", m) for m in ("none", "full", "selective")}
    assert recs["full"]["final_loss"] == recs["none"]["final_loss"] == \
        recs["selective"]["final_loss"]
    for mode, rec in recs.items():
        assert rec["remat"] == mode and rec["vs_baseline"] > 0
        assert rec["exec_tflops_per_sec"] is None and rec["hw_utilization"] is None
    assert transformer.remat_mode() == "none"


def test_remat_auto_resolves_as_bench_py():
    """``bench.py:380-386``: 'none' on the kernel route; under BLOCK xla
    'none' to batch 96, 'full' above; an explicit mode as given."""
    from mudpt_torch.models import layers

    assert bench.resolve_remat("auto", 384) == "none"
    assert bench.resolve_remat("selective", 8) == "selective"
    layers.set_block_impl("xla")
    try:
        assert [bench.resolve_remat("auto", b) for b in (96, 97)] == ["none", "full"]
    finally:
        layers.set_block_impl("auto")


@pytest.mark.parametrize("mode,remat,want", [("train", "full", "full"),
                                             ("train", "auto", "none"),
                                             ("eval", "full", "none")])
def test_remat_set_for_the_run_and_restored(monkeypatch, capsys, mode, remat, want):
    """The mode is set through ``set_remat_mode`` for the run (eval forces
    'none', ``bench.py:263-265``) and the previous one restored after."""
    from mudpt_torch.models import transformer

    seen = []
    monkeypatch.setattr(bench, f"run_{mode}",
                        lambda args, dev: seen.append(transformer.remat_mode()) or {})
    transformer.set_remat_mode("selective")
    try:
        bench.main(["--mode", mode, "--remat", remat, *TINY])
        assert seen == [want] and transformer.remat_mode() == "selective"
    finally:
        transformer.set_remat_mode("none")
    capsys.readouterr()


def test_flop_accounts_under_remat():
    """Executed FLOPs under REMAT 'full' add each tower's forward; under
    'selective' the XLA route's attention products, the kernel route
    nothing."""
    from mudpt_torch.models import layers
    from mudpt_torch.models.clip import VIT_B16

    model, none = bench.train_flops(VIT_B16, 384, 100, 2, 16)
    _, full = bench.train_flops(VIT_B16, 384, 100, 2, 16, "full")
    assert full - none == bench.tower_fwd_flops(199, 12, 768, 384) + bench.tower_fwd_flops(
        16, 12, 512, 100)
    assert bench.train_flops(VIT_B16, 384, 100, 2, 16, "selective")[1] == none == model
    layers.set_block_impl("xla")
    try:
        _, sel = bench.train_flops(VIT_B16, 384, 100, 2, 16, "selective")
    finally:
        layers.set_block_impl("auto")
    assert sel - none == 8 * 199 * 199 * 768 * 12 * 384 + 8 * 16 * 16 * 512 * 12 * 100
