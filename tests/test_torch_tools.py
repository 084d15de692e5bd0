"""The port's counterparts of the JAX package's tools, on the CPU at a tiny
size (``--device cpu``, the plain versions): ``bench_cocoop``,
``sweep_bench``, ``profile_step``, ``bench_zoo``, ``bench_input`` and
``run_protocol``, each through ``main(argv)``.  Each line carries the JAX
tool's keys, read from the JAX tool's source (its dict literals), so the
JAX tools themselves do not run; without ``--device cpu`` each tool but
``bench_input`` raises where CUDA is absent; ``run_protocol --synthetic``
runs every stage, skips them on a rerun and writes the JAX summary's keys,
and ``tools/parse_test_res.py`` reads the port's ``metrics.jsonl``."""

import ast
import json
import re
from pathlib import Path

import pytest
import torch

from mudpt_torch.tools import (bench_cocoop, bench_input, bench_zoo, profile_step,
                               run_protocol, sweep_bench)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def jax_dict_keys(tool: str, func: str) -> list:
    """The string keys of each dict literal in ``func`` of ``tools/<tool>.py``."""
    tree = ast.parse((ROOT / "tools" / f"{tool}.py").read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    return [{k.value for k in d.keys if isinstance(k, ast.Constant)}
            for d in ast.walk(fn) if isinstance(d, ast.Dict) and d.keys]


def json_lines(out: str) -> list:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("argv", [
    ["--mode", "train"],
    ["--mode", "train", "--text-trunc", "0", "--chunk", "1"],
    ["--mode", "eval", "--quant", "int8"],
    ["--mode", "train", "--quant", "int8_ste"],
], ids=["train", "full-rows-chunked", "eval-int8", "train-int8_ste"])
def test_bench_cocoop_line_has_the_jax_keys(monkeypatch, capsys, argv):
    from mudpt_torch.models import text

    monkeypatch.setattr(bench_cocoop, "MODEL", "test-tiny")
    rec = bench_cocoop.main(argv + ["--device", "cpu", "--n-cls", "10", "--batch", "2",
                                    "--steps", "1", "--warmup", "1"])
    assert json_lines(capsys.readouterr().out) == [rec]
    want = {frozenset(k) for k in jax_dict_keys("bench_cocoop", "main")}
    assert frozenset(rec) in want
    assert ("final_loss" in rec) == ("train" in argv)
    assert rec["text_trunc"] == ("0" if "0" in argv else "auto")
    assert text.text_truncate() == "auto"  # the switch is restored


def test_bench_cocoop_pairs_quant_and_mode_as_jax():
    for argv in (["--quant", "int8"], ["--mode", "eval", "--quant", "int8_ste"]):
        with pytest.raises(SystemExit):
            bench_cocoop.parse_args(argv)


def test_sweep_bench_prints_the_jax_line_and_restores_the_policy(monkeypatch, capsys):
    from mudpt_torch.models import layers, transformer
    from mudpt_torch.ops import fused_block

    monkeypatch.setattr(sweep_bench, "MODEL", "test-tiny")
    monkeypatch.setattr(sweep_bench, "TIMED", 1)
    out = sweep_bench.main(["4:full:xla:reco", "4:nonsense:pallas", "--device", "cpu"])
    text = capsys.readouterr().out
    assert re.search(r"^B=4 remat=full block=xla save=reco: [\d.]+ img/s \([\d.]+ ms/step, "
                     r"loss [\d.]+\)$", text, re.M)
    assert re.search(r"^B=4 remat=nonsense block=pallas save=save: FAILED ValueError", text,
                     re.M)
    rows = out["results"]
    assert json_lines(text) == [{"metric": "MuDPT test-tiny train step sweep (n_cls 100)", **r}
                                for r in rows]
    assert rows[0]["img_per_sec"] > 0 and "error" in rows[1]
    assert (layers.block_impl(), transformer.remat_mode(), fused_block.save_acts_enabled()) == (
        "auto", "none", True)


def test_profile_step_table_and_line(capsys, tmp_path):
    rec = profile_step.main(["--device", "cpu", "--model", "test-tiny", "--batch", "2",
                             "--n-cls", "4", "--depth", "2", "--steps", "1", "--top", "5",
                             "--outdir", str(tmp_path)])
    text = capsys.readouterr().out
    # the JAX tool's columns, less xprof's memory rate
    assert re.search(r"^op\s+self_ms\s+%\s+occ$", text, re.M)
    assert json_lines(text) == [rec]
    assert rec["self_time"] == "host" and rec["by_kernel_ms"] is None
    assert len(rec["top"]) == 5 and rec["total_ms"] > 0
    assert list(tmp_path.glob("trace-*.json"))


@pytest.mark.parametrize("mode,trainers", [("train", ["CoOp", "CoCoOp"]),
                                           ("eval", ["CoOp", "ZeroshotCLIP"])])
def test_bench_zoo_lines_have_the_jax_keys(capsys, mode, trainers):
    rows = bench_zoo.main(["--model", "test-tiny", "--batch", "8", "--n-cls", "4", "--size",
                           "32", "--steps", "2", "--warmup", "1", "--mode", mode, "--device",
                           "cpu", "--trainers", *trainers])
    lines = json_lines(capsys.readouterr().out)
    assert [line["trainer"] for line in lines] == list(rows) == trainers
    want = {frozenset(k) | {"metric"} for k in jax_dict_keys("bench_zoo", "bench_one")}
    assert all(frozenset(line) in want for line in lines)
    assert all("error" not in r and r["img_per_sec"] > 0 for r in rows.values())
    if mode == "eval":
        assert all(r["text_cached"] for r in rows.values())


def test_bench_zoo_reports_a_failed_method_and_goes_on(monkeypatch, capsys):
    real = bench_zoo.build

    def build(name, extra, args):
        if name == "VPT":
            raise MemoryError("out of memory")
        return real(name, extra, args)

    monkeypatch.setattr(bench_zoo, "build", build)
    rows = bench_zoo.main(["--model", "test-tiny", "--batch", "8", "--n-cls", "4", "--size",
                           "32", "--steps", "1", "--device", "cpu", "--trainers", "VPT", "CoOp",
                           "TRAINER.COOP.N_CTX", "3"])
    assert rows["VPT"] == {"trainer": "VPT", "error": "MemoryError: out of memory"}
    assert "error" not in rows["CoOp"]


def test_bench_input_gives_a_line_for_each_pipeline(capsys):
    out = bench_input.main(["--pipeline", "threads", "grain", "tfdata", "--batch", "4",
                            "--n-jpegs", "8", "--size", "32", "--steps", "1", "--warmup", "1",
                            "--workers", "2"])
    lines = json_lines(capsys.readouterr().out)
    assert list(out) == ["threads", "grain", "tfdata"] and lines == list(out.values())
    (want,) = jax_dict_keys("bench_input", "main")
    assert all(set(line) == want and line["value"] > 0 for line in lines)


def test_run_protocol_synthetic_runs_skips_and_summarises(tmp_path, capsys):
    import sys

    argv = ["--synthetic", "--output_root", str(tmp_path), "--device", "cpu"]
    summary = run_protocol.main(argv)
    first = capsys.readouterr().out
    stages = ("zeroshot", "fewshot", "base2new", "domain_gen")
    assert first.count("[run ]") == 6 and "[skip]" not in first
    again = run_protocol.main(argv)
    second = capsys.readouterr().out
    assert second.count("[skip]") == 6 and "[run ]" not in second
    assert again == summary
    # the JAX stage_parse's summary keys, less the published comparison
    tree = ast.parse((ROOT / "tools" / "run_protocol.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "stage_parse")
    keys = {t.slice.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
            for t in n.targets if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
            and t.value.id == "summary"}
    keys |= {"n_units"}
    assert set(summary) == keys - {"published_comparison"}
    assert summary["n_units"] == 6 and summary["failures"] == []
    assert set(stages) <= set(summary)
    assert json.loads((tmp_path / "protocol_summary.json").read_text()) == summary
    # tools/parse_test_res.py reads the port's metrics.jsonl as it reads the JAX package's
    sys.path.insert(0, str(ROOT))
    try:
        from tools.parse_test_res import collect
    finally:
        sys.path.remove(str(ROOT))
    runs = dict(collect(str(tmp_path), "test", ["accuracy"]))
    assert {"zeroshot/synthetic", "base2new/synthetic/seed_1/test_new"} <= set(runs)
    assert runs["zeroshot/synthetic"]["accuracy"] == summary["zeroshot"]["synthetic"]["accuracy"]


@pytest.mark.parametrize("tool,argv", [
    (bench_cocoop, []),
    (sweep_bench, ["4:none:pallas"]),
    (profile_step, []),
    (bench_zoo, ["--trainers", "CoOp"]),
    (run_protocol, ["--synthetic", "--output_root", "unused"]),
], ids=lambda v: getattr(v, "__name__", "").rsplit(".", 1)[-1] or None)
def test_tool_without_device_needs_cuda(monkeypatch, tool, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)
