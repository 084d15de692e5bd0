"""What the harness and the reference load, and how the harness ends where
it cannot run: a cell's run loads no module whose top-level name is
``jax``, ``jaxlib``, ``flax`` or ``mudpt_tpu`` (whole names, so
``mudpt_torch`` is none of them); the reference loads nothing of
``mudpt_torch``; without a card, or without the program beside it, a run
exits with another code than 0 and prints no result."""

import ast
import os
import shutil
import subprocess
import sys
import textwrap

from benchmark import run, spec

ROOT = str(spec.ROOT)
ENV = dict(os.environ, PYTHONPATH=ROOT)


def _python(code: str, cwd: str = ROOT) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=cwd, env=ENV,
                          capture_output=True, text=True, timeout=600)


def test_a_cell_run_loads_no_jax():
    out = _python("""
        import sys, torch
        from benchmark import run
        from benchmark.tests.conftest import tiny_cell
        for kind in ("train", "serve", "serve_int8"):
            run.run_cell(tiny_cell(kind), 5, 0.1, False, torch.device("cpu"))
        print("FORBIDDEN", run.forbidden_modules())
        print("PORT", "mudpt_torch" in sys.modules)
    """)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout
    assert "PORT True" in out.stdout


def test_the_forbidden_names_are_compared_whole():
    sys.modules.setdefault("mudpt_tpu_like", sys)
    try:
        assert "mudpt_tpu_like" not in run.forbidden_modules()
    finally:
        sys.modules.pop("mudpt_tpu_like", None)


def test_the_reference_loads_nothing_of_the_port():
    out = _python("""
        import sys
        import benchmark.reference.clip_mudpt
        print(sorted(m for m in sys.modules if m.split(".")[0] in
                     ("mudpt_torch", "mudpt_tpu", "jax")))
    """)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
    here = os.path.join(ROOT, "benchmark", "reference")
    for name in os.listdir(here):
        if name.endswith(".py"):
            tree = ast.parse(open(os.path.join(here, name)).read())
            for node in ast.walk(tree):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                        [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                for m in mods:
                    top = m.split(".")[0]
                    assert top not in ("mudpt_torch", "mudpt_tpu", "jax", "benchmark"), (name, m)


def test_no_card_means_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "mudpt-vitb16.train-b384", "--seed", str(2 ** 31 + 1),
                          "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_without_the_program_a_run_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-c", textwrap.dedent("""
        import torch
        from benchmark import run
        from benchmark.tests.conftest import tiny_cell
        print(run.run_cell(tiny_cell("train"), 5, 0.1, False, torch.device("cpu")))
    """)], cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(tmp_path)),
        capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "mudpt_torch" in out.stderr
