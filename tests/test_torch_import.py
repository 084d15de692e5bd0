"""``mudpt_torch`` and ``chip_smoke.py`` stand alone: nothing of JAX, of the
JAX package, of ``regex``, ``ml_dtypes``, ``grain`` or TensorFlow is
imported, and importing the port with those modules blocked succeeds."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "optax", "ml_dtypes", "mudpt_tpu", "regex", "grain", "tensorflow")
SOURCES = sorted((ROOT / "mudpt_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        f"for name in {BANNED!r}:\n"
        "    sys.modules[name] = None\n"
        "import mudpt_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(mudpt_torch.__path__, 'mudpt_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(len(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_banned_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BANNED, f"{path}:{node.lineno} imports {name}"


def test_parallel_is_scanned():
    """The mesh's modules are among the scanned sources."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {"mudpt_torch/parallel/__init__.py", "mudpt_torch/parallel/mesh.py",
            "mudpt_torch/parallel/multihost.py"} <= names


def test_tools_are_scanned():
    """The serving tools and the probes are among the scanned sources,
    beside the modules they drive."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {"mudpt_torch/tools/export_serving.py", "mudpt_torch/tools/predict.py",
            "mudpt_torch/tools/bench_artifact.py", "mudpt_torch/serving.py",
            "mudpt_torch/api.py", "mudpt_torch/ops/library.py",
            "mudpt_torch/tools/probe_int8_mxu.py", "mudpt_torch/tools/probe_q8_residual.py",
            "mudpt_torch/ops/probe.py"} <= names
