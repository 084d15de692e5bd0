"""``python -m mudpt_torch.tools.validate_zeroshot`` against the JAX
package's ``tools/validate_zeroshot.py`` (loaded by path), both in this
process on one saved tiny CLIP ``.pt``: the synthetic dataset (no
published value, exit 0), a small Caltech101 tree (a FAIL line against
the published 92.90, exit 1), the same measured accuracies, the report's
lines and the tool's two refusals."""

import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from mudpt_torch.tools import validate_zeroshot as TV
from tests.test_torch_checkpoint import _state_dict

ROOT = Path(__file__).resolve().parent.parent
OPTS = ["INPUT.SIZE", "(32, 32)", "DATALOADER.TEST.BATCH_SIZE", "8",
        "DATALOADER.NUM_WORKERS", "2"]
CLASSES = ("ant", "bass", "camera", "dolphin")
LINE = re.compile(r"^(\w+): measured ([\d.]+) (?:published ([\d.]+) delta ([+-][\d.]+) "
                  r"\[(OK|FAIL)\]|\(no published value\))$")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on few cores: keep torch's intra-op
    pool small so these files do not crowd out timing-sensitive tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_validate_zeroshot",
                                                  ROOT / "tools" / "validate_zeroshot.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def backbone(tmp_path_factory):
    """A tiny CLIP (width 64, image 32, one head, two layers a tower) with
    the tokenizer's whole vocabulary, written as an OpenAI state dict."""
    path = tmp_path_factory.mktemp("clip") / "tiny.pt"
    torch.save(_state_dict(np.random.RandomState(6), vocab=49408), path)
    return str(path)


@pytest.fixture(scope="module")
def caltech(tmp_path_factory):
    """The Caltech101 reader's layout: four classes of ten 32 x 32 JPEGs
    (its 50/20/30 split: three test images a class) and the two folders it
    ignores."""
    root = tmp_path_factory.mktemp("data")
    img_root = root / "caltech101" / "caltech-101" / "101_ObjectCategories"
    rs = np.random.RandomState(0)
    for name, n in [(c, 10) for c in CLASSES] + [("BACKGROUND_Google", 2), ("Faces_easy", 2)]:
        (img_root / name).mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rs.randint(0, 256, (32, 32, 3), np.uint8)).save(
                img_root / name / f"image_{i:04d}.jpg")
    return str(root)


def _run_both(jax_tool, monkeypatch, capsys, argv):
    """(exit code, report lines) of the JAX tool, then of the port's."""
    out = []
    monkeypatch.setattr(sys, "argv", ["validate_zeroshot.py", *argv])
    rc = jax_tool.main()
    out.append((rc, _report(capsys.readouterr().out)))
    rc = TV.main([*argv, "--device", "cpu"])
    out.append((rc, _report(capsys.readouterr().out)))
    return out


def _report(stdout: str) -> list:
    return [m.groups() for m in map(LINE.match, stdout.splitlines()) if m]


def test_synthetic_has_no_published_value(jax_tool, backbone, tmp_path, monkeypatch, capsys):
    (jrc, jrep), (trc, trep) = _run_both(jax_tool, monkeypatch, capsys, [
        "--dataset_root", str(tmp_path), "--backbone_path", backbone, *OPTS,
        "--datasets", "synthetic"])
    assert jrc == trc == 0
    assert trep == jrep and len(trep) == 1
    assert trep[0][0] == "synthetic" and trep[0][2] is None


def test_caltech101_fails_the_published_number(jax_tool, backbone, caltech, monkeypatch,
                                               capsys):
    """Random weights cannot meet 92.90 within 1.0: both tools print the
    same FAIL line and exit 1; the port's accuracy is its trainer's
    ``test()`` on the same config."""
    (jrc, jrep), (trc, trep) = _run_both(jax_tool, monkeypatch, capsys, [
        "--dataset_root", caltech, "--backbone_path", backbone, *OPTS,
        "--datasets", "caltech101", "--tolerance", "1.0"])
    assert jrc == trc == 1
    assert trep == jrep and len(trep) == 1
    name, measured, published, delta, status = trep[0]
    assert (name, published, status) == ("caltech101", "92.90", "FAIL")
    assert float(delta) == pytest.approx(float(measured) - 92.9, abs=0.011)

    from mudpt_torch.trainers.base import build_trainer

    cfg = TV.dataset_config("caltech101", caltech, "ViT-B/16", backbone, OPTS)
    tr = build_trainer(cfg, devices="cpu")
    rec = tr.test()
    assert f"{rec['accuracy']:.2f}" == measured and rec["total"] == 3 * len(CLASSES)


@pytest.mark.parametrize("argv,err", [
    (["--dataset_root", "x", "--bogus", "1"], "unknown flags"),
    (["--dataset_root", "x", "--datasets", "caltech101", "INPUT.SIZE", "(32, 32)"],
     "swallowed config override keys"),
])
def test_refusals(argv, err, capsys):
    with pytest.raises(SystemExit) as exc:
        TV.main(argv)
    assert exc.value.code == 2 and err in capsys.readouterr().err


def test_published_table_is_the_jax_tools(jax_tool):
    assert TV.PUBLISHED_VIT_B16 == jax_tool.PUBLISHED_VIT_B16
