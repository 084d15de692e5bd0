"""The port's serving tools on the CPU (``--device cpu``), each as
``python -m mudpt_torch.tools.<name>`` in a subprocess, the counterparts of
``tests/test_serving.py``'s CLI cases: ``export_serving`` on the config
cascade of ``mudpt_torch.train``, ``predict`` (top-k JSON lines, a pinned
artifact's tail padded, a batch it cannot serve refused), ``bench_artifact``
(the JAX tool's keys), and a loader that imports no model code."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mudpt_torch import serving
from mudpt_torch.config import load_config
from mudpt_torch.trainers import build_trainer

ROOT = Path(__file__).resolve().parent.parent
FILES = ("configs/datasets/synthetic.yaml", "configs/trainers/test/tiny.yaml")
ENV = dict({k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
           OMP_NUM_THREADS="2")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _run(*argv, timeout=300):
    return subprocess.run([sys.executable, *argv], cwd=ROOT, env=ENV, capture_output=True,
                          text=True, timeout=timeout)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A MuDPT artifact with a symbolic batch and one of its kernel tier,
    and a CoCoOp one pinned to 2."""
    root = tmp_path_factory.mktemp("arts")
    out = {}
    for name, batch in (("MuDPT", None), ("CoCoOp", 2)):
        opts = ["TRAINER.NAME", name, "OUTPUT_DIR", str(root / name),
                f"TRAINER.{name.upper()}.PREC", "fp32"]
        tr = build_trainer(load_config(*FILES, opts=opts), devices="cpu")
        out[name] = str(root / f"art_{name}")
        serving.export_trainer(out[name], tr, batch=batch, platforms=("cpu",))
        out[name + "_classnames"] = list(tr.classnames)
        if name == "MuDPT":
            out["pallas"] = str(root / "art_pallas")
            serving.export_trainer(out["pallas"], tr, batch=2, block_impl="pallas")
    return out


def test_export_cli(tmp_path):
    art = str(tmp_path / "cli_artifact")
    r = _run("-m", "mudpt_torch.tools.export_serving", "--device", "cpu",
             "--trainer", "CoOp", "--dataset_config", "configs/datasets/synthetic.yaml",
             "--backbone", "test-tiny", "--backbone_path", "random",
             "--output_dir", str(tmp_path / "out"), "--export_dir", art,
             "--platforms", "cpu", "--", "INPUT.SIZE", "(32, 32)", "TRAINER.COOP.PREC", "fp32")
    assert r.returncode == 0, r.stderr
    clf = serving.load(art, device="cpu")
    assert clf.meta["trainer"] == "CoOp" and clf.meta["platforms"] == ["cpu"]
    out = clf.predict(np.zeros((2, 32, 32, 3), np.float32))
    assert out.shape == (2, len(clf.classnames)) and np.isfinite(out).all()


def test_bench_artifact_cli(artifacts, capsys):
    from mudpt_torch.tools import bench_artifact

    art = artifacts["MuDPT"]
    with pytest.raises(SystemExit):
        bench_artifact.main(["--artifact", art, "--device", "cpu", "--steps", "2"])
    assert "symbolic-batch" in capsys.readouterr().err
    r = _run("-m", "mudpt_torch.tools.bench_artifact", "--artifact", art, "--device", "cpu",
             "--batch", "4", "--steps", "2", "--warmup", "0")
    assert r.returncode == 0, r.stderr
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["unit"] == "images/sec/chip" and line["finite"] is True
    assert line["value"] > 0 and line["ms_per_batch"] > 0
    assert line["device"] == "cpu" and line["card"] is None
    assert "(xla, batch 4, n_cls 4, cpu)" in line["metric"]


def test_predict_cli(tmp_path, artifacts):
    from PIL import Image

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(5):
        Image.fromarray(rng.randint(0, 255, (40, 48, 3), np.uint8)).save(img_dir / f"im{i}.jpg")
    out_path = str(tmp_path / "preds.jsonl")
    r = _run("-m", "mudpt_torch.tools.predict", "--artifact", artifacts["MuDPT"],
             "--device", "cpu", "--image_dir", str(img_dir), "--batch", "2", "--top_k", "3",
             "--output", out_path)
    assert r.returncode == 0, r.stderr
    recs = [json.loads(line) for line in open(out_path)]
    assert len(recs) == 5
    names = artifacts["MuDPT_classnames"]
    for rec in recs:
        assert 0 <= rec["pred"] < len(names) and len(rec["top_k"]) == 3
        assert rec["top_k"][0]["label"] == rec["pred"]
        assert rec["top_k"][0]["classname"] in names
        probs = [t["prob"] for t in rec["top_k"]]
        assert probs == sorted(probs, reverse=True)
    # a pinned artifact: 5 images through batch 2 pad the tail; a batch it
    # cannot serve is refused
    from mudpt_torch.tools import predict

    argv = ["--artifact", artifacts["CoCoOp"], "--device", "cpu", "--image_dir", str(img_dir)]
    predict.main(predict.parse_args(argv + ["--output", out_path]))
    assert len(open(out_path).readlines()) == 5
    with pytest.raises(SystemExit, match="pinned batch"):
        predict.main(predict.parse_args(argv + ["--batch", "4"]))


def test_loader_needs_no_model_code(artifacts):
    """``serving.load`` and ``predict`` in a fresh process import no
    ``mudpt_torch.models`` or ``mudpt_torch.trainers`` module, on the
    ``xla`` tier and on the kernel tier (which imports ``ops.library``)."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from mudpt_torch import serving\n"
        f"for art in ({artifacts['MuDPT']!r}, {artifacts['pallas']!r}):\n"
        "    clf = serving.load(art, device='cpu')\n"
        "    out = clf.predict(np.zeros((2, 32, 32, 3), np.float32))\n"
        "    assert out.shape[0] == 2\n"
        "assert 'mudpt_torch.ops.library' in sys.modules\n"
        "bad = [m for m in sys.modules if m.startswith(('mudpt_torch.models',\n"
        "       'mudpt_torch.trainers'))]\n"
        "assert not bad, f'loader imported model code: {bad}'\n"
        "print('OK', out.shape)\n"
    )
    r = _run("-c", code)
    assert r.returncode == 0, r.stderr
    assert "OK" in r.stdout
