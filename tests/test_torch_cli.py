"""The port's CLI, ``python -m mudpt_torch.train``, on the CPU: what
``tests/test_cli.py`` checks of ``train.py`` (train then ``--eval_only``,
the config cascade, the dead reference flags, the SIGTERM preemption
checkpoint of a real subprocess), every registered trainer trained and
evaluated at test-tiny, and the device rule: without ``--device`` the run
takes the card and raises when CUDA is absent."""

import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from mudpt_torch import train as train_cli

ROOT = Path(__file__).resolve().parent.parent
VPT_OPTS = ("VISUAL_PROMPT_DEPTH", "2", "DEEP_VISUAL_N_CTX", "2")
EXTRA = {"VPT": VPT_OPTS, "MPT": VPT_OPTS + ("TEXT_PROMPT_DEPTH", "2", "DEEP_TEXT_N_CTX", "2")}
TRAINERS = ("CoOp", "CoCoOp", "VPT", "MPT", "UMuDPT", "UUMuDPT", "MuDPT",
            "ZeroshotCLIP", "ZeroshotCLIP2")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _restore_streams():
    """``setup_logger`` tees stdout and stderr into the run's log.txt."""
    yield
    sys.stdout, sys.stderr = sys.__stdout__, sys.__stderr__


def _argv(tmp_path, trainer="MuDPT", extra=(), device=("--device", "cpu")):
    key = f"TRAINER.{trainer.upper()}"
    hp = () if trainer.startswith("Zeroshot") else (f"{key}.PREC", "fp32")
    hp += tuple(x for k, v in zip(EXTRA.get(trainer, ())[::2], EXTRA.get(trainer, ())[1::2])
                for x in (f"{key}.{k}", v))
    return [
        "--trainer", trainer,
        "--dataset_config", "configs/datasets/synthetic.yaml",
        "--output_dir", str(tmp_path / "out"),
        "--seed", "1",
        "--backbone", "test-tiny",
        "--backbone_path", "random",
        *device,
        *extra,
        "OPTIM.MAX_EPOCH", "1",
        "INPUT.SIZE", "(32, 32)",
        "DATALOADER.TRAIN_X.BATCH_SIZE", "8",
        "DATALOADER.TEST.BATCH_SIZE", "8",
        "TRAIN.PRINT_FREQ", "100",
        *hp,
    ]


def _records(out, kind):
    with open(out / "metrics.jsonl") as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


def test_cli_train_and_eval_only(tmp_path):
    args = train_cli.parse_args(_argv(tmp_path))
    train_cli.main(args)
    out_dir = tmp_path / "out"
    assert (out_dir / "log.txt").exists()
    assert (out_dir / "metrics.jsonl").exists()
    assert (out_dir / "MultimodalDeepPromptTuning" / "model.pth.tar-1").exists()
    trained = _records(out_dir, "eval")[-1]

    # eval_only reloads the trained prompts (reference train.py:167-169)
    args = train_cli.parse_args(
        _argv(tmp_path, extra=["--eval_only", "--model_dir", str(out_dir),
                               "--load_epoch", "1"]))
    train_cli.main(args)
    reloaded = _records(out_dir, "eval")[-1]
    assert reloaded["total"] == trained["total"] == 16
    assert reloaded["correct"] == trained["correct"]
    assert "Loading weights for MultimodalDeepPromptTuning" in (out_dir / "log.txt").read_text()


@pytest.mark.parametrize("trainer", TRAINERS)
def test_cli_trains_and_evaluates_every_trainer(tmp_path, trainer):
    train_cli.main(train_cli.parse_args(_argv(tmp_path, trainer)))
    out_dir = tmp_path / "out"
    evals = _records(out_dir, "eval")
    assert len(evals) == 1 and evals[0]["total"] == 16
    if trainer.startswith("Zeroshot"):
        assert not _records(out_dir, "train")
    else:
        assert len(_records(out_dir, "train")) == 1  # the epoch's last batch
        assert list(out_dir.glob("*/model.pth.tar-1"))


def test_cli_config_cascade(tmp_path):
    args = train_cli.parse_args(_argv(tmp_path) + ["OPTIM.LR", "0.123"])
    cfg = train_cli.setup_config(args)
    assert cfg.OPTIM.LR == 0.123
    assert cfg.DATASET.NAME == "Synthetic"
    assert cfg.TRAINER.NAME == "MuDPT"
    assert cfg.MODEL.BACKBONE.NAME == "test-tiny"
    assert cfg.TRAINER.MUDPT.PREC == "fp32"
    # the trainer yaml over the dataset yaml, the flags over both
    args = train_cli.parse_args(
        ["--trainer_config", "configs/trainers/CoOp/vit_b16_c16_ep200.yaml",
         "--dataset_config", "configs/datasets/synthetic.yaml", "--trainer", "CoOp",
         "--backbone", "ViT-B/32", "TRAINER.COOP.CLASS_TOKEN_POSITION", "front"])
    cfg = train_cli.setup_config(args)
    assert cfg.TRAINER.COOP.CSC and cfg.OPTIM.MAX_EPOCH == 200
    assert cfg.MODEL.BACKBONE.NAME == "ViT-B/32"
    assert cfg.TRAINER.COOP.CLASS_TOKEN_POSITION == "front"


def test_cli_accepts_dead_reference_flags(tmp_path):
    args = train_cli.parse_args(
        _argv(tmp_path, extra=["--head", "linear", "--transforms",
                               "random_flip", "random_crop", "--"]))
    cfg = train_cli.setup_config(args)
    assert cfg.TRAINER.NAME == "MuDPT"
    assert args.device == "cpu"


def test_cli_without_device_takes_the_card(tmp_path, monkeypatch):
    """No ``--device``: CUDA, and a RuntimeError where it is absent; a
    multi-process launch without CUDA raises too, as NCCL needs it.  CoCoOp builds
    under an int8 tier, as in the JAX package (its per-instance text encode
    on the dynamic chain), on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = train_cli.parse_args(_argv(tmp_path, "CoOp", device=()))
    assert args.device is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(args)
    from mudpt_torch.models import layers

    try:
        tr = train_cli.main(train_cli.parse_args(
            _argv(tmp_path, "CoCoOp", extra=("--no_train",)) + ["TRAIN.QUANT", "int8"]))
        assert type(tr).__name__ == "CoCoOp" and layers.quant_mode() == "int8"
        assert "q8_weights" in tr.frozen["text"]["blocks"]
    finally:
        layers.set_quant_mode("none")  # the build set it
    # a multi-process launch joins the process group first: an incomplete
    # torchrun environment, or NCCL without CUDA, raises (no other backend)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="RANK, MASTER_ADDR, MASTER_PORT missing"):
        train_cli.main(train_cli.parse_args(_argv(tmp_path, device=())))
    for k, v in (("RANK", "1"), ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="backend 'nccl' needs CUDA"):
        train_cli.main(train_cli.parse_args(_argv(tmp_path, device=())))


def test_sigterm_writes_preemption_checkpoint(tmp_path):
    """A SIGTERM to a training subprocess: it finishes the in-flight step,
    writes model-preempt.pth.tar, prints the RESUME hint and exits 0."""
    out_dir = tmp_path / "out"
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "NUM_PROCESSES")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "mudpt_torch.train", "--device", "cpu",
         "--trainer", "CoOp",
         "--dataset_config", "configs/datasets/synthetic.yaml",
         "--output_dir", str(out_dir),
         "--backbone", "test-tiny", "--backbone_path", "random",
         "OPTIM.MAX_EPOCH", "500",
         "INPUT.SIZE", "(32, 32)",
         "DATALOADER.TRAIN_X.BATCH_SIZE", "8",
         "TRAINER.COOP.PREC", "fp32",
         "TRAIN.PRINT_FREQ", "1"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
    )
    lines, seen_batch = [], threading.Event()

    def _reader():
        for line in proc.stdout:
            lines.append(line)
            if "batch [" in line:
                seen_batch.set()

    t = threading.Thread(target=_reader, daemon=True)
    t.start()
    try:
        assert seen_batch.wait(timeout=300), "train loop never started:\n" + "".join(lines[-30:])
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=300)
        t.join(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    out = "".join(lines)
    assert proc.returncode == 0, out[-3000:]
    assert "Preemption checkpoint saved to" in out
    assert "Training preempted" in out
    assert (out_dir / "prompt_learner" / "model-preempt.pth.tar").exists(), out[-3000:]
