"""The engine end to end at tiny size: the port's MuDPT trainer against the
JAX package's on one epoch of the synthetic dataset
(``configs/trainers/test/tiny.yaml``: test-tiny, PREC fp32, 32 px), the
JAX trainer's frozen, trainable and aux trees crossed into the port before
training; a preempted-then-resumed run against an uninterrupted one; and
the trainer's device rule."""

import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from mudpt_tpu.config import load_config as jload_config
from mudpt_tpu.trainers import build_trainer as jbuild_trainer

from mudpt_torch.config import load_config
from mudpt_torch.models.convert import params_from_numpy
from mudpt_torch.models.clip import leaves
from mudpt_torch.trainers.base import TrainerBase, build_trainer

FILES = ("configs/datasets/synthetic.yaml", "configs/trainers/test/tiny.yaml")
# fp32 on both sides: the packages differ only in the order of fp32 sums
REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _opts(out, *more):
    return ["TRAINER.NAME", "MuDPT", "OUTPUT_DIR", str(out), "TRAIN.PRINT_FREQ", "1", *more]


def _train_records(out):
    with open(f"{out}/metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if r["kind"] == "train"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_one_epoch_matches_jax_trainer(tmp_path):
    jtr = jbuild_trainer(jload_config(*FILES, opts=_opts(tmp_path / "jax")))
    ttr = build_trainer(load_config(*FILES, opts=_opts(tmp_path / "torch")), devices="cpu")
    # the port's MuDPT builds the same trees: names, shapes, the CTX_INIT
    # context and the class buffers
    for jt, tt in ((jtr.trainable, ttr.trainable), (jtr.aux, ttr.aux)):
        assert (jax.tree_util.tree_map(np.shape, jt)
                == jax.tree_util.tree_map(lambda t: tuple(t.shape), tt))
    assert ttr.model_name == jtr.model_name == "MultimodalDeepPromptTuning"
    np.testing.assert_array_equal(ttr.aux["eot_idx"].numpy(), np.asarray(jtr.aux["eot_idx"]))
    ttr.place(frozen=params_from_numpy(_np(jtr.frozen), "cpu"),
              aux_class_tree=params_from_numpy(_np(jtr.aux), "cpu"), aux_repl=None,
              trainable=params_from_numpy(_np(jtr.trainable), "cpu"))
    ttr._build_train_state()
    jtr.train()
    ttr.train()

    jrec, trec = _train_records(tmp_path / "jax"), _train_records(tmp_path / "torch")
    assert len(jrec) == len(trec) == len(ttr.dm.train_loader) == 4
    for j, t in zip(jrec, trec):
        assert t["step"] == j["step"]
        assert abs(t["loss"] - j["loss"]) <= REL * abs(j["loss"]), (t, j)
        assert abs(t["acc"] - j["acc"]) <= REL * max(abs(j["acc"]), 1e-6), (t, j)
        assert t["lr"] == pytest.approx(j["lr"], rel=1e-6)
    jleaves = jax.tree_util.tree_leaves(_np(jtr.trainable))
    tleaves = leaves(ttr.trainable)
    assert len(jleaves) == len(tleaves) == 10
    for a, b in zip(jleaves, tleaves):
        b = b.detach().numpy()
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= REL * np.abs(a).max()

    # test predictions: equal, or one sample apart whose two top logits tie
    # within 1e-4 (the argmax of a near-tie may fall either way)
    loader = ttr.dm.test_loader
    jtxt = jtr._text_features(jtr.trainable, jtr.frozen, jtr.aux)
    ttxt = ttr._text_features(ttr.trainable, ttr.frozen, ttr.aux)
    diffs = []
    for batch in loader:
        n = int(batch["valid"].sum())
        jp = np.asarray(jtr._eval_step_cached(jtr.trainable, jtr.frozen, jtr.aux,
                                              batch["image"], jtxt))[:n]
        images = torch.from_numpy(batch["image"])
        tp = ttr._eval_step_cached(ttr.trainable, ttr.frozen, ttr.aux, images, ttxt).numpy()[:n]
        with torch.no_grad():
            logits = ttr.forward_image(ttr.trainable, ttr.frozen, ttr.aux, images, ttxt)[:n]
        top2 = logits.topk(2, dim=-1).values
        diffs += [float(top2[i, 0] - top2[i, 1]) for i in np.nonzero(jp != tp)[0]]
    assert len(diffs) == 0 or (len(diffs) == 1 and diffs[0] <= 1e-4), diffs


def _resume_cfg(out, *more):
    return load_config(*FILES, opts=_opts(out, "OPTIM.MAX_EPOCH", "2", *more))


def test_preempted_then_resumed_run_equals_uninterrupted(tmp_path):
    """A SIGTERM during batch 3 of epoch 1 (of 4) writes
    model-preempt.pth.tar after that batch and stops; a trainer with RESUME
    fast-forwards the loader and continues; its losses and final prompts
    equal an uninterrupted run's exactly.  MODEL.INIT_WEIGHTS then
    warm-starts a new trainer from the finished run's prompts."""
    full = build_trainer(_resume_cfg(tmp_path / "full"), devices="cpu")
    full.train()

    part = build_trainer(_resume_cfg(tmp_path / "part"), devices="cpu")
    step = part._train_step

    def preempting_step(batch):
        out = step(batch)
        if part.epoch == 0 and part.global_step == 2:  # batch 3 is about to finish
            os.kill(os.getpid(), signal.SIGTERM)  # the trainer's handler sets the flag
        return out

    part._train_step = preempting_step
    part.train()
    assert (tmp_path / "part" / part.model_name / "model-preempt.pth.tar").exists()
    assert not (tmp_path / "part" / part.model_name / "model.pth.tar-2").exists()

    resumed = build_trainer(_resume_cfg(tmp_path / "part", "RESUME", str(tmp_path / "part")),
                            devices="cpu")
    resumed.train()
    losses = [r["loss"] for r in _train_records(tmp_path / "full")]
    part_losses = [r["loss"] for r in _train_records(tmp_path / "part")]
    assert len(losses) == 8 and part_losses == losses
    for a, b in zip(leaves(full.trainable), leaves(resumed.trainable)):
        assert torch.equal(a, b)
    assert not (tmp_path / "part" / part.model_name / "model-preempt.pth.tar").exists()
    assert signal.getsignal(signal.SIGTERM) is not None  # the handler was put back

    warm = build_trainer(_resume_cfg(tmp_path / "warm", "MODEL.INIT_WEIGHTS",
                                     str(tmp_path / "full")), devices="cpu")
    for a, b in zip(leaves(full.trainable), leaves(warm.trainable)):
        assert torch.equal(a, b)


def test_trainer_without_cuda_raises(tmp_path, monkeypatch):
    """``devices=None`` means the card: no quiet drift onto the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(*FILES, opts=_opts(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainerBase(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_trainer(cfg)


def test_train_quant_modes(tmp_path):
    """TRAIN.QUANT 'int8_ste' trains against the int8 chains, the towers'
    weights quantized once at build; the static tiers calibrate at build
    (tests/test_torch_static_calib.py holds them against the JAX package)."""
    from mudpt_torch.models import layers

    try:
        tr = build_trainer(load_config(*FILES, opts=_opts(tmp_path / "ste", "TRAIN.QUANT",
                                                          "int8_ste")), devices="cpu")
        assert layers.quant_mode() == "int8_ste"
        assert all("q8_weights" in tr.frozen[t]["blocks"] for t in ("visual", "text"))
        before = [t.detach().clone() for t in leaves(tr.trainable)]
        tr.train()
        losses = [r["loss"] for r in _train_records(tmp_path / "ste")]
        assert len(losses) == 4 and all(np.isfinite(losses))
        assert any(not torch.equal(a, b) for a, b in zip(before, leaves(tr.trainable)))
        for quant in ("int8_static", "int8_ste_static"):
            tr = build_trainer(load_config(*FILES, opts=_opts(tmp_path / quant, "TRAIN.QUANT",
                                                              quant)), devices="cpu")
            assert layers.quant_mode() == quant and tr.dm.train_loader._epoch == 0
            for t in ("visual", "text"):
                blocks = tr.frozen[t]["blocks"]
                assert "q8_weights" in blocks and blocks["q8_scales"].shape[1] == 4
    finally:
        layers.set_quant_mode("none")


def test_ctx_init_matches_jax():
    """CTX_INIT "a photo of a": the phrase's token embeddings at positions
    1..1+n_ctx, through the port's tokenizer and table."""
    import jax.numpy as jnp

    from mudpt_tpu.trainers.prompt_utils import ctx_vectors_from_init as jctx

    from mudpt_torch.trainers.prompt_utils import ctx_vectors_from_init

    table = np.random.RandomState(0).standard_normal((49408, 8)).astype(np.float32)
    for n_ctx in (2, 4):
        want = np.asarray(jctx({"token_embedding": jnp.asarray(table)}, "a_photo of a", n_ctx))
        got = ctx_vectors_from_init({"token_embedding": torch.from_numpy(table)},
                                    "a_photo of a", n_ctx)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
