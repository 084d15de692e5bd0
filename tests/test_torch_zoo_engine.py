"""The port's zoo trainers end to end at tiny size: one epoch of CoOp and
CoCoOp (the deep-prompt trainers in ``test_torch_zoo_engine_deep.py``)
through ``build_trainer(..., devices="cpu")`` against the JAX trainer on
the synthetic dataset (``configs/trainers/test/tiny.yaml``, PREC fp32),
the JAX trainer's frozen, trainable and aux trees crossed into the port
before training: per-step losses within 1e-4, the final prompts within
1e-4 of their largest value, the test predictions equal; the zero-shot
pair's test results; and the static text cache following a change of the
frozen tree."""

import json

import jax
import numpy as np
import pytest
import torch

from mudpt_tpu.config import load_config as jload_config
from mudpt_tpu.trainers import build_trainer as jbuild_trainer
from mudpt_tpu.trainers import zsclip as JZS

from mudpt_torch.config import load_config
from mudpt_torch.models.clip import leaves
from mudpt_torch.models.convert import params_from_numpy
from mudpt_torch.trainers import build_trainer
from mudpt_torch.trainers import vpt as TVP
from mudpt_torch.trainers import zsclip as TZS

FILES = ("configs/datasets/synthetic.yaml", "configs/trainers/test/tiny.yaml")
REL = 1e-4
VPT_OPTS = ("VISUAL_PROMPT_DEPTH", "2", "DEEP_VISUAL_N_CTX", "2")
HPARAMS = {
    "CoOp": ("N_CTX", "4", "CLASS_TOKEN_POSITION", "middle"),
    "CoCoOp": ("N_CTX", "4", "ENCODE_CHUNK", "3"),
    "VPT": VPT_OPTS,
    "MPT": VPT_OPTS + ("TEXT_PROMPT_DEPTH", "2", "DEEP_TEXT_N_CTX", "2"),
    "UMuDPT": (),
    "UUMuDPT": (),
}


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _opts(trainer, out):
    key = f"TRAINER.{trainer.upper()}"
    hp = HPARAMS.get(trainer, ())
    opts = ["TRAINER.NAME", trainer, "OUTPUT_DIR", str(out), "TRAIN.PRINT_FREQ", "1"]
    if trainer in HPARAMS:
        opts += [f"{key}.PREC", "fp32"]
    for k, v in zip(hp[::2], hp[1::2]):
        opts += [f"{key}.{k}", v]
    return opts


def _train_records(out):
    with open(f"{out}/metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if r["kind"] == "train"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _crossed(trainer, tmp_path):
    """The JAX trainer and the port's, the port's trees replaced by the JAX
    trainer's (its own static text cache rebuilt from them)."""
    jtr = jbuild_trainer(jload_config(*FILES, opts=_opts(trainer, tmp_path / "jax")))
    ttr = build_trainer(load_config(*FILES, opts=_opts(trainer, tmp_path / "torch")),
                        devices="cpu")
    assert ttr.model_name == jtr.model_name
    jaux = {k: v for k, v in jtr.aux.items() if k != "static_text_features"}
    for jt, tt in ((jtr.trainable, ttr.trainable), (jtr.aux, ttr.aux)):
        shapes = {k: tuple(np.shape(v)) for k, v in _flat(_np(jt)).items()}
        assert shapes == {k: tuple(v.shape) for k, v in _flat(tt).items()}
    ttr.place(frozen=params_from_numpy(_np(jtr.frozen), "cpu"),
              aux_class_tree=params_from_numpy(_np(jaux), "cpu"), aux_repl=None,
              trainable=params_from_numpy(_np(jtr.trainable), "cpu"))
    ttr._build_train_state()
    ttr._cache_static_text()
    return jtr, ttr


@pytest.mark.parametrize("trainer", ["CoOp", "CoCoOp"])
def test_one_epoch_matches_jax_trainer(tmp_path, trainer):
    check_one_epoch(tmp_path, trainer)


def check_one_epoch(tmp_path, trainer):
    """One epoch of ``trainer`` in both packages from the same trees."""
    jtr, ttr = _crossed(trainer, tmp_path)
    jtr.train()
    ttr.train()
    jrec, trec = _train_records(tmp_path / "jax"), _train_records(tmp_path / "torch")
    assert len(jrec) == len(trec) == len(ttr.dm.train_loader) == 4
    for j, t in zip(jrec, trec):
        assert t["step"] == j["step"]
        assert abs(t["loss"] - j["loss"]) <= REL * abs(j["loss"]), (t, j)
        assert t["lr"] == pytest.approx(j["lr"], rel=1e-6)
    jleaves, tleaves = _flat(_np(jtr.trainable)), _flat(ttr.trainable)
    assert sorted(jleaves) == sorted(tleaves)
    for name, a in jleaves.items():
        b = tleaves[name].detach().numpy()
        assert np.abs(a - b).max() <= REL * np.abs(a).max(), name
    jres = _eval_records(tmp_path / "jax")
    tres = _eval_records(tmp_path / "torch")
    assert [r["total"] for r in tres] == [r["total"] for r in jres] == [16]
    assert [r["correct"] for r in tres] == [r["correct"] for r in jres]


def _eval_records(out):
    with open(f"{out}/metrics.jsonl") as f:
        return [r for r in map(json.loads, f) if r["kind"] == "eval"]


@pytest.mark.parametrize("trainer", ["ZeroshotCLIP", "ZeroshotCLIP2"])
def test_zero_shot_matches_jax_trainer(tmp_path, trainer, monkeypatch):
    """In fp32 (PREC's class default set to fp32 on both sides): the port's
    template encode from the JAX weights equals the JAX trainer's cached
    text features, and ``train()``, which runs ``test()``, scores alike."""
    for cls in (JZS.ZeroshotCLIP, TZS.ZeroshotCLIP):
        monkeypatch.setattr(cls, "prec_default", "fp32")
    jtr = jbuild_trainer(jload_config(*FILES, opts=_opts(trainer, tmp_path / "jax")))
    ttr = build_trainer(load_config(*FILES, opts=_opts(trainer, tmp_path / "torch")),
                        devices="cpu")
    assert ttr.trainable is None and ttr.compute_dtype == torch.float32
    frozen = params_from_numpy(_np(jtr.frozen), "cpu")
    templates = ([JZS.CUSTOM_TEMPLATES["Synthetic"]] if trainer == "ZeroshotCLIP"
                 else list(JZS.IMAGENET_TEMPLATES_SELECT) + [JZS.CUSTOM_TEMPLATES["Synthetic"]])
    txt = TZS._encode_templates(frozen, ttr.clip_cfg, ttr.classnames, templates,
                                torch.float32, "cpu")
    want = np.asarray(jtr.aux["text_features"])
    assert np.abs(txt.numpy() - want).max() <= REL * np.abs(want).max()
    ttr.place(frozen=frozen, aux_class_tree={"text_features": txt}, aux_repl=None,
              trainable=None)
    jtr.train()
    ttr.train()
    jres, tres = _eval_records(tmp_path / "jax"), _eval_records(tmp_path / "torch")
    assert len(tres) == len(jres) == 1
    assert tres[0]["total"] == jres[0]["total"] == 16
    assert tres[0]["correct"] == jres[0]["correct"]


def test_static_text_cache_tracks_frozen(tmp_path, monkeypatch):
    """VPT encodes its fixed text once at build; a change of the frozen tree
    through ``_set_frozen`` re-encodes it, and a VPT step never runs the
    text tower."""
    cfg = load_config(*FILES, opts=_opts("VPT", tmp_path))
    tr = build_trainer(cfg, devices="cpu")
    assert tr.static_text and set(tr.trainable) == {"visual_ctx", "visual_deep_prompts"}
    before = tr.aux["static_text_features"].clone()
    frozen = dict(tr.frozen, text=dict(tr.frozen["text"],
                                       projection=tr.frozen["text"]["projection"] * 2.0))
    tr._set_frozen(frozen)
    aux = {k: v for k, v in tr.aux.items() if k != "static_text_features"}
    fresh = tr._text_features(tr.trainable, tr.frozen, aux)
    torch.testing.assert_close(tr.aux["static_text_features"], fresh, rtol=0, atol=0)
    assert (tr.aux["static_text_features"] - before).abs().max() > 0

    def no_text(*args, **kwargs):
        raise AssertionError("a VPT step ran the text tower")

    monkeypatch.setattr(TVP, "text_forward", no_text)
    batch = tr._device_batch(next(iter(tr.dm.train_loader)))
    before = [t.detach().clone() for t in leaves(tr.trainable)]
    tr._train_step(batch)
    assert all(not torch.equal(a, b) for a, b in zip(before, leaves(tr.trainable)))
