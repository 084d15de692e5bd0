"""Trained accuracy of the port against the JAX package through the whole
protocol (the port-vs-JAX form of ``tools/accuracy_ab.py``): both packages'
engines train MuDPT end to end in one CPU process, from one backbone file
and the same prompt weights, on the same few-shot data, base-to-new.

Scale, from ``tools/accuracy_ab.py:1-40``: a CLIP of width 64 with 2 + 2
layers (``tests/test_torch_feat_extractor.clip_state_dict``), 32 x 32
images, 8 classes (per-class tints at the RGB cube's corners under uniform
noise), ``DEEP_PROMPT_DEPTH 2``, batch 4.  Recipe: SGD with momentum 0.9
and weight decay, per-epoch cosine LR after a 1-epoch constant warmup,
16-shot sampling.  Protocol: train on the 4 base classes (the last epoch's
checkpoint saved), then a trainer built on the 4 new classes (its class
buffers rebuilt) loads it and tests.  Held: the loss at the end of every
epoch within ``REL``, each stage's test top-1 within ``TOP1_BAND`` points
(``tests/test_accuracy_protocol.py:54-58``), the base top-1 above chance.
"""

import json
import random

import jax
import numpy as np
import pytest
import torch

from mudpt_tpu import trainers as jtrainers  # noqa: F401  (registration)
from mudpt_tpu.config import default_config as jdefault_config
from mudpt_tpu.data import datum as jdatum
from mudpt_tpu.utils.registry import TRAINER_REGISTRY as JREGISTRY

from mudpt_torch import trainers as ttrainers  # noqa: F401  (registration)
from mudpt_torch.config import default_config
from mudpt_torch.data import datum as tdatum
from mudpt_torch.models.convert import params_from_numpy
from mudpt_torch.utils.registry import TRAINER_REGISTRY

from tests.test_torch_feat_extractor import write_clip_pt

N_CLS, IMG, BATCH, TEST_BATCH, SHOTS = 8, 32, 4, 32, 16
LR, WARMUP_CONS_LR, MOMENTUM, WEIGHT_DECAY = 0.015, 1e-5, 0.9, 5e-4
EPOCHS = 4
HP = dict(N_CTX=2, CTX_INIT="a photo of a", DEEP_PROMPT_DEPTH=2, PREC="fp32")
# fp32 on both sides: the packages differ only in the order of fp32 sums
REL = 1e-4
TOP1_BAND = 3.0
CHANCE = 100.0 / (N_CLS // 2)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def synth_splits(datum_cls, data_seed: int = 7, amp: float = 0.24, noise: float = 0.68):
    """``tools/accuracy_ab.synth_splits``: per-class tints at the RGB
    cube's corners plus uniform pixel noise, 32 train, 8 val and 24 test
    images a class; ``datum_cls`` is either package's Datum."""
    rng = np.random.RandomState(1000 + data_seed)
    corners = np.array([[i >> 2 & 1, i >> 1 & 1, i & 1] for i in range(8)], np.float32)
    colors = (0.5 + amp * (corners - 0.5))[:N_CLS]
    splits = {"train": [], "val": [], "test": []}
    for c in range(N_CLS):
        for split, count in (("train", 32), ("val", 8), ("test", 24)):
            for _ in range(count):
                img = colors[c] + noise * (rng.rand(IMG, IMG, 3).astype(np.float32) - 0.5)
                splits[split].append(datum_cls(label=c, classname=f"object {c}",
                                               array=np.clip(img, 0.0, 1.0).astype(np.float32)))
    return splits["train"], splits["val"], splits["test"]


def protocol_dataset(pkg, cfg):
    """``tools/accuracy_ab.protocol_dataset`` in either package's data
    module: seed -> few-shot -> base/new classes -> one fixed interleave of
    the class-grouped few-shot list (the sequential sampler replays it)."""
    train_pool, val, test = synth_splits(pkg.Datum)
    random.seed(cfg.SEED)
    train = pkg.generate_fewshot(train_pool, SHOTS)
    val = pkg.generate_fewshot(val, min(SHOTS, 4))
    train, val, test = pkg.subsample_classes(train, val, test,
                                             subsample=cfg.DATASET.SUBSAMPLE_CLASSES)
    random.Random(97 + cfg.SEED).shuffle(train)
    return pkg.DatasetBase(train_x=train, val=val, test=test)


def protocol_cfg(make_default, pt: str, out: str, subsample: str, seed: int = 1):
    cfg = make_default()
    cfg.SEED = seed
    cfg.TRAINER.NAME = "MuDPT"
    cfg.MODEL.BACKBONE.NAME = "test-tiny"
    cfg.MODEL.BACKBONE.PATH = pt
    cfg.DATASET.NAME = "SyntheticAB"
    cfg.DATASET.NUM_SHOTS = SHOTS
    cfg.DATASET.SUBSAMPLE_CLASSES = subsample
    cfg.INPUT.SIZE = (IMG, IMG)
    cfg.INPUT.TRANSFORMS = ("normalize",)  # deterministic
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = BATCH
    cfg.DATALOADER.TRAIN_X.SAMPLER = "sequential"
    cfg.DATALOADER.TEST.BATCH_SIZE = TEST_BATCH
    cfg.DATALOADER.NUM_WORKERS = 2
    cfg.OPTIM.NAME = "sgd"
    cfg.OPTIM.LR = LR
    cfg.OPTIM.MAX_EPOCH = EPOCHS
    cfg.OPTIM.LR_SCHEDULER = "cosine"
    cfg.OPTIM.WARMUP_EPOCH = 1
    cfg.OPTIM.WARMUP_TYPE = "constant"
    cfg.OPTIM.WARMUP_CONS_LR = WARMUP_CONS_LR
    cfg.OPTIM.MOMENTUM = MOMENTUM
    cfg.OPTIM.WEIGHT_DECAY = WEIGHT_DECAY
    cfg.TEST.FINAL_MODEL = "last_step"
    cfg.TRAIN.PRINT_FREQ = 1000  # a train record at the end of each epoch
    cfg.OUTPUT_DIR = out
    hp = cfg.trainer_params("MuDPT")
    for k, v in HP.items():
        setattr(hp, k, v)
    return cfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _epoch_losses(out: str) -> list:
    with open(f"{out}/metrics.jsonl") as f:
        return [r["loss"] for r in map(json.loads, f) if r["kind"] == "train"]


@pytest.fixture(scope="module")
def protocol(tmp_path_factory):
    """Both packages through base then new: {package: {stage: top-1},
    package + ' losses': per-epoch losses of the base stage}."""
    root = tmp_path_factory.mktemp("ab")
    pt = write_clip_pt(str(root / "clip.pt"), seed=11)
    result = {"jax": {}, "port": {}}
    stages = {}
    for stage in ("base", "new"):
        jcfg = protocol_cfg(jdefault_config, pt, str(root / f"jax_{stage}"), stage)
        tcfg = protocol_cfg(default_config, pt, str(root / f"port_{stage}"), stage)
        jtr = JREGISTRY.get("MuDPT")(jcfg, dataset=protocol_dataset(jdatum, jcfg))
        ttr = TRAINER_REGISTRY.get("MuDPT")(tcfg, dataset=protocol_dataset(tdatum, tcfg),
                                            devices="cpu")
        if stage == "base":
            # the JAX trainer's prompt init crossed into the port (the
            # backbone and class buffers come from the same .pt already)
            ttr.place(frozen=params_from_numpy(_np(jtr.frozen), "cpu"),
                      aux_class_tree=params_from_numpy(_np(jtr.aux), "cpu"), aux_repl=None,
                      trainable=params_from_numpy(_np(jtr.trainable), "cpu"))
            ttr._build_train_state()
            jtr.train()
            ttr.train()
            result["jax losses"] = _epoch_losses(jcfg.OUTPUT_DIR)
            result["port losses"] = _epoch_losses(tcfg.OUTPUT_DIR)
        else:
            jtr.load_model(stages["jax"], epoch=EPOCHS)
            ttr.load_model(stages["port"], epoch=EPOCHS)
        result["jax"][stage] = jtr.test()["accuracy"]
        result["port"][stage] = ttr.test()["accuracy"]
        stages = {"jax": jcfg.OUTPUT_DIR, "port": tcfg.OUTPUT_DIR}
    print(f"per-epoch losses: JAX {result['jax losses']}, port {result['port losses']}; "
          f"top-1 JAX {result['jax']}, port {result['port']}")
    return result


def test_epoch_losses_match(protocol):
    jl, tl = protocol["jax losses"], protocol["port losses"]
    assert len(jl) == len(tl) == EPOCHS
    for j, t in zip(jl, tl):
        assert abs(t - j) <= REL * abs(j), (t, j)


@pytest.mark.parametrize("stage", ("base", "new"))
def test_stage_top1_within_band(protocol, stage):
    j, t = protocol["jax"][stage], protocol["port"][stage]
    assert abs(t - j) <= TOP1_BAND, (stage, t, j)


def test_base_learns_above_chance(protocol):
    for pkg in ("jax", "port"):
        assert protocol[pkg]["base"] > CHANCE + 10, protocol
