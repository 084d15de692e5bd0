"""The RN presets through the port's trainers (``mudpt_torch/trainers``)
against the JAX package's, on ``test-tiny-rn`` (the synthetic dataset,
PREC fp32, 32 px), at the CPU:

* the CoOp and ZeroshotCLIP logits through ``build_trainer``, the JAX
  trainer's frozen, trainable and aux trees crossed over (fp32, within 1e-4
  of the largest value: the packages differ in the order of fp32 sums);
* the five ViT-only trainers refusing an RN backbone with the JAX message;
* the static int8 tiers raising where the JAX package raises: they
  calibrate residual blocks, and an RN vision tower has none;
* a CoOp ``test-tiny-rn`` trainer exported under ``xla`` and served from
  the artifact.
"""

import jax
import numpy as np
import pytest
import torch

from mudpt_tpu.config import default_config as jdefault_config
from mudpt_tpu.models import layers as JL
from mudpt_tpu.parallel.mesh import shard_batch
from mudpt_tpu.trainers import build_trainer as jbuild_trainer
from mudpt_tpu.trainers import zsclip as JZS

from mudpt_torch import serving
from mudpt_torch.config import default_config
from mudpt_torch.models import layers as TL
from mudpt_torch.models.convert import params_from_numpy
from mudpt_torch.trainers import build_trainer
from mudpt_torch.trainers import zsclip as TZS

REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(trainer, tmp_path, quant="none"):
    """The JAX package's ``tests/test_trainers.tiny_cfg`` on test-tiny-rn,
    and the same on the port's config."""
    out = []
    for make, side in ((jdefault_config, "jax"), (default_config, "torch")):
        cfg = make()
        cfg.TRAINER.NAME = trainer
        cfg.MODEL.BACKBONE.NAME = "test-tiny-rn"
        cfg.MODEL.BACKBONE.PATH = "random"
        cfg.DATASET.NAME = "Synthetic"
        cfg.INPUT.SIZE = (32, 32)
        cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 8
        cfg.DATALOADER.TEST.BATCH_SIZE = 8
        cfg.DATALOADER.NUM_WORKERS = 2
        cfg.OPTIM.MAX_EPOCH = 1
        cfg.OUTPUT_DIR = str(tmp_path / side)
        cfg.TRAIN.QUANT = quant
        if not trainer.startswith("Zeroshot"):
            hp = cfg.trainer_params(trainer)
            hp.N_CTX = 2
            hp.PREC = "fp32"
        out.append(cfg)
    return out


@pytest.fixture
def modes():
    """The JAX package on its Pallas blocks (interpret mode here: its quant
    tiers exist only there); both packages' modes restored after."""
    prev = JL._BLOCK_IMPL, JL.quant_mode(), TL.quant_mode()
    JL.set_block_impl("pallas")
    try:
        yield
    finally:
        JL._BLOCK_IMPL = prev[0]
        JL.set_quant_mode(prev[1])
        TL.set_quant_mode(prev[2])


@pytest.mark.parametrize("trainer", ["CoOp", "ZeroshotCLIP"])
def test_rn_trainer_logits_match_jax(tmp_path, monkeypatch, trainer):
    for cls in (JZS.ZeroshotCLIP, TZS.ZeroshotCLIP):
        monkeypatch.setattr(cls, "prec_default", "fp32")
    jcfg, tcfg = _cfgs(trainer, tmp_path)
    jtr, ttr = jbuild_trainer(jcfg), build_trainer(tcfg, devices="cpu")
    assert ttr.clip_cfg.vision_arch == "resnet"
    trainable = None if jtr.trainable is None else params_from_numpy(_np(jtr.trainable), "cpu")
    ttr.place(frozen=params_from_numpy(_np(jtr.frozen), "cpu"),
              aux_class_tree=params_from_numpy(_np(jtr.aux), "cpu"), aux_repl=None,
              trainable=trainable)
    images = next(iter(ttr.dm.test_loader))["image"]
    want = np.asarray(jax.jit(jtr.forward)(jtr.trainable, jtr.frozen, jtr.aux,
                                  shard_batch(jtr.mesh, {"image": images})["image"]))
    with torch.no_grad():
        got = ttr.forward(ttr.trainable, ttr.frozen, ttr.aux, torch.from_numpy(images)).numpy()
    n = ttr.num_classes
    assert np.abs(got[:, :n] - want[:, :n]).max() <= REL * np.abs(want[:, :n]).max()


@pytest.mark.parametrize("trainer", ["MuDPT", "VPT", "MPT", "UMuDPT", "UUMuDPT"])
def test_vit_only_trainers_refuse_rn_as_jax(tmp_path, trainer):
    jcfg, tcfg = _cfgs(trainer, tmp_path)
    with pytest.raises(ValueError) as jerr:
        jbuild_trainer(jcfg)
    with pytest.raises(ValueError) as terr:
        build_trainer(tcfg, devices="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "needs a ViT backbone; got vision_arch='resnet'" in str(terr.value)


@pytest.mark.parametrize("quant", ["int8_static", "int8_ste_static"])
@pytest.mark.parametrize("trainer", ["CoOp", "ZeroshotCLIP"])
def test_rn_static_tiers_raise_as_jax(tmp_path, modes, trainer, quant):
    """The static tiers calibrate the vision tower's residual blocks; an RN
    tower has none, so calibration raises in both packages (the dynamic
    tiers build and quantize the text tower alone)."""
    jcfg, tcfg = _cfgs(trainer, tmp_path, quant)
    with pytest.raises(ValueError, match="calibration forward ran no residual blocks"):
        jbuild_trainer(jcfg)
    with pytest.raises(ValueError, match="calibration forward ran no residual blocks"):
        build_trainer(tcfg, devices="cpu")


def test_rn_coop_exports_and_serves(tmp_path):
    _, tcfg = _cfgs("CoOp", tmp_path)
    tr = build_trainer(tcfg, devices="cpu")
    art = str(tmp_path / "artifact")
    serving.export_trainer(art, tr, platforms=("cpu",))
    clf = serving.load(art, device="cpu")
    images = np.random.RandomState(6).randn(3, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        want = tr.forward(tr.trainable, tr.frozen, tr.aux, torch.from_numpy(images))
    want = want[:, :tr.num_classes].float().numpy()
    np.testing.assert_allclose(clf.predict(images), want, rtol=1e-5, atol=1e-5)
    assert clf.meta["image_shape"] == [32, 32, 3]
