"""Static int8 calibration at build (``TRAIN.QUANT int8_static`` and
``int8_ste_static``) through ``build_trainer(..., devices="cpu")`` and the
CLI, against the JAX package's trainer on ``tests/test_trainers.tiny_cfg``
(test-tiny, the synthetic dataset, PREC fp32), mirroring
``tests/test_quant_block.py:592`` (calibrates and serves), ``:753``
(``int8_ste_static`` trains and serves) and ``:792`` (calibration keeps the
data order):

* MuDPT (fp32) and ZeroshotCLIP (bf16) calibrate on the first training
  batch; on the JAX trainer's trees crossed over, the scales and the served
  logits within ``test_torch_quant_serving``'s bounds of the JAX package's:
  scales 2^-20 relative in fp32 (the order of fp32 sums) and 2^-6 in bf16
  (a bf16 ulp: the packages round a site's values at different points),
  logits 2^-12 of the largest in fp32 (room for an int8 code flipped across
  a rounding boundary) and 2^-4 in bf16;
* one epoch under ``int8_ste_static`` on those trees: the first step's loss
  within 1e-5 relative of the JAX trainer's and the later ones within 2^-5
  (a code flip, see ``LOSS_RTOL``), and the trained prompts served under
  ``int8_static`` bit-equal to the training forward;
* ``load_model`` after build (``--eval_only``) calibrates again, on the
  loaded prompts, and no calibration moves the training loader's epoch;
* CoCoOp raises the JAX package's ``ValueError``.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudpt_tpu.models import layers as JL
from mudpt_tpu.parallel.mesh import shard_batch
from mudpt_tpu.trainers import build_trainer as jbuild_trainer

from mudpt_torch import train as train_cli
from mudpt_torch.config import default_config
from mudpt_torch.models import layers as TL
from mudpt_torch.models.clip import leaves
from mudpt_torch.models.convert import params_from_numpy
from mudpt_torch.ops import quant_block
from mudpt_torch.trainers import build_trainer
from tests.test_trainers import tiny_cfg

# by compute dtype (tiny.yaml's MuDPT runs fp32, the zero-shot trainers
# bf16): the bounds and readings of tests/test_torch_quant_serving.py
SCALE_RTOL = {torch.float32: 2.0 ** -20, torch.bfloat16: 2.0 ** -6}
LOGITS_TOL = {torch.float32: 2.0 ** -12, torch.bfloat16: 2.0 ** -4}
# one epoch under 'int8_ste_static' (4 steps at LR 0.5): the first step's
# loss, both packages on the same trees, within fp32 reach (reading 1.5e-7);
# each later one within 2^-5.  After a step the packages' prompts differ by
# fp32 rounding (1e-6 relative), and a value that the two sides' fp32
# arithmetic puts on either side of a rounding boundary of the static grid
# (1/127 of the tensor's calibrated absmax) takes a neighbouring code: on
# the JAX trainer's prompts after step 1, fed to both packages, such a flip
# moves the text features by 0.02 of 3.35.  Readings, steps 2-4: 1.4e-3,
# 2.3e-3, 9.6e-3 (no flip in the 'none' or 'int8_ste' tiers: 4e-7)
LOSS_RTOL_FIRST, LOSS_RTOL = 1e-5, 2.0 ** -5


@pytest.fixture(autouse=True)
def _modes():
    """Two torch threads; the JAX package on its Pallas blocks (interpret
    mode here); both packages' quant modes restored after each test."""
    prev = torch.get_num_threads(), JL._BLOCK_IMPL, JL.quant_mode(), TL.quant_mode()
    torch.set_num_threads(2)
    JL.set_block_impl("pallas")
    try:
        yield
    finally:
        torch.set_num_threads(prev[0])
        JL._BLOCK_IMPL = prev[1]
        JL.set_quant_mode(prev[2])
        TL.set_quant_mode(prev[3])


def port_cfg(trainer, out, quant="none", epochs=1):
    """``tiny_cfg`` on the port's config."""
    cfg = default_config()
    cfg.TRAINER.NAME = trainer
    cfg.MODEL.BACKBONE.NAME = "test-tiny"
    cfg.MODEL.BACKBONE.PATH = "random"
    cfg.DATASET.NAME = "Synthetic"
    cfg.INPUT.SIZE = (32, 32)
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 8
    cfg.DATALOADER.TEST.BATCH_SIZE = 8
    cfg.DATALOADER.NUM_WORKERS = 2
    cfg.OPTIM.MAX_EPOCH = epochs
    cfg.OPTIM.LR = 0.5
    cfg.OPTIM.WARMUP_EPOCH = 0
    cfg.OUTPUT_DIR = str(out)
    cfg.TRAIN.PRINT_FREQ = 1
    cfg.TRAIN.QUANT = quant
    if trainer not in ("ZeroshotCLIP", "ZeroshotCLIP2"):
        hp = cfg.trainer_params(trainer)
        hp.N_CTX = 2
        hp.PREC = "fp32"
    return cfg


def jax_trainer(trainer, out, quant, epochs=1):
    cfg = tiny_cfg(trainer, out)
    cfg.TRAIN.QUANT = quant
    cfg.OPTIM.MAX_EPOCH = epochs
    cfg.TRAIN.PRINT_FREQ = 1
    return jbuild_trainer(cfg)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _without_scales(frozen):
    return {k: dict(v, blocks={kk: vv for kk, vv in v["blocks"].items() if kk != "q8_scales"})
            if isinstance(v, dict) and "blocks" in v else v for k, v in frozen.items()}


def cross(jtr, ttr, keep_scales: bool):
    """The JAX trainer's trees into the port's trainer, the towers' weights
    quantized once as the port's build does (with JAX's scales, or none)."""
    frozen = _np(jtr.frozen if keep_scales else _without_scales(jtr.frozen))
    frozen = params_from_numpy(frozen, "cpu")
    for tower in ("visual", "text"):
        frozen[tower]["blocks"] = quant_block.quantize_blocks(frozen[tower]["blocks"])
    trainable = None if jtr.trainable is None else params_from_numpy(_np(jtr.trainable), "cpu")
    aux = params_from_numpy(_np(jtr.aux), "cpu")
    ttr.place(frozen=frozen, aux_class_tree=aux, aux_repl=None, trainable=trainable)
    if trainable is not None:
        ttr._build_train_state()


def _scales(frozen, tower):
    return np.asarray(frozen[tower]["blocks"]["q8_scales"], np.float64)


@pytest.fixture(scope="module")
def jax_mudpt(tmp_path_factory):
    """The JAX package's MuDPT built under 'int8_ste_static' (the same
    calibration as 'int8_static'), and a numpy copy of its trees as built."""
    prev = JL._BLOCK_IMPL, JL.quant_mode()
    JL.set_block_impl("pallas")
    try:
        jtr = jax_trainer("MuDPT", tmp_path_factory.mktemp("jax"), "int8_ste_static")
    finally:
        JL._BLOCK_IMPL = prev[0]
        JL.set_quant_mode(prev[1])
    return jtr, SimpleNamespace(frozen=_np(jtr.frozen), trainable=_np(jtr.trainable),
                                aux=_np(jtr.aux))


def _jax_logits(jtr, trees, images):
    JL.set_quant_mode("int8_static")
    tr = (None if trees.trainable is None
          else jax.tree_util.tree_map(jnp.asarray, trees.trainable))
    frozen, aux = (jax.tree_util.tree_map(jnp.asarray, t) for t in (trees.frozen, trees.aux))
    images = shard_batch(jtr.mesh, {"image": images})["image"]
    return np.asarray(jtr.forward(tr, frozen, aux, images), np.float64)


@pytest.mark.parametrize("trainer", ["MuDPT", "ZeroshotCLIP"])
def test_int8_static_calibrates_and_serves(tmp_path, jax_mudpt, trainer):
    if trainer == "MuDPT":
        jtr, trees = jax_mudpt
    else:
        jtr = jax_trainer(trainer, tmp_path / "jax", "int8_static")
        trees = SimpleNamespace(frozen=_np(jtr.frozen), trainable=None, aux=_np(jtr.aux))
    ttr = build_trainer(port_cfg(trainer, tmp_path / "torch", "int8_static"), devices="cpu")
    assert TL.quant_mode() == "int8_static" and ttr._static_calibrated
    assert ttr.dm.train_loader._epoch == 0
    towers = ("visual", "text") if trainer == "MuDPT" else ("visual",)
    for tower in ("visual", "text"):
        blocks = ttr.frozen[tower]["blocks"]
        assert ("q8_scales" in blocks) == (tower in towers)
        if tower in towers:
            assert tuple(blocks["q8_scales"].shape) == (blocks["ln_1"]["scale"].shape[0], 4)

    # on JAX's trees, the port calibrates JAX's scales and serves its logits
    cross(trees, ttr, keep_scales=False)
    ttr._calibrate_static_quant()
    for tower in towers:
        np.testing.assert_allclose(_scales(ttr.frozen, tower), _scales(trees.frozen, tower),
                                   rtol=SCALE_RTOL[ttr.compute_dtype])
    batch = next(iter(ttr.dm.test_loader))
    want = _jax_logits(jtr, trees, batch["image"])
    with torch.no_grad():
        got = ttr.forward(ttr.trainable, ttr.frozen, ttr.aux,
                          torch.from_numpy(batch["image"]).to(ttr.compute_dtype))
    got, n = got.double().numpy(), ttr.num_classes
    drift = np.abs(got[:, :n] - want[:, :n]).max()
    assert drift <= LOGITS_TOL[ttr.compute_dtype] * np.abs(want[:, :n]).max()
    assert ttr.dm.train_loader._epoch == 0


def test_int8_ste_static_epoch_matches_jax_and_serves(tmp_path, jax_mudpt):
    jtr, trees = jax_mudpt
    ttr = build_trainer(port_cfg("MuDPT", tmp_path / "torch", "int8_ste_static"),
                        devices="cpu")
    cross(trees, ttr, keep_scales=True)
    JL.set_quant_mode("int8_ste_static")
    jtr.train()
    ttr.train()
    jloss, tloss = train_losses(jtr.cfg.OUTPUT_DIR), train_losses(tmp_path / "torch")
    assert len(jloss) == len(tloss) == len(ttr.dm.train_loader) == 4
    np.testing.assert_allclose(tloss[0], jloss[0], rtol=LOSS_RTOL_FIRST)
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    # train/serve parity: the static-QAT forward is the static serving forward
    images = torch.from_numpy(next(iter(ttr.dm.test_loader))["image"])
    with torch.no_grad():
        trained = ttr.forward(ttr.trainable, ttr.frozen, ttr.aux, images)
        with TL.quantized("int8_static"):
            served = ttr.forward(ttr.trainable, ttr.frozen, ttr.aux, images)
    assert torch.equal(trained, served)


def train_losses(out):
    import json

    with open(f"{out}/metrics.jsonl") as f:
        return [r["loss"] for r in map(json.loads, f) if r["kind"] == "train"]


def _argv(out, *more):
    return ["--device", "cpu", "--trainer", "MuDPT",
            "--dataset_config", "configs/datasets/synthetic.yaml",
            "--trainer_config", "configs/trainers/test/tiny.yaml",
            "--output_dir", str(out), *more]


def test_cli_trains_then_recalibrates_on_load(tmp_path):
    """``python -m mudpt_torch.train``: one epoch under ``int8_ste_static``,
    then ``--eval_only`` under ``int8_static`` loads the checkpoint and
    calibrates again: its scales are those of a calibration on the loaded
    prompts, not the build's; the loader's epoch stays 0."""
    train_cli.main(train_cli.parse_args(_argv(tmp_path / "train",
                                              "TRAIN.QUANT", "int8_ste_static")))
    ev = train_cli.main(train_cli.parse_args(_argv(
        tmp_path / "eval", "--eval_only", "--model_dir", str(tmp_path / "train"),
        "--load_epoch", "1", "TRAIN.QUANT", "int8_static")))
    assert TL.quant_mode() == "int8_static" and ev.dm.train_loader._epoch == 0
    fresh = build_trainer(port_cfg("MuDPT", tmp_path / "fresh", "int8_static"), devices="cpu")
    loaded = {t: ev.frozen[t]["blocks"]["q8_scales"].clone() for t in ("visual", "text")}
    # the build's scales (random prompts) differ from the loaded prompts'
    assert not torch.equal(loaded["visual"], fresh.frozen["visual"]["blocks"]["q8_scales"])
    with torch.no_grad():
        for dst, src in zip(leaves(fresh.trainable), leaves(ev.trainable)):
            dst.copy_(src)
    fresh._calibrate_static_quant()
    for t in ("visual", "text"):
        assert torch.equal(loaded[t], fresh.frozen[t]["blocks"]["q8_scales"])
    with open(tmp_path / "eval" / "log.txt") as f:
        assert "=> result on test" in f.read()


@pytest.mark.parametrize("pipeline", ["threads", "grain"])
def test_calibration_keeps_data_order(tmp_path, pipeline):
    cfg_q = port_cfg("MuDPT", tmp_path / "q", "int8_ste_static")
    cfg_p = port_cfg("MuDPT", tmp_path / "p")
    for cfg in (cfg_q, cfg_p):
        cfg.DATALOADER.PIPELINE = pipeline
    tr_q = build_trainer(cfg_q, devices="cpu")
    tr_p = build_trainer(cfg_p, devices="cpu")
    assert tr_q.dm.train_loader._epoch == tr_p.dm.train_loader._epoch == 0
    order_q = [b["label"].tolist() for b in tr_q.dm.train_loader]
    order_p = [b["label"].tolist() for b in tr_p.dm.train_loader]
    assert order_q == order_p, "calibration perturbed the epoch order"


@pytest.mark.parametrize("quant", ["int8_static", "int8_ste_static"])
def test_cocoop_refuses_static_tiers(tmp_path, quant):
    cfg = tiny_cfg("CoCoOp", tmp_path / "jax")
    cfg.TRAIN.QUANT = quant
    with pytest.raises(ValueError) as jerr:
        jbuild_trainer(cfg)
    with pytest.raises(ValueError) as terr:
        build_trainer(port_cfg("CoCoOp", tmp_path / "torch", quant), devices="cpu")
    assert str(terr.value) == str(jerr.value) and "int8_ste" in str(terr.value)
