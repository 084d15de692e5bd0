"""The trainer zoo under the int8 tiers, through the port's
``build_trainer(..., devices="cpu")`` against the JAX package's trainer
(Pallas in interpret mode) at tiny size: CoOp (shared, and class-specific
with the class token in the middle), VPT, MPT, UMuDPT, UUMuDPT, ZeroshotCLIP
and ZeroshotCLIP2 on ``configs/trainers/test/tiny.yaml`` and the synthetic
dataset, PREC fp32 (the zero-shot pair's class default set to fp32 on both
sides).  The JAX trainer's frozen, trainable and aux trees cross into the
port's trainer, its towers quantized as the port's build does.

* ``int8`` (here): the logits of a test batch;
* ``int8_ste`` (``test_torch_zoo_quant_ste.py``): the first training
  batch's loss and the gradient of every trainable leaf (the zero-shot
  pair, which train nothing: the logits);
* ``int8_static`` and ``int8_ste_static`` (``test_torch_zoo_quant_static.py``):
  the same after the port's calibration on the JAX trainer's trees, its
  scales held to the JAX trainer's.

Bounds, fp32 on both sides.  The packages sum in other orders, so a value
one fp32 ulp from a rounding boundary of the int8 grid can take the
neighbouring code in one package: at these widths (D = 64, one head) one
such flip moves its image's logits row by up to 0.031 of the largest logit
(ZeroshotCLIP under ``int8_static``), and the step's loss by 5.7e-4
relative (UMuDPT under ``int8_ste``).  A flip stays within its image's
row of the logits, so the logits are held row by row: every row within
2^-4 of the largest value, and all rows but a quarter of the batch within
2^-12 (the order of fp32 sums; a tower left unquantized moves every row by
1-2%).  A loss mixes the rows: within 2^-7 relative; every trainable leaf's
gradient within 2^-6 of its largest value, in max and in norm (reading 1.3e-3).
The files
split the cases to keep each under a minute on the CPU.  CoCoOp, whose text
depends on the image, is in ``test_torch_cocoop_quant.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudpt_tpu.config import load_config as jload_config
from mudpt_tpu.models import layers as JL
from mudpt_tpu.parallel.mesh import shard_batch
from mudpt_tpu.trainers import build_trainer as jbuild_trainer
from mudpt_tpu.trainers import zsclip as JZS

from mudpt_torch.config import load_config
from mudpt_torch.models import layers as TL
from mudpt_torch.models.clip import leaves
from mudpt_torch.models.convert import params_from_numpy
from mudpt_torch.ops import quant_block
from mudpt_torch.trainers import build_trainer
from mudpt_torch.trainers import zsclip as TZS

FILES = ("configs/datasets/synthetic.yaml", "configs/trainers/test/tiny.yaml")
VPT_OPTS = ("VISUAL_PROMPT_DEPTH", "2", "DEEP_VISUAL_N_CTX", "2")
# case -> (trainer, its hparams)
CASES = {
    "CoOp": ("CoOp", ("N_CTX", "4")),
    "CoOp-csc-middle": ("CoOp", ("N_CTX", "4", "CSC", "True", "CLASS_TOKEN_POSITION", "middle")),
    "VPT": ("VPT", VPT_OPTS),
    "MPT": ("MPT", VPT_OPTS + ("TEXT_PROMPT_DEPTH", "2", "DEEP_TEXT_N_CTX", "2")),
    "UMuDPT": ("UMuDPT", ()),
    "UUMuDPT": ("UUMuDPT", ()),
    "ZeroshotCLIP": ("ZeroshotCLIP", None),
    "ZeroshotCLIP2": ("ZeroshotCLIP2", None),
}
ROW_TOL, ROW_FLIP_TOL = 2.0 ** -12, 2.0 ** -4
GRAD_TOL, LOSS_RTOL = 2.0 ** -6, 2.0 ** -7


@pytest.fixture(autouse=True)
def modes(monkeypatch):
    """Two torch threads; the zero-shot pair in fp32; the JAX package on its
    Pallas blocks; both packages' modes restored after each case."""
    prev = torch.get_num_threads(), JL._BLOCK_IMPL, JL.quant_mode(), TL.quant_mode()
    torch.set_num_threads(2)
    for cls in (JZS.ZeroshotCLIP, TZS.ZeroshotCLIP):
        monkeypatch.setattr(cls, "prec_default", "fp32")
    JL.set_block_impl("pallas")
    try:
        yield
    finally:
        torch.set_num_threads(prev[0])
        JL._BLOCK_IMPL = prev[1]
        JL.set_quant_mode(prev[2])
        TL.set_quant_mode(prev[3])


def _opts(case, out, quant):
    """``case``: a key of CASES, or a (trainer, hparams) pair."""
    trainer, hp = CASES[case] if isinstance(case, str) else case
    opts = ["TRAINER.NAME", trainer, "OUTPUT_DIR", str(out), "TRAIN.QUANT", quant]
    if hp is not None:
        hp = ("PREC", "fp32") + hp
    for k, v in zip((hp or ())[::2], (hp or ())[1::2]):
        opts += [f"TRAINER.{trainer.upper()}.{k}", v]
    return opts


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


def _without_scales(frozen):
    return {k: dict(v, blocks={kk: vv for kk, vv in v["blocks"].items() if kk != "q8_scales"})
            if isinstance(v, dict) and "blocks" in v else v for k, v in frozen.items()}


def build_pair(case, tmp_path, quant):
    """The JAX trainer and the port's, both built under ``quant``; the
    port's trees replaced by the JAX trainer's (its towers' weights
    quantized once, as the port's build does, without the JAX trainer's
    static scales) and its static text cache rebuilt from them."""
    jtr = jbuild_trainer(jload_config(*FILES, opts=_opts(case, tmp_path / "jax", quant)))
    ttr = build_trainer(load_config(*FILES, opts=_opts(case, tmp_path / "torch", quant)),
                        devices="cpu")
    assert TL.quant_mode() == JL.quant_mode() == quant
    frozen = params_from_numpy(_np(_without_scales(jtr.frozen)), "cpu")
    for tower in ("visual", "text"):
        frozen[tower]["blocks"] = quant_block.quantize_blocks(frozen[tower]["blocks"])
    jaux = {k: v for k, v in jtr.aux.items() if k != "static_text_features"}
    trainable = None if jtr.trainable is None else params_from_numpy(_np(jtr.trainable), "cpu")
    ttr.place(frozen=frozen, aux_class_tree=params_from_numpy(_np(jaux), "cpu"),
              aux_repl=None, trainable=trainable)
    if trainable is not None:
        ttr._build_train_state()
    ttr._cache_static_text()
    return jtr, ttr


def _hold(what, got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    assert np.abs(want).max() > 0, f"{what}: the JAX value is zero"
    assert err.max() <= GRAD_TOL * np.abs(want).max(), (what, err.max(), np.abs(want).max())
    assert np.linalg.norm(err) <= GRAD_TOL * np.linalg.norm(want), what


def hold_rows(got, want):
    """Logits (B, n_cls) row by row: every row within ROW_FLIP_TOL of the
    largest value, all but a quarter of the rows within ROW_TOL."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    largest = np.abs(want).max()
    row_err = np.abs(got - want).max(axis=1)
    assert row_err.max() <= ROW_FLIP_TOL * largest, (row_err, largest)
    n_off = int((row_err > ROW_TOL * largest).sum())
    assert n_off <= len(row_err) // 4, (row_err, largest)


def check_logits(jtr, ttr):
    batch = next(iter(ttr.dm.test_loader))
    images = shard_batch(jtr.mesh, {"image": batch["image"]})["image"]
    want = np.asarray(jax.jit(lambda *a: jtr.forward(*a))(jtr.trainable, jtr.frozen, jtr.aux,
                                                          images))
    with torch.no_grad():
        got = ttr.forward(ttr.trainable, ttr.frozen, ttr.aux,
                          torch.from_numpy(batch["image"])).numpy()
    n = ttr.num_classes
    hold_rows(got[:, :n], want[:, :n])


def check_first_step(jtr, ttr):
    """The first training batch's loss and the gradient of every trainable
    leaf, the JAX side by ``jax.value_and_grad`` of its trainer's loss."""
    batch = next(iter(ttr.dm.train_loader))
    n = ttr.num_classes
    jimages = shard_batch(jtr.mesh, {"image": batch["image"]})["image"]
    labels = jnp.asarray(batch["label"])

    def jloss(tr):
        logits = jtr.forward(tr, jtr.frozen, jtr.aux, jimages)[:, :n].astype(jnp.float32)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(logp, labels[:, None], axis=1).mean()

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(jtr.trainable)
    loss, _ = ttr.loss_fn(ttr._device_batch(batch))
    names = list(_flat(ttr.trainable))
    grads = torch.autograd.grad(loss, leaves(ttr.trainable))
    assert abs(loss.item() - float(jl)) <= LOSS_RTOL * abs(float(jl)), (loss.item(), float(jl))
    jflat = _flat(_np(jgrads))
    assert sorted(names) == sorted(jflat)
    for name, g in zip(names, grads):
        _hold(f"gradient of {name}", g.numpy(), jflat[name])


def check_case(tmp_path, case, quant):
    jtr, ttr = build_pair(case, tmp_path, quant)
    if ttr.trainable is None or quant in ("int8", "int8_static"):
        check_logits(jtr, ttr)
    else:
        check_first_step(jtr, ttr)
    return jtr, ttr


def check_dynamic(tmp_path, case, quant):
    _, ttr = check_case(tmp_path, case, quant)
    for tower in ("visual", "text"):
        assert "q8_weights" in ttr.frozen[tower]["blocks"]
        assert "q8_scales" not in ttr.frozen[tower]["blocks"]


@pytest.mark.parametrize("case", list(CASES))
def test_zoo_int8_matches_jax(tmp_path, case):
    check_dynamic(tmp_path, case, "int8")
