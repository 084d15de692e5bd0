"""The port's ``xla`` serving artifact against the JAX package's
(``mudpt_tpu/serving.py``) on the same MuDPT weights and images, each
loaded by its own package's loader: fp32 within 1e-5, bf16 within the
drift bound of ``test_torch_serving.py`` (logits within 3% of their largest
magnitude, the same top-1 wherever the JAX margin exceeds twice the drift,
75% agreement)."""

import jax
import numpy as np
import pytest
import torch

import mudpt_tpu.serving as jserving
from mudpt_tpu.config import load_config as jload_config
from mudpt_tpu.trainers import build_trainer as jbuild_trainer

from mudpt_torch import serving
from mudpt_torch.config import load_config
from mudpt_torch.models import layers as TL
from mudpt_torch.models.convert import params_from_numpy
from mudpt_torch.trainers import build_trainer

FILES = ("configs/datasets/synthetic.yaml", "configs/trainers/test/tiny.yaml")
FP32 = dict(rtol=1e-5, atol=1e-5)
DRIFT = 0.03  # bf16: of the largest magnitude (tests/test_torch_serving.py)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _opts(out, prec):
    return ["TRAINER.NAME", "MuDPT", "OUTPUT_DIR", str(out), "TRAINER.MUDPT.PREC", prec]


def _images(n, res=32, seed=0):
    return np.random.RandomState(seed).randn(n, res, res, 3).astype(np.float32)


def _jax_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("prec", ["fp32", "fp16"])
def test_xla_artifact_matches_jax_artifact(tmp_path, prec):
    """The two packages' ``xla`` artifacts of one MuDPT on the same weights
    and images.  JAX's 'auto' is XLA on a CPU host, so the port encodes
    the class text under 'xla' as well."""
    jtr = jbuild_trainer(jload_config(*FILES, opts=_opts(tmp_path / "j", prec)))
    ttr = build_trainer(load_config(*FILES, opts=_opts(tmp_path / "t", prec)), devices="cpu")
    ttr.trainable = params_from_numpy(_jax_np(jtr.trainable), "cpu")
    ttr.frozen = params_from_numpy(_jax_np(jtr.frozen), "cpu")
    ttr.aux = params_from_numpy(_jax_np(jtr.aux), "cpu")
    jart, tart = str(tmp_path / "jax_art"), str(tmp_path / "torch_art")
    jserving.export_trainer(jart, jtr, platforms=("cpu",))
    TL.set_block_impl("xla")
    try:
        serving.export_trainer(tart, ttr)
    finally:
        TL.set_block_impl("auto")
    imgs = _images(6, seed=11)
    want = np.asarray(jserving.load(jart).predict(imgs), np.float64)
    got = serving.load(tart, device="cpu").predict(imgs).astype(np.float64)
    if prec == "fp32":
        np.testing.assert_allclose(got, want, **FP32)
        return
    drift = np.abs(got - want).max()
    assert drift <= DRIFT * np.abs(want).max(), drift
    top = np.sort(want, axis=-1)
    decisive = top[:, -1] - top[:, -2] > 2 * drift
    assert (want.argmax(-1)[decisive] == got.argmax(-1)[decisive]).all()
    assert (want.argmax(-1) == got.argmax(-1)).mean() >= 0.75
