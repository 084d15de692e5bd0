"""The int8 tiers on fp32 activations, at tiny size: the port's MuDPT
trainer through ``build_trainer`` under ``PREC fp32`` and each ``TRAIN.QUANT``
tier against the JAX package's trainer under ``PERF.BLOCK pallas`` -- its q8
layer kernels (``quant_block.py`` :89, :178, :377, :563) on fp32
activations, in interpret mode -- from the same trees crossed by
``params_from_numpy`` (``test_torch_zoo_quant.py``'s ``build_pair``):

* ``int8_ste`` and ``int8_ste_static``: the first step's loss and every
  trainable leaf's gradient;
* ``int8`` and ``int8_static``: the logits of a test batch, the static
  scales calibrated at build equal to the JAX trainer's within fp32 sum
  order (2^-20, ``test_torch_zoo_quant_static.py``'s bound);

and the port's zero-shot ``pallas_int8`` artifact at its default compute
dtype (fp32) against the JAX package's zero-shot scoring under the same
tier.  The JAX artifact of that tier is TPU-only (Mosaic calls), so the
JAX side is the function its export traces (``serving.py:423``), run under
the Pallas int8 blocks here.

Bounds: ``test_torch_zoo_quant.py``'s, which allow a code flip (the
packages sum the LayerNorm statistics, attention and the dequantized
products in other orders, so a value next to a boundary of the int8 grid
takes the neighbouring code in one of them): logits row by row within
2^-4 of the largest, all but a quarter of the rows within 2^-12; the loss
within 2^-7 relative; each gradient within 2^-6 of its largest value, in
max and in norm; the zero-shot text features, unquantized fp32, within
1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudpt_tpu.models import layers as JL
from mudpt_tpu.models.clip import init_clip_params as jinit
from mudpt_tpu.trainers import zsclip as JZS
from mudpt_tpu.trainers.base import TINY_TEST as JTINY
from mudpt_tpu.utils.rng import new_rng

from mudpt_torch import serving
from mudpt_torch.models import layers as TL
from mudpt_torch.models.clip import TINY_TEST
from mudpt_torch.models.convert import params_from_numpy
from mudpt_torch.trainers import zsclip as TZS
from tests.test_torch_zoo_quant import (build_pair, check_first_step, check_logits,  # noqa: F401
                                        hold_rows, modes)

MUDPT = ("MuDPT", ())  # PREC fp32 prepended by the zoo tests' options
SCALE_RTOL = 2.0 ** -20
TXT = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quant", ["int8", "int8_static", "int8_ste", "int8_ste_static"])
def test_mudpt_fp32_under_each_tier_matches_jax_pallas(tmp_path, quant):
    jtr, ttr = build_pair(MUDPT, tmp_path, quant)
    assert ttr.compute_dtype == torch.float32 and jtr.compute_dtype == jnp.float32
    assert JL.resolve_block_impl() == TL.resolve_block_impl() == "pallas"
    if quant.endswith("static"):
        assert ttr._static_calibrated
        ttr._calibrate_static_quant()  # on the crossed trees, as the build does
        for tower in ("visual", "text"):
            got = ttr.frozen[tower]["blocks"]["q8_scales"]
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.double().numpy(), np.asarray(
                jtr.frozen[tower]["blocks"]["q8_scales"], np.float64), rtol=SCALE_RTOL)
    if quant in ("int8", "int8_static"):
        check_logits(jtr, ttr)
    else:
        check_first_step(jtr, ttr)


def test_zero_shot_pallas_int8_artifact_fp32_matches_jax(tmp_path):
    """The port's artifact, exported and served on the CPU (its custom ops
    run the q8 chains' plain versions in fp32), against the JAX zero-shot
    scoring under the Pallas int8 blocks on the same weights and images."""
    jparams = jinit(new_rng(0), JTINY)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    classnames, templates = ["tabby_cat", "dog", "bird", "fish"], ["a photo of a {}.",
                                                                  "a drawing of a {}."]
    imgs = np.random.RandomState(3).randn(8, 32, 32, 3).astype(np.float32)
    art = str(tmp_path / "zs_q8")
    serving.export_zero_shot(art, TINY_TEST, params, classnames, templates, batch=8,
                             block_impl="pallas_int8")
    clf = serving.load(art, device="cpu")
    assert clf.meta["block_impl"] == "pallas_int8"
    got = clf.predict(imgs)
    assert got.dtype == np.float32 and got.shape == (8, len(classnames))

    jtxt = JZS._encode_templates(jparams, JTINY, classnames, templates, jnp.float32)
    txt = TZS._encode_templates(params, TINY_TEST, classnames, templates, torch.float32,
                                torch.device("cpu"))
    np.testing.assert_allclose(txt.numpy(), np.asarray(jtxt), **TXT)
    prev = JL._BLOCK_IMPL, JL.quant_mode()
    JL.set_block_impl("pallas")
    JL.set_quant_mode("int8")
    try:
        want = jax.jit(lambda p, t, x: JZS._zs_inference(
            None, p, {"text_features": t}, x, clip_cfg=JTINY, compute_dtype=jnp.float32))(
                jparams, jtxt, jnp.asarray(imgs))
    finally:
        JL._BLOCK_IMPL = prev[0]
        JL.set_quant_mode(prev[1])
    hold_rows(got, np.asarray(want))
