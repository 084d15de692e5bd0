"""The quantization-aware prompt-tuning step at tiny size against the JAX
package on the same trees (Pallas in interpret mode under
``set_quant_mode``, restored after): one step's loss and the gradients of
the ten trainable leaves under 'int8_ste' and, on JAX's calibrated scales,
'int8_ste_static'.  The static tier's fp32 arithmetic is held layer by
layer in ``tests/test_torch_quant_block.py``; here the step in bf16."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudpt_tpu.ops import quant_block as JQ
from mudpt_tpu.trainers import mudpt as JM

from mudpt_torch.models import layers as TL
from mudpt_torch.models.clip import TINY_TEST
from mudpt_torch.models.convert import params_from_numpy
from mudpt_torch.trainers import mudpt as TM
from mudpt_torch.utils import synth_step as TS
from tests.test_torch_quant_serving import (DTYPES, _frozen_of, _jax_kw, _make_trees, _np,
                                            jax_quant)

LEAVES = ("ctx", "deep_prompts", "embed_projection/w", "embed_projection/b",
          "deep_projections/w", "deep_projections/b", "visual_ctx",
          "visual_ctx_deep_prompts", "visual_ctx_deep_projections/w",
          "visual_ctx_deep_projections/b")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on few cores: keep torch's intra-op
    pool small so these files do not crowd out timing-sensitive tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def trees():
    return _make_trees()


def _leaf(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return tree


def _qat_case(trees, dt_name, mode):
    """Loss and gradients of one quantization-aware step in each package;
    under 'int8_ste_static' both towers carry JAX's scales, calibrated as
    ``bench.py:398-425`` does (the text tower with its output, then the
    vision tower with that output)."""
    frozen, trainable, aux, images, labels = trees
    tdt, jdt = DTYPES[dt_name]
    frozen = _frozen_of(frozen, dt_name)
    kw = _jax_kw(jdt)
    jimages, jlabels = jnp.asarray(images, jdt), jnp.asarray(labels)
    if mode == "int8_ste_static":
        with jax_quant(mode):
            ts, txt = JQ.calibrate(functools.partial(JM.mudpt_text_features, **kw),
                                   trainable, frozen, aux, with_output=True)
            vs = JQ.calibrate(functools.partial(JM.mudpt_image_logits, **kw),
                              trainable, frozen, aux, jimages, txt)
        frozen = dict(frozen)
        frozen["text"] = dict(frozen["text"], blocks=JQ.attach_scales(frozen["text"]["blocks"], ts))
        frozen["visual"] = dict(frozen["visual"],
                                blocks=JQ.attach_scales(frozen["visual"]["blocks"], vs))

    def jloss_fn(tr):
        logits = JM.mudpt_forward(tr, frozen, aux, jimages, **kw).astype(jnp.float32)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(logp, jlabels[:, None], axis=1).mean()

    with jax_quant(mode):
        jloss, jgrads = jax.value_and_grad(jloss_fn)(trainable)
    tfrozen, ttr, taux = (params_from_numpy(_np(t), "cpu") for t in (frozen, trainable, aux))
    for t in TS.leaves(ttr):
        t.requires_grad_(True)
    with TL.quantized(mode):
        logits = TM.mudpt_forward(ttr, tfrozen, taux, torch.from_numpy(images).to(tdt),
                                  clip_cfg=TINY_TEST, compute_dtype=tdt)
        loss = TS.nll_loss(logits, torch.from_numpy(labels))
    loss.backward()
    return float(jloss), _np(jgrads), loss.item(), ttr


# One step's loss and gradients, port vs JAX, worst leaf: max abs err of the
# largest JAX gradient, and relative norm error.  Readings in fp32 3.1e-6
# and 3.7e-6 ('int8_ste'), 2.4e-6 and 2.5e-6 ('int8_ste_static'), the loss
# equal.  In bf16 0.149 and 0.123, 0.132 and 0.133, the loss 1.4e-3 and
# 2.9e-3 relative: quantization amplifies the drift of the bf16 step (0.048
# and 0.045 between the packages, tests/test_torch_train_step.py).  For
# scale, each package's bf16 quantization-aware gradients lie 0.10-0.20 (in
# norm, per leaf) from its own fp32 ones, farther than from each other's.
# Bounds: fp32 2^-12; bf16 2^-2, under twice the readings; the loss 1e-2.
QAT_TOL = {"fp32": (2.0 ** -12, 2.0 ** -12, 1e-5), "bf16": (2.0 ** -2, 2.0 ** -2, 1e-2)}


@pytest.mark.parametrize("mode,dt_name", [("int8_ste", "fp32"), ("int8_ste", "bf16"),
                                          ("int8_ste_static", "bf16")])
def test_qat_step_tracks_jax(trees, mode, dt_name):
    jloss, jgrads, loss, ttr = _qat_case(trees, dt_name, mode)
    max_tol, norm_tol, loss_tol = QAT_TOL[dt_name]
    assert abs(loss - jloss) <= loss_tol * abs(jloss), (loss, jloss)
    for name in LEAVES:
        j = _leaf(jgrads, name).astype(np.float64)
        t = _leaf(ttr, name).grad.double().numpy()
        err = np.abs(t - j)
        assert np.abs(j).max() > 0, name
        assert err.max() <= max_tol * np.abs(j).max(), (name, err.max(), np.abs(j).max())
        assert np.linalg.norm(err) <= norm_tol * np.linalg.norm(j), name
