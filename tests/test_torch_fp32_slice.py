"""The fp32 slice as a whole at tiny size: the port's MuDPT trainer through
``build_trainer`` under ``PREC fp32`` (``configs/trainers/test/tiny.yaml``)
against the JAX package's trainer under ``PERF.BLOCK pallas`` -- its
``layer_fullblock`` saving forward and backward kernels on fp32 activations,
in interpret mode -- from the same frozen, trainable and aux trees: the
first step's loss and every trainable leaf's gradient, and the evaluate's
logits (the class text encoded once, then a batch of images), within 1e-4
as ``test_torch_engine.py`` holds them.  ``test_torch_engine.py`` runs the
JAX trainer on its XLA blocks (its 'auto' on a CPU); this file holds the
port's fp32 kernel route against the Pallas route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudpt_tpu.config import load_config as jload_config
from mudpt_tpu.models import layers as JL
from mudpt_tpu.trainers import build_trainer as jbuild_trainer

from mudpt_torch.config import load_config
from mudpt_torch.models import layers as TL
from mudpt_torch.models.clip import leaves
from mudpt_torch.models.convert import params_from_numpy
from mudpt_torch.trainers.base import build_trainer

FILES = ("configs/datasets/synthetic.yaml", "configs/trainers/test/tiny.yaml")
# fp32 on both sides: the packages differ only in the order of fp32 sums
REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    """The JAX trainer and the port's under PERF.BLOCK pallas, the port's
    trees replaced by the JAX trainer's, and the first training batch."""
    tmp = tmp_path_factory.mktemp("fp32_slice")
    opts = ["TRAINER.NAME", "MuDPT", "PERF.BLOCK", "pallas", "TRAINER.MUDPT.PREC", "fp32"]
    try:
        jtr = jbuild_trainer(jload_config(*FILES, opts=[*opts, "OUTPUT_DIR", str(tmp / "jax")]))
        ttr = build_trainer(load_config(*FILES, opts=[*opts, "OUTPUT_DIR", str(tmp / "torch")]),
                            devices="cpu")
        assert JL.resolve_block_impl() == TL.resolve_block_impl() == "pallas"
        assert ttr.compute_dtype == torch.float32
        np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        ttr.place(frozen=params_from_numpy(np_tree(jtr.frozen), "cpu"),
                  aux_class_tree=params_from_numpy(np_tree(jtr.aux), "cpu"), aux_repl=None,
                  trainable=params_from_numpy(np_tree(jtr.trainable), "cpu"))
        batch = next(iter(ttr.dm.train_loader))
        yield jtr, ttr, batch
    finally:
        JL.set_block_impl("auto")
        TL.set_block_impl("auto")


def _jax_loss(jtr, batch):
    """The JAX trainer's loss (``base.py:422-438``) as a function of its
    trainable tree."""
    n_cls = jtr.num_classes
    images = jnp.asarray(batch["image"], jnp.float32)
    labels = jnp.asarray(batch["label"])
    valid = jnp.asarray(batch["valid"], jnp.float32)

    def loss_fn(trainable):
        logits = jtr.forward(trainable, jtr.frozen, jtr.aux, images)[:, :n_cls]
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(logp, labels[:, None], axis=1)[:, 0]
        return (nll * valid).sum() / jnp.maximum(valid.sum(), 1.0)
    return loss_fn


def test_first_step_loss_and_grads_match_pallas(crossed):
    jtr, ttr, batch = crossed
    jloss, jgrads = jax.jit(jax.value_and_grad(_jax_loss(jtr, batch)))(jtr.trainable)
    loss, _ = ttr.loss_fn(ttr._device_batch(batch))
    params = leaves(ttr.trainable)
    grads = torch.autograd.grad(loss, params)
    assert abs(loss.item() - float(jloss)) <= REL * abs(float(jloss))
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads) == 10
    for a, b in zip(jleaves, grads):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= REL * np.abs(a).max()


def test_evaluate_logits_match_pallas(crossed):
    jtr, ttr, batch = crossed
    jtxt = jtr._text_features(jtr.trainable, jtr.frozen, jtr.aux)
    jlogits = np.asarray(jax.jit(jtr.forward_image)(jtr.trainable, jtr.frozen, jtr.aux,
                                                    jnp.asarray(batch["image"], jnp.float32),
                                                    jtxt))
    with torch.no_grad():
        ttxt = ttr._text_features(ttr.trainable, ttr.frozen, ttr.aux)
        images = ttr._device_batch(batch)["image"]
        logits = ttr.forward_image(ttr.trainable, ttr.frozen, ttr.aux, images, ttxt).numpy()
    assert logits.dtype == np.float32 and logits.shape == jlogits.shape
    assert np.abs(logits - jlogits).max() <= REL * np.abs(jlogits).max()
    np.testing.assert_array_equal(logits.argmax(-1), jlogits.argmax(-1))
