"""The whole training slice at tiny size: the port's ``mudpt_forward``, mean
NLL and ``.backward()`` against ``jax.value_and_grad`` of the JAX package's
(``set_block_impl("pallas")``: ``layer_fullblock``'s saving forward and
backward kernels in interpret mode) on the same frozen, trainable and aux
trees -- the loss and the gradient of each of the ten trainable leaves, in
fp32 and bf16 -- then an 8-step SGD trajectory against optax, and the
synthetic train step's device rule."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mudpt_tpu.models import layers as JL
from mudpt_tpu.models.clip import cast_matmul_weights as jcast
from mudpt_tpu.models.clip import init_clip_params as jinit
from mudpt_tpu.trainers import mudpt as JM
from mudpt_tpu.trainers.base import TINY_TEST as JTINY
from mudpt_tpu.trainers.prompt_utils import embed_classnames as jembed
from mudpt_tpu.trainers.prompt_utils import init_linear as jinit_linear
from mudpt_tpu.trainers.prompt_utils import random_ctx as jrandom_ctx
from mudpt_tpu.utils.rng import new_rng

from mudpt_torch.models.clip import TINY_TEST
from mudpt_torch.models.convert import params_from_numpy
from mudpt_torch.trainers import mudpt as TM
from mudpt_torch.utils import synth_step as TS

# 32 classes: both packages pack G=4 text rows; depth 3 splices layer 1 of
# each 2-layer tower; the vision rows are 4 patches + CLS + 2 prompts = 7
N_CLS, N_CTX, DEPTH, B, STEPS = 32, 2, 3, 8, 8
CLASSNAMES = [f"object number {i}" for i in range(N_CLS)]
LEAVES = ("ctx", "deep_prompts", "embed_projection/w", "embed_projection/b",
          "deep_projections/w", "deep_projections/b", "visual_ctx",
          "visual_ctx_deep_prompts", "visual_ctx_deep_projections/w",
          "visual_ctx_deep_projections/b")
# bf16 backbone: the port's plain chain rounds at the Pallas kernels' points,
# XLA on the CPU rounds its own ops (patchify, tower LayerNorms, logits) at
# its own and may keep fused intermediates in fp32, so the two drift like two
# bf16 runs of one model.  Readings, worst leaf, against the largest JAX bf16
# gradient (max abs err) and in relative norm: 0.048 and 0.045; loss 2.4e-3
# relative.  For scale, each package's bf16 gradients lie 0.03-0.054 from the
# fp32 ones.  Bounds 2.6x above the readings (the loss 4x):
BF16_GRAD_MAX, BF16_GRAD_NORM, BF16_LOSS = 2.0 ** -3, 2.0 ** -3, 1e-2


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on few cores: keep torch's intra-op
    pool small so these files do not crowd out timing-sensitive tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pallas_blocks():
    """The JAX side runs ``layer_fullblock``'s custom VJP (interpret mode)."""
    JL.set_block_impl("pallas")
    yield
    JL.set_block_impl("auto")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    frozen = jinit(new_rng(0), JTINY)
    ks = jax.random.split(new_rng(1), 8)
    dim, vdim = JTINY.transformer_width, JTINY.vision_width
    trainable = {
        "ctx": jrandom_ctx(ks[0], (N_CTX, dim)),
        "deep_prompts": jrandom_ctx(ks[1], (DEPTH - 1, N_CTX, dim)),
        "embed_projection": jinit_linear(ks[2], dim, vdim),
        "deep_projections": jinit_linear(ks[3], dim, vdim),
        "visual_ctx": jrandom_ctx(ks[4], (N_CTX, vdim)),
        "visual_ctx_deep_prompts": jrandom_ctx(ks[5], (DEPTH - 1, N_CTX, vdim)),
        "visual_ctx_deep_projections": jinit_linear(ks[6], vdim, dim),
    }
    aux = jembed(frozen["text"], CLASSNAMES, N_CTX, "a photo of a").as_device_tree()
    rng = np.random.RandomState(0)
    batches = [(rng.randn(B, 32, 32, 3).astype(np.float32),
                rng.randint(0, N_CLS, B).astype(np.int32)) for _ in range(STEPS)]
    return frozen, trainable, aux, batches


def _jax_loss_fn(frozen, aux, dtype):
    def loss_fn(tr, images, labels):
        logits = JM.mudpt_forward(tr, frozen, aux, images, clip_cfg=JTINY,
                                  compute_dtype=dtype).astype(jnp.float32)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(logp, labels[:, None], axis=1).mean()
    return loss_fn


def _leaf(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return tree


def _port_trees(frozen, trainable, aux):
    frozen, trainable, aux = (params_from_numpy(_np(t), "cpu") for t in (frozen, trainable, aux))
    for t in TS.leaves(trainable):
        t.requires_grad_(True)
    return frozen, trainable, aux


def _port_loss(frozen, trainable, aux, images, labels, dtype):
    logits = TM.mudpt_forward(trainable, frozen, aux, torch.from_numpy(images).to(dtype),
                              clip_cfg=TINY_TEST, compute_dtype=dtype)
    return TS.nll_loss(logits, torch.from_numpy(labels))


def _grads_both(trees, dtype):
    frozen, trainable, aux, batches = trees
    images, labels = batches[0]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jfrozen = frozen if dtype == torch.float32 else jcast(frozen, jnp.bfloat16)
    jloss, jgrads = jax.value_and_grad(_jax_loss_fn(jfrozen, aux, jdt))(
        trainable, jnp.asarray(images, jdt), jnp.asarray(labels))
    tfrozen, ttr, taux = _port_trees(jfrozen, trainable, aux)
    loss = _port_loss(tfrozen, ttr, taux, images, labels, dtype)
    loss.backward()
    return float(jloss), _np(jgrads), loss.item(), ttr


def test_loss_and_grads_fp32_match_jax(trees, pallas_blocks):
    jloss, jgrads, loss, ttr = _grads_both(trees, torch.float32)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=1e-5)
    for name in LEAVES:
        j = _leaf(jgrads, name)
        t = _leaf(ttr, name).grad.numpy()
        assert np.abs(j).max() > 0, name
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-4 * np.abs(j).max(), err_msg=name)


def test_loss_and_grads_bf16_track_jax(trees, pallas_blocks):
    jloss, jgrads, loss, ttr = _grads_both(trees, torch.bfloat16)
    assert abs(loss - jloss) <= BF16_LOSS * abs(jloss), (loss, jloss)
    for name in LEAVES:
        j = _leaf(jgrads, name).astype(np.float64)
        t = _leaf(ttr, name).grad.double().numpy()
        err = np.abs(t - j)
        assert err.max() <= BF16_GRAD_MAX * np.abs(j).max(), (name, err.max(), np.abs(j).max())
        assert np.linalg.norm(err) <= BF16_GRAD_NORM * np.linalg.norm(j), name


def test_sgd_trajectory_matches_optax(trees, pallas_blocks):
    """8 SGD steps at lr 2.5e-3, momentum 0.9 (the synthetic step's
    optimizer) in fp32: losses track and the weight deltas agree within 2e-2
    of the largest delta (``tests/test_trajectory_parity.py:166-188``)."""
    frozen, trainable, aux, batches = trees
    tx = optax.sgd(TS.LR, momentum=TS.MOMENTUM)
    loss_fn = _jax_loss_fn(frozen, aux, jnp.float32)

    @jax.jit
    def step(tr, opt_state, images, labels):
        loss, grads = jax.value_and_grad(loss_fn)(tr, images, labels)
        updates, opt_state = tx.update(grads, opt_state, tr)
        return optax.apply_updates(tr, updates), opt_state, loss

    jtr, opt_state, jlosses = trainable, tx.init(trainable), []
    for images, labels in batches:
        jtr, opt_state, loss = step(jtr, opt_state, jnp.asarray(images), jnp.asarray(labels))
        jlosses.append(float(loss))

    tfrozen, ttr, taux = _port_trees(frozen, trainable, aux)
    opt = torch.optim.SGD(TS.leaves(ttr), lr=TS.LR, momentum=TS.MOMENTUM)
    losses = []
    for images, labels in batches:
        opt.zero_grad(set_to_none=True)
        loss = _port_loss(tfrozen, ttr, taux, images, labels, torch.float32)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    np.testing.assert_allclose(losses, jlosses, rtol=2e-3, atol=2e-4)
    for name in LEAVES:
        w0 = np.asarray(_leaf(trainable, name), np.float64)
        dj = np.asarray(_leaf(jtr, name), np.float64) - w0
        dt = _leaf(ttr, name).detach().double().numpy() - w0
        assert np.abs(dj).max() > 1e-8, name
        np.testing.assert_allclose(dt, dj, rtol=0, atol=2e-2 * np.abs(dj).max(), err_msg=name)


def test_synth_step_trains_on_cpu_when_asked():
    st = TS.build_synth_mudpt_step("test-tiny", 4, 10, N_CTX, DEPTH, device="cpu")
    before = [t.detach().clone() for t in TS.leaves(st.trainable)]
    losses = [float(st.train_step(st.images, st.labels)) for _ in range(3)]
    assert all(np.isfinite(losses)), losses
    assert len(before) == 10
    assert all(t.dtype == torch.float32 and t.requires_grad for t in TS.leaves(st.trainable))
    moved = [not torch.equal(b, t.detach()) for b, t in zip(before, TS.leaves(st.trainable))]
    assert all(moved), moved


def test_synth_step_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.build_synth_mudpt_step("test-tiny", 4, 10, N_CTX, DEPTH)


@pytest.mark.parametrize("n_rows,padded", [(100, 16), (512, 80), (2560, 16), (2559, 16)])
def test_text_saves_off_rule_matches_jax(n_rows, padded):
    """Above 512 x 80 row-tokens the text tower's backward recomputes; on
    CUDA the port raises there (it needs the half-block kernels)."""
    from mudpt_tpu.models import text as JT

    from mudpt_torch.models import text as TT

    assert TT._text_saves_off(n_rows, padded) == JT._text_saves_off(n_rows, padded)
