"""REMAT and SCAN_UNROLL of the port's towers (``models/transformer.py``):
the MuDPT loss and the gradient of each trainable leaf bit-equal under
'none', 'full' and 'selective', on the kernel route's plain versions and on
the XLA route; 'full' against the JAX package's ``jax.checkpoint`` in fp32
(1e-5); a recomputed layer taking its forward's route after the caller's
contexts closed; what 'full' keeps; and the packed text rows refused, as in
JAX, when the unroll does not cover the tower."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudpt_tpu.models import layers as JL
from mudpt_tpu.models import text as JT
from mudpt_tpu.models import transformer as JTR
from mudpt_tpu.models.clip import init_clip_params as jinit
from mudpt_tpu.trainers import mudpt as JM
from mudpt_tpu.trainers.base import TINY_TEST as JTINY
from mudpt_tpu.trainers.prompt_utils import embed_classnames as jembed
from mudpt_tpu.trainers.prompt_utils import init_linear as jinit_linear
from mudpt_tpu.trainers.prompt_utils import random_ctx as jrandom_ctx
from mudpt_tpu.utils.rng import new_rng

from mudpt_torch.models import layers as TL
from mudpt_torch.models import text as TT
from mudpt_torch.models import transformer as TTR
from mudpt_torch.models.clip import TINY_TEST
from mudpt_torch.models.convert import params_from_numpy
from mudpt_torch.ops import fused_block as TFB
from mudpt_torch.trainers import mudpt as TM
from mudpt_torch.utils import synth_step as TS

# 16 classes: the kernel route packs G=2 text rows; depth 3 splices layer 1
# of each 2-layer tower
N_CLS, N_CTX, DEPTH, B = 16, 2, 3, 4
CLASSNAMES = [f"object number {i}" for i in range(N_CLS)]
LEAVES = ("ctx", "deep_prompts", "embed_projection/w", "embed_projection/b",
          "deep_projections/w", "deep_projections/b", "visual_ctx",
          "visual_ctx_deep_prompts", "visual_ctx_deep_projections/w",
          "visual_ctx_deep_projections/b")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def remat():
    """Set the REMAT mode of both packages; 'none' again after."""
    def set_both(mode):
        JTR.set_remat_mode(mode)
        TTR.set_remat_mode(mode)
    yield set_both
    set_both("none")


@pytest.fixture
def block_impl():
    def set_both(name):
        JL.set_block_impl(name)
        TL.set_block_impl(name)
    yield set_both
    set_both("auto")


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
    images = rng.randn(B, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, N_CLS, B).astype(np.int32)
    return frozen, trainable, aux, images, labels


def _leaf(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return tree


def _port_loss_grads(trees, dtype=torch.float32):
    frozen, trainable, aux, images, labels = trees
    frozen, trainable, aux = (params_from_numpy(_np(t), "cpu") for t in (frozen, trainable, aux))
    for t in TS.leaves(trainable):
        t.requires_grad_(True)
    logits = TM.mudpt_forward(trainable, frozen, aux, torch.from_numpy(images).to(dtype),
                              clip_cfg=TINY_TEST, compute_dtype=dtype)
    loss = TS.nll_loss(logits, torch.from_numpy(labels).long())
    loss.backward()
    return loss.detach(), {n: _leaf(trainable, n).grad for n in LEAVES}


@pytest.mark.parametrize("impl", ["auto", "xla"])
@pytest.mark.parametrize("mode", ["full", "selective"])
def test_remat_loss_and_grads_bit_equal(trees, remat, block_impl, impl, mode):
    """Recomputing a layer (or the XLA attention's scores and probs) runs
    the same operations on the same inputs: loss and every leaf's gradient
    bit-equal to 'none', on both routes."""
    block_impl(impl)
    loss0, g0 = _port_loss_grads(trees)
    remat(mode)
    loss1, g1 = _port_loss_grads(trees)
    assert torch.equal(loss0, loss1)
    for n in LEAVES:
        assert torch.equal(g0[n], g1[n]), n


def test_remat_bf16_bit_equal(trees, remat):
    """The same in bf16 on the kernel route's plain versions."""
    loss0, g0 = _port_loss_grads(trees, torch.bfloat16)
    remat("full")
    loss1, g1 = _port_loss_grads(trees, torch.bfloat16)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(g0[n], g1[n]) for n in LEAVES)


def test_remat_full_matches_jax(trees, remat, block_impl):
    """REMAT 'full' in both packages, XLA blocks, fp32: loss and gradients
    within 1e-5 (relative to the largest JAX gradient)."""
    remat("full")
    block_impl("xla")
    frozen, trainable, aux, images, labels = trees

    def loss_fn(tr):
        logits = JM.mudpt_forward(tr, frozen, aux, jnp.asarray(images), clip_cfg=JTINY,
                                  compute_dtype=jnp.float32).astype(jnp.float32)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], axis=1).mean()

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(trainable)
    loss, grads = _port_loss_grads(trees)
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    for n in LEAVES:
        want = np.asarray(_leaf(jgrads, n))
        got = grads[n].numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), n


def test_recompute_takes_the_forward_route(trees, remat, monkeypatch):
    """Under 'full' each layer runs again in the backward, after the
    caller's contexts have closed: it re-enters the forward's routing state
    (here the plain blocks, saves off and LN 'bf16'), so every run of
    every block, the recompute too, sees the same state."""
    remat("full")
    seen = []
    block = TTR.residual_block

    def spy(*args, **kwargs):
        seen.append((TL.routes(), TL.ln_dtype(), TFB.save_acts_enabled()))
        return block(*args, **kwargs)

    monkeypatch.setattr(TTR, "residual_block", spy)
    frozen, trainable, aux, images, labels = trees
    frozen, trainable, aux = (params_from_numpy(_np(t), "cpu") for t in (frozen, trainable, aux))
    for t in TS.leaves(trainable):
        t.requires_grad_(True)
    TL.set_ln_dtype("bf16")
    try:
        with TL.plain_blocks(), TFB.saved_acts(False):
            logits = TM.mudpt_forward(trainable, frozen, aux, torch.from_numpy(images),
                                      clip_cfg=TINY_TEST, compute_dtype=torch.float32)
    finally:
        TL.set_ln_dtype("fp32")
    n_fwd = len(seen)
    assert n_fwd == 4  # two text and two vision layers
    TS.nll_loss(logits, torch.from_numpy(labels).long()).backward()
    assert len(seen) == 2 * n_fwd  # each layer recomputed once
    assert set(seen) == {((True, "none"), "bf16", False)}


def test_full_keeps_only_the_layer_inputs(trees, remat):
    """What the forward leaves for the backward: 'full' keeps each layer's
    input and drops what the layers save (qkv, h and their inputs), so the
    bytes held under 'full' fall below 'none''s."""
    def saved_bytes():
        held = []

        def pack(t):
            held.append(t.numel() * t.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            _port_loss_grads(trees)
        return sum(held)

    none = saved_bytes()
    remat("full")
    full = saved_bytes()
    assert full < none, (full, none)


def test_packed_text_rows_need_the_unrolled_tower(trees):
    """Packed rows splice at every period, which JAX's rolled scan cannot:
    with the unroll below the tower depth both packages refuse an explicit
    pack, and the auto rule does not pack."""
    frozen = trees[0]
    text_p = params_from_numpy(_np(frozen["text"]), "cpu")
    S = 16
    x = np.random.RandomState(3).randn(16, S, JTINY.transformer_width).astype(np.float32)
    eot = np.full(16, S - 1, np.int32)
    JTR.set_scan_unroll(1)
    TTR.set_scan_unroll(1)
    try:
        JT.set_text_pack(2)
        with pytest.raises(NotImplementedError, match="unrolled"):
            JT.text_forward(frozen["text"], jnp.asarray(x), jnp.asarray(eot), n_head=8)
        JT.set_text_pack(0)
        with pytest.raises(NotImplementedError, match="unrolled"):
            TT.text_forward(text_p, torch.from_numpy(x), torch.from_numpy(eot), n_head=8,
                            pack=2)
        assert JT._resolve_pack(16, 2, S) == 1
        want = np.asarray(JT.text_forward(frozen["text"], jnp.asarray(x), jnp.asarray(eot),
                                          n_head=8))
        with torch.no_grad():
            got = TT.text_forward(text_p, torch.from_numpy(x), torch.from_numpy(eot),
                                  n_head=8).numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    finally:
        JT.set_text_pack(0)
        JTR.set_scan_unroll("auto")
        TTR.set_scan_unroll("auto")


def test_remat_and_unroll_setters_refuse_unknown_values():
    with pytest.raises(ValueError, match="REMAT"):
        TTR.set_remat_mode("some")
    with pytest.raises(ValueError, match="SCAN_UNROLL"):
        TTR.set_scan_unroll("two")
    TTR.set_scan_unroll("-1")
    assert TTR.resolve_unroll() == -1
    TTR.set_scan_unroll("auto")
    assert TTR.remat_mode() == "none" and TTR.resolve_unroll() == 64
