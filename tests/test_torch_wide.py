"""The routes through the half-blocks, against the JAX package's
``residual_block`` (``set_block_impl("pallas")``: the Pallas custom VJPs in
interpret mode): one layer's dx with saves off and at the ViT-L/14 width,
the dispatch and its policies; then a tiny train step with a 1024-wide
vision tower (2 layers, patch 14, 28 px; text 64 x 2) -- the loss and each
trainable leaf's gradient with the MLP h saved and recomputed, and with the
text tower's saves off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudpt_tpu.models import layers as JL
from mudpt_tpu.models import text as JT
from mudpt_tpu.models.clip import CLIPConfig as JCLIPConfig
from mudpt_tpu.models.clip import init_clip_params as jinit
from mudpt_tpu.ops import fused_block as JFB
from mudpt_tpu.trainers import mudpt as JM
from mudpt_tpu.trainers.prompt_utils import embed_classnames as jembed
from mudpt_tpu.trainers.prompt_utils import init_linear as jinit_linear
from mudpt_tpu.trainers.prompt_utils import random_ctx as jrandom_ctx
from mudpt_tpu.utils.rng import new_rng

from mudpt_torch.models import layers as TL
from mudpt_torch.models import text as TT
from mudpt_torch.models.clip import CLIPConfig
from mudpt_torch.models.convert import params_from_numpy
from mudpt_torch.ops import fused_block as TFB
from mudpt_torch.trainers import mudpt as TM
from mudpt_torch.utils import synth_step as TS

D, S, H, B = 64, 16, 2, 3
WIDE_D, WIDE_S, WIDE_H, WIDE_B = 1024, 8, 16, 2
MASKS = [False, True, (8, 8), (8, 6)]
MASK_IDS = ["none", "causal", "packed8_8", "packed8_6"]
BLOCKS = ("ln_1", "attn", "ln_2", "mlp")
# one layer's dx in bf16 (max err over the largest value, relative norm
# err): at D = 64 the bounds of tests/test_torch_halfblock.py; at D = 1024,
# where a one-ulp flip of dy1 moves every value of its row through the
# LayerNorm dx, those of tests/test_torch_layer_bwd.py.  Readings in each
# test's docstring
BF16_MAX, BF16_NORM = 2.0 ** -8, 2.0 ** -10
WIDE_MAX, WIDE_NORM = 2.0 ** -6, 2.0 ** -7

# the wide train step: vision 1024 wide (16 heads), 4 patches + CLS + 2
# prompts = 7 tokens; 32 classes pack G = 4 text rows of 16 tokens
WIDE_CFG = dict(embed_dim=64, image_resolution=28, vision_layers=2, vision_width=1024,
                vision_patch_size=14, transformer_width=64, transformer_heads=2,
                transformer_layers=2)
N_CLS, N_CTX, DEPTH, N_IMG = 32, 2, 3, 2
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


@pytest.fixture
def pallas_blocks():
    """The JAX side's ``residual_block`` runs the Pallas custom VJPs."""
    JL.set_block_impl("pallas")
    yield
    JL.set_block_impl("auto")


@pytest.fixture
def wide_mode():
    """Set the wide-MLP h-save mode on both sides; "auto" again after."""
    def set_both(mode):
        JFB.set_save_mlp_wide(mode)
        TFB.set_save_mlp_wide(mode)
    yield set_both
    set_both("auto")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t.astype(jnp.float32))


# ---------------------------------------------------------------------------
# one layer through residual_block
# ---------------------------------------------------------------------------

def _layer_arrays(seed, d=D, s=S, b=B):
    rng = np.random.RandomState(seed)
    mk = lambda *shape: (rng.randn(*shape) * 0.05).astype(np.float32)  # noqa: E731
    ln = lambda: {"scale": (rng.rand(d) + 0.5).astype(np.float32), "bias": mk(d)}  # noqa: E731
    return {
        "x": rng.randn(b, s, d).astype(np.float32), "g": rng.randn(b, s, d).astype(np.float32),
        "ln_1": ln(),
        "attn": {"qkv_w": mk(d, 3 * d), "qkv_b": mk(3 * d), "out_w": mk(d, d), "out_b": mk(d)},
        "ln_2": ln(),
        "mlp": {"fc_w": mk(d, 4 * d), "fc_b": mk(4 * d), "proj_w": mk(4 * d, d), "proj_b": mk(d)},
    }


def _torch_layer(a, dtype):
    return {k: {n: torch.from_numpy(v).to(torch.float32 if k.startswith("ln") else dtype)
                for n, v in a[k].items()} for k in BLOCKS}


def _layer_dx(a, n_head, causal, save):
    """dx of one layer through each package's ``residual_block`` in bf16,
    the port's last autograd node, and whether it kept its tensor."""
    jp = {k: {n: jnp.asarray(v, jnp.float32 if k.startswith("ln") else jnp.bfloat16)
              for n, v in a[k].items()} for k in BLOCKS}
    jx, jg = jnp.asarray(a["x"], jnp.bfloat16), jnp.asarray(a["g"], jnp.bfloat16)
    with JFB.saved_acts(save):
        _, vjp = jax.vjp(lambda x: JL.residual_block(jp, x, n_head, causal=causal), jx)
    (dx_jax,) = vjp(jg)
    tx = torch.from_numpy(a["x"]).bfloat16().requires_grad_(True)
    with TFB.saved_acts(save):
        y = TL.residual_block(_torch_layer(a, torch.bfloat16), tx, n_head, causal)
    node = type(y.grad_fn).__name__
    kept = y.grad_fn.saved_tensors[-1] is not None
    (dx,) = torch.autograd.grad(y, tx, torch.from_numpy(a["g"]).bfloat16())
    return _np(dx_jax), _np(dx), node, kept


def _assert_bf16_close(got, ref, max_bound=BF16_MAX, norm_bound=BF16_NORM):
    err = np.abs(got - ref)
    assert err.max() <= max_bound * np.abs(ref).max(), (err.max(), np.abs(ref).max())
    assert np.linalg.norm(err) <= norm_bound * np.linalg.norm(ref), np.linalg.norm(err)


@pytest.mark.parametrize("causal", MASKS, ids=MASK_IDS)
def test_residual_block_with_saves_off_recomputes_as_jax(causal, pallas_blocks):
    """With saves off the JAX package runs the half-blocks, whose MLP
    backward takes QuickGELU' of the fp32 h32 it recomputes, never rounded
    (``_mlp_bwd_kernel`` :444).  The port's ``residual_block`` used to run
    ``layer_fullblock``'s chain there, which takes it of the bf16-saved h.
    Share of dx elements not bit-equal to the JAX dx, bf16, readings over
    the four masks: 0 to 0.0101 (max err up to 1.7e-3 of the largest value,
    norm err up to 3.0e-4) through the half-blocks; 0.156 to 0.167 (max err
    3.5e-3, norm err 1.26e-3 to 1.35e-3, over the norm bound too) through
    the ``layer_fullblock`` chain.  Limit 2^-5 = 0.031: 3.1x above the one,
    5x below the other."""
    dx_jax, dx, node, kept = _layer_dx(_layer_arrays(6), H, causal, save=False)
    assert node == "MlpHalfblockFnBackward" and not kept
    assert (dx != dx_jax).mean() <= 2.0 ** -5, (dx != dx_jax).mean()
    _assert_bf16_close(dx, dx_jax)


@pytest.mark.parametrize("mode", ["1", "0"], ids=["save_h", "recompute_h"])
def test_residual_block_wide_route_matches_jax(mode, pallas_blocks, wide_mode):
    """D = 1024, 16 heads, saves on: qkv saved, h saved or recomputed under
    the wide-MLP policy, in bf16.  Readings: max err 3.4e-3 of the largest
    value, norm err 2.7e-3 and 2.6e-3, 0.43 and 0.42 of the elements not
    bit-equal (h saved, recomputed)."""
    wide_mode(mode)
    a = _layer_arrays(7, WIDE_D, WIDE_S, WIDE_B)
    dx_jax, dx, node, kept = _layer_dx(a, WIDE_H, False, save=True)
    assert node == "MlpHalfblockFnBackward" and kept == (mode == "1")
    _assert_bf16_close(dx, dx_jax, WIDE_MAX, WIDE_NORM)


@pytest.mark.parametrize("save,d,want", [
    (True, D, "LayerFullblockFnBackward"),
    (False, D, "MlpHalfblockFnBackward"),
    (True, WIDE_D, "MlpHalfblockFnBackward"),
], ids=["saves_on", "saves_off", "wide"])
def test_residual_block_routes_as_jax(save, d, want):
    a = _layer_arrays(8, d, 8, 1)
    x = torch.from_numpy(a["x"]).requires_grad_(True)
    with TFB.saved_acts(save):
        y = TL.residual_block(_torch_layer(a, torch.float32), x, d // 32, False)
    assert type(y.grad_fn).__name__ == want
    if want.startswith("Mlp"):
        # the MLP half's input is the attention half's output
        assert type(y.grad_fn.next_functions[0][0]).__name__ == "AttnHalfblockFnBackward"


def test_residual_block_refuses_wider_than_1024():
    """Wider than 1024 the kernels refuse the layer and the block takes the
    XLA route instead, as the JAX package's does (``layers.py:283-284``):
    the same output as JAX's residual_block there, in fp32, within 1e-5 of
    the largest value (the packages' fp32 sums of 4,352 products run in
    another order: 2.4e-6 read)."""
    a = _layer_arrays(9, 1088, 2, 1)
    got = TL.residual_block(_torch_layer(a, torch.float32), torch.from_numpy(a["x"]), 17, False)
    want = np.asarray(JL.residual_block(
        {k: {n: jnp.asarray(v) for n, v in a[k].items()} for k in BLOCKS},
        jnp.asarray(a["x"]), 17))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("mode", ["auto", "1", "0"])
def test_wide_mlp_save_policy_matches_jax(mode, wide_mode):
    wide_mode(mode)
    for rows in (None, 1, 112 * 264, 112 * 264 + 1, 384 * 259):
        assert TFB.wide_mlp_save(rows) == JFB.wide_mlp_save(rows), (mode, rows)
    with pytest.raises(ValueError, match="save_mlp_wide"):
        TFB.set_save_mlp_wide("yes")


# ---------------------------------------------------------------------------
# a tiny train step with a 1024-wide vision tower
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trees():
    jcfg = JCLIPConfig(**WIDE_CFG)
    frozen = jinit(new_rng(0), jcfg)
    ks = jax.random.split(new_rng(1), 8)
    dim, vdim = jcfg.transformer_width, jcfg.vision_width
    trainable = {
        "ctx": jrandom_ctx(ks[0], (N_CTX, dim)),
        "deep_prompts": jrandom_ctx(ks[1], (DEPTH - 1, N_CTX, dim)),
        "embed_projection": jinit_linear(ks[2], dim, vdim),
        "deep_projections": jinit_linear(ks[3], dim, vdim),
        "visual_ctx": jrandom_ctx(ks[4], (N_CTX, vdim)),
        "visual_ctx_deep_prompts": jrandom_ctx(ks[5], (DEPTH - 1, N_CTX, vdim)),
        "visual_ctx_deep_projections": jinit_linear(ks[6], vdim, dim),
    }
    aux = jembed(frozen["text"], [f"object number {i}" for i in range(N_CLS)], N_CTX,
                 "a photo of a").as_device_tree()
    rng = np.random.RandomState(0)
    images = rng.randn(N_IMG, 28, 28, 3).astype(np.float32)
    labels = rng.randint(0, N_CLS, N_IMG).astype(np.int32)
    return jcfg, frozen, trainable, aux, images, labels


def _leaf(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("route", ["saves", "recompute"])
def test_wide_train_step_matches_jax(route, trees, pallas_blocks, wide_mode, monkeypatch):
    """fp32: the loss within 1e-5 and each leaf's gradient within 1e-4 of
    its largest JAX value (the bounds of tests/test_torch_train_step.py).
    "saves": the vision MLP saves h ("1"), the text tower saves
    (``layer_fullblock``).  "recompute": the vision MLP recomputes h ("0")
    and the text tower runs with saves off, its row-token threshold
    lowered on both sides to its 32 rows x 16 tokens (the half-blocks'
    recompute backwards at D = 64, packed)."""
    jcfg, frozen, trainable, aux, images, labels = trees
    wide_mode("1" if route == "saves" else "0")
    if route == "recompute":
        monkeypatch.setattr(JT, "_AUTO_RECOMPUTE_MIN_ROW_TOKENS", N_CLS * 16)
        monkeypatch.setattr(TT, "_AUTO_RECOMPUTE_MIN_ROW_TOKENS", N_CLS * 16)

    def jax_loss(tr):
        logits = JM.mudpt_forward(tr, frozen, aux, jnp.asarray(images), clip_cfg=jcfg,
                                  compute_dtype=jnp.float32)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return -jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], axis=1).mean()

    jloss, jgrads = jax.value_and_grad(jax_loss)(trainable)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    tfrozen, ttr, taux = (params_from_numpy(np_tree(t), "cpu") for t in (frozen, trainable, aux))
    for t in TS.leaves(ttr):
        t.requires_grad_(True)
    logits = TM.mudpt_forward(ttr, tfrozen, taux, torch.from_numpy(images),
                              clip_cfg=CLIPConfig(**WIDE_CFG), compute_dtype=torch.float32)
    loss = TS.nll_loss(logits, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, atol=1e-5)
    for name in LEAVES:
        j = np.asarray(_leaf(jgrads, name))
        assert np.abs(j).max() > 0, name
        np.testing.assert_allclose(_leaf(ttr, name).grad.numpy(), j, rtol=0,
                                   atol=1e-4 * np.abs(j).max(), err_msg=name)
