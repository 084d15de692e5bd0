"""Sequence blocks longer than the 384 rows of the first ports, and the
ViT-L/14@336px preset: the port's attention half-block (its plain
attention, what ``attention_fwd`` and ``attention_bwd`` are held to on the
card) against the JAX package's ``attn_halfblock`` (Pallas in interpret
mode) at 579 rows, the 336px grid plus two prompt tokens, with every mask
spec, forward and dx; the preset equal field by field to the JAX
package's; one MuDPT train step whose vision blocks are 579 rows long
against ``jax.value_and_grad`` of the JAX package's; and the 336px train
step's route and launch plan."""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudpt_tpu.models import layers as JL
from mudpt_tpu.models.clip import init_clip_params as jinit
from mudpt_tpu.ops import fused_block as JFB
from mudpt_tpu.trainers import mudpt as JM
from mudpt_tpu.trainers.base import TINY_TEST as JTINY
from mudpt_tpu.trainers.base import _NAMED_CONFIGS
from mudpt_tpu.trainers.prompt_utils import embed_classnames as jembed
from mudpt_tpu.trainers.prompt_utils import init_linear as jinit_linear
from mudpt_tpu.trainers.prompt_utils import random_ctx as jrandom_ctx
from mudpt_tpu.utils.rng import new_rng

from mudpt_torch.models.clip import TINY_TEST
from mudpt_torch.models.convert import params_from_numpy
from mudpt_torch.ops import fused_block as TFB
from mudpt_torch.trainers import mudpt as TM
from mudpt_torch.utils import synth_step

S, D, H, B = 579, 64, 1, 1  # 577 patch and class rows + n_ctx 2; one head of 64
MASKS = [False, True, (193, 180)]  # none, causal, packed: 3 blocks of 193, 180 valid
MASK_IDS = ["none", "causal", "packed193_180"]
ATTN = ("ln_s", "ln_b", "qkv_w", "qkv_b", "out_w", "out_b")
# fp32: both sides compute the same fp32 softmax and products; the order of
# the sums differs.  bf16: the same rounding points, an ulp moved now and
# then (tests/test_torch_halfblock.py's limits, whose readings at 16 rows
# were 0 / 0)
FP32_TOL = 2e-5
BF16_MAX, BF16_NORM = 2.0 ** -8, 2.0 ** -10


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _arrays(seed):
    rng = np.random.RandomState(seed)
    mk = lambda *shape: (rng.randn(*shape) * 0.05).astype(np.float32)  # noqa: E731
    return {"x": rng.randn(B, S, D).astype(np.float32),
            "ln_s": (rng.rand(D) + 0.5).astype(np.float32), "ln_b": mk(D),
            "qkv_w": mk(D, 3 * D) * 8, "qkv_b": mk(3 * D), "out_w": mk(D, D), "out_b": mk(D)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", MASKS, ids=MASK_IDS)
def test_attn_halfblock_579_rows_matches_pallas(causal, dtype):
    a = _arrays(0)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = [jnp.asarray(a[n], jnp.float32 if n.startswith("ln") else jdt) for n in ATTN]
    y_jax = np.asarray(JFB.attn_halfblock(jnp.asarray(a["x"], jdt), *jp, H, causal)
                       .astype(jnp.float32))
    tp = [torch.from_numpy(a[n]).to(torch.float32 if n.startswith("ln") else dtype) for n in ATTN]
    y = TFB.attn_halfblock(torch.from_numpy(a["x"]).to(dtype), *tp, H, causal).float().numpy()
    assert y.shape == (B, S, D)
    if dtype == torch.float32:
        np.testing.assert_allclose(y, y_jax, rtol=FP32_TOL, atol=FP32_TOL)
        return
    err = np.abs(y - y_jax)
    assert err.max() <= BF16_MAX * np.abs(y_jax).max()
    assert np.linalg.norm(err) <= BF16_NORM * np.linalg.norm(y_jax)


def test_vit_l14_336px_preset_matches_jax():
    port, ref = synth_step.MODELS["ViT-L/14@336px"], _NAMED_CONFIGS["ViT-L/14@336px"]
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.grid_size == ref.grid_size == 24
    assert port.vision_seq_len == ref.vision_seq_len == 577
    assert port.vision_seq_len + 2 == S  # the served blocks, n_ctx 2




@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", MASKS, ids=MASK_IDS)
def test_attn_halfblock_dx_579_rows_matches_pallas(causal, dtype):
    """dx of the attention half (``AttnHalfblockFn``, qkv saved, on the
    kernels' plain versions) against the Pallas VJP (``_attn_bwd_save_kernel``
    in interpret mode) from the same upstream gradient."""
    a = _arrays(1)
    g = np.random.RandomState(2).randn(B, S, D).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = [jnp.asarray(a[n], jnp.float32 if n.startswith("ln") else jdt) for n in ATTN]
    _, vjp = jax.vjp(lambda x: JFB.attn_halfblock(x, *jp, H, causal), jnp.asarray(a["x"], jdt))
    dx_jax = np.asarray(vjp(jnp.asarray(g, jdt))[0].astype(jnp.float32))
    tp = [torch.from_numpy(a[n]).to(torch.float32 if n.startswith("ln") else dtype) for n in ATTN]
    x = torch.from_numpy(a["x"]).to(dtype).requires_grad_(True)
    y = TFB.attn_halfblock(x, *tp, H, causal)
    assert isinstance(y.grad_fn, TFB.AttnHalfblockFn._backward_cls)
    dx = torch.autograd.grad(y, x, torch.from_numpy(g).to(dtype))[0].float().numpy()
    assert dx.shape == (B, S, D) and np.isfinite(dx).all()
    # dx reaches ~60 here, and the fp32 softmax and products sum 579 terms
    # in another order: held to FP32_TOL of its largest value and in norm.
    # Readings: fp32 max 5.3e-6 / 9.6e-6 / 1.1e-5, norm 3.7e-6-3.9e-6;
    # bf16 max 2.8e-4 / 2.2e-3 / 1.2e-4, norm 8.4e-6-1.2e-4
    err = np.abs(dx - dx_jax)
    max_tol, norm_tol = (FP32_TOL, FP32_TOL) if dtype == torch.float32 else (BF16_MAX, BF16_NORM)
    assert err.max() <= max_tol * np.abs(dx_jax).max()
    assert np.linalg.norm(err) <= norm_tol * np.linalg.norm(dx_jax)


# a MuDPT train step at tiny width whose vision blocks are 579 rows long:
# a 24 x 24 grid of 2-pixel patches, the class token and 2 prompts
GRID_CFG = dict(image_resolution=48, vision_patch_size=2)
N_CLS, N_CTX, DEPTH, N_IMG = 8, 2, 3, 2
LEAVES = ("ctx", "deep_prompts", "embed_projection/w", "embed_projection/b",
          "deep_projections/w", "deep_projections/b", "visual_ctx",
          "visual_ctx_deep_prompts", "visual_ctx_deep_projections/w",
          "visual_ctx_deep_projections/b")


def _leaf(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return tree


def test_loss_and_grads_fp32_match_jax_at_579_tokens():
    """fp32 loss and the gradient of each trainable leaf, the port's
    ``mudpt_forward`` and backward against ``jax.value_and_grad`` of the JAX
    package's with its Pallas layers (interpret mode), at the tolerances of
    ``tests/test_torch_train_step.py``."""
    jcfg = dataclasses.replace(JTINY, **GRID_CFG)
    tcfg = dataclasses.replace(TINY_TEST, **GRID_CFG)
    assert tcfg.vision_seq_len + N_CTX == S
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
    images = rng.randn(N_IMG, 48, 48, 3).astype(np.float32)
    labels = rng.randint(0, N_CLS, N_IMG).astype(np.int32)

    def jloss_fn(tr):
        logits = JM.mudpt_forward(tr, frozen, aux, jnp.asarray(images), clip_cfg=jcfg,
                                  compute_dtype=jnp.float32)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return -jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], axis=1).mean()

    JL.set_block_impl("pallas")
    try:
        jloss, jgrads = jax.value_and_grad(jloss_fn)(trainable)
    finally:
        JL.set_block_impl("auto")
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    tfrozen, ttr, taux = (params_from_numpy(np_tree(t), "cpu") for t in (frozen, trainable, aux))
    for t in synth_step.leaves(ttr):
        t.requires_grad_(True)
    logits = TM.mudpt_forward(ttr, tfrozen, taux, torch.from_numpy(images), clip_cfg=tcfg,
                              compute_dtype=torch.float32)
    loss = synth_step.nll_loss(logits, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, atol=1e-5)
    for name in LEAVES:
        j = np.asarray(_leaf(jgrads, name))
        t = _leaf(ttr, name).grad.numpy()
        assert np.abs(j).max() > 0, name
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-4 * np.abs(j).max(), err_msg=name)


class _SetUpReached(Exception):
    pass


def test_vit_l14_336px_train_step_builds_with_its_launch_plan(monkeypatch):
    """The 336px step takes its 579-row blocks: ``build_synth_mudpt_step``
    reaches its set-up (stopped there: a full-width model is not built on
    the CPU).  Its vision layers take the half-blocks with h recomputed at batch
    384 (the JAX package's row-token budget), attention_bwd once a layer,
    and a step's launches are chip_smoke's plan for that route."""
    def stop(*args, **kwargs):
        raise _SetUpReached

    monkeypatch.setattr(synth_step, "_setup", stop)
    with pytest.raises(_SetUpReached):
        synth_step.build_synth_mudpt_step("ViT-L/14@336px", 384, 100, N_CTX, 9, device="cpu")
    cfg = synth_step.MODELS["ViT-L/14@336px"]
    assert cfg.vision_width > TFB.FULLBLOCK_MAX_WIDTH and cfg.vision_width <= TFB.MAX_WIDTH
    assert not TFB.wide_mlp_save(384 * (cfg.vision_seq_len + N_CTX))  # h recomputed
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    C = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(C)
    plan = C.step_launches(TFB, cfg, "full_train", "half_train_recompute_h")
    assert plan["attention_bwd"] == cfg.vision_layers + cfg.transformer_layers == 36
    assert plan["attention_fwd"] == 36
    # per vision layer 9 products (h recomputed), per text layer 8
    assert plan["gemm_bf16_epilogue"] == 9 * 24 + 8 * 12
    assert plan["attn_halfblock_bwd"] == plan["mlp_halfblock_bwd"] == 24
