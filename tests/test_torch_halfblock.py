"""The port's half-blocks against the JAX package's custom VJPs of
``attn_halfblock`` and ``mlp_halfblock`` (Pallas in interpret mode), on the
same numpy-seeded arrays: the primal, the tensors the saving forward keeps
(``_attn_fwd`` / ``_mlp_fwd``), and dx with saves on and off (the saving
and the recompute backwards), for every mask spec, in fp32 and bf16; at
D = 1024 the wide route, where the MLP h-save has a policy of its own;
the QuickGELU' fault that the recompute chain repairs; and
``layer_fullblock`` as the two halves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudpt_tpu.ops import fused_block as JFB

from mudpt_torch.ops import fused_block as TFB

D, S, H, B = 64, 16, 2, 3  # head dim 32: the plain versions take any
WIDE_D, WIDE_S, WIDE_H, WIDE_B = 1024, 8, 16, 2  # the ViT-L/14 vision width
MASKS = [False, True, (8, 8), (8, 6)]
MASK_IDS = ["none", "causal", "packed8_8", "packed8_6"]
ATTN = ("ln_s", "ln_b", "qkv_w", "qkv_b", "out_w", "out_b")
MLP = ("ln_s", "ln_b", "fc_w", "fc_b", "proj_w", "proj_b")
DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["fp32", "bf16"]
# bf16: both sides round at the same points, but the order of fp32 sums
# differs and XLA's CPU compiler may keep a fused bf16 intermediate in
# fp32, so one rounding can move by an ulp and carry through the chain.
# Readings (max err over the largest value / relative norm err): at D = 64
# every attention y, qkv and dx 0 / 0, MLP y and saving dx 0 / 0, h 6.2e-4 /
# 2.4e-5, recompute dx 4.7e-4 / 6.1e-5; at D = 1024 attention dx 1.3e-3 /
# 3.5e-4, MLP dx 1.5e-3 / 2.1e-4.  Bounds 2.5x and 2.8x above the worst:
BF16_MAX, BF16_NORM = 2.0 ** -8, 2.0 ** -10


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on few cores: keep torch's intra-op
    pool small so these files do not crowd out timing-sensitive tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def wide_mode():
    """Set the wide-MLP h-save mode on both sides; "auto" again after."""
    def set_both(mode):
        JFB.set_save_mlp_wide(mode)
        TFB.set_save_mlp_wide(mode)
    yield set_both
    set_both("auto")


def _arrays(seed, names, d=D, s=S, b=B):
    rng = np.random.RandomState(seed)
    mk = lambda *shape: (rng.randn(*shape) * 0.05).astype(np.float32)  # noqa: E731
    shapes = {"qkv_w": (d, 3 * d), "qkv_b": (3 * d,), "out_w": (d, d), "out_b": (d,),
              "fc_w": (d, 4 * d), "fc_b": (4 * d,), "proj_w": (4 * d, d), "proj_b": (d,)}
    a = {"x": rng.randn(b, s, d).astype(np.float32), "g": rng.randn(b, s, d).astype(np.float32),
         "ln_s": (rng.rand(d) + 0.5).astype(np.float32), "ln_b": mk(d)}
    a.update({n: mk(*shapes[n]) for n in names[2:]})
    return a


def _jax_args(a, names, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ps = [jnp.asarray(a[n], jnp.float32 if n.startswith("ln") else jdt) for n in names]
    return jnp.asarray(a["x"], jdt), ps, jnp.asarray(a["g"], jdt)


def _torch_args(a, names, dtype):
    ps = [torch.from_numpy(a[n]).to(torch.float32 if n.startswith("ln") else dtype)
          for n in names]
    return torch.from_numpy(a["x"]).to(dtype), ps, torch.from_numpy(a["g"]).to(dtype)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t.astype(jnp.float32))


def _assert_close(got, ref, dtype, what, fp32_tol=2e-5):
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, rtol=fp32_tol, atol=fp32_tol, err_msg=what)
        return
    err = np.abs(got - ref)
    assert err.max() <= BF16_MAX * np.abs(ref).max(), (what, err.max(), np.abs(ref).max())
    assert np.linalg.norm(err) <= BF16_NORM * np.linalg.norm(ref), (what, np.linalg.norm(err))


# ---------------------------------------------------------------------------
# primal and saved tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("causal", MASKS, ids=MASK_IDS)
def test_attn_primal_and_saved_qkv_match_pallas(causal, dtype):
    a = _arrays(0, ATTN)
    jx, jp, _ = _jax_args(a, ATTN, dtype)
    y_jax = JFB.attn_halfblock(jx, *jp, H, causal)
    _, (_, qkv_jax, _) = JFB._attn_fwd(jx, *jp, H, causal)
    tx, tp, _ = _torch_args(a, ATTN, dtype)
    y = TFB.attn_halfblock(tx, *tp, H, causal)
    y_save, qkv = TFB.attn_halfblock_fwd_save_plain(tx, *tp, H, causal)
    assert torch.equal(y, y_save)
    _assert_close(_np(y), _np(y_jax), dtype, "y")
    _assert_close(_np(qkv), _np(qkv_jax), dtype, "qkv")
    # and the training forward keeps that qkv beside its input
    saved = TFB.attn_halfblock(tx.clone().requires_grad_(True), *tp, H, causal).grad_fn
    assert torch.equal(saved.saved_tensors[0], tx) and torch.equal(saved.saved_tensors[-1], qkv)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_mlp_primal_and_saved_h_match_pallas(dtype):
    a = _arrays(1, MLP)
    jx, jp, _ = _jax_args(a, MLP, dtype)
    y_jax = JFB.mlp_halfblock(jx, *jp)
    _, (_, h_jax, _) = JFB._mlp_fwd(jx, *jp)
    tx, tp, _ = _torch_args(a, MLP, dtype)
    y = TFB.mlp_halfblock(tx, *tp)
    y_save, h = TFB.mlp_halfblock_fwd_save_plain(tx, *tp)
    assert torch.equal(y, y_save)
    _assert_close(_np(y), _np(y_jax), dtype, "y")
    _assert_close(_np(h), _np(h_jax), dtype, "h")
    saved = TFB.mlp_halfblock(tx.clone().requires_grad_(True), *tp).grad_fn
    assert torch.equal(saved.saved_tensors[0], tx) and torch.equal(saved.saved_tensors[-1], h)


# ---------------------------------------------------------------------------
# dx, saves on and off
# ---------------------------------------------------------------------------

def _dx_pair(fn_jax, fn_port, a, names, dtype, save):
    """dx of the JAX custom VJP and of the port's Function, both under the
    save policy ``save``; also whether each side's forward kept its tensor."""
    jx, jp, jg = _jax_args(a, names, dtype)
    with JFB.saved_acts(save):
        _, vjp = jax.vjp(lambda x: fn_jax(x, jp), jx)
    (dx_jax,) = vjp(jg)
    tx, tp, tg = _torch_args(a, names, dtype)
    tx.requires_grad_(True)
    with TFB.saved_acts(save):
        y = fn_port(tx, tp)
    kept = y.grad_fn.saved_tensors[-1] is not None
    (dx,) = torch.autograd.grad(y, tx, tg)
    return _np(dx_jax), _np(dx), kept


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("save", [True, False], ids=["save", "recompute"])
@pytest.mark.parametrize("causal", MASKS, ids=MASK_IDS)
def test_attn_dx_matches_pallas(causal, save, dtype):
    dx_jax, dx, kept = _dx_pair(lambda x, p: JFB.attn_halfblock(x, *p, H, causal),
                                lambda x, p: TFB.attn_halfblock(x, *p, H, causal),
                                _arrays(2, ATTN), ATTN, dtype, save)
    assert kept == save
    _assert_close(dx, dx_jax, dtype, "dx", fp32_tol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("save", [True, False], ids=["save", "recompute"])
def test_mlp_dx_matches_pallas(save, dtype):
    dx_jax, dx, kept = _dx_pair(lambda x, p: JFB.mlp_halfblock(x, *p),
                                lambda x, p: TFB.mlp_halfblock(x, *p),
                                _arrays(3, MLP), MLP, dtype, save)
    assert kept == save
    _assert_close(dx, dx_jax, dtype, "dx", fp32_tol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("half", ["attn", "mlp"])
def test_recompute_and_saving_backwards(half, dtype):
    """In fp32 the saved qkv or h is the recomputed one, so the two
    backwards agree to the last bits; in bf16 the attention half's do too
    (qkv is bf16 either way), the MLP half's do not (h32 against bf16 h)."""
    names = ATTN if half == "attn" else MLP
    a = _arrays(4, names)
    tx, tp, tg = _torch_args(a, names, dtype)
    if half == "attn":
        _, qkv = TFB.attn_halfblock_fwd_save_plain(tx, *tp, H, True)
        dx_save = TFB.attn_halfblock_bwd_plain(tx, qkv, tg, *tp[:5], H, True)
        dx_rec = TFB.attn_halfblock_bwd_plain(tx, None, tg, *tp[:5], H, True)
    else:
        _, h = TFB.mlp_halfblock_fwd_save_plain(tx, *tp)
        dx_save = TFB.mlp_halfblock_bwd_plain(tx, h, tg, *tp[:5])
        dx_rec = TFB.mlp_halfblock_bwd_plain(tx, None, tg, *tp[:5])
    if half == "mlp" and dtype == torch.bfloat16:
        assert not torch.equal(dx_save, dx_rec)
    else:
        np.testing.assert_allclose(_np(dx_rec), _np(dx_save), rtol=1e-6, atol=1e-6)


def test_weights_that_need_grad_are_refused():
    a = _arrays(5, MLP)
    tx, tp, _ = _torch_args(a, MLP, torch.float32)
    tx.requires_grad_(True)
    tp[2].requires_grad_(True)
    with pytest.raises(ValueError, match="must not require grad"):
        TFB.mlp_halfblock(tx, *tp)
    a = _arrays(5, ATTN)
    tx, tp, _ = _torch_args(a, ATTN, torch.float32)
    tx.requires_grad_(True)
    tp[4].requires_grad_(True)
    with pytest.raises(ValueError, match="must not require grad"):
        TFB.attn_halfblock(tx, *tp, H, False)


# ---------------------------------------------------------------------------
# D = 1024 and the QuickGELU' of the recompute backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["1", "0"], ids=["save_h", "recompute_h"])
@pytest.mark.parametrize("half", ["attn", "mlp"])
def test_wide_halfblocks_match_pallas(half, mode, wide_mode):
    """D = 1024, 16 heads, bf16, saves on: qkv saved, and h saved or
    recomputed under the wide-MLP policy (``wide_mlp_save``), as in the JAX
    package."""
    wide_mode(mode)
    names = ATTN if half == "attn" else MLP
    a = _arrays(6, names, WIDE_D, WIDE_S, WIDE_B)
    if half == "attn":
        fns = (lambda x, p: JFB.attn_halfblock(x, *p, WIDE_H, False),
               lambda x, p: TFB.attn_halfblock(x, *p, WIDE_H, False))
    else:
        fns = (lambda x, p: JFB.mlp_halfblock(x, *p), lambda x, p: TFB.mlp_halfblock(x, *p))
    dx_jax, dx, kept = _dx_pair(*fns, a, names, torch.bfloat16, True)
    assert kept == (half == "attn" or mode == "1")
    _assert_close(dx, dx_jax, torch.bfloat16, "dx")


def test_recompute_chain_repairs_the_gelu_grad_of_bf16_h():
    """The fault of the port's old route: dx of the JAX ``mlp_halfblock``
    with saves off (``_mlp_bwd_kernel`` in interpret mode, QuickGELU' of
    the fp32 h32), bf16, against the port's recompute chain and against the
    chain that ``layer_fullblock`` runs (QuickGELU' of the bf16-saved h,
    where the port's ``residual_block`` sent every layer before).  Share
    of elements not bit-equal and relative norm error, readings: recompute
    chain 0 and 0; bf16-h chain 0.125 and 1.0e-3 (over the norm bound of
    ``test_mlp_dx_matches_pallas`` as well)."""
    a = _arrays(0, MLP)
    jx, jp, jg = _jax_args(a, MLP, torch.bfloat16)
    with JFB.saved_acts(False):
        _, vjp = jax.vjp(lambda x: JFB.mlp_halfblock(x, *jp), jx)
    dx_jax = _np(vjp(jg)[0])
    tx, tp, tg = _torch_args(a, MLP, torch.bfloat16)
    _, h = TFB.mlp_halfblock_fwd_save_plain(tx, *tp)
    readings = {}
    for name, saved in (("recompute", None), ("bf16_h", h)):
        dx = _np(TFB.mlp_halfblock_bwd_plain(tx, saved, tg, *tp[:5]))
        readings[name] = ((dx != dx_jax).mean(),
                          np.linalg.norm(dx - dx_jax) / np.linalg.norm(dx_jax))
    assert readings["bf16_h"][0] > 2.0 ** -4, readings
    assert readings["recompute"][0] <= readings["bf16_h"][0] / 32, readings
    assert readings["recompute"][1] <= readings["bf16_h"][1] / 32, readings


# ---------------------------------------------------------------------------
# layer_fullblock is the two halves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, (8, 6)], ids=["none", "packed8_6"])
def test_layer_fullblock_is_the_two_halves(causal):
    """The layer's chains are the halves' chains (saves on, bf16): the same
    y, y1, qkv, h and dx, bit for bit."""
    tx, attn, tg = _torch_args(_arrays(7, ATTN), ATTN, torch.bfloat16)
    _, mlp, _ = _torch_args(_arrays(8, MLP), MLP, torch.bfloat16)
    y, y1, qkv, h = TFB.layer_fullblock_fwd_save_plain(tx, *attn, *mlp, H, causal)
    y1_h, qkv_h = TFB.attn_halfblock_fwd_save_plain(tx, *attn, H, causal)
    y_h, h_h = TFB.mlp_halfblock_fwd_save_plain(y1_h, *mlp)
    for got, ref in ((y_h, y), (y1_h, y1), (qkv_h, qkv), (h_h, h)):
        assert torch.equal(got, ref)

    xg = tx.clone().requires_grad_(True)
    (dx_layer,) = torch.autograd.grad(TFB.layer_fullblock(xg, *attn, *mlp, H, causal), xg, tg)
    y_halves = TFB.mlp_halfblock(TFB.attn_halfblock(xg, *attn, H, causal), *mlp)
    (dx_halves,) = torch.autograd.grad(y_halves, xg, tg)
    assert torch.equal(dx_layer, dx_halves)
