"""The port's training layer against the JAX package's custom VJP of
``layer_fullblock``: the saving forward's (y, y1, qkv, h) against
``_layer_fwd`` (``_layer_fwd_kernel`` in interpret mode) and the dx of
``LayerFullblockFn`` (on CPU tensors: the plain versions of its kernel
chain) against ``jax.vjp`` (``_layer_bwd_kernel`` in interpret mode), for
every mask spec, on the same numpy-seeded arrays; dx also against autograd
through the plain forward, an oracle independent of JAX; and the
LayerNorm-dx and QuickGELU-gradient pieces alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudpt_tpu.ops import fused_block as JFB

from mudpt_torch.ops import fused_block as TFB

D, S, H, B = 64, 40, 2, 3  # head dim 32: the plain versions take any
MASKS = [False, True, (8, 8), (8, 6)]
MASK_IDS = ["none", "causal", "packed8_8", "packed8_6"]
NAMES = ("ln1_s", "ln1_b", "qkv_w", "qkv_b", "out_w", "out_b",
         "ln2_s", "ln2_b", "fc_w", "fc_b", "proj_w", "proj_b")
# bf16: both sides round at the same points, but the order of fp32 sums
# differs and XLA's CPU compiler may keep a fused bf16 intermediate in
# fp32, so one rounding can move by an ulp and carry through the chain.
# Readings (max err over the largest value / relative norm err), worst of
# the four masks: y 3.8e-3 / 1.6e-3, y1 and qkv 0 / 0, h 5.4e-3 / 3.6e-3,
# dx 3.6e-3 / 1.5e-3.  Bounds 2.9x and 2.2x above the worst reading:
BF16_MAX, BF16_NORM = 2.0 ** -6, 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on few cores: keep torch's intra-op
    pool small so these files do not crowd out timing-sensitive tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _arrays(seed):
    rng = np.random.RandomState(seed)
    mk = lambda *s: (rng.randn(*s) * 0.05).astype(np.float32)  # noqa: E731
    return {
        "x": rng.randn(B, S, D).astype(np.float32),
        "g": rng.randn(B, S, D).astype(np.float32),
        "ln1_s": (rng.rand(D) + 0.5).astype(np.float32), "ln1_b": mk(D),
        "qkv_w": mk(D, 3 * D), "qkv_b": mk(3 * D), "out_w": mk(D, D), "out_b": mk(D),
        "ln2_s": (rng.rand(D) + 0.5).astype(np.float32), "ln2_b": mk(D),
        "fc_w": mk(D, 4 * D), "fc_b": mk(4 * D), "proj_w": mk(4 * D, D), "proj_b": mk(D),
    }


def _jax_args(a, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ps = [jnp.asarray(a[n], jnp.float32 if n.startswith("ln") else jdt) for n in NAMES]
    return jnp.asarray(a["x"], jdt), ps, jnp.asarray(a["g"], jdt)


def _torch_args(a, dtype):
    ps = [torch.from_numpy(a[n]).to(torch.float32 if n.startswith("ln") else dtype)
          for n in NAMES]
    return torch.from_numpy(a["x"]).to(dtype), ps, torch.from_numpy(a["g"]).to(dtype)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t.astype(jnp.float32))


def _forward_pair(a, causal, dtype):
    jx, jp, _ = _jax_args(a, dtype)
    y, (_, y1, qkv, h, _) = JFB._layer_fwd(jx, *jp, H, causal)
    tx, tp, _ = _torch_args(a, dtype)
    port = TFB.layer_fullblock_fwd_save_plain(tx, *tp, H, causal)
    return [_np(t) for t in (y, y1, qkv, h)], [_np(t) for t in port]


def _dx_pair(a, causal, dtype):
    jx, jp, jg = _jax_args(a, dtype)
    _, vjp = jax.vjp(lambda x: JFB.layer_fullblock(x, *jp, H, causal), jx)
    (dx_jax,) = vjp(jg)
    tx, tp, tg = _torch_args(a, dtype)
    tx.requires_grad_(True)
    y = TFB.layer_fullblock(tx, *tp, H, causal)
    (dx_port,) = torch.autograd.grad(y, tx, tg)
    return _np(dx_jax), _np(dx_port)


def _assert_bf16_close(got, ref, what):
    err = np.abs(got - ref)
    assert err.max() <= BF16_MAX * np.abs(ref).max(), (what, err.max(), np.abs(ref).max())
    assert np.linalg.norm(err) <= BF16_NORM * np.linalg.norm(ref), what


@pytest.mark.parametrize("causal", MASKS, ids=MASK_IDS)
def test_fwd_save_fp32_matches_pallas(causal):
    jax_out, port_out = _forward_pair(_arrays(0), causal, torch.float32)
    for name, j, t in zip(("y", "y1", "qkv", "h"), jax_out, port_out):
        np.testing.assert_allclose(t, j, rtol=2e-5, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("causal", MASKS, ids=MASK_IDS)
def test_fwd_save_bf16_matches_pallas(causal):
    jax_out, port_out = _forward_pair(_arrays(1), causal, torch.bfloat16)
    for name, j, t in zip(("y", "y1", "qkv", "h"), jax_out, port_out):
        _assert_bf16_close(t, j, name)


@pytest.mark.parametrize("causal", MASKS, ids=MASK_IDS)
def test_dx_fp32_matches_pallas(causal):
    dx_jax, dx_port = _dx_pair(_arrays(2), causal, torch.float32)
    np.testing.assert_allclose(dx_port, dx_jax, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal", MASKS, ids=MASK_IDS)
def test_dx_bf16_matches_pallas(causal):
    dx_jax, dx_port = _dx_pair(_arrays(3), causal, torch.bfloat16)
    _assert_bf16_close(dx_port, dx_jax, "dx")


@pytest.mark.parametrize("causal", MASKS, ids=MASK_IDS)
def test_dx_fp32_matches_autograd_of_plain_forward(causal):
    a = _arrays(4)
    tx, tp, tg = _torch_args(a, torch.float32)
    tx.requires_grad_(True)
    (dx_fn,) = torch.autograd.grad(TFB.layer_fullblock(tx, *tp, H, causal), tx, tg)
    (dx_ag,) = torch.autograd.grad(TFB.layer_fullblock_plain(tx, *tp, H, causal), tx, tg)
    np.testing.assert_allclose(dx_fn.numpy(), dx_ag.numpy(), rtol=1e-4, atol=1e-4)


def test_weights_that_need_grad_are_refused():
    a = _arrays(5)
    tx, tp, _ = _torch_args(a, torch.float32)
    tx.requires_grad_(True)
    tp[2].requires_grad_(True)
    with pytest.raises(ValueError, match="must not require grad"):
        TFB.layer_fullblock(tx, *tp, H, False)


def test_layer_norm_bwd_matches_pallas_piece():
    rng = np.random.RandomState(6)
    x = rng.randn(B * S, D).astype(np.float32) * 2 + 0.5
    dxn = rng.randn(B * S, D).astype(np.float32)
    r = rng.randn(B * S, D).astype(np.float32)
    s = (rng.rand(D) + 0.5).astype(np.float32)
    _, xhat, inv = JFB._ln_fp32(jnp.asarray(x), jnp.asarray(s), jnp.zeros(D))
    j = np.asarray(JFB._ln_bwd_dx(jnp.asarray(dxn), xhat, inv, jnp.asarray(s)))
    t = TFB.layer_norm_bwd_plain(*(torch.from_numpy(v) for v in (dxn, x, s)))
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-5)
    t = TFB.layer_norm_bwd_plain(*(torch.from_numpy(v) for v in (dxn, x, s, r)))
    np.testing.assert_allclose(t.numpy(), j + r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_tower_layer_norm_dx_matches_jax_autodiff(dtype):
    """A tower LayerNorm on an input that needs a gradient goes through
    ``LayerNormFn`` (on CPU tensors: the plain versions of layernorm_fwd and
    layernorm_bwd, no residual); its y and dx against XLA's autodiff of the
    JAX package's ``layers.layer_norm``."""
    from mudpt_tpu.models import layers as JL

    from mudpt_torch.models import layers as TL

    rng = np.random.RandomState(8)
    x = (rng.randn(B, S, D) * 2 + 0.5).astype(np.float32)
    g = rng.randn(B, S, D).astype(np.float32)
    p = {"scale": (rng.rand(D) + 0.5).astype(np.float32),
         "bias": (rng.randn(D) * 0.1).astype(np.float32)}
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    y_jax, vjp = jax.vjp(lambda v: JL.layer_norm(jp, v), jnp.asarray(x, jdt))
    (dx_jax,) = vjp(jnp.asarray(g, jdt))
    tx = torch.from_numpy(x).to(dtype).requires_grad_(True)
    y = TL.layer_norm({k: torch.from_numpy(v) for k, v in p.items()}, tx)
    assert type(y.grad_fn).__name__ == "LayerNormFnBackward"
    (dx,) = torch.autograd.grad(y, tx, torch.from_numpy(g).to(dtype))
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(y.detach()), _np(y_jax), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(_np(dx), _np(dx_jax), rtol=1e-4, atol=1e-4)
    else:
        _assert_bf16_close(_np(y.detach()), _np(y_jax), "y")
        _assert_bf16_close(_np(dx), _np(dx_jax), "dx")


def test_gelu_bwd_epilogue_matches_pallas_piece():
    rng = np.random.RandomState(7)
    a = rng.randn(B * S, D).astype(np.float32)
    w = (rng.randn(4 * D, D) * 0.1).astype(np.float32)  # (N, K): read transposed
    h = (rng.randn(B * S, 4 * D) * 3).astype(np.float32)
    ref = (a @ w.T) * np.asarray(JFB._quick_gelu_grad(jnp.asarray(h)))
    got = TFB.gemm_epilogue_plain(torch.from_numpy(a), torch.from_numpy(w), None,
                                  "gelu_bwd", torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
