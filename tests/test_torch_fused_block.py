"""The port's ``layer_fullblock`` (plain PyTorch version, CPU) against the
JAX package's Pallas ``layer_fullblock`` in interpret mode, on the same
numpy-seeded weights and inputs, for every mask spec; and the port's plain
layers against the JAX package's XLA layers."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mudpt_tpu.models import layers as JL
from mudpt_tpu.ops import fused_block as JFB

from mudpt_torch.models import layers as TL
from mudpt_torch.ops import fused_block as TFB

D, S, H, B = 64, 40, 2, 3
MASKS = [False, True, (8, 8), (8, 6)]
MASK_IDS = ["none", "causal", "packed8_8", "packed8_6"]
NAMES = ("ln1_s", "ln1_b", "qkv_w", "qkv_b", "out_w", "out_b",
         "ln2_s", "ln2_b", "fc_w", "fc_b", "proj_w", "proj_b")


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
        "ln1_s": (rng.rand(D) + 0.5).astype(np.float32), "ln1_b": mk(D),
        "qkv_w": mk(D, 3 * D), "qkv_b": mk(3 * D), "out_w": mk(D, D), "out_b": mk(D),
        "ln2_s": (rng.rand(D) + 0.5).astype(np.float32), "ln2_b": mk(D),
        "fc_w": mk(D, 4 * D), "fc_b": mk(4 * D), "proj_w": mk(4 * D, D), "proj_b": mk(D),
    }


def _is_ln(name):
    return name.startswith("ln")


def _run_both(a, causal, dtype):
    """JAX Pallas layer (interpret) and the port's plain layer on the same
    arrays; activations and matmul weights in ``dtype``, LayerNorm fp32."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx = jnp.asarray(a["x"], jdt)
    jp = [jnp.asarray(a[n], jnp.float32 if _is_ln(n) else jdt) for n in NAMES]
    y_jax = JFB.layer_fullblock(jx, *jp, H, causal)
    tx = torch.from_numpy(a["x"]).to(dtype)
    tp = [torch.from_numpy(a[n]).to(torch.float32 if _is_ln(n) else dtype) for n in NAMES]
    y_port = TFB.layer_fullblock_plain(tx, *tp, H, causal)
    return np.asarray(y_jax.astype(jnp.float32)), y_port.float().numpy()


@pytest.mark.parametrize("causal", MASKS, ids=MASK_IDS)
def test_layer_fullblock_fp32_matches_pallas(causal):
    y_jax, y_port = _run_both(_arrays(0), causal, torch.float32)
    np.testing.assert_allclose(y_port, y_jax, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", MASKS, ids=MASK_IDS)
def test_layer_fullblock_bf16_matches_pallas(causal):
    """Same bf16 rounding points in the code, but the order of the fp32
    sums differs, and XLA's CPU compiler may keep a fused bf16
    intermediate in fp32 (excess precision), so a rounding can move by one
    bf16 ulp at an intermediate.  Bound: 4 ulps of the largest output
    (2**-5 of it), and a relative norm error below the bf16 unit roundoff
    (2**-8)."""
    y_jax, y_port = _run_both(_arrays(1), causal, torch.bfloat16)
    err = np.abs(y_port - y_jax)
    assert err.max() <= 2.0 ** -5 * np.abs(y_jax).max(), err.max()
    assert np.linalg.norm(err) <= 2.0 ** -8 * np.linalg.norm(y_jax)


def test_wrappers_take_plain_version_on_cpu():
    a = _arrays(2)
    tx = torch.from_numpy(a["x"])
    tp = [torch.from_numpy(a[n]) for n in NAMES]
    TFB.reset_launches()
    y = TFB.layer_fullblock(tx, *tp, H, (8, 6))
    assert torch.equal(y, TFB.layer_fullblock_plain(tx, *tp, H, (8, 6)))
    assert all(v == 0 for v in TFB.LAUNCHES.values()), TFB.LAUNCHES


@pytest.mark.parametrize("causal", [False, True], ids=["none", "causal"])
def test_plain_attention_and_mlp_match_xla_layers(causal):
    from mudpt_tpu.models.text import causal_mask

    a = _arrays(3)
    h = a["x"]
    jattn = {"qkv_w": a["qkv_w"], "qkv_b": a["qkv_b"], "out_w": a["out_w"], "out_b": a["out_b"]}
    jmlp = {"fc_w": a["fc_w"], "fc_b": a["fc_b"], "proj_w": a["proj_w"], "proj_b": a["proj_b"]}
    jmask = causal_mask(S) if causal else None
    ja = JL.attention({k: jnp.asarray(v) for k, v in jattn.items()}, jnp.asarray(h), H, jmask)
    jm = JL.mlp({k: jnp.asarray(v) for k, v in jmlp.items()}, jnp.asarray(h))
    tmask = torch.tensor(np.asarray(jmask)) if causal else None
    ta = TL.attention({k: torch.from_numpy(v) for k, v in jattn.items()},
                      torch.from_numpy(h), H, tmask)
    tm = TL.mlp({k: torch.from_numpy(v) for k, v in jmlp.items()}, torch.from_numpy(h))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=2e-5, atol=2e-5)


def test_layer_norm_matches_xla():
    a = _arrays(4)
    p = {"scale": a["ln1_s"], "bias": a["ln1_b"]}
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        j = JL.layer_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(a["x"], jdt))
        t = TL.layer_norm({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(a["x"]).to(dt))
        # bf16: one rounding of the same fp32 value, so at most 1 ulp apart
        tol = 2e-5 if dt == torch.float32 else 2.0 ** -7
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j.astype(jnp.float32)),
                                   rtol=tol, atol=tol)
