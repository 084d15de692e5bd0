"""Sequence blocks longer than the 384 rows of the first ports, and the
ViT-L/14@336px preset: the port's attention half-block (its plain
attention, what ``attention_fwd`` is held to on the card) against the JAX
package's ``attn_halfblock`` (Pallas in interpret mode) at 579 rows, the
336px grid plus two prompt tokens, with every mask spec; the preset equal
field by field to the JAX package's; and its train step refused until
``attention_bwd`` takes such blocks."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudpt_tpu.ops import fused_block as JFB
from mudpt_tpu.trainers.base import _NAMED_CONFIGS

from mudpt_torch.ops import fused_block as TFB
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


def test_vit_l14_336px_train_step_raises_until_attention_bwd_takes_it():
    with pytest.raises(NotImplementedError, match=r"ROADMAP B\.1.*build_synth_mudpt_server"):
        synth_step.build_synth_mudpt_step("ViT-L/14@336px", 2, 3, 2, 2, device="cpu")
