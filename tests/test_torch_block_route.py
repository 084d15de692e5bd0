"""The XLA block route of ``models/layers.py`` against the JAX package's
``set_block_impl('xla')`` blocks and towers at tiny size: one block under
every mask (fp32 within 1e-5 of the largest value, bf16 within the drift
bound of ``test_torch_serving.py``), both towers, LN 'bf16', the routes
JAX takes without being asked (a tower wider than 1024, an additive mask
that is not causal), the quant modes refusing the XLA route as JAX's do,
the text tower unpacked there, and the four PERF knobs accepted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudpt_tpu.config import load_config as jload_config
from mudpt_tpu.config.perf import apply_perf_config as japply
from mudpt_tpu.models import layers as JL
from mudpt_tpu.models import text as JT
from mudpt_tpu.models import transformer as JTR
from mudpt_tpu.models.clip import encode_image as jencode_image
from mudpt_tpu.models.clip import encode_text as jencode_text
from mudpt_tpu.models.clip import init_clip_params as jinit
from mudpt_tpu.trainers.base import TINY_TEST as JTINY
from mudpt_tpu.utils.rng import new_rng

from mudpt_torch.config import load_config, perf_snapshot
from mudpt_torch.config.perf import apply_perf_config
from mudpt_torch.models import layers as TL
from mudpt_torch.models import text as TT
from mudpt_torch.models import transformer as TTR
from mudpt_torch.models.clip import TINY_TEST, encode_image, encode_text
from mudpt_torch.models.convert import params_from_numpy

D, S, H, B = 64, 16, 4, 3
BLOCKS = ("ln_1", "attn", "ln_2", "mlp")
FP32 = 1e-5   # of the largest value: the packages' fp32 sums run in another order
DRIFT = 0.03  # bf16: of the largest magnitude (tests/test_torch_serving.py)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def xla():
    """Both packages on their XLA blocks; 'auto' and fp32 LayerNorms after."""
    JL.set_block_impl("xla")
    TL.set_block_impl("xla")
    yield
    for m in (JL, TL):
        m.set_block_impl("auto")
        m.set_ln_dtype("fp32")


def _block(seed, d=D):
    rng = np.random.RandomState(seed)
    mk = lambda *shape: (rng.randn(*shape) * 0.05).astype(np.float32)  # noqa: E731
    ln = lambda: {"scale": (rng.rand(d) + 0.5).astype(np.float32), "bias": mk(d)}  # noqa: E731
    return {"ln_1": ln(), "ln_2": ln(),
            "attn": {"qkv_w": mk(d, 3 * d), "qkv_b": mk(3 * d), "out_w": mk(d, d), "out_b": mk(d)},
            "mlp": {"fc_w": mk(d, 4 * d), "fc_b": mk(4 * d), "proj_w": mk(4 * d, d),
                    "proj_b": mk(d)}}


def _jblock(a, dtype=jnp.float32):
    return {k: {n: jnp.asarray(v, jnp.float32 if k.startswith("ln") else dtype)
                for n, v in a[k].items()} for k in BLOCKS}


def _tblock(a, dtype=torch.float32):
    return {k: {n: torch.from_numpy(v).to(torch.float32 if k.startswith("ln") else dtype)
                for n, v in a[k].items()} for k in BLOCKS}


def jax_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), np.abs(got - want).max()


# the port's mask spec, and the additive mask JAX's XLA route takes with it
MASKS = {"none": (False, None), "causal": (True, np.triu(np.full((S, S), -np.inf), 1)),
         "packed8_8": ((8, 8), None), "packed8_6": ((8, 6), None)}


def _jmask(name):
    causal, mask = MASKS[name]
    if isinstance(causal, tuple):
        mask = np.asarray(JT.packed_causal_mask(S, *causal))
    return causal, (None if mask is None else jnp.asarray(mask, jnp.float32))


@pytest.mark.parametrize("name", list(MASKS))
def test_xla_block_matches_jax(xla, name):
    a = _block(1)
    x = np.random.RandomState(2).randn(B, S, D).astype(np.float32)
    causal, jmask = _jmask(name)
    want = JL.residual_block(_jblock(a), jnp.asarray(x), H, jmask, causal)
    got = TL.residual_block(_tblock(a), torch.from_numpy(x), H, causal)
    _close(got, want, FP32)
    # bf16 activations and weights on both sides
    want16 = JL.residual_block(_jblock(a, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16), H,
                               jmask, causal).astype(jnp.float32)
    got16 = TL.residual_block(_tblock(a, torch.bfloat16), torch.from_numpy(x).bfloat16(), H,
                              causal).float()
    _close(got16, want16, DRIFT)


def test_additive_mask_not_causal_takes_the_xla_route():
    """Under 'auto' the kernel route runs, except for an additive mask that
    is not causal, which both packages run on XLA (``layers.py:249``)."""
    a = _block(3)
    x = np.random.RandomState(4).randn(B, S, D).astype(np.float32)
    m = np.random.RandomState(5).randn(S, S).astype(np.float32)
    JL.set_block_impl("pallas")
    try:
        want = JL.residual_block(_jblock(a), jnp.asarray(x), H, jnp.asarray(m), False)
    finally:
        JL.set_block_impl("auto")
    xt = torch.from_numpy(x).requires_grad_(True)
    got = TL.residual_block(_tblock(a), xt, H, False, mask=torch.from_numpy(m))
    assert "Halfblock" not in type(got.grad_fn).__name__
    assert "Fullblock" not in type(got.grad_fn).__name__
    _close(got.detach(), want, FP32)


@pytest.mark.parametrize("ln", ["fp32", "bf16"])
def test_xla_towers_match_jax(xla, ln):
    """Both towers under the XLA blocks, with deep prompts, fp32; under LN
    'bf16' the towers' and blocks' LayerNorms normalize in the input dtype
    in both packages (in fp32 activations the same formula)."""
    JL.set_ln_dtype(ln)
    TL.set_ln_dtype(ln)
    jp = jinit(new_rng(0), JTINY)
    tp = params_from_numpy(jax_np(jp), "cpu")
    rng = np.random.RandomState(6)
    images = rng.randn(2, 32, 32, 3).astype(np.float32)
    deep_v = rng.randn(2, 2, JTINY.vision_width).astype(np.float32) * 0.1
    want = jencode_image(jp, jnp.asarray(images), JTINY, deep_prompts=jnp.asarray(deep_v))
    with torch.no_grad():
        got = encode_image(tp, torch.from_numpy(images), TINY_TEST,
                           deep_prompts=torch.from_numpy(deep_v))
    _close(got, want, FP32)
    tokens = rng.randint(1, 400, (5, 16)).astype(np.int32)
    tokens[:, 9] = 49407  # the EOT id: the argmax of each row
    want = jencode_text(jp, jnp.asarray(tokens), JTINY)
    with torch.no_grad():
        got = encode_text(tp, torch.from_numpy(tokens), TINY_TEST)
    _close(got, want, FP32)


def test_ln_bf16_block_tracks_jax(xla):
    """LN 'bf16' with bf16 activations: both packages normalize in bf16,
    within the drift bound."""
    JL.set_ln_dtype("bf16")
    TL.set_ln_dtype("bf16")
    a = _block(7)
    x = np.random.RandomState(8).randn(B, S, D).astype(np.float32)
    want = JL.residual_block(_jblock(a, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16), H)
    got = TL.residual_block(_tblock(a, torch.bfloat16), torch.from_numpy(x).bfloat16(), H)
    _close(got.float(), want.astype(jnp.float32), DRIFT)
    # and it is not the fp32 LayerNorm
    TL.set_ln_dtype("fp32")
    fp32_ln = TL.residual_block(_tblock(a, torch.bfloat16), torch.from_numpy(x).bfloat16(), H)
    assert not torch.equal(fp32_ln, got)


def test_wide_block_routes_to_xla_on_cpu():
    """D = 1280 (20 heads), wider than the kernel chains take: 'auto' runs
    the XLA route, forward and backward, the same block as 'xla'."""
    a = _block(9, 1280)
    x = np.random.RandomState(10).randn(2, 8, 1280).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = TL.residual_block(_tblock(a), xt, 20)
    assert type(y.grad_fn).__name__ == "AddBackward0"
    y.sum().backward()
    TL.set_block_impl("xla")
    try:
        xr = torch.from_numpy(x).requires_grad_(True)
        yr = TL.residual_block(_tblock(a), xr, 20)
        yr.sum().backward()
    finally:
        TL.set_block_impl("auto")
    assert torch.equal(y, yr) and torch.equal(xt.grad, xr.grad)


def test_quant_modes_refuse_the_xla_route():
    """The int8 tiers exist only as the kernel chains: under block impl
    'xla' a quant mode raises in both packages, and the XLA route of a
    wide tower raises too, rather than serve unquantized blocks."""
    a = _block(11)
    x = np.random.RandomState(12).randn(B, S, D).astype(np.float32)
    for m in (JL, TL):
        m.set_block_impl("xla")
        m.set_quant_mode("int8")
    try:
        with pytest.raises(ValueError, match="impl='xla'"):
            JL.residual_block(_jblock(a), jnp.asarray(x), H)
        with pytest.raises(ValueError, match="impl='xla'"):
            TL.residual_block(_tblock(a), torch.from_numpy(x), H)
        TL.set_block_impl("auto")
        with pytest.raises(ValueError, match="D=1280"):
            TL.residual_block(_tblock(_block(13, 1280)), torch.zeros(1, 4, 1280), 20)
    finally:
        for m in (JL, TL):
            m.set_quant_mode("none")
            m.set_block_impl("auto")


def test_text_tower_unpacked_on_the_xla_route(monkeypatch):
    """JAX packs text rows only on the kernel route (``text._resolve_pack``
    :78-93); under 'xla' the port's tower runs unpacked too."""
    periods = []
    forward = TT.transformer_forward

    def spy(*args, **kwargs):
        periods.append(kwargs.get("splice_period", 0))
        return forward(*args, **kwargs)

    monkeypatch.setattr(TT, "transformer_forward", spy)
    jp = jinit(new_rng(0), JTINY)
    tp = params_from_numpy(jax_np(jp), "cpu")
    x = torch.randn(16, S, JTINY.transformer_width)
    eot = torch.full((16,), S - 1)
    with torch.no_grad():
        TT.text_forward(tp["text"], x, eot, n_head=8)
        TL.set_block_impl("xla")
        try:
            TT.text_forward(tp["text"], x, eot, n_head=8)
        finally:
            TL.set_block_impl("auto")
    assert periods == [S, 0]
    JL.set_block_impl("xla")
    try:
        assert JT._resolve_pack(16, 2, S) == 1
    finally:
        JL.set_block_impl("auto")


def test_perf_knobs_accepted_as_in_jax():
    """PERF.BLOCK, LN, SCAN_UNROLL and REMAT reach both packages' modules
    and their snapshots agree on them."""
    opts = ["PERF.BLOCK", "xla", "PERF.LN", "bf16", "PERF.SCAN_UNROLL", "4",
            "PERF.REMAT", "selective"]
    keys = ("BLOCK", "BLOCK_RESOLVED", "LN", "SCAN_UNROLL", "REMAT", "QUANT")
    reset = ["PERF.BLOCK", "auto", "PERF.LN", "fp32", "PERF.SCAN_UNROLL", "auto",
             "PERF.REMAT", "none"]
    try:
        jsnap = japply(jload_config(opts=opts).PERF)
        tsnap = apply_perf_config(load_config(opts=opts).PERF)
        assert {k: str(jsnap[k]) for k in keys} == {k: str(tsnap[k]) for k in keys}
        assert tsnap == perf_snapshot()
        assert TTR.remat_mode() == "selective" and TTR.resolve_unroll() == 4
    finally:
        japply(jload_config(opts=reset).PERF)
        apply_perf_config(load_config(opts=reset).PERF)
    assert JTR._REMAT_MODE == "none" and TL.block_impl() == "auto" and TL.ln_dtype() == "fp32"
    with pytest.raises(ValueError, match="block impl"):
        TL.set_block_impl("mosaic")
    with pytest.raises(ValueError, match="LN dtype"):
        TL.set_ln_dtype("fp16")
