"""Primitive layers as plain functions over parameter dicts (counterpart of
``mudpt_tpu/models/layers.py``).

LayerNorm computes in float32 and casts back to the input dtype; QuickGELU
is ``x * sigmoid(1.702 x)``; weights use the ``(in, out)`` layout.

:func:`residual_block` is the dispatch of ``layers.py:209-285``: the whole
layer (``layer_fullblock``) or its two halves (``attn_halfblock``,
``mlp_halfblock``) as the JAX package picks them; a CUDA tensor goes to
their hand-written kernels (the saving forward and the kernel backward when
x needs a gradient), a CPU tensor to the kernels' plain versions.  A CUDA
tensor the kernels cannot take raises; it never quietly runs the plain
body.  :func:`plain_blocks` lets a reference run ask for the plain versions
on the card explicitly.

Under a quant mode (:func:`set_quant_mode`, :func:`quantized`) every block
runs an int8 tier of ``ops/quant_block.py`` instead (``layers.py:182-248``).
:func:`calibration_capture` selects a plain unquantized route, ``x +
attention(LN x) + mlp(LN x)`` with an additive mask, whose four quant sites
record their absmax (``layers.py:28-53``, which forces the XLA blocks).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from mudpt_torch.ops import fused_block, quant_block

_PLAIN_ON_CUDA = False

# The activation-absmax sink of calibration_capture: while installed, the
# plain route's attention and mlp record the absmax of their four quant
# sites (LN1 output, MHA output, LN2 output, post-GELU), 4 values a block
_CALIB_SINK: Optional[list] = None

# 'none' | 'int8' | 'int8_static' | 'int8_ste' | 'int8_ste_static' (the JAX
# package's quant modes, layers.py:182-206, without MUDPT_TPU_QUANT)
QUANT_MODES = ("none", "int8", "int8_static", "int8_ste", "int8_ste_static")
_QUANT_MODE = "none"


def set_quant_mode(name: str) -> None:
    """'int8': every block's projections s8 x s8 -> s32 with dynamic per-row
    activation scales, serving only (a backward raises).  'int8_static':
    blocks with a ``q8_scales`` leaf quantize activations by calibrated
    per-tensor scales, the others fall back to 'int8'.  'int8_ste' /
    'int8_ste_static': the same forwards with a straight-through backward
    (quantization-aware prompt tuning)."""
    if name not in QUANT_MODES:
        raise ValueError(f"quant mode {name!r}: expected one of {QUANT_MODES}")
    global _QUANT_MODE
    _QUANT_MODE = name


def quant_mode() -> str:
    return _QUANT_MODE


@contextlib.contextmanager
def quantized(name: str):
    """The quant mode inside the context, the previous one after it."""
    prev = _QUANT_MODE
    set_quant_mode(name)
    try:
        yield
    finally:
        set_quant_mode(prev)


@contextlib.contextmanager
def calibration_capture(sink: list):
    """Install an activation-absmax sink; every block takes the plain
    unquantized route and every LayerNorm its plain version meanwhile, on
    either device (``layers.py:37-48``: the JAX capture forces XLA blocks)."""
    global _CALIB_SINK, _QUANT_MODE, _PLAIN_ON_CUDA
    prev = (_CALIB_SINK, _QUANT_MODE, _PLAIN_ON_CUDA)
    _CALIB_SINK, _QUANT_MODE, _PLAIN_ON_CUDA = sink, "none", True
    try:
        yield
    finally:
        _CALIB_SINK, _QUANT_MODE, _PLAIN_ON_CUDA = prev


def calibrating() -> bool:
    return _CALIB_SINK is not None


def _calib_record(x: torch.Tensor) -> None:
    if _CALIB_SINK is not None:
        _CALIB_SINK.append(x.float().abs().amax())


def routes() -> tuple:
    """The process-global routing state the blocks read at forward time:
    (plain versions on the card, quant mode).  A recompute that runs after
    its caller's contexts have closed (``torch.utils.checkpoint``) enters
    :func:`routed` with this snapshot to take the forward's route."""
    return _PLAIN_ON_CUDA, _QUANT_MODE


@contextlib.contextmanager
def routed(state: tuple):
    """The routing state of :func:`routes` inside the context, the previous
    one after it."""
    global _PLAIN_ON_CUDA, _QUANT_MODE
    prev = (_PLAIN_ON_CUDA, _QUANT_MODE)
    _PLAIN_ON_CUDA, _QUANT_MODE = state
    try:
        yield
    finally:
        _PLAIN_ON_CUDA, _QUANT_MODE = prev


@contextlib.contextmanager
def plain_blocks():
    """Run every residual block and tower LayerNorm through the plain
    versions on any device while the context is open (the layer's saving
    forward and backward too): the reference that the kernels are held
    against on the card."""
    global _PLAIN_ON_CUDA
    prev, _PLAIN_ON_CUDA = _PLAIN_ON_CUDA, True
    try:
        yield
    finally:
        _PLAIN_ON_CUDA = prev


def _require_bf16(x: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"{x.dtype} activations on CUDA need kernels of that type "
            "(ROADMAP.md B, 'fp32 activations'); the port's kernels take "
            "bfloat16"
        )


class LayerNormFn(torch.autograd.Function):
    """A tower LayerNorm whose input needs a gradient: ``layernorm_fwd``
    forward, ``layernorm_bwd`` backward (no residual, the bf16 upstream
    gradient as dxn), dx only (JAX: XLA's autodiff of ``layer_norm``
    :67-80, with scale and bias frozen)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            raise ValueError("LayerNormFn returns dx only: scale and bias must not require grad")
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return fused_block.layer_norm_fwd(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        return fused_block.layer_norm_bwd(g.contiguous(), x, scale, None, ctx.eps), None, None, None


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """fp32 statistics, cast back to x's dtype; on the card through the
    ``layernorm_fwd`` kernel and, when x needs a gradient, ``layernorm_bwd``
    (bf16 activations only)."""
    if _PLAIN_ON_CUDA:
        return fused_block.layer_norm_plain(x, p["scale"], p["bias"], eps)
    if x.is_cuda:
        _require_bf16(x)
    x = x.contiguous()
    if torch.is_grad_enabled() and x.requires_grad:
        return LayerNormFn.apply(x, p["scale"], p["bias"], eps)
    return fused_block.layer_norm_fwd(x, p["scale"], p["bias"], eps)


def layer_norm_trainable(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """A LayerNorm whose scale and bias train: ``F.layer_norm`` on autograd
    with the fp32 statistics and affine of ``layers.py:67-80``, cast back to
    x's dtype, on any device (JAX runs it on XLA's autodiff).  Only the
    trained prompt heads take it (:func:`residual_block_trainable`,
    ``trainers/prompt_utils.prompt_transform_head``); a frozen tower's
    LayerNorm is :func:`layer_norm`."""
    y = torch.nn.functional.layer_norm(x.float(), x.shape[-1:], p["scale"].float(),
                                       p["bias"].float(), eps)
    return y.to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, p["w"].to(x.dtype)) + p["b"].to(x.dtype)


def attention(p: dict, x: torch.Tensor, n_head: int,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain multi-head self-attention, (B, S, D) -> (B, S, D), with an
    optional additive (S, S) mask (``layers.py:91-128``)."""
    B, S, D = x.shape
    hd = D // n_head
    _calib_record(x)  # site 1: the qkv product's input (LN1 output)
    qkv = torch.matmul(x, p["qkv_w"].to(x.dtype)) + p["qkv_b"].to(x.dtype)
    q, k, v = qkv.reshape(B, S, 3, n_head, hd).permute(2, 0, 3, 1, 4)  # (B, H, S, hd)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.matmul(probs, v).permute(0, 2, 1, 3).reshape(B, S, D)
    _calib_record(out)  # site 2: the out-projection's input (MHA output)
    return torch.matmul(out, p["out_w"].to(x.dtype)) + p["out_b"].to(x.dtype)


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``layers.py:131-136``."""
    _calib_record(x)  # site 3: the fc product's input (LN2 output)
    h = quick_gelu(torch.matmul(x, p["fc_w"].to(x.dtype)) + p["fc_b"].to(x.dtype))
    _calib_record(h)  # site 4: the proj product's input (post-GELU)
    return torch.matmul(h, p["proj_w"].to(x.dtype)) + p["proj_b"].to(x.dtype)


def _additive_mask(S: int, causal: fused_block.Causal, device) -> Optional[torch.Tensor]:
    """The XLA route's (S, S) mask: none; causal, -inf above the diagonal
    (``text.causal_mask``); packed ``(period, valid)``, -1e30 outside each
    block's causal window and at pad keys (``fused_block._causal_mask``)."""
    if causal is False:
        return None
    row = torch.arange(S, device=device)[:, None]
    col = torch.arange(S, device=device)[None, :]
    if causal is True:
        return torch.where(col > row, float("-inf"), 0.0)
    period, valid = causal
    ok = (col <= row) & (row // period == col // period) & (col % period < valid)
    return torch.where(ok, 0.0, fused_block.NEG)


def _plain_route(p: dict, x: torch.Tensor, n_head: int,
                 causal: fused_block.Causal) -> torch.Tensor:
    """``x + attention(LN x)``, then ``+ mlp(LN x)`` (``layers.py:283-285``)."""
    mask = _additive_mask(x.shape[1], causal, x.device)
    x = x + attention(p["attn"], layer_norm(p["ln_1"], x), n_head, mask)
    return x + mlp(p["mlp"], layer_norm(p["ln_2"], x))


def _valid_mask_spec(causal) -> bool:
    if isinstance(causal, bool):
        return True
    return (isinstance(causal, tuple) and len(causal) == 2
            and all(isinstance(v, int) for v in causal))


def _quant_block(p: dict, x: torch.Tensor, n_head: int, causal) -> torch.Tensor:
    """The quant dispatch (``layers.py:218-248``): the int8 tiers exist only
    as the q8 chains, so an unsupported mask or width raises rather than
    serve an unquantized block the caller did not ask for."""
    D = x.shape[-1]
    if not (_valid_mask_spec(causal) and D <= fused_block.MAX_WIDTH):
        raise ValueError(
            f"quant mode {_QUANT_MODE!r} requires the q8 layer chains (causal or "
            f"unmasked attention, width <= {fused_block.MAX_WIDTH}; got mask spec "
            f"{causal!r}, D={D}); set_quant_mode('none')"
        )
    if x.is_cuda and not _PLAIN_ON_CUDA:
        _require_bf16(x)
    plain = _PLAIN_ON_CUDA
    if _QUANT_MODE in ("int8_ste", "int8_ste_static"):
        return quant_block.residual_block_q8_ste(p, x, n_head, causal, plain)
    if _QUANT_MODE == "int8_static" and "q8_scales" in p:
        return quant_block.residual_block_q8_static(p, x, n_head, causal, plain)
    # 'int8', or 'int8_static' on a tower without calibrated scales
    return quant_block.residual_block_q8(p, x, n_head, causal, plain)


def residual_block(p: dict, x: torch.Tensor, n_head: int,
                   causal: fused_block.Causal = False) -> torch.Tensor:
    """One pre-LN residual block (mask spec ``causal``: False, True or
    ``(period, valid)``), routed as ``layers.py:249-282`` routes it on
    either device: ``layer_fullblock`` while saves are on and D <= 768,
    else ``attn_halfblock`` then ``mlp_halfblock``.  Wider than 1024 the
    JAX package falls back to XLA, which the port does not have: it raises.
    Under a quant mode the int8 tiers run instead; under
    :func:`calibration_capture` the plain route."""
    if _CALIB_SINK is not None:
        return _plain_route(p, x, n_head, causal)
    if _QUANT_MODE != "none":
        return _quant_block(p, x, n_head, causal)
    D = x.shape[-1]
    if D > fused_block.MAX_WIDTH:
        raise NotImplementedError(
            f"width {D} > {fused_block.MAX_WIDTH}: the JAX package runs its XLA layer "
            "there (models/layers.py:283-284, no Pallas kernel); the port has no such "
            "route yet (ROADMAP.md A, 'the XLA block route')"
        )
    if x.is_cuda and not _PLAIN_ON_CUDA:
        _require_bf16(x)
    plain = _PLAIN_ON_CUDA
    ln_1, attn, ln_2, mlp_p = p["ln_1"], p["attn"], p["ln_2"], p["mlp"]
    if fused_block.save_acts_enabled() and D <= fused_block.FULLBLOCK_MAX_WIDTH:
        return fused_block.layer_fullblock(
            x, ln_1["scale"], ln_1["bias"], attn["qkv_w"], attn["qkv_b"],
            attn["out_w"], attn["out_b"], ln_2["scale"], ln_2["bias"],
            mlp_p["fc_w"], mlp_p["fc_b"], mlp_p["proj_w"], mlp_p["proj_b"],
            n_head, causal, plain=plain)
    x = fused_block.attn_halfblock(
        x, ln_1["scale"], ln_1["bias"], attn["qkv_w"], attn["qkv_b"],
        attn["out_w"], attn["out_b"], n_head, causal, plain=plain)
    return fused_block.mlp_halfblock(
        x, ln_2["scale"], ln_2["bias"], mlp_p["fc_w"], mlp_p["fc_b"],
        mlp_p["proj_w"], mlp_p["proj_b"], plain=plain)


def residual_block_trainable(p: dict, x: torch.Tensor, n_head: int,
                             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A pre-LN residual block whose weights receive gradients
    (``layers.py:288-300``): plain autograd ops on any device and dtype,
    never the dx-only kernel chains, which raise when a weight requires
    grad.  JAX runs this block on XLA's autodiff, not on Pallas.  Only the
    UMuDPT/UUMuDPT prompt heads' LightTransformer takes it."""
    x = x + attention(p["attn"], layer_norm_trainable(p["ln_1"], x), n_head, mask)
    return x + mlp(p["mlp"], layer_norm_trainable(p["ln_2"], x))
