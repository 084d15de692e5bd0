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
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from mudpt_torch.ops import fused_block

_PLAIN_ON_CUDA = False


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
            "(ROADMAP.md queue A, 'fp32 compute on the card'); the port's "
            "kernels take bfloat16"
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
    qkv = torch.matmul(x, p["qkv_w"].to(x.dtype)) + p["qkv_b"].to(x.dtype)
    q, k, v = qkv.reshape(B, S, 3, n_head, hd).permute(2, 0, 3, 1, 4)  # (B, H, S, hd)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.matmul(probs, v).permute(0, 2, 1, 3).reshape(B, S, D)
    return torch.matmul(out, p["out_w"].to(x.dtype)) + p["out_b"].to(x.dtype)


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``layers.py:131-136``."""
    h = quick_gelu(torch.matmul(x, p["fc_w"].to(x.dtype)) + p["fc_b"].to(x.dtype))
    return torch.matmul(h, p["proj_w"].to(x.dtype)) + p["proj_b"].to(x.dtype)


def residual_block(p: dict, x: torch.Tensor, n_head: int,
                   causal: fused_block.Causal = False) -> torch.Tensor:
    """One pre-LN residual block (mask spec ``causal``: False, True or
    ``(period, valid)``), routed as ``layers.py:249-282`` routes it on
    either device: ``layer_fullblock`` while saves are on and D <= 768,
    else ``attn_halfblock`` then ``mlp_halfblock``.  Wider than 1024 the
    JAX package falls back to XLA, which the port does not have: it raises."""
    D = x.shape[-1]
    if D > fused_block.MAX_WIDTH:
        raise NotImplementedError(
            f"width {D} > {fused_block.MAX_WIDTH}: the JAX package runs XLA layers "
            "there; the port has no such route (ROADMAP.md queue B item 5, "
            "mlp_halfblock_chunked)"
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
