"""Primitive layers as plain functions over parameter dicts (counterpart of
``mudpt_tpu/models/layers.py``).

LayerNorm computes in float32 and casts back to the input dtype; QuickGELU
is ``x * sigmoid(1.702 x)``; weights use the ``(in, out)`` layout.

:func:`residual_block` is the dispatch of ``layers.py:209-285``: a CUDA
tensor goes to the hand-written ``layer_fullblock`` kernels, a CPU tensor
to their plain version.  A CUDA tensor the kernels cannot take raises; it
never quietly runs the plain body.  :func:`plain_blocks` lets a reference
run ask for the plain body on the card explicitly.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from mudpt_torch.ops import fused_block

_PLAIN_ON_CUDA = False


@contextlib.contextmanager
def plain_blocks():
    """Run every residual block through ``layer_fullblock_plain`` on any
    device while the context is open: the reference that the kernels are
    held against on the card."""
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


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """fp32 statistics, cast back to x's dtype; on the card through the
    ``layernorm_fwd`` kernel (bf16 activations only)."""
    if not x.is_cuda or _PLAIN_ON_CUDA:
        return fused_block.layer_norm_plain(x, p["scale"], p["bias"], eps)
    _require_bf16(x)
    D = x.shape[-1]
    y = fused_block.layer_norm_fwd(x.contiguous().view(-1, D), p["scale"], p["bias"], eps)
    return y.view(x.shape)


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
    """One pre-LN residual block through ``layer_fullblock`` (mask spec
    ``causal``: False, True or ``(period, valid)``)."""
    args = (
        x,
        p["ln_1"]["scale"], p["ln_1"]["bias"],
        p["attn"]["qkv_w"], p["attn"]["qkv_b"],
        p["attn"]["out_w"], p["attn"]["out_b"],
        p["ln_2"]["scale"], p["ln_2"]["bias"],
        p["mlp"]["fc_w"], p["mlp"]["fc_b"],
        p["mlp"]["proj_w"], p["mlp"]["proj_b"],
        n_head, causal,
    )
    if not x.is_cuda or _PLAIN_ON_CUDA:
        return fused_block.layer_fullblock_plain(*args)
    D = x.shape[-1]
    if D > fused_block.MAX_WIDTH:
        raise NotImplementedError(
            f"width {D} > {fused_block.MAX_WIDTH} on CUDA needs the attention/MLP "
            "half-block kernels (ROADMAP.md queue B item 2, attn_halfblock / "
            "mlp_halfblock)"
        )
    _require_bf16(x)
    return fused_block.layer_fullblock(*args)
