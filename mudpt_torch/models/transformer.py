"""Prompt-injectable transformer over stacked per-layer weights
(counterpart of ``mudpt_tpu/models/transformer.py``, its fully-unrolled
static path :167-203).

The loop over layers is always unrolled: :func:`set_scan_unroll` takes
every value the JAX package takes, and the one thing it changes here is
JAX's refusal of packed text rows when the unroll does not cover the tower
(:205-209).  :func:`set_remat_mode` is JAX's rematerialization (:37-81):
'full' runs each layer under ``torch.utils.checkpoint``, so the backward
recomputes it from its input; 'selective' recomputes only the XLA route's
fp32 attention scores and probs, and on the kernel route, where nothing is
named, saves what 'none' saves.

Splicing semantics:
  * text layers replace positions ``1 .. 1+n_ctx`` (keeping the SOS prefix
    and the class-name suffix), at every ``splice_period`` offset when rows
    are packed;
  * visual layers replace the LAST ``n_ctx`` positions;
  * layer 0 never splices (the tower places the layer-0 prompt); prompted
    layers are ``1 .. depth-1``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from mudpt_torch.models import layers
from mudpt_torch.models.layers import residual_block

REMAT_MODES = ("none", "full", "selective")
_REMAT_MODE = "none"
# 'auto' (the whole tower unrolled) or an integer (``transformer.py:57``)
_SCAN_UNROLL = "auto"


def set_remat_mode(name: str) -> None:
    """'none' (save what the layers save), 'full' (keep each layer's input,
    recompute the layer in the backward) or 'selective' (recompute the XLA
    route's attention scores and probs) (``transformer.py:62-81``)."""
    if name not in REMAT_MODES:
        raise ValueError(f"REMAT {name!r}: expected one of {REMAT_MODES}")
    global _REMAT_MODE
    _REMAT_MODE = name


def remat_mode() -> str:
    return _REMAT_MODE


def set_scan_unroll(value) -> None:
    """'auto' or an integer unroll factor (``transformer.py:74-82``)."""
    v = str(value)
    if not (v == "auto" or v.lstrip("-").isdigit()):
        raise ValueError(f"SCAN_UNROLL {value!r}: expected 'auto' or an integer")
    global _SCAN_UNROLL
    _SCAN_UNROLL = v


def resolve_unroll() -> int:
    """The unroll factor JAX's scan would take: 64 for 'auto', enough to
    unroll every CLIP tower (``transformer.py:57-61``)."""
    return 64 if _SCAN_UNROLL == "auto" else int(_SCAN_UNROLL)


def _remat_layer(state: tuple, p: dict, x: torch.Tensor, n_head: int, causal, mask):
    # the recompute runs in the backward, after the caller's contexts have
    # closed: it re-enters the forward's routing state to take its route
    with layers.routing(state):
        return residual_block(p, x, n_head, causal, mask)


def make_injection_schedule(
    num_layers: int,
    deep_prompts: Optional[torch.Tensor],
) -> Tuple[Optional[torch.Tensor], Optional[np.ndarray]]:
    """Padded per-layer prompts (L, n_ctx, D) and a static (L,) bool mask of
    the layers that splice (``transformer.py:90-122``).  ``deep_prompts``
    (depth-1, n_ctx, D) feed layers ``1 .. depth-1``; rows deeper than the
    tower are never consumed."""
    if deep_prompts is None or deep_prompts.shape[0] == 0:
        return None, None
    depth_m1, n_ctx, dim = deep_prompts.shape
    head = deep_prompts.new_zeros((1, n_ctx, dim))
    prompts = torch.cat([head, deep_prompts], dim=0)[:num_layers]
    if prompts.shape[0] < num_layers:
        tail = deep_prompts.new_zeros((num_layers - prompts.shape[0], n_ctx, dim))
        prompts = torch.cat([prompts, tail], dim=0)
    layer_ids = np.arange(num_layers)
    mask = (layer_ids >= 1) & (layer_ids < 1 + depth_m1)
    return prompts, mask


def layer_params(stacked: dict, l: int) -> dict:
    """Layer ``l``'s parameters: a contiguous view into each stacked leaf."""
    return {k: layer_params(v, l) if isinstance(v, dict) else v[l] for k, v in stacked.items()}


def num_layers_of(stacked: dict) -> int:
    return stacked["ln_1"]["scale"].shape[0]


def transformer_forward(
    stacked_params: dict,
    x: torch.Tensor,
    *,
    n_head: int,
    mask: Optional[torch.Tensor] = None,
    prompts: Optional[torch.Tensor] = None,
    prompt_mask: Optional[np.ndarray] = None,
    n_ctx: int = 0,
    is_text: bool = False,
    causal=False,
    splice_period: int = 0,
) -> torch.Tensor:
    """Run the tower, x (B, S, D) -> (B, S, D).  Splices write the prompt
    rows in place into the previous layer's output, which nothing else
    holds; ``x`` itself is written only if layer 0 splices, which the
    towers' schedules never ask for.  Autograd accepts the write: the
    layer's forward saves its input, not its output, and returns a tensor
    of its own (not a view).  Under REMAT 'full' the splice stays outside
    the checkpointed layer, so the layer's kept input is the spliced one and
    is not written after.  ``mask``, an additive (S, S) mask, goes to
    :func:`layers.residual_block` (a mask that is not causal takes the XLA
    route, as in the JAX package)."""
    L = num_layers_of(stacked_params)
    if splice_period and resolve_unroll() < L:
        raise NotImplementedError(
            "packed text rows require the fully-unrolled static path "
            "(SCAN_UNROLL must cover the tower)"
        )
    grad = torch.is_grad_enabled()
    full = _REMAT_MODE == "full" and grad
    with layers.recomputing_probs(_REMAT_MODE == "selective" and grad):
        state = layers.routing_state() if full else None
        B, S, D = x.shape
        for l in range(L):
            if prompts is not None and prompt_mask[l]:
                rows = prompts[l].to(x.dtype)
                if not is_text:
                    x[:, S - n_ctx:] = rows
                elif splice_period:
                    x.view(B, S // splice_period, splice_period, D)[:, :, 1:1 + n_ctx] = rows
                else:
                    x[:, 1:1 + n_ctx] = rows
            p = layer_params(stacked_params, l)
            if full:
                x = checkpoint(_remat_layer, state, p, x, n_head, causal, mask,
                               use_reentrant=False)
            else:
                x = residual_block(p, x, n_head, causal, mask)
    return x
