"""Prompt-injectable transformer over stacked per-layer weights
(counterpart of ``mudpt_tpu/models/transformer.py``, its fully-unrolled
static path :167-203).

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

from mudpt_torch.models.layers import residual_block


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
    of its own (not a view)."""
    B, S, D = x.shape
    for l in range(num_layers_of(stacked_params)):
        if prompts is not None and prompt_mask[l]:
            rows = prompts[l].to(x.dtype)
            if not is_text:
                x[:, S - n_ctx:] = rows
            elif splice_period:
                x.view(B, S // splice_period, splice_period, D)[:, :, 1:1 + n_ctx] = rows
            else:
                x[:, 1:1 + n_ctx] = rows
        x = residual_block(layer_params(stacked_params, l), x, n_head, causal)
    return x
