"""Text transformer tower with prompt hooks (counterpart of
``mudpt_tpu/models/text.py``).

embeddings + positional -> causal transformer -> ln_final -> the EOT
position -> @ projection.  Two shape levers of the JAX package carry over:

  * EOT truncation (:96-127): the tower is causal and only the EOT row is
    read out, so rows are cut to max(eot)+1 rounded up to 8, floored at 16;
  * row packing (:35-75): G class rows share one kernel row of G*P tokens
    under the packed ``(period, valid)`` mask, so the projections run at
    G times the rows per launch while attention stays per sequence.

The tower keeps the JAX package's save/recompute policy (:130-157, :222-230):
from 512 x 80 row-tokens on it runs with saves off, so its layers go to the
half-blocks, whose backward recomputes qkv and h instead of saving them.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from mudpt_torch.models.layers import layer_norm
from mudpt_torch.models.transformer import make_injection_schedule, num_layers_of, transformer_forward
from mudpt_torch.ops.fused_block import saved_acts

_AUTO_PACK_TOKENS = 256
_AUTO_PACK_MAX_G = 8
_AUTO_PACK_MIN_GROUPS = 8
_TRUNC_MIN = 16
# row-token count from which the text tower's backward recomputes rather
# than saves (text.py:150, the measured crossover of 512 rows x 80 tokens)
_AUTO_RECOMPUTE_MIN_ROW_TOKENS = 512 * 80


def _auto_pack_g(padded_seq: int, n_rows: int) -> int:
    """Power of two nearest 256 / P, capped at 8, shrunk until the rows
    fill at least 8 groups (``text.py:64-75``)."""
    ratio = max(1.0, _AUTO_PACK_TOKENS / max(1, padded_seq))
    g = 2 ** int(round(math.log2(ratio)))
    g = max(1, min(_AUTO_PACK_MAX_G, g))
    while g > 1 and n_rows < _AUTO_PACK_MIN_GROUPS * g:
        g //= 2
    return g


def _text_saves_off(n_rows: int, padded_seq: int) -> bool:
    """``text._text_saves_off`` :154-157 under its default "auto" rule."""
    return n_rows * padded_seq >= _AUTO_RECOMPUTE_MIN_ROW_TOKENS


def effective_text_length(max_eot: int, full_length: int) -> int:
    """max(eot)+1 rounded up to 8, floored at 16, never above the full
    length (``text.py:121-127``)."""
    L = max(_TRUNC_MIN, -(-(int(max_eot) + 1) // 8) * 8)
    return min(full_length, L)


def text_forward(
    p: dict,
    prompt_embeddings: torch.Tensor,
    eot_idx: torch.Tensor,
    *,
    n_head: int,
    deep_prompts: Optional[torch.Tensor] = None,
    pack: Optional[int] = None,
) -> torch.Tensor:
    """Encode pre-embedded prompts (N, S, width) -> (N, embed_dim).

    ``pack``: rows per kernel row; None picks it as the JAX package's auto
    rule does, 1 runs the unpacked causal tower."""
    N, S, D = prompt_embeddings.shape
    x = prompt_embeddings + p["pos_embedding"][:S].to(prompt_embeddings.dtype)[None]
    n_ctx = deep_prompts.shape[-2] if deep_prompts is not None else 0
    if 1 + n_ctx > S:
        raise ValueError(
            f"deep-prompt splice window 1+{n_ctx} exceeds the text row length {S}"
        )
    prompts, pmask = make_injection_schedule(num_layers_of(p["blocks"]), deep_prompts)
    P = -(-S // 8) * 8
    G = _auto_pack_g(P, N) if pack is None else pack
    kw = dict(n_head=n_head, prompts=prompts, prompt_mask=pmask, n_ctx=n_ctx, is_text=True)
    with saved_acts(False) if _text_saves_off(N, P) else contextlib.nullcontext():
        if G > 1:
            # (N, S, D) -> (Npad/G, G*P, D): sequences at offsets g*P, pad rows
            # and pad positions zero; their outputs are dropped at unpack
            Npad = -(-N // G) * G
            xp = x.new_zeros((Npad, P, D))
            xp[:N, :S] = x
            xp = transformer_forward(
                p["blocks"], xp.reshape(Npad // G, G * P, D),
                causal=(P, S), splice_period=P, **kw,
            )
            x = xp.reshape(Npad, P, D)[:N, :S]
        else:
            x = transformer_forward(p["blocks"], x, causal=True, **kw)
    pooled = layer_norm(p["ln_final"], x[torch.arange(N, device=x.device), eot_idx.long()])
    return torch.matmul(pooled, p["projection"].to(pooled.dtype))
