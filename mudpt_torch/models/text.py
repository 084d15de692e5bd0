"""Text transformer tower with prompt hooks (counterpart of
``mudpt_tpu/models/text.py``).

embeddings + positional -> causal transformer -> ln_final -> the EOT
position -> @ projection.  Two shape levers of the JAX package carry over:

  * EOT truncation (:96-127): the tower is causal and only the EOT row is
    read out, so rows are cut to max(eot)+1 rounded up to 8, floored at 16;
  * row packing (:35-75): G class rows share one kernel row of G*P tokens
    under the packed ``(period, valid)`` mask, so the projections run at
    G times the rows per launch while attention stays per sequence.

A 4-D input (instances x classes, CoCoOp) runs as one batch of rows.
The tower keeps the JAX package's save/recompute policy (:130-157, :222-230):
from 512 x 80 row-tokens on it runs with saves off, so its layers go to the
half-blocks, whose backward recomputes qkv and h instead of saving them.

Three module switches set these levers, as ``PERF.TEXT_PACK``,
``TEXT_TRUNC`` and ``TEXT_RECOMPUTE`` do through ``config/perf.py``
(the JAX package's ``set_text_pack`` :59-61, ``set_text_truncate``
:112-118 and ``set_text_recompute`` :145-151; the port reads no
environment variable):

  * :func:`set_text_pack` ``g``: 0 the auto rule, 1 off, G > 1 forces G
    rows a kernel row on either block route;
  * :func:`set_text_truncate` ``on``: off keeps the full 77-token rows;
  * :func:`set_text_recompute` ``mode``: 'auto' the row-token crossover,
    '0' always save, '1' always recompute.

The text projection runs as products of a fixed row count
(:func:`_project`), so a row's features and its gradient do not depend on
how many rows share the call (CoCoOp's chunks against its whole batch).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from mudpt_torch.models.layers import calibrating, layer_norm, resolve_block_impl
from mudpt_torch.models.transformer import (make_injection_schedule, num_layers_of,
                                            resolve_unroll, transformer_forward)
from mudpt_torch.ops.fused_block import saved_acts
from mudpt_torch.parallel.mesh import shard_rows, shard_rows_2d
from mudpt_torch.utils.profiling import span

# 0 = auto; 1 = off; G > 1 forces G rows a kernel row (text.py:44)
_TEXT_PACK = 0
_AUTO_PACK_TOKENS = 256
_AUTO_PACK_MAX_G = 8
_AUTO_PACK_MIN_GROUPS = 8
# "auto" = EOT-truncated rows; "0" = the full rows (text.py:106)
_TEXT_TRUNC = "auto"
_TRUNC_MIN = 16
# "auto" | "0" (always save) | "1" (always recompute) (text.py:141)
_TEXT_RECOMPUTE = "auto"
# row-token count from which the text tower's backward recomputes rather
# than saves (text.py:150, the measured crossover of 512 rows x 80 tokens)
_AUTO_RECOMPUTE_MIN_ROW_TOKENS = 512 * 80
# rows of each text-projection product (see _project)
_PROJ_ROWS = 256


def set_text_pack(g: int) -> None:
    """0 auto, 1 off, G > 1 forced (``text.py:59-61``)."""
    global _TEXT_PACK
    _TEXT_PACK = max(0, int(g))


def text_pack() -> int:
    return _TEXT_PACK


def set_text_truncate(on: bool) -> None:
    """EOT-truncated rows when on, the full rows when off (``text.py:116-118``)."""
    global _TEXT_TRUNC
    _TEXT_TRUNC = "auto" if on else "0"


def text_truncate_enabled() -> bool:
    return _TEXT_TRUNC != "0"


def text_truncate() -> str:
    return _TEXT_TRUNC


def set_text_recompute(mode) -> None:
    """'auto' (the row-token crossover), '1' (always recompute) or '0'
    (always save) (``text.py:145-151``)."""
    v = str(mode)
    if v not in ("auto", "0", "1"):
        raise ValueError(f"TEXT_RECOMPUTE {mode!r}: expected 'auto', '0' or '1'")
    global _TEXT_RECOMPUTE
    _TEXT_RECOMPUTE = v


def text_recompute() -> str:
    return _TEXT_RECOMPUTE


def _auto_pack_g(padded_seq: int, n_rows: int) -> int:
    """Power of two nearest 256 / P, capped at 8, shrunk until the rows
    fill at least 8 groups (``text.py:64-75``)."""
    ratio = max(1.0, _AUTO_PACK_TOKENS / max(1, padded_seq))
    g = 2 ** int(round(math.log2(ratio)))
    g = max(1, min(_AUTO_PACK_MAX_G, g))
    while g > 1 and n_rows < _AUTO_PACK_MIN_GROUPS * g:
        g //= 2
    return g


def _resolve_pack(n_rows: int, num_layers: int, padded_seq: int = 80) -> int:
    """Rows a kernel row (``text._resolve_pack`` :78-93): the switch when
    set; else the auto rule on the kernel route with the tower unrolled,
    1 otherwise.  The calibration capture runs the auto rule unpacked, as
    the JAX capture's XLA blocks do (packed pad rows would enter the
    absmax); a forced G packs there too, as in the JAX package."""
    if _TEXT_PACK != 0:
        return _TEXT_PACK
    if (resolve_block_impl() == "pallas" and not calibrating()
            and resolve_unroll() >= num_layers):
        return _auto_pack_g(padded_seq, n_rows)
    return 1


def _text_saves_off(n_rows: int, padded_seq: int = 80) -> bool:
    """``text._text_saves_off`` :154-157: the row-token crossover under
    'auto', else the switch."""
    if _TEXT_RECOMPUTE == "auto":
        return n_rows * padded_seq >= _AUTO_RECOMPUTE_MIN_ROW_TOKENS
    return _TEXT_RECOMPUTE == "1"


def effective_text_length(max_eot: int, full_length: int) -> int:
    """max(eot)+1 rounded up to 8, floored at 16, never above the full
    length; the full length with truncation off (``text.py:121-127``)."""
    if not text_truncate_enabled():
        return full_length
    L = max(_TRUNC_MIN, -(-(int(max_eot) + 1) // 8) * 8)
    return min(full_length, L)


def embed_tokens(p: dict, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Token embedding lookup: (N, S) int -> (N, S, width) (``text.py:170-172``)."""
    return p["token_embedding"][tokens.long()].to(compute_dtype)


def text_forward(
    p: dict,
    prompt_embeddings: torch.Tensor,
    eot_idx: torch.Tensor,
    *,
    n_head: int,
    deep_prompts: Optional[torch.Tensor] = None,
    pack: Optional[int] = None,
    mesh_ctx=None,
) -> torch.Tensor:
    """Encode pre-embedded prompts (N, S, width) -> (N, embed_dim).

    A 4-D input (B, N, S, width) is B instance-conditioned copies of the N
    class rows (CoCoOp) -> (B, N, embed_dim): the B*N rows go through the
    tower as one batch, so packing and the save/recompute rule see the true
    row count (``text.py:225``, :274-287), and each copy reads its class's
    EOT position (:295-299).

    Under a mesh (``mesh_ctx``) the class rows split over the 'model' axis
    and, for a 4-D input, the instances are this rank's rows of the 'data'
    axis (``text.py:273-290``, ``parallel/mesh.shard_rows``).  The packing
    G and the saves-off rule are resolved from the GLOBAL row count, as the
    JAX package resolves them before its tower runs per shard (:222-243),
    and each rank packs its own block of rows.

    ``pack``: rows per kernel row.  An explicit value wins over the module
    switch (:func:`set_text_pack`); None takes the switch, whose 0 picks G
    as the JAX package's auto rule does (on the kernel route only).  1 runs
    the unpacked causal tower; G > 1 packs on either block route, and under
    a rolled scan (``SCAN_UNROLL`` below the depth) raises."""
    with span("mudpt.text"):
        lead = prompt_embeddings.shape[:-2]
        S, D = prompt_embeddings.shape[-2:]
        x = prompt_embeddings + p["pos_embedding"][:S].to(prompt_embeddings.dtype)
        N = math.prod(lead)
        if len(lead) == 2 and mesh_ctx is not None:
            N *= mesh_ctx.n_data  # the global batch's instances
        n_ctx = deep_prompts.shape[-2] if deep_prompts is not None else 0
        if 1 + n_ctx > S:
            raise ValueError(
                f"deep-prompt splice window 1+{n_ctx} exceeds the text row length {S}; "
                "set PERF.TEXT_TRUNC 0 or shrink N_CTX"
            )
        prompts, pmask = make_injection_schedule(num_layers_of(p["blocks"]), deep_prompts)
        P = -(-S // 8) * 8
        G = _resolve_pack(N, num_layers_of(p["blocks"]), P) if pack is None else pack
        kw = dict(n_head=n_head, prompts=prompts, prompt_mask=pmask, n_ctx=n_ctx, is_text=True)

        def tower(xx):
            # (n, S, D) rows -> (n, S, D); the rows this rank encodes
            n = xx.shape[0]
            if G == 1:
                return transformer_forward(p["blocks"], xx, causal=True, **kw)
            # (n, S, D) -> (npad/G, G*P, D): sequences at offsets g*P, pad rows
            # and pad positions zero; their outputs are dropped at unpack
            npad = -(-n // G) * G
            xp = xx.new_zeros((npad, P, D))
            xp[:n, :S] = xx
            xp = transformer_forward(
                p["blocks"], xp.reshape(npad // G, G * P, D),
                causal=(P, S), splice_period=P, **kw,
            )
            return xp.reshape(npad, P, D)[:n, :S]

        with saved_acts(False) if _text_saves_off(N, P) else contextlib.nullcontext():
            if len(lead) == 2:
                x = shard_rows_2d(mesh_ctx, ("data", "model"),
                                  lambda xx: tower(xx.reshape(-1, S, D)).reshape(xx.shape), x)
            else:
                x = shard_rows(mesh_ctx, "model", tower, x.reshape(-1, S, D))
        x = x.reshape(-1, S, D)
        if len(lead) == 2:
            eot_idx = eot_idx.repeat(lead[0])
        pooled = layer_norm(p["ln_final"], x[torch.arange(x.shape[0], device=x.device),
                                             eot_idx.long()])
        out = _project(pooled, p["projection"].to(pooled.dtype))
        return out.reshape(*lead, out.shape[-1])


def _project(pooled: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """``pooled @ proj`` as products of ``_PROJ_ROWS`` rows each, the rows
    padded with zeros to a multiple of it.  A library GEMM picks its method
    by the row count, and with it the order of each row's sums: one product
    over 2,000 rows and one over 4,000 part in the last bits, forward and
    backward.  Products of one shape give every row the same sums whatever
    the count of rows around it."""
    n = pooled.shape[0]
    pad = (-n) % _PROJ_ROWS
    if pad:
        pooled = torch.cat([pooled, pooled.new_zeros((pad, pooled.shape[1]))])
    return torch.cat([torch.matmul(c, proj) for c in pooled.split(_PROJ_ROWS)])[:n]
