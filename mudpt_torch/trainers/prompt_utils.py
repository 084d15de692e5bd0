"""Shared prompt-learner machinery (counterpart of
``mudpt_tpu/trainers/prompt_utils.py``): class-prompt embedding, context
vectors from an init phrase, the class-token layouts (end, middle, front)
as one gather through a per-class index map, torch-default initializers
for the small learned modules, and the LayerNorm -> LightTransformer ->
LayerNorm -> Linear prompt head of UMuDPT and UUMuDPT.  Random draws take
an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from mudpt_torch.models.layers import layer_norm_trainable, linear, residual_block_trainable
from mudpt_torch.models.text import effective_text_length
from mudpt_torch.tokenizer import get_tokenizer, tokenize
from mudpt_torch.utils.profiling import span


@dataclasses.dataclass
class ClassPromptAux:
    """Class-dependent static buffers: the SOS prefix and the class-name
    suffix embeddings, and the EOT positions."""

    eot_idx: np.ndarray          # (n_cls,) int32
    token_prefix: torch.Tensor   # (n_cls, 1, D)
    token_suffix: torch.Tensor   # (n_cls, 77-1-n_ctx, D)
    n_ctx: int
    name_lens: List[int]         # BPE tokens of each class name

    def effective_length(self) -> int:
        """Composed-sequence length after EOT truncation."""
        full = 1 + self.n_ctx + self.token_suffix.shape[1]
        return effective_text_length(int(np.max(self.eot_idx)), full)

    def as_device_tree(self) -> dict:
        """The aux tree the forward functions take, with the suffix cut to
        the EOT-truncated length (``prompt_utils.py:56-65``)."""
        keep = self.effective_length() - 1 - self.n_ctx
        return {
            "token_prefix": self.token_prefix,
            "token_suffix": self.token_suffix[:, :keep],
            "eot_idx": torch.from_numpy(self.eot_idx).to(self.token_prefix.device),
        }


def embed_classnames(
    text_params: dict,
    classnames: Sequence[str],
    n_ctx: int,
    prompt_prefix: str,
) -> ClassPromptAux:
    """Tokenize and embed "<prefix> <name>." per class; the embedding
    gather runs on the token table's device."""
    names = [name.replace("_", " ") for name in classnames]
    tok = get_tokenizer()
    tokenized = tokenize([f"{prompt_prefix} {name}." for name in names])
    table = text_params["token_embedding"]
    ids = torch.from_numpy(tokenized).to(table.device).long()
    embedding = table[ids].float()
    return ClassPromptAux(
        eot_idx=tokenized.argmax(axis=-1).astype(np.int32),
        token_prefix=embedding[:, :1],
        token_suffix=embedding[:, 1 + n_ctx:],
        n_ctx=n_ctx,
        name_lens=[len(tok.encode(name)) for name in names],
    )


def ctx_vectors_from_init(text_params: dict, ctx_init: str, n_ctx: int) -> torch.Tensor:
    """fp32 context vectors from a phrase's token embeddings, positions
    1..1+n_ctx (``prompt_utils.py:98-108``, reference mudpt.py:59-66)."""
    tokens = tokenize(ctx_init.replace("_", " "))[0]
    table = text_params["token_embedding"]
    return table[torch.from_numpy(tokens[1:1 + n_ctx]).to(table.device).long()].float()


def build_position_index_map(
    position: str,
    name_lens: Sequence[int],
    n_ctx: int,
    context_length: int = 77,
) -> Optional[np.ndarray]:
    """Index map (n_cls, context_length) into the per-class bank
    [prefix(1) | suffix(S) | ctx(n_ctx)] that realizes the middle and front
    layouts (``prompt_utils.py:119-145``, reference coop.py:106-166); None
    for 'end' (plain concatenation).  Each row is a permutation of the
    bank's columns."""
    if position == "end":
        return None
    n_cls = len(name_lens)
    S = context_length - 1 - n_ctx
    idx = np.zeros((n_cls, context_length), np.int32)
    suffix = list(range(1, 1 + S))
    ctx = list(range(1 + S, 1 + S + n_ctx))
    for i, L in enumerate(name_lens):
        if position == "middle":
            half = n_ctx // 2
            cols = [0] + ctx[:half] + suffix[:L] + ctx[half:] + suffix[L:]
        elif position == "front":
            cols = [0] + suffix[:L] + ctx + suffix[L:]
        else:
            raise NotImplementedError(f"class_token_position={position!r}")
        idx[i] = np.asarray(cols, np.int32)
    return idx


def compose_prompts(ctx: torch.Tensor, prefix: torch.Tensor, suffix: torch.Tensor,
                    index_map: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Assemble prompt embeddings (``prompt_utils.py:148-170``).  ``ctx``:
    (n_ctx, D) shared, (n_cls, n_ctx, D) class-specific, or (B, n_cls,
    n_ctx, D) per instance (CoCoOp), which gives (B, n_cls, S, D).  Without
    ``index_map`` the layout is [prefix | ctx | suffix] ('end'); with it, one
    ``torch.gather`` over the bank [prefix | suffix | ctx].  The map permutes
    the bank's columns, so the gather's backward adds into distinct
    positions, in no order that could change a sum."""
    with span("mudpt.prompts"):
        n_cls = prefix.shape[0]
        if ctx.dim() == 2:
            ctx = ctx[None].expand(n_cls, *ctx.shape)
        ctx = ctx.to(prefix.dtype)
        lead = ctx.shape[:-3]
        prefix = prefix.expand(*lead, *prefix.shape)
        suffix = suffix.expand(*lead, *suffix.shape)
        if index_map is None:
            return torch.cat([prefix, ctx, suffix], dim=-2)
        bank = torch.cat([prefix, suffix, ctx], dim=-2)
        index = torch.as_tensor(index_map, device=bank.device).long()
        index = index[..., None].expand(*lead, *index.shape, bank.shape[-1])
        return torch.gather(bank, -2, index)


def _uniform(g: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=g, device=g.device) * 2 - 1) * bound


def init_linear(g: torch.Generator, d_in: int, d_out: int) -> dict:
    """torch nn.Linear default: U(-1/sqrt(in), 1/sqrt(in)) for w and b."""
    bound = 1.0 / math.sqrt(d_in)
    return {"w": _uniform(g, (d_in, d_out), bound), "b": _uniform(g, (d_out,), bound)}


def random_ctx(g: torch.Generator, shape) -> torch.Tensor:
    """N(0, 0.02^2) prompt vectors."""
    return torch.randn(shape, generator=g, device=g.device) * 0.02


def _layer_norm_params(g: torch.Generator, d: int) -> dict:
    return {"scale": torch.ones(d, device=g.device), "bias": torch.zeros(d, device=g.device)}


def init_light_transformer(g: torch.Generator, d_model: int) -> dict:
    """One residual MHA + MLP block (``prompt_utils.py:187-215``, reference
    umudpt.py:54-75), torch-style init: xavier-uniform fused QKV,
    default-Linear elsewhere, zero attention biases."""
    limit = math.sqrt(6.0 / (d_model + 3 * d_model))
    qkv_w = _uniform(g, (d_model, 3 * d_model), limit)
    out_w = init_linear(g, d_model, d_model)["w"]
    fc = init_linear(g, d_model, 4 * d_model)
    proj = init_linear(g, 4 * d_model, d_model)
    return {
        "ln_1": _layer_norm_params(g, d_model),
        "attn": {"qkv_w": qkv_w, "qkv_b": torch.zeros(3 * d_model, device=g.device),
                 "out_w": out_w, "out_b": torch.zeros(d_model, device=g.device)},
        "ln_2": _layer_norm_params(g, d_model),
        "mlp": {"fc_w": fc["w"], "fc_b": fc["b"], "proj_w": proj["w"], "proj_b": proj["b"]},
    }


def init_prompt_transform_head(g: torch.Generator, d_model: int, d_out: int) -> dict:
    """LayerNorm -> LightTransformer -> LayerNorm -> Linear, the cross-modal
    prompt head (``prompt_utils.py:226-235``, reference umudpt.py:121-124)."""
    return {
        "ln_pre": _layer_norm_params(g, d_model),
        "block": init_light_transformer(g, d_model),
        "ln_post": _layer_norm_params(g, d_model),
        "proj": init_linear(g, d_model, d_out),
    }


def prompt_transform_head(p: dict, x: torch.Tensor, n_head: int) -> torch.Tensor:
    """The head on x (rows, tokens, D) (``prompt_utils.py:218-240``): every
    part trains its weights, on plain autograd, never on the frozen towers'
    dx-only kernel chains."""
    y = layer_norm_trainable(p["ln_pre"], x)
    y = residual_block_trainable(p["block"], y, n_head)
    y = layer_norm_trainable(p["ln_post"], y)
    return linear(p["proj"], y)
