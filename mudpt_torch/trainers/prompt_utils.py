"""Shared prompt-learner machinery (counterpart of
``mudpt_tpu/trainers/prompt_utils.py``): class-prompt embedding, context
vectors from an init phrase, the ``'end'`` prompt layout, and
torch-default initializers for the small learned modules.  Random draws
take an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from mudpt_torch.models.text import effective_text_length
from mudpt_torch.tokenizer import tokenize


@dataclasses.dataclass
class ClassPromptAux:
    """Class-dependent static buffers: the SOS prefix and the class-name
    suffix embeddings, and the EOT positions."""

    eot_idx: np.ndarray          # (n_cls,) int32
    token_prefix: torch.Tensor   # (n_cls, 1, D)
    token_suffix: torch.Tensor   # (n_cls, 77-1-n_ctx, D)
    n_ctx: int

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
    tokenized = tokenize([f"{prompt_prefix} {name}." for name in names])
    table = text_params["token_embedding"]
    ids = torch.from_numpy(tokenized).to(table.device).long()
    embedding = table[ids].float()
    return ClassPromptAux(
        eot_idx=tokenized.argmax(axis=-1).astype(np.int32),
        token_prefix=embedding[:, :1],
        token_suffix=embedding[:, 1 + n_ctx:],
        n_ctx=n_ctx,
    )


def ctx_vectors_from_init(text_params: dict, ctx_init: str, n_ctx: int) -> torch.Tensor:
    """fp32 context vectors from a phrase's token embeddings, positions
    1..1+n_ctx (``prompt_utils.py:98-108``, reference mudpt.py:59-66)."""
    tokens = tokenize(ctx_init.replace("_", " "))[0]
    table = text_params["token_embedding"]
    return table[torch.from_numpy(tokens[1:1 + n_ctx]).to(table.device).long()].float()


def compose_prompts(ctx: torch.Tensor, prefix: torch.Tensor, suffix: torch.Tensor) -> torch.Tensor:
    """[prefix | ctx | suffix] per class, the ``'end'`` layout; ``ctx`` is
    (n_ctx, D) shared or (n_cls, n_ctx, D) class-specific."""
    n_cls = prefix.shape[0]
    if ctx.dim() == 2:
        ctx = ctx[None].expand(n_cls, *ctx.shape)
    return torch.cat([prefix, ctx.to(prefix.dtype), suffix], dim=1)


def _uniform(g: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=g, device=g.device) * 2 - 1) * bound


def init_linear(g: torch.Generator, d_in: int, d_out: int) -> dict:
    """torch nn.Linear default: U(-1/sqrt(in), 1/sqrt(in)) for w and b."""
    bound = 1.0 / math.sqrt(d_in)
    return {"w": _uniform(g, (d_in, d_out), bound), "b": _uniform(g, (d_out,), bound)}


def random_ctx(g: torch.Generator, shape) -> torch.Tensor:
    """N(0, 0.02^2) prompt vectors."""
    return torch.randn(shape, generator=g, device=g.device) * 0.02
