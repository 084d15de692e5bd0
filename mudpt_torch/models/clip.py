"""CLIP config, parameter initialization and the image-side forward
(counterpart of ``mudpt_tpu/models/clip.py``).

The parameter tree is a nested dict of tensors with the JAX tree's names
and ``(in, out)`` weight layout, blocks stacked on a leading layer axis:

  params = {
    "visual": {patch_w, class_embedding, pos_embedding, ln_pre, blocks,
               ln_post, proj},
    "text":   {token_embedding, pos_embedding, blocks, ln_final, projection},
    "logit_scale": scalar,
  }

:func:`cast_matmul_weights` changes only the matmul weights and their
biases; LayerNorm parameters and embeddings stay float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    image_resolution: int = 224
    vision_layers: int = 12
    vision_width: int = 768
    vision_patch_size: int = 16
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12
    vision_arch: str = "vit"

    @property
    def vision_heads(self) -> int:
        return self.vision_width // 64

    @property
    def grid_size(self) -> int:
        return self.image_resolution // self.vision_patch_size

    @property
    def vision_seq_len(self) -> int:
        return self.grid_size ** 2 + 1


VIT_B16 = CLIPConfig()
# mudpt_tpu/models/clip.py:72-75: vision 1024 x 24 layers x 16 heads, patch
# 14 at 224 px (257 tokens); text 768 x 12 layers x 12 heads
VIT_L14 = CLIPConfig(
    embed_dim=768, vision_layers=24, vision_width=1024, vision_patch_size=14,
    transformer_width=768, transformer_heads=12, transformer_layers=12,
)
# CPU smoke size (mudpt_tpu/trainers/base.py TINY_TEST)
TINY_TEST = CLIPConfig(
    embed_dim=64, image_resolution=32, vision_layers=2, vision_width=64,
    vision_patch_size=16, transformer_width=64, transformer_heads=1,
    transformer_layers=2,
)


def _normal(g: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=g.device) * std


def _init_block_stack(g: torch.Generator, layers: int, width: int) -> dict:
    """Stacked residual blocks with the reference init scheme: attn in-proj
    std w^-0.5, out-proj and mlp proj std (w^-0.5)(2L)^-0.5, fc std
    (2w)^-0.5; biases zero, LayerNorm unit/zero."""
    attn_std = width ** -0.5
    proj_std = (width ** -0.5) * ((2 * layers) ** -0.5)
    fc_std = (2 * width) ** -0.5
    zeros = lambda *s: torch.zeros(s, device=g.device)  # noqa: E731
    ones = lambda *s: torch.ones(s, device=g.device)  # noqa: E731
    return {
        "ln_1": {"scale": ones(layers, width), "bias": zeros(layers, width)},
        "attn": {
            "qkv_w": _normal(g, (layers, width, 3 * width), attn_std),
            "qkv_b": zeros(layers, 3 * width),
            "out_w": _normal(g, (layers, width, width), proj_std),
            "out_b": zeros(layers, width),
        },
        "ln_2": {"scale": ones(layers, width), "bias": zeros(layers, width)},
        "mlp": {
            "fc_w": _normal(g, (layers, width, 4 * width), fc_std),
            "fc_b": zeros(layers, 4 * width),
            "proj_w": _normal(g, (layers, 4 * width, width), proj_std),
            "proj_b": zeros(layers, width),
        },
    }


def init_clip_params(cfg: CLIPConfig, generator: torch.Generator) -> dict:
    """Random float32 parameters on the generator's device, with the init
    scheme of ``mudpt_tpu/models/clip.py:112-237`` (the draws differ: a
    torch generator is not a JAX key)."""
    if cfg.vision_arch != "vit":
        raise NotImplementedError("the ResNet towers are not ported yet (ROADMAP.md queue A)")
    g = generator
    vw, tw = cfg.vision_width, cfg.transformer_width
    vscale = vw ** -0.5
    ones = lambda n: torch.ones(n, device=g.device)  # noqa: E731
    zeros = lambda n: torch.zeros(n, device=g.device)  # noqa: E731
    visual = {
        "patch_w": _normal(g, (cfg.vision_patch_size ** 2 * 3, vw), vscale),
        "class_embedding": _normal(g, (vw,), vscale),
        "pos_embedding": _normal(g, (cfg.vision_seq_len, vw), vscale),
        "ln_pre": {"scale": ones(vw), "bias": zeros(vw)},
        "blocks": _init_block_stack(g, cfg.vision_layers, vw),
        "ln_post": {"scale": ones(vw), "bias": zeros(vw)},
        "proj": _normal(g, (vw, cfg.embed_dim), vscale),
    }
    text = {
        "token_embedding": _normal(g, (cfg.vocab_size, tw), 0.02),
        "pos_embedding": _normal(g, (cfg.context_length, tw), 0.01),
        "blocks": _init_block_stack(g, cfg.transformer_layers, tw),
        "ln_final": {"scale": ones(tw), "bias": zeros(tw)},
        "projection": _normal(g, (tw, cfg.embed_dim), tw ** -0.5),
    }
    return {
        "visual": visual,
        "text": text,
        "logit_scale": torch.tensor(math.log(1 / 0.07), device=g.device),
    }


_CAST_PATHS = (
    ("visual", "patch_w"),
    ("visual", "blocks", "attn"),
    ("visual", "blocks", "mlp"),
    ("visual", "proj"),
    ("text", "blocks", "attn"),
    ("text", "blocks", "mlp"),
    ("text", "projection"),
)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def cast_matmul_weights(params: dict, dtype: torch.dtype) -> dict:
    """Cast the matmul weights and their biases (the ViT paths of
    ``mudpt_tpu/models/clip.py:240-302``); embeddings and LayerNorms stay
    float32.  Returns a new tree; untouched leaves are shared."""
    out = _map(params, lambda t: t)
    for path in _CAST_PATHS:
        node = out
        for k in path[:-1]:
            node = node.get(k) if isinstance(node, dict) else None
            if node is None:
                break
        if not (isinstance(node, dict) and path[-1] in node):
            raise KeyError(
                f"cast_matmul_weights: expected path {'/'.join(path)} missing "
                "from the parameter tree"
            )
        node[path[-1]] = _map(node[path[-1]], lambda t: t.to(dtype))
    return out


def encode_image(
    params: dict,
    images: torch.Tensor,
    cfg: CLIPConfig = VIT_B16,
    *,
    compute_dtype: torch.dtype = torch.float32,
    layer0_prompt: Optional[torch.Tensor] = None,
    deep_prompts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if cfg.vision_arch != "vit":
        raise NotImplementedError("the ResNet towers are not ported yet (ROADMAP.md queue A)")
    from mudpt_torch.models.vit import vit_forward

    return vit_forward(
        params["visual"],
        images,
        patch_size=cfg.vision_patch_size,
        n_head=cfg.vision_heads,
        compute_dtype=compute_dtype,
        layer0_prompt=layer0_prompt,
        deep_prompts=deep_prompts,
    )


def cosine_logits(image_features, text_features, logit_scale) -> torch.Tensor:
    """L2-normalize both sides and scale by exp(logit_scale), in fp32."""
    img = image_features.float()
    txt = text_features.float()
    img = img / img.norm(dim=-1, keepdim=True)
    txt = txt / txt.norm(dim=-1, keepdim=True)
    return logit_scale.float().exp() * (img @ txt.T)
