"""CLIP config, parameter initialization and the image-side forward
(counterpart of ``mudpt_tpu/models/clip.py``).

The parameter tree is a nested dict of tensors with the JAX tree's names
and ``(in, out)`` weight layout, blocks stacked on a leading layer axis:

  params = {
    "visual": {patch_w, class_embedding, pos_embedding, ln_pre, blocks,
               ln_post, proj},      (a ViT; an RN tower: models/resnet.py)
    "text":   {token_embedding, pos_embedding, blocks, ln_final, projection},
    "logit_scale": scalar,
  }

:func:`cast_matmul_weights` changes only the matmul weights and their
biases (an RN tower's convs and attention-pool linears); LayerNorm
parameters, embeddings and BatchNorm statistics stay float32.
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
    # "resnet": blocks per stage (reference clip/model.py:892-898)
    vision_layers_per_stage: tuple = ()

    @property
    def vision_heads(self) -> int:
        if self.vision_arch == "resnet":
            return self.vision_width * 32 // 64
        return self.vision_width // 64

    @property
    def grid_size(self) -> int:
        return self.image_resolution // self.vision_patch_size

    @property
    def vision_seq_len(self) -> int:
        return self.grid_size ** 2 + 1


VIT_B16 = CLIPConfig()
VIT_B32 = CLIPConfig(vision_patch_size=32)
# mudpt_tpu/models/clip.py:72-75: vision 1024 x 24 layers x 16 heads, patch
# 14 at 224 px (257 tokens); text 768 x 12 layers x 12 heads
VIT_L14 = CLIPConfig(
    embed_dim=768, vision_layers=24, vision_width=1024, vision_patch_size=14,
    transformer_width=768, transformer_heads=12, transformer_layers=12,
)
# the 336px fine-tune (mudpt_tpu/trainers/base.py:76-79): the same towers,
# a 24 x 24 patch grid, 577 tokens
VIT_L14_336 = dataclasses.replace(VIT_L14, image_resolution=336)
# the RN family (mudpt_tpu/models/clip.py:80-109): the OpenAI checkpoints'
# dims, for PATH='random' runs; a real checkpoint infers its own
RN50 = CLIPConfig(
    embed_dim=1024, vision_layers=16, vision_width=64, vision_patch_size=0,
    vision_arch="resnet", vision_layers_per_stage=(3, 4, 6, 3),
)
RN101 = CLIPConfig(
    embed_dim=512, vision_layers=33, vision_width=64, vision_patch_size=0,
    vision_arch="resnet", vision_layers_per_stage=(3, 4, 23, 3),
)
RN50X4 = CLIPConfig(
    embed_dim=640, image_resolution=288, vision_layers=26, vision_width=80,
    vision_patch_size=0, vision_arch="resnet", vision_layers_per_stage=(4, 6, 10, 6),
    transformer_width=640, transformer_heads=10,
)
RN50X16 = CLIPConfig(
    embed_dim=768, image_resolution=384, vision_layers=40, vision_width=96,
    vision_patch_size=0, vision_arch="resnet", vision_layers_per_stage=(6, 8, 18, 8),
    transformer_width=768, transformer_heads=12,
)
RN50X64 = CLIPConfig(
    embed_dim=1024, image_resolution=448, vision_layers=64, vision_width=128,
    vision_patch_size=0, vision_arch="resnet", vision_layers_per_stage=(3, 15, 36, 10),
    transformer_width=1024, transformer_heads=16,
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


def _uniform(g: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=g, device=g.device) * 2 - 1) * bound


def _init_resnet_visual(g: torch.Generator, cfg: CLIPConfig) -> dict:
    """Random ModifiedResNet parameters in the converter's layout
    (``_init_resnet_visual`` :145): HWIO convs and linears within torch's
    default bounds, unit BatchNorm statistics."""
    w = cfg.vision_width
    C = w * 32  # the attention pool's width

    def conv(kk, cin, cout):
        return _uniform(g, (kk, kk, cin, cout), (kk * kk * cin) ** -0.5)

    def bn(ch):
        return {"scale": torch.ones(ch, device=g.device), "bias": torch.zeros(ch, device=g.device),
                "mean": torch.zeros(ch, device=g.device), "var": torch.ones(ch, device=g.device)}

    def lin(din, dout):
        return {"w": _uniform(g, (din, dout), din ** -0.5), "b": _uniform(g, (dout,), din ** -0.5)}

    p = {"conv1": conv(3, 3, w // 2), "bn1": bn(w // 2),
         "conv2": conv(3, w // 2, w // 2), "bn2": bn(w // 2),
         "conv3": conv(3, w // 2, w), "bn3": bn(w)}
    inplanes = w
    for s, blocks in enumerate(cfg.vision_layers_per_stage, start=1):
        planes = w * (2 ** (s - 1))
        stage = {}
        for b in range(blocks):
            bp = {"conv1": conv(1, inplanes, planes), "bn1": bn(planes),
                  "conv2": conv(3, planes, planes), "bn2": bn(planes),
                  "conv3": conv(1, planes, planes * 4), "bn3": bn(planes * 4)}
            stride = 2 if (s > 1 and b == 0) else 1
            # the reference Bottleneck's downsample rule (clip/model.py:31-39)
            if stride > 1 or inplanes != planes * 4:
                bp["downsample"] = {"conv": conv(1, inplanes, planes * 4), "bn": bn(planes * 4)}
            stage[str(b)] = bp
            inplanes = planes * 4
        p[f"layer{s}"] = stage
    spacial = cfg.image_resolution // 32
    p["attnpool"] = {"pos_embedding": _normal(g, (spacial * spacial + 1, C), C ** -0.5),
                     "q": lin(C, C), "k": lin(C, C), "v": lin(C, C), "c": lin(C, cfg.embed_dim)}
    return p


def init_clip_params(cfg: CLIPConfig, generator: torch.Generator) -> dict:
    """Random float32 parameters on the generator's device, with the init
    scheme of ``mudpt_tpu/models/clip.py:112-237`` (the draws differ: a
    torch generator is not a JAX key)."""
    g = generator
    vw, tw = cfg.vision_width, cfg.transformer_width
    vscale = vw ** -0.5
    ones = lambda n: torch.ones(n, device=g.device)  # noqa: E731
    zeros = lambda n: torch.zeros(n, device=g.device)  # noqa: E731
    if cfg.vision_arch == "resnet":
        visual = _init_resnet_visual(g, cfg)
    else:
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


def leaves(tree: dict) -> list:
    """The tensors of a nested dict, in key order."""
    out = []
    for v in tree.values():
        out.extend(leaves(v) if isinstance(v, dict) else [v])
    return out


def _cast_rn_visual(tree: dict, dtype: torch.dtype) -> dict:
    """The RN tower's cast rules (``_cast_rn_visual`` :252-270): conv kernels
    and the attention pool's q/k/v/c linears to ``dtype``; BatchNorm
    statistics and the positional embedding stay float32 (``batch_norm``
    folds them in fp32)."""
    out = {}
    for k, val in tree.items():
        if isinstance(val, dict):
            if k.startswith("bn"):
                out[k] = val
            elif k in ("q", "k", "v", "c"):
                out[k] = _map(val, lambda t: t.to(dtype))
            else:
                out[k] = _cast_rn_visual(val, dtype)
        else:
            out[k] = val.to(dtype) if k.startswith("conv") else val
    return out


def cast_matmul_weights(params: dict, dtype: torch.dtype) -> dict:
    """Cast the matmul weights and their biases (``mudpt_tpu/models/clip.py
    :273-302``), an RN tower's by :func:`_cast_rn_visual`; embeddings and
    LayerNorms stay float32.  Returns a new tree; untouched leaves are
    shared."""
    out = _map(params, lambda t: t)
    is_rn = isinstance(out.get("visual"), dict) and "attnpool" in out["visual"]
    if is_rn:
        out["visual"] = _cast_rn_visual(out["visual"], dtype)
    for path in _CAST_PATHS:
        if is_rn and path[0] == "visual":
            continue
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
    mesh_ctx=None,
) -> torch.Tensor:
    if cfg.vision_arch == "resnet":
        from mudpt_torch.models.resnet import resnet_forward

        assert layer0_prompt is None and deep_prompts is None, (
            "prompt injection is defined for the ViT towers only (as in the "
            "reference, whose prompt block variants are transformer-only)"
        )
        return resnet_forward(params["visual"], images, layers=cfg.vision_layers_per_stage,
                              heads=cfg.vision_heads, compute_dtype=compute_dtype)
    from mudpt_torch.models.vit import vit_forward

    return vit_forward(
        params["visual"],
        images,
        patch_size=cfg.vision_patch_size,
        n_head=cfg.vision_heads,
        compute_dtype=compute_dtype,
        layer0_prompt=layer0_prompt,
        deep_prompts=deep_prompts,
        mesh_ctx=mesh_ctx,
    )


def encode_text(
    params: dict,
    tokens: torch.Tensor,
    cfg: CLIPConfig = VIT_B16,
    *,
    compute_dtype: torch.dtype = torch.float32,
    deep_prompts: Optional[torch.Tensor] = None,
    mesh_ctx=None,
) -> torch.Tensor:
    """Zero-shot text encoding from raw token ids (N, S) -> (N, embed_dim)
    (``clip.py:347-368``); the EOT position is the token row's argmax."""
    from mudpt_torch.models.text import embed_tokens, text_forward

    x = embed_tokens(params["text"], tokens, compute_dtype)
    return text_forward(params["text"], x, tokens.argmax(-1), n_head=cfg.transformer_heads,
                        deep_prompts=deep_prompts, mesh_ctx=mesh_ctx)


def cosine_logits(image_features, text_features, logit_scale) -> torch.Tensor:
    """L2-normalize both sides and scale by exp(logit_scale), in fp32."""
    from mudpt_torch.utils.profiling import span  # mudpt_torch.utils imports this module

    with span("mudpt.logits"):
        img = image_features.float()
        txt = text_features.float()
        img = img / img.norm(dim=-1, keepdim=True)
        txt = txt / txt.norm(dim=-1, keepdim=True)
        return logit_scale.float().exp() * (img @ txt.T)


def clip_forward(params: dict, images: torch.Tensor, tokens: torch.Tensor,
                 cfg: CLIPConfig = VIT_B16, *, compute_dtype: torch.dtype = torch.float32):
    """(logits_per_image (N_img, N_txt), logits_per_text, its transpose):
    the reference's ``model(image, text)`` (``clip.py:380-386``), both
    towers in ``compute_dtype`` and the logits from their fp32 features."""
    img = encode_image(params, images, cfg, compute_dtype=compute_dtype)
    txt = encode_text(params, tokens, cfg, compute_dtype=compute_dtype)
    logits_per_image = cosine_logits(img.float(), txt.float(), params["logit_scale"])
    return logits_per_image, logits_per_image.T


def num_params(tree: dict) -> int:
    """The number of parameters in a tree (``clip.py:389-390``)."""
    return sum(t.numel() for t in leaves(tree))
