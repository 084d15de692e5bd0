"""Plain MuDPT on OpenAI's CLIP: the yardstick the benchmark holds the port to.

Read straight from the OpenAI-layout state dict (``benchmark.inputs
.openai_state_dict``: ``clip/model.py``'s names, linear weights (out, in)),
in fp32 with TF32 off, with PyTorch's plain ops and autograd, and nothing of
the port.  The MuDPT coupling (Miao et al., MuDPT, and
``trainers/mudpt.py`` of the repository it ports):

  layer-0 visual prompt        = visual_ctx + embed_projection(ctx)
  visual deep prompts (1..d-1) = deep_projections(deep_prompts)
                                 + visual_ctx_deep_prompts
  text deep prompts (1..d-1)   = deep_prompts
                                 + visual_ctx_deep_projections(visual_ctx_deep_prompts)

The text prompt is [SOT, ctx, name, ".", EOT, ...] over all 77 positions
under the causal mask, read out at EOT; the visual sequence is [CLS,
patches, layer-0 prompt]; a deep prompt replaces the text positions
1..n_ctx, or the visual sequence's last n_ctx positions, before layers
1..depth-1.  The trainable linears take (in, out) weights.

``quant`` follows a quantized tier in fp32: before each of a block's four
projections the activation rows are rounded to its grid, scaled by their
absmax (the LayerNorm's fp32 output, the attention's fp32 output, the fp32
QuickGELU output), and the weights per output channel.  'int8' is the
port's int8 tier (codes in [-127, 127], absmax / 127 a step); 'int4' the
same in [-7, 7] (an int8 cell's control); 'fp8' rounds to float8 e4m3 with
the absmax at 448 (a bf16 cell's control).  The rounding passes gradients
straight through, as the quantization-aware tiers do.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def exact_fp32():
    """fp32 matmuls and convolutions without TF32 inside the context."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]
        torch.set_float32_matmul_precision(prev[2])


def fp32_weights(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.float() for k, v in sd.items()}


QUANTS = {"int8": 127, "int4": 7, "fp8": 448}


def _fake_quant(x: torch.Tensor, quant: str) -> torch.Tensor:
    """x rounded to the grid of ``quant``, scaled by the absmax of its last
    axis, in fp32; the gradient passes straight through."""
    top = QUANTS[quant]
    s = (x.abs().amax(-1, keepdim=True) / top).clamp_min(1e-8)
    if quant == "fp8":
        q = (x / s).to(torch.float8_e4m3fn).float()
    else:
        q = torch.round(x / s).clamp(-top, top)
    return x + (q * s - x).detach()


def _linear(x, w, b, quant: Optional[str] = None):
    """``x @ w.T + b`` for an OpenAI (out, in) weight; with ``quant`` both
    operands rounded first (the weight per output channel)."""
    if quant is not None:
        x, w = _fake_quant(x, quant), _fake_quant(w, quant)
    return x @ w.t() + b


def _layer_norm(x, sd, key):
    return F.layer_norm(x, x.shape[-1:], sd[key + ".weight"], sd[key + ".bias"], 1e-5)


def _block(sd, key: str, x: torch.Tensor, n_head: int, causal: bool, quant) -> torch.Tensor:
    """OpenAI's ``ResidualAttentionBlock``: x + attn(ln_1 x), + mlp(ln_2 x)."""
    B, S, D = x.shape
    hd = D // n_head
    qkv = _linear(_layer_norm(x, sd, key + ".ln_1"), sd[key + ".attn.in_proj_weight"],
                  sd[key + ".attn.in_proj_bias"], quant)
    q, k, v = qkv.reshape(B, S, 3, n_head, hd).permute(2, 0, 3, 1, 4)
    scores = (q @ k.transpose(-1, -2)) * hd ** -0.5
    if causal:
        scores = scores.masked_fill(
            torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1), float("-inf"))
    a = (scores.softmax(-1) @ v).permute(0, 2, 1, 3).reshape(B, S, D)
    x = x + _linear(a, sd[key + ".attn.out_proj.weight"], sd[key + ".attn.out_proj.bias"], quant)
    h = _linear(_layer_norm(x, sd, key + ".ln_2"), sd[key + ".mlp.c_fc.weight"],
                sd[key + ".mlp.c_fc.bias"], quant)
    h = h * torch.sigmoid(1.702 * h)
    return x + _linear(h, sd[key + ".mlp.c_proj.weight"], sd[key + ".mlp.c_proj.bias"], quant)


def _prompt_linear(p: dict, x):
    return x @ p["w"] + p["b"]


def encode_text(sd, cfg: dict, tr: dict, ids: torch.Tensor, eot: torch.Tensor,
                quant: Optional[str] = None) -> torch.Tensor:
    """Class text features (n_cls, embed_dim) of the prompts ``ids``."""
    n = cfg["n_ctx"]
    x = sd["token_embedding.weight"][ids]
    x = torch.cat([x[:, :1], tr["ctx"].expand(x.shape[0], -1, -1), x[:, 1 + n:]], 1)
    x = x + sd["positional_embedding"]
    deep = tr["deep_prompts"] + _prompt_linear(tr["visual_ctx_deep_projections"],
                                               tr["visual_ctx_deep_prompts"])
    for layer in range(cfg["transformer_layers"]):
        if 1 <= layer < cfg["deep_prompt_depth"]:
            x = torch.cat([x[:, :1], deep[layer - 1].expand(x.shape[0], -1, -1),
                           x[:, 1 + n:]], 1)
        x = _block(sd, f"transformer.resblocks.{layer}", x, cfg["transformer_heads"], True, quant)
    x = _layer_norm(x[torch.arange(x.shape[0], device=x.device), eot], sd, "ln_final")
    return x @ sd["text_projection"]


def encode_image(sd, cfg: dict, tr: dict, images: torch.Tensor,
                 quant: Optional[str] = None) -> torch.Tensor:
    """Image features (B, embed_dim) of NHWC images."""
    n, P = cfg["n_ctx"], cfg["vision_patch_size"]
    x = F.conv2d(images.permute(0, 3, 1, 2).float(), sd["visual.conv1.weight"], stride=P)
    x = x.flatten(2).transpose(1, 2)
    B, _, W = x.shape
    x = torch.cat([sd["visual.class_embedding"].expand(B, 1, W), x], 1)
    x = x + sd["visual.positional_embedding"]
    prompt0 = tr["visual_ctx"] + _prompt_linear(tr["embed_projection"], tr["ctx"])
    x = _layer_norm(torch.cat([x, prompt0.expand(B, -1, -1)], 1), sd, "visual.ln_pre")
    deep = (_prompt_linear(tr["deep_projections"], tr["deep_prompts"])
            + tr["visual_ctx_deep_prompts"])
    for layer in range(cfg["vision_layers"]):
        if 1 <= layer < cfg["deep_prompt_depth"]:
            x = torch.cat([x[:, :-n], deep[layer - 1].expand(B, -1, -1)], 1)
        x = _block(sd, f"visual.transformer.resblocks.{layer}", x,
                   cfg["vision_width"] // 64, False, quant)
    return _layer_norm(x[:, 0], sd, "visual.ln_post") @ sd["visual.proj"]


def cosine_logits(img, txt, logit_scale) -> torch.Tensor:
    img = img / img.norm(dim=-1, keepdim=True)
    txt = txt / txt.norm(dim=-1, keepdim=True)
    return logit_scale.exp() * img @ txt.t()


def _leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def loss_and_grads(sd, cfg, tr, ids, eot, images, labels, chunk: int,
                   quant: Optional[str] = None):
    """(mean NLL of the logits, {leaf: gradient}): the text features once,
    the images in blocks of ``chunk`` rows, the text tower's backward once
    from the gradient the blocks left on its features."""
    leaves = dict(_leaves(tr))
    for t in leaves.values():
        t.grad = None
    txt = encode_text(sd, cfg, tr, ids, eot, quant)
    txt_in = txt.detach().requires_grad_(True)
    B, total = images.shape[0], 0.0
    for i in range(0, B, chunk):
        logits = cosine_logits(encode_image(sd, cfg, tr, images[i:i + chunk], quant), txt_in,
                               sd["logit_scale"])
        loss = F.cross_entropy(logits, labels[i:i + chunk], reduction="sum") / B
        loss.backward()
        total += loss.item()
    txt.backward(txt_in.grad)
    return total, {k: t.grad.detach().clone() for k, t in leaves.items()}


def train(sd, cfg, tr0: dict, ids, eot, batches, lr: float, momentum: float, chunk: int,
          quant: Optional[str] = None):
    """SGD with momentum (PyTorch's: the first buffer is the gradient) from
    ``tr0`` over ``batches`` [(images, labels)]: (losses, the first step's
    gradients, the parameters after the last step)."""
    tr = {k: ({kk: vv.detach().clone().requires_grad_(True) for kk, vv in v.items()}
              if isinstance(v, dict) else v.detach().clone().requires_grad_(True))
          for k, v in tr0.items()}
    leaves = dict(_leaves(tr))
    bufs, losses, first = {}, [], None
    for images, labels in batches:
        loss, grads = loss_and_grads(sd, cfg, tr, ids, eot, images, labels, chunk, quant)
        losses.append(loss)
        first = grads if first is None else first
        with torch.no_grad():
            for k, t in leaves.items():
                bufs[k] = grads[k] if k not in bufs else bufs[k] * momentum + grads[k]
                t -= lr * bufs[k]
    return losses, first, {k: t.detach() for k, t in leaves.items()}


@torch.no_grad()
def serve_logits(sd, cfg, tr, txt, images, chunk: int, quant: Optional[str] = None):
    """fp32 logits of an image batch against text features ``txt``."""
    return torch.cat([cosine_logits(encode_image(sd, cfg, tr, images[i:i + chunk], quant), txt,
                                    sd["logit_scale"])
                      for i in range(0, images.shape[0], chunk)])
