"""Everything a cell feeds both sides, made from ``--seed``.

* CLIP weights in OpenAI's state-dict layout (``clip/model.py``): linear
  weights (out, in), the patch convolution (width, 3, P, P), per-block
  tensors stacked on a leading layer axis under keys with ``*`` for the
  block number.  They are drawn on the device in two calls, one for the
  bf16 leaves (the matmul weights and their biases, the dtype they are
  served in) and one for the fp32 leaves (embeddings, LayerNorms).
  :func:`openai_state_dict` gives the flat per-layer view the reference
  reads; :func:`to_port` hands the same values to the port's parameter tree.
* The trainable MuDPT prompts and projections, fp32.
* Class prompts as token ids: SOT, the context slots, a class name of 1-8
  BPE ids, ".", EOT.  Every seed has the same multiset of name lengths,
  spread evenly over the classes in a seeded order, so the longest prompt
  (and the port's EOT-truncated row length) is the same for every seed.
* Image pools (NHWC, bf16, as the port's images are fed) and labels.

The same seed gives the same tensors on the same device: every draw comes
from a ``torch.Generator`` or a numpy generator seeded from it.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Tuple

import numpy as np
import torch

SOT, EOT, DOT = 49406, 49407, 269
CTX_TOKEN = 343        # "X": the id under each context slot, which ctx replaces
NAME_LENGTHS = tuple(range(1, 9))
NAME_ID_RANGE = (256, 49406)   # BPE merges and bytes, no special token


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch generator for one stream of draws of this seed."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))


def np_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def host_rng(seed: int, stream: int) -> random.Random:
    return random.Random(f"{int(seed)}/{stream}")


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def _block_specs(prefix: str, layers: int, width: int) -> list:
    """OpenAI ``ResidualAttentionBlock`` tensors stacked over ``layers``."""
    attn_std = width ** -0.5
    proj_std = width ** -0.5 * (2 * layers) ** -0.5
    fc_std = (2 * width) ** -0.5
    L, D = layers, width
    p = f"{prefix}.*."
    return [
        (p + "attn.in_proj_weight", (L, 3 * D, D), "bf16", attn_std),
        (p + "attn.in_proj_bias", (L, 3 * D), "bf16", 0.02),
        (p + "attn.out_proj.weight", (L, D, D), "bf16", proj_std),
        (p + "attn.out_proj.bias", (L, D), "bf16", 0.02),
        (p + "mlp.c_fc.weight", (L, 4 * D, D), "bf16", fc_std),
        (p + "mlp.c_fc.bias", (L, 4 * D), "bf16", 0.02),
        (p + "mlp.c_proj.weight", (L, D, 4 * D), "bf16", proj_std),
        (p + "mlp.c_proj.bias", (L, D), "bf16", 0.02),
        (p + "ln_1.weight", (L, D), "fp32", "ln_scale"),
        (p + "ln_1.bias", (L, D), "fp32", 0.02),
        (p + "ln_2.weight", (L, D), "fp32", "ln_scale"),
        (p + "ln_2.bias", (L, D), "fp32", 0.02),
    ]


def weight_specs(cfg: dict) -> list:
    """(key, shape, dtype, std or 'ln_scale') of every tensor of the model."""
    vw, tw, P = cfg["vision_width"], cfg["transformer_width"], cfg["vision_patch_size"]
    grid = cfg["image_resolution"] // P
    E = cfg["embed_dim"]
    return [
        ("visual.conv1.weight", (vw, 3, P, P), "bf16", (3 * P * P) ** -0.5),
        ("visual.class_embedding", (vw,), "fp32", vw ** -0.5),
        ("visual.positional_embedding", (grid * grid + 1, vw), "fp32", vw ** -0.5),
        ("visual.ln_pre.weight", (vw,), "fp32", "ln_scale"),
        ("visual.ln_pre.bias", (vw,), "fp32", 0.02),
        *_block_specs("visual.transformer.resblocks", cfg["vision_layers"], vw),
        ("visual.ln_post.weight", (vw,), "fp32", "ln_scale"),
        ("visual.ln_post.bias", (vw,), "fp32", 0.02),
        ("visual.proj", (vw, E), "bf16", vw ** -0.5),
        ("token_embedding.weight", (cfg["vocab_size"], tw), "fp32", 0.02),
        ("positional_embedding", (cfg["context_length"], tw), "fp32", 0.01),
        *_block_specs("transformer.resblocks", cfg["transformer_layers"], tw),
        ("ln_final.weight", (tw,), "fp32", "ln_scale"),
        ("ln_final.bias", (tw,), "fp32", 0.02),
        ("text_projection", (tw, E), "bf16", tw ** -0.5),
    ]


_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's weights in OpenAI's layout (block tensors stacked, keys
    with ``*``), one normal draw per dtype, each leaf scaled in place."""
    specs = weight_specs(cfg)
    out = {"logit_scale": torch.tensor(math.log(1 / 0.07), device=device)}
    for k, dname in enumerate(("bf16", "fp32")):
        group = [s for s in specs if s[2] == dname]
        n = sum(math.prod(s[1]) for s in group)
        flat = torch.randn(n, generator=generator(seed, k, device), device=device,
                           dtype=_DTYPES[dname])
        off = 0
        for key, shape, _, std in group:
            t = flat[off:off + math.prod(shape)].view(shape)
            off += t.numel()
            if std == "ln_scale":
                t.mul_(0.1).add_(1.0)
            else:
                t.mul_(std)
            out[key] = t
    return out


def openai_state_dict(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The flat OpenAI state dict: one key per block tensor
    (``...resblocks.<i>.attn.in_proj_weight``), views of the stacks."""
    sd = {}
    for key, t in weights.items():
        if ".*." in key:
            for i in range(t.shape[0]):
                sd[key.replace("*", str(i))] = t[i]
        else:
            sd[key] = t
    return sd


def _port_blocks(w: dict, prefix: str) -> dict:
    def get(name):
        return w[f"{prefix}.*.{name}"]

    def t(name):  # OpenAI (out, in) -> the port's (in, out)
        return get(name).transpose(1, 2).contiguous()

    return {
        "ln_1": {"scale": get("ln_1.weight"), "bias": get("ln_1.bias")},
        "attn": {"qkv_w": t("attn.in_proj_weight"), "qkv_b": get("attn.in_proj_bias").clone(),
                 "out_w": t("attn.out_proj.weight"),
                 "out_b": get("attn.out_proj.bias").clone()},
        "ln_2": {"scale": get("ln_2.weight"), "bias": get("ln_2.bias")},
        "mlp": {"fc_w": t("mlp.c_fc.weight"), "fc_b": get("mlp.c_fc.bias").clone(),
                "proj_w": t("mlp.c_proj.weight"), "proj_b": get("mlp.c_proj.bias").clone()},
    }


def to_port(w: Dict[str, torch.Tensor]) -> dict:
    """The port's parameter tree (``mudpt_torch.models.clip``'s layout, as
    ``models/convert.state_dict_to_params`` lays out a checkpoint) holding
    the same values: (in, out) weights, the patch weight (P*P*3, width)
    ordered (row, column, channel), bf16 matmul weights and biases, fp32
    embeddings and LayerNorms.  The bf16 leaves are copies, so that the
    draw ``w`` holds them in is freed with ``w``; the fp32 leaves, all used
    as they are, are the tensors of ``w``."""
    conv = w["visual.conv1.weight"]
    return {
        "visual": {
            "patch_w": conv.permute(2, 3, 1, 0).reshape(-1, conv.shape[0]).contiguous(),
            "class_embedding": w["visual.class_embedding"],
            "pos_embedding": w["visual.positional_embedding"],
            "ln_pre": {"scale": w["visual.ln_pre.weight"], "bias": w["visual.ln_pre.bias"]},
            "blocks": _port_blocks(w, "visual.transformer.resblocks"),
            "ln_post": {"scale": w["visual.ln_post.weight"], "bias": w["visual.ln_post.bias"]},
            "proj": w["visual.proj"].clone(),
        },
        "text": {
            "token_embedding": w["token_embedding.weight"],
            "pos_embedding": w["positional_embedding"],
            "blocks": _port_blocks(w, "transformer.resblocks"),
            "ln_final": {"scale": w["ln_final.weight"], "bias": w["ln_final.bias"]},
            "projection": w["text_projection"].clone(),
        },
        "logit_scale": w["logit_scale"],
    }


# ---------------------------------------------------------------------------
# trainable prompts, class prompts, images
# ---------------------------------------------------------------------------

def make_trainable(cfg: dict, seed: int, device) -> dict:
    """MuDPT's trainable tree (``trainers/mudpt.MuDPT.build_model``'s
    shapes): N(0, 0.02^2) prompts, linears U(+-1/sqrt(in)) with (in, out)
    weights, fp32."""
    g = generator(seed, 2, device)
    n, d = cfg["n_ctx"], cfg["deep_prompt_depth"] - 1
    tw, vw = cfg["transformer_width"], cfg["vision_width"]

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device) * 0.02

    def lin(i, o):
        b = 1 / math.sqrt(i)
        return {"w": (torch.rand((i, o), generator=g, device=device) * 2 - 1) * b,
                "b": (torch.rand((o,), generator=g, device=device) * 2 - 1) * b}

    return {"ctx": normal(n, tw), "deep_prompts": normal(d, n, tw),
            "embed_projection": lin(tw, vw), "deep_projections": lin(tw, vw),
            "visual_ctx": normal(n, vw), "visual_ctx_deep_prompts": normal(d, n, vw),
            "visual_ctx_deep_projections": lin(vw, tw)}


def leaf_items(tree: dict, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(dotted name, tensor) of every leaf, in key order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.extend(leaf_items(v, f"{prefix}{k}."))
        else:
            out.append((prefix + k, v))
    return out


def clone_tree(tree: dict) -> dict:
    return {k: clone_tree(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


def class_tokens(n_cls: int, n_ctx: int, context_length: int, seed: int):
    """(ids (n_cls, context_length) int64, EOT positions (n_cls,) int64):
    SOT, ``n_ctx`` context slots, a name of 1-8 ids, ".", EOT, zeros."""
    rng = np_rng(seed, 3)
    lens = rng.permutation(np.resize(np.asarray(NAME_LENGTHS), n_cls))
    names = rng.integers(*NAME_ID_RANGE, size=(n_cls, max(NAME_LENGTHS)))
    ids = np.zeros((n_cls, context_length), np.int64)
    eot = np.zeros(n_cls, np.int64)
    for c, L in enumerate(lens):
        row = [SOT, *[CTX_TOKEN] * n_ctx, *names[c, :L], DOT, EOT]
        ids[c, :len(row)] = row
        eot[c] = len(row) - 1
    return ids, eot


IMAGE_GRID = 4


def images(n: int, resolution: int, seed: int, stream: int, device) -> torch.Tensor:
    """(n, H, W, 3) bf16 images of unit variance, as normalized pixels are:
    each image its own mean colour and a coarse ``IMAGE_GRID`` x
    ``IMAGE_GRID`` layout of colour, over pixel noise, in equal parts.
    Pixel noise alone would tell images apart only by chance: a random
    tower's attention averages the patches, so its features of two noise
    images all but agree."""
    g, G = generator(seed, stream, device), IMAGE_GRID
    assert resolution % G == 0, (resolution, G)
    x = torch.randn((n, resolution, resolution, 3), generator=g, device=device,
                    dtype=torch.bfloat16)
    mean = torch.randn((n, 1, 1, 1, 1, 3), generator=g, device=device)
    layout = torch.randn((n, G, 1, G, 1, 3), generator=g, device=device)
    x.view(n, G, resolution // G, G, resolution // G, 3).add_((mean + layout).to(x.dtype))
    return x.mul_(3 ** -0.5)


def labels(shape, n_cls: int, seed: int, stream: int, device) -> torch.Tensor:
    return torch.randint(0, n_cls, shape, generator=generator(seed, stream, device),
                         device=device)


class RequestSchedule:
    """The serving client's requests: sizes cycling through ``sizes`` in a
    fresh seeded order each cycle, each request a seeded slice
    ``[offset, offset + size)`` of the image pool.  Request ``i`` is the
    same for every run of one seed, however many a run completes."""

    def __init__(self, sizes, pool: int, seed: int):
        self.sizes, self.pool = list(sizes), pool
        self._rng = host_rng(seed, 4)
        self._made: List[Tuple[int, int]] = []

    def __getitem__(self, i: int) -> Tuple[int, int]:
        while len(self._made) <= i:
            for n in self._rng.sample(self.sizes, len(self.sizes)):
                self._made.append((n, self._rng.randrange(self.pool - n + 1)))
        return self._made[i]
