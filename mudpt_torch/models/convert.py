"""CLIP checkpoints and parameter trees in and out of the port (counterpart
of ``mudpt_tpu/models/convert.py``).

``params_from_numpy`` turns a parameter, trainable or aux tree whose leaves
are numpy arrays (for example ``np.asarray`` of each leaf of a JAX tree)
into the port's tensors, keeping names and layouts.  bfloat16 leaves come
as ``ml_dtypes`` arrays (dtype name ``bfloat16``) or as their ``uint16``
bit views; both become ``torch.bfloat16`` through a bit view, without a
round trip through float.  The port itself never imports ``ml_dtypes``.
A tower's calibrated ``q8_scales`` leaf (the JAX ``quant_block.attach_scales``,
(L, 4) fp32) crosses over like any other, and each layer reads its row.

``load_clip_checkpoint`` reads an OpenAI CLIP ``.pt`` file (TorchScript
archive or plain state dict) or a converted ``.npz``, with the shape
inference and layout changes of ``convert.py:34-155``: torch Linear
weights (out, in) become (in, out), the patch conv a (P*P*3, width) matmul
weight ordered (ph, pw, channel), per-block tensors stacked on a leading
layer axis.  The ``.npz`` format (flat '/'-joined keys plus a ``__cfg__``
JSON of the config) and the conversion cache beside a ``.pt``
(``<path>.mudpt_tpu.npz``) are the JAX package's, so one conversion
serves both packages.  An RN checkpoint's ``visual.*`` entries convert
through ``models/resnet.convert_resnet_visual``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

from mudpt_torch.models.clip import CLIPConfig, _map
from mudpt_torch.models.resnet import convert_resnet_visual, stage_counts


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        bits = np.ascontiguousarray(a).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, device) -> dict:
    """Map every array leaf of a nested dict to a tensor on ``device``;
    other leaves (ints, strings, lists) are kept as they are."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, np.generic)) or hasattr(tree, "__array__"):
        return _leaf(tree, device)
    return tree


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().float().numpy()


def _text_dims(sd: Dict[str, np.ndarray]) -> dict:
    return dict(
        embed_dim=sd["text_projection"].shape[1],
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=sd["ln_final.weight"].shape[0],
        transformer_heads=sd["ln_final.weight"].shape[0] // 64,
        transformer_layers=len(
            {k.split(".")[2] for k in sd if k.startswith("transformer.resblocks")}
        ),
    )


def infer_config(sd: Dict[str, np.ndarray]) -> CLIPConfig:
    """The config of a CLIP state dict (``convert.py:34-83``): an RN tower
    when it has no ``visual.proj`` (:45-60)."""
    if "visual.proj" not in sd:
        counts = stage_counts(sd)
        output_width = round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
        return CLIPConfig(
            image_resolution=output_width * 32, vision_layers=sum(counts),
            vision_width=sd["visual.layer1.0.conv1.weight"].shape[0], vision_patch_size=0,
            vision_arch="resnet", vision_layers_per_stage=counts, **_text_dims(sd),
        )
    conv1 = sd["visual.conv1.weight"]
    vision_patch_size = conv1.shape[-1]
    grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
    return CLIPConfig(
        image_resolution=vision_patch_size * grid,
        vision_layers=len(
            {k.split(".")[3] for k in sd if k.startswith("visual.transformer.resblocks.")}
        ),
        vision_width=conv1.shape[0],
        vision_patch_size=vision_patch_size,
        **_text_dims(sd),
    )


def _stack_blocks(sd: Dict[str, np.ndarray], prefix: str, layers: int) -> dict:
    def stack(name, transpose=False):
        return np.stack([sd[f"{prefix}.{i}.{name}"].T if transpose else sd[f"{prefix}.{i}.{name}"]
                         for i in range(layers)])

    return {
        "ln_1": {"scale": stack("ln_1.weight"), "bias": stack("ln_1.bias")},
        "attn": {
            "qkv_w": stack("attn.in_proj_weight", True),
            "qkv_b": stack("attn.in_proj_bias"),
            "out_w": stack("attn.out_proj.weight", True),
            "out_b": stack("attn.out_proj.bias"),
        },
        "ln_2": {"scale": stack("ln_2.weight"), "bias": stack("ln_2.bias")},
        "mlp": {
            "fc_w": stack("mlp.c_fc.weight", True),
            "fc_b": stack("mlp.c_fc.bias"),
            "proj_w": stack("mlp.c_proj.weight", True),
            "proj_b": stack("mlp.c_proj.bias"),
        },
    }


def state_dict_to_params(state_dict) -> Tuple[CLIPConfig, dict]:
    """(config, fp32 CPU parameter tree) of a CLIP state dict
    (``torch_state_dict_to_jax``, ``convert.py:116-160``)."""
    sd = {k: _to_numpy(v) for k, v in state_dict.items()
          if k not in ("input_resolution", "context_length", "vocab_size")}
    cfg = infer_config(sd)
    if cfg.vision_arch == "resnet":
        visual, _ = convert_resnet_visual(sd)
    else:
        conv1 = sd["visual.conv1.weight"]  # (width, 3, P, P)
        visual = {
            "patch_w": conv1.transpose(2, 3, 1, 0).reshape(-1, cfg.vision_width),
            "class_embedding": sd["visual.class_embedding"],
            "pos_embedding": sd["visual.positional_embedding"],
            "ln_pre": {"scale": sd["visual.ln_pre.weight"], "bias": sd["visual.ln_pre.bias"]},
            "blocks": _stack_blocks(sd, "visual.transformer.resblocks", cfg.vision_layers),
            "ln_post": {"scale": sd["visual.ln_post.weight"], "bias": sd["visual.ln_post.bias"]},
            "proj": sd["visual.proj"],
        }
    params = {
        "visual": visual,
        "text": {
            "token_embedding": sd["token_embedding.weight"],
            "pos_embedding": sd["positional_embedding"],
            "blocks": _stack_blocks(sd, "transformer.resblocks", cfg.transformer_layers),
            "ln_final": {"scale": sd["ln_final.weight"], "bias": sd["ln_final.bias"]},
            "projection": sd["text_projection"],
        },
        "logit_scale": sd["logit_scale"].reshape(()),
    }
    return cfg, params_from_numpy(_map(params, lambda a: np.asarray(a, np.float32)), "cpu")


def load_clip_checkpoint(path: str) -> Tuple[CLIPConfig, dict]:
    """(config, fp32 CPU parameter tree) of a local CLIP file: a ``.npz``
    as written by :func:`save_npz_params`, else an OpenAI ``.pt``, tried as
    a TorchScript archive, then as a pickled state dict (reference
    trainers/mudpt.py:26-32); a ``.pt``'s conversion is cached beside it."""
    if path.endswith(".npz"):
        return load_npz_params(path)
    cache = path + ".mudpt_tpu.npz"
    if os.path.exists(cache):
        return load_npz_params(cache)
    try:
        state_dict = torch.jit.load(path, map_location="cpu").eval().state_dict()
    except RuntimeError:
        state_dict = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(state_dict, "state_dict"):
            state_dict = state_dict.state_dict()
    cfg, params = state_dict_to_params(state_dict)
    try:
        save_npz_params(cache, cfg, params)
    except OSError:
        pass  # read-only checkpoint directory: the conversion stays uncached
    return cfg, params


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = _to_numpy(v)
    return out


def _unflatten(flat):
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_npz_params(path: str, cfg: CLIPConfig, params: dict) -> None:
    """The JAX package's converted-checkpoint format (``convert.py:219-227``)."""
    meta = np.frombuffer(json.dumps(dataclasses.asdict(cfg)).encode(), dtype=np.uint8)
    np.savez(path, **_flatten(params), __cfg__=meta)


def load_npz_params(path: str) -> Tuple[CLIPConfig, dict]:
    data = dict(np.load(path))
    cfg_kwargs = json.loads(bytes(data.pop("__cfg__")).decode())
    # JSON keeps a tuple as a list; a file written before the RN trunk has none
    cfg_kwargs["vision_layers_per_stage"] = tuple(cfg_kwargs.get("vision_layers_per_stage", ()))
    return CLIPConfig(**cfg_kwargs), params_from_numpy(_unflatten(data), "cpu")
