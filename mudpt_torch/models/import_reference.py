"""Import reference-trained (PyTorch/Dassl) checkpoints as trainable trees
(counterpart of ``mudpt_tpu/models/import_reference.py``).

The reference saves ``torch.save({"state_dict": ..., "epoch": ...})`` under
``<output_dir>/<registered_name>/model.pth.tar-<E>`` (Dassl's
``save_checkpoint``).  The port keeps the same directory and filename
contract, so ``--eval_only --model_dir`` (or ``MODEL.INIT_WEIGHTS``) can name
a reference output directory: ``utils/checkpoint.load_checkpoint`` detects
the torch pickle and routes it here.  Only the learned prompt weights are
imported; the class-dependent token prefix/suffix buffers are rebuilt from
the live dataset (the reference's own ``load_model``, mudpt.py:293-303), and
torch optimizer state is not translated (a resume starts its momentum
afresh).

The trainer family is inferred from the state dict's key names (each
reference trainer has a distinctive learner prefix).  Key mapping follows
``models/convert.py``: ``nn.Linear`` weights transpose to (in, out),
LayerNorm weight/bias become scale/bias, and ``nn.MultiheadAttention``'s
fused in-projection becomes ``qkv_w``/``qkv_b``.  Leaves go through
``utils/checkpoint.to_numpy`` (so bf16 tensors convert); fp16 leaves come
up to fp32.  Returns numpy trees.
"""

from __future__ import annotations

import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np

from mudpt_torch.utils.checkpoint import to_numpy


def is_torch_checkpoint(path: str) -> bool:
    """True when ``path`` is a torch pickle (zip-format ``torch.save`` -- a
    zip with a ``data.pkl`` member -- or a legacy protocol-2 pickle).  An
    ``.npz`` is also a zip, so membership decides, not the magic alone."""
    try:
        with open(path, "rb") as f:
            magic = f.read(2)
    except OSError:
        return False
    if magic == b"PK":
        try:
            with zipfile.ZipFile(path) as z:
                return any(n.endswith("data.pkl") for n in z.namelist())
        except zipfile.BadZipFile:
            return False
    return magic[:1] == b"\x80"


def _np(t) -> np.ndarray:
    a = to_numpy(t)
    # fp16 backbone-era params come up to fp32 (the trainable dtype)
    return a.astype(np.float32) if a.dtype == np.float16 else a


def _lin(sd: Dict[str, Any], prefix: str) -> dict:
    """torch nn.Linear (out, in) -> {"w": (in, out), "b": (out,)}."""
    return {"w": _np(sd[prefix + ".weight"]).T.copy(), "b": _np(sd[prefix + ".bias"])}


def _ln(sd: Dict[str, Any], prefix: str) -> dict:
    return {"scale": _np(sd[prefix + ".weight"]), "bias": _np(sd[prefix + ".bias"])}


def _light_transformer(sd: Dict[str, Any], prefix: str) -> dict:
    """Reference ``LightTransformer`` (umudpt.py:56-77): a residual MHA+MLP
    block with a torch ``nn.MultiheadAttention`` -> the port's block layout."""
    return {
        "ln_1": _ln(sd, f"{prefix}.ln_1"),
        "attn": {
            "qkv_w": _np(sd[f"{prefix}.attn.in_proj_weight"]).T.copy(),
            "qkv_b": _np(sd[f"{prefix}.attn.in_proj_bias"]),
            "out_w": _np(sd[f"{prefix}.attn.out_proj.weight"]).T.copy(),
            "out_b": _np(sd[f"{prefix}.attn.out_proj.bias"]),
        },
        "ln_2": _ln(sd, f"{prefix}.ln_2"),
        "mlp": {
            "fc_w": _np(sd[f"{prefix}.mlp.c_fc.weight"]).T.copy(),
            "fc_b": _np(sd[f"{prefix}.mlp.c_fc.bias"]),
            "proj_w": _np(sd[f"{prefix}.mlp.c_proj.weight"]).T.copy(),
            "proj_b": _np(sd[f"{prefix}.mlp.c_proj.bias"]),
        },
    }


def _head(sd: Dict[str, Any], ln_pre: str, block: str, ln_post: str, proj: str) -> dict:
    """LN -> LightTransformer -> LN -> Linear prompt-synthesis head
    (reference umudpt.py:121-124)."""
    return {"ln_pre": _ln(sd, ln_pre), "block": _light_transformer(sd, block),
            "ln_post": _ln(sd, ln_post), "proj": _lin(sd, proj)}


def _stacked_resblock_ctx(sd: Dict[str, Any], tower: str) -> Optional[np.ndarray]:
    """Stack ``<tower>.transformer.resblocks.{i}.visual_ctx`` (the per-block
    deep prompts of the VPT/MPT block variant) in layer order.  Blocks
    1..depth-1 own prompts; layer 0 never does."""
    found = {}
    pre, post = f"{tower}.transformer.resblocks.", ".visual_ctx"
    for k in sd:
        if k.startswith(pre) and k.endswith(post):
            mid = k[len(pre):-len(post)]
            if mid.isdigit():
                found[int(mid)] = _np(sd[k])
    if not found:
        return None
    return np.stack([found[i] for i in sorted(found)])


def _mudpt_visual(sd: Dict[str, Any]) -> dict:
    return {"visual_ctx": _np(sd["image_encoder.visual_ctx"]),
            "visual_ctx_deep_prompts": _np(sd["image_encoder.visual_ctx_deep_prompts"])}


def reference_state_dict_to_trainable(sd: Dict[str, Any]) -> Tuple[dict, str]:
    """A reference checkpoint's ``state_dict`` -> (trainable tree, detected
    trainer family).  Raises ``ValueError`` when no reference prompt-learner
    signature is recognised."""
    if "mudpt_prompt_learner.ctx" in sd:
        pl = "mudpt_prompt_learner"
        return {
            "ctx": _np(sd[f"{pl}.ctx"]),
            "deep_prompts": _np(sd[f"{pl}.deep_prompts"]),
            "embed_projection": _lin(sd, f"{pl}.embed_projection"),
            "deep_projections": _lin(sd, f"{pl}.deep_projections"),
            **_mudpt_visual(sd),
            "visual_ctx_deep_projections": _lin(sd, "image_encoder.visual_ctx_deep_projections"),
        }, "MuDPT"
    for family in ("UUMuDPT", "UMuDPT"):
        pl = f"{family.lower()}_prompt_learner"
        if f"{pl}.ctx" not in sd:
            continue
        tree = {
            "ctx": _np(sd[f"{pl}.ctx"]),
            "deep_prompts": _np(sd[f"{pl}.deep_prompts"]),
            "t2v": _head(sd, f"{pl}.ln_pre", f"{pl}.self_attn", f"{pl}.ln_post",
                         f"{pl}.visual_proj"),
        }
        if family == "UUMuDPT":
            tree.update(_mudpt_visual(sd))
            tree["v2t"] = _head(sd, "image_encoder.visual_ctx_ln_intra_pre",
                                "image_encoder.visual_ctx_self_attn",
                                "image_encoder.visual_ctx_ln_intra_post",
                                "image_encoder.visual_ctx_text_proj")
        return tree, family
    if "meta_net.linear1.weight" in sd:
        return {"ctx": _np(sd["ctx"]),
                "meta_net": {"linear1": _lin(sd, "meta_net.linear1"),
                             "linear2": _lin(sd, "meta_net.linear2")}}, "CoCoOp"
    if "ctx" in sd:  # CoOp PromptLearner: ctx (+ class buffers, dropped)
        return {"ctx": _np(sd["ctx"])}, "CoOp"
    # VPT/MPT: a whole-model dict whose only learned params are the
    # visual_ctx names.  MPT's TextPromptLearner also owns the layer-0 text
    # context, a parameter ALSO named visual_ctx (mpt.py:77, the freeze-rule
    # trick), which maps to the "ctx" leaf
    tree: dict = {}
    if "text_prompt_learner.visual_ctx" in sd:
        tree["ctx"] = _np(sd["text_prompt_learner.visual_ctx"])
    if "image_encoder.visual_ctx" in sd:
        tree["visual_ctx"] = _np(sd["image_encoder.visual_ctx"])
    for tower, key in (("image_encoder", "visual_deep_prompts"),
                       ("text_encoder", "text_deep_prompts")):
        stack = _stacked_resblock_ctx(sd, tower)
        if stack is not None:
            tree[key] = stack
    if tree:
        return tree, "VPT/MPT"
    raise ValueError(
        "Unrecognized reference checkpoint: no known prompt-learner keys "
        "(expected one of mudpt/umudpt/uumudpt_prompt_learner.*, ctx, or "
        "*.visual_ctx). Keys seen: " + ", ".join(sorted(sd)[:8]) + " ..."
    )


def load_reference_checkpoint(path: str) -> Tuple[dict, Dict[str, Any]]:
    """A reference torch checkpoint file -> (trainable tree, meta).  Takes
    the Dassl envelope ``{"state_dict": ..., "epoch": ...}`` or a bare state
    dict, its keys with or without nn.DataParallel's ``module.`` prefix."""
    import torch

    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        # older pickles (or exotic scheduler state): a full unpickle, which
        # a user-supplied checkpoint may take
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in dict(sd).items()}
    tree, trainer = reference_state_dict_to_trainable(sd)
    meta = {"trainer": trainer, "imported_from": "reference-torch"}
    if isinstance(ckpt, dict) and "epoch" in ckpt:
        try:
            meta["epoch"] = int(ckpt["epoch"])
        except (TypeError, ValueError):
            pass
    print(f"Imported reference {trainer} checkpoint from {path} "
          f"({sum(np.size(x) for x in _leaves(tree))} prompt params)")
    return tree, meta


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
