"""Export trained prompt trees as reference-format (PyTorch/Dassl)
checkpoints, the inverse of ``models/import_reference.py`` (counterpart of
``mudpt_tpu/models/export_reference.py``).

The ``torch.save({"state_dict", "epoch"})`` pickle loads through the
reference's own ``load_model`` (``checkpoint["state_dict"]`` into
``load_state_dict(strict=False)`` after the class-dependent token
prefix/suffix buffers are deleted, reference trainers/mudpt.py:286-303), so
only the learned prompt weights are written.  Key mapping is the exact
inverse of the importer: (in, out) linear weights transpose back to torch's
(out, in), LayerNorm scale/bias become weight/bias, and the fused ``qkv_w``
splits back into ``nn.MultiheadAttention``'s ``in_proj_weight``.

Given the trainer's name (the checkpoint meta's ``trainer``), the family is
the trainer's; without one it is inferred from the tree's keys, as the JAX
exporter infers it.  The two differ on one tree: MPT with
``VISUAL_PROMPT_DEPTH 0`` and ``TEXT_PROMPT_DEPTH <= 1`` trains ``ctx``
alone, which the key rule exports as CoOp's bare ``ctx``; under trainer
``MPT`` it is ``text_prompt_learner.visual_ctx``, the key the reference MPT
loads.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from mudpt_torch.utils.checkpoint import to_numpy

# the reference family of each trainer name (and of the importer's families)
FAMILIES = {"MuDPT": "MuDPT", "UMuDPT": "UMuDPT", "UUMuDPT": "UUMuDPT", "CoCoOp": "CoCoOp",
            "CoOp": "CoOp", "VPT": "VPT/MPT", "MPT": "VPT/MPT", "VPT/MPT": "VPT/MPT"}


def _t(x) -> np.ndarray:
    return np.asarray(to_numpy(x), dtype=np.float32)


def _lin(out: Dict[str, Any], prefix: str, p: dict) -> None:
    out[prefix + ".weight"] = _t(p["w"]).T.copy()
    out[prefix + ".bias"] = _t(p["b"])


def _ln(out: Dict[str, Any], prefix: str, p: dict) -> None:
    out[prefix + ".weight"] = _t(p["scale"])
    out[prefix + ".bias"] = _t(p["bias"])


def _light_transformer(out: Dict[str, Any], prefix: str, p: dict) -> None:
    _ln(out, f"{prefix}.ln_1", p["ln_1"])
    out[f"{prefix}.attn.in_proj_weight"] = _t(p["attn"]["qkv_w"]).T.copy()
    out[f"{prefix}.attn.in_proj_bias"] = _t(p["attn"]["qkv_b"])
    out[f"{prefix}.attn.out_proj.weight"] = _t(p["attn"]["out_w"]).T.copy()
    out[f"{prefix}.attn.out_proj.bias"] = _t(p["attn"]["out_b"])
    _ln(out, f"{prefix}.ln_2", p["ln_2"])
    out[f"{prefix}.mlp.c_fc.weight"] = _t(p["mlp"]["fc_w"]).T.copy()
    out[f"{prefix}.mlp.c_fc.bias"] = _t(p["mlp"]["fc_b"])
    out[f"{prefix}.mlp.c_proj.weight"] = _t(p["mlp"]["proj_w"]).T.copy()
    out[f"{prefix}.mlp.c_proj.bias"] = _t(p["mlp"]["proj_b"])


def _head(out: Dict[str, Any], p: dict, ln_pre: str, block: str, ln_post: str,
          proj: str) -> None:
    _ln(out, ln_pre, p["ln_pre"])
    _light_transformer(out, block, p["block"])
    _ln(out, ln_post, p["ln_post"])
    _lin(out, proj, p["proj"])


def infer_family(trainable: dict) -> str:
    """The family the JAX exporter reads off the tree's keys."""
    if "embed_projection" in trainable:
        return "MuDPT"
    if "v2t" in trainable:
        return "UUMuDPT"
    if "t2v" in trainable:
        return "UMuDPT"
    if "meta_net" in trainable:
        return "CoCoOp"
    # any tree still holding visual_ctx is VPT/MPT (MuDPT and UUMuDPT
    # matched above), MPT's depth-1 {ctx, visual_ctx} included
    if set(trainable) & {"visual_deep_prompts", "text_deep_prompts", "visual_ctx"}:
        return "VPT/MPT"
    if "ctx" in trainable:
        return "CoOp"
    raise ValueError(f"Unrecognized trainable tree: keys {sorted(trainable)} match no "
                     "reference trainer signature")


def trainable_to_reference_state_dict(
    trainable: dict, trainer: Optional[str] = None,
) -> Tuple[Dict[str, np.ndarray], str]:
    """The trainable tree as reference state-dict keys: (flat numpy state
    dict, family).  ``trainer`` (a trainer name or an imported family)
    decides the family; None infers it from the keys."""
    if trainer is None:
        family = infer_family(trainable)
    elif trainer in FAMILIES:
        family = FAMILIES[trainer]
    else:
        raise ValueError(f"trainer {trainer!r} has no reference checkpoint layout; "
                         f"known: {sorted(FAMILIES)}")
    sd: Dict[str, np.ndarray] = {}
    if family == "MuDPT":
        pl = "mudpt_prompt_learner"
        sd[f"{pl}.ctx"] = _t(trainable["ctx"])
        sd[f"{pl}.deep_prompts"] = _t(trainable["deep_prompts"])
        _lin(sd, f"{pl}.embed_projection", trainable["embed_projection"])
        _lin(sd, f"{pl}.deep_projections", trainable["deep_projections"])
        sd["image_encoder.visual_ctx"] = _t(trainable["visual_ctx"])
        sd["image_encoder.visual_ctx_deep_prompts"] = _t(trainable["visual_ctx_deep_prompts"])
        _lin(sd, "image_encoder.visual_ctx_deep_projections",
             trainable["visual_ctx_deep_projections"])
    elif family in ("UUMuDPT", "UMuDPT"):
        pl = f"{family.lower()}_prompt_learner"
        sd[f"{pl}.ctx"] = _t(trainable["ctx"])
        sd[f"{pl}.deep_prompts"] = _t(trainable["deep_prompts"])
        _head(sd, trainable["t2v"], f"{pl}.ln_pre", f"{pl}.self_attn", f"{pl}.ln_post",
              f"{pl}.visual_proj")
        if family == "UUMuDPT":
            sd["image_encoder.visual_ctx"] = _t(trainable["visual_ctx"])
            sd["image_encoder.visual_ctx_deep_prompts"] = _t(
                trainable["visual_ctx_deep_prompts"])
            _head(sd, trainable["v2t"], "image_encoder.visual_ctx_ln_intra_pre",
                  "image_encoder.visual_ctx_self_attn", "image_encoder.visual_ctx_ln_intra_post",
                  "image_encoder.visual_ctx_text_proj")
    elif family == "CoCoOp":  # learner-only checkpoint
        sd["ctx"] = _t(trainable["ctx"])
        _lin(sd, "meta_net.linear1", trainable["meta_net"]["linear1"])
        _lin(sd, "meta_net.linear2", trainable["meta_net"]["linear2"])
    elif family == "VPT/MPT":  # per-block visual_ctx params on both towers
        if "ctx" in trainable:
            # MPT's learnable layer-0 text context: the reference keeps it on
            # the TextPromptLearner under the name visual_ctx (mpt.py:77)
            sd["text_prompt_learner.visual_ctx"] = _t(trainable["ctx"])
        if "visual_ctx" in trainable:
            sd["image_encoder.visual_ctx"] = _t(trainable["visual_ctx"])
        for tower, key in (("image_encoder", "visual_deep_prompts"),
                           ("text_encoder", "text_deep_prompts")):
            if key in trainable:
                stack = _t(trainable[key])
                for i in range(stack.shape[0]):
                    sd[f"{tower}.transformer.resblocks.{i + 1}.visual_ctx"] = stack[i]
    else:  # CoOp, learner-only
        sd["ctx"] = _t(trainable["ctx"])
    return sd, family


def save_reference_checkpoint(path: str, trainable: dict, epoch: int = 0,
                              trainer: Optional[str] = None) -> str:
    """Write a reference-loadable torch pickle of the trainable tree."""
    import torch

    sd, _ = trainable_to_reference_state_dict(trainable, trainer)
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in sd.items()},
                "epoch": int(epoch)}, path)
    return path
