"""User-facing CLIP-style API, the reference's ``clip.load()`` /
``clip.tokenize()`` surface (counterpart of ``mudpt_tpu/api.py``).

    import mudpt_torch.api as clip

    clip_cfg, params, preprocess = clip.load("ViT-B/16")        # or a local path
    tokens = torch.from_numpy(clip.tokenize(["a photo of a cat"]))  # (1, 77)
    image = preprocess(PIL.Image.open("cat.jpg"))                # (224, 224, 3)

    img_feats = clip.encode_image(params, images, clip_cfg)
    txt_feats = clip.encode_text(params, tokens, clip_cfg)
    logits_per_image, logits_per_text = clip.clip_forward(params, images, tokens, clip_cfg)

    # serving: text tower encoded once, then one image pass per batch
    classify = clip.zero_shot_classifier(clip_cfg, params, ["cat", "dog"])
    logits = classify(images)                                    # (B, n_cls)

A registry name (``available_models()``) loads the verified ``.pt`` from
``download_root``, downloading it first on a miss (``download_model``).
Without ``device`` the parameters go to the card (raises without CUDA).
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from mudpt_torch.data.transforms import EvalTransform
from mudpt_torch.models.clip import (  # noqa: F401  (re-exports)
    CLIPConfig,
    clip_forward,
    cosine_logits,
    encode_image,
    encode_text,
)
from mudpt_torch.models.clip import _map
from mudpt_torch.models.convert import load_clip_checkpoint
from mudpt_torch.models.download import available_models, download_model  # noqa: F401
from mudpt_torch.tokenizer import tokenize  # noqa: F401
from mudpt_torch.utils.device import resolve_device


def zero_shot_classifier(clip_cfg, params, classnames, templates=("a photo of a {}.",),
                         compute_dtype=None):
    """A zero-shot classifier for serving (``api.py:38``): the class-prompt
    text tower encoded once, the mean of the normalized text features over
    ``templates``, normalized again (reference zsclip.py:105-115), and a
    ``classify(images) -> logits`` over a normalized (B, H, W, 3) batch on
    the parameters' device.  ``compute_dtype`` defaults to bfloat16 on the
    card and float32 on the CPU."""
    from mudpt_torch.trainers.zsclip import _encode_templates, _zs_inference

    device = params["logit_scale"].device
    if compute_dtype is None:
        compute_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    aux = {"text_features": _encode_templates(params, clip_cfg, list(classnames),
                                              list(templates), compute_dtype, device)}

    @torch.no_grad()
    def classify(images):
        images = torch.as_tensor(images, dtype=torch.float32, device=device)
        return _zs_inference(None, params, aux, images, clip_cfg=clip_cfg,
                             compute_dtype=compute_dtype)

    return classify


def load(name_or_path: str, download_root: str = "~/.cache/clip", device=None) -> Tuple:
    """``(clip_cfg, params, preprocess)`` of a CLIP model by registry name or
    local checkpoint path, an OpenAI ``.pt`` or a converted ``.npz``
    (``api.py:92-110``); ``params`` fp32 on ``device`` (None: the card),
    ``preprocess`` maps a PIL image to a normalized (H, W, 3) float32
    array."""
    path = os.path.expanduser(name_or_path)
    if not os.path.exists(path):
        path = download_model(name_or_path, download_root)
    cfg, params = load_clip_checkpoint(path)
    dev = resolve_device(device)
    return cfg, _map(params, lambda t: t.to(dev)), EvalTransform(size=cfg.image_resolution)
