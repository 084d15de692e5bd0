"""Zero-shot CLIP trainers (counterpart of ``mudpt_tpu/trainers/zsclip.py``,
reference trainers/zsclip.py:51-118).

``ZeroshotCLIP``: the dataset's hand template, its text features encoded
once at build.  ``ZeroshotCLIP2``: prompt ensembling, the mean of the
normalized text features over IMAGENET_TEMPLATES_SELECT (and the dataset's
template when it is not ImageNet), normalized again.  Nothing trains:
``train()`` runs ``test()``.
"""

from __future__ import annotations

import torch

from mudpt_torch.models.clip import encode_image, encode_text
from mudpt_torch.models.text import effective_text_length
from mudpt_torch.tokenizer import tokenize
from mudpt_torch.trainers.base import TrainerBase
from mudpt_torch.trainers.templates import CUSTOM_TEMPLATES, IMAGENET_TEMPLATES_SELECT
from mudpt_torch.utils.registry import TRAINER_REGISTRY


@torch.no_grad()
def _encode_templates(params, clip_cfg, classnames, templates, compute_dtype, device):
    """Mean of the normalized text features over the templates
    (``zsclip.py:27-50``), each template's token rows cut to its EOT-truncated
    length (the tower is causal and reads only the EOT row)."""
    mean = 0.0
    for temp in templates:
        toks = tokenize([temp.format(c.replace("_", " ")) for c in classnames])
        L = effective_text_length(int(toks.argmax(axis=-1).max()), toks.shape[1])
        tokens = torch.from_numpy(toks[:, :L]).to(device)
        feats = encode_text(params, tokens, clip_cfg, compute_dtype=compute_dtype).float()
        mean = mean + feats / feats.norm(dim=-1, keepdim=True)
    mean = mean / len(templates)
    return mean / mean.norm(dim=-1, keepdim=True)


def _zs_inference(trainable, frozen, aux, images, *, clip_cfg, compute_dtype, mesh_ctx=None):
    """fp32 logits of an image batch against the cached, normalized text
    features (``zsclip.py:53-62``)."""
    img = encode_image(frozen, images, clip_cfg, compute_dtype=compute_dtype,
                       mesh_ctx=mesh_ctx).float()
    img = img / img.norm(dim=-1, keepdim=True)
    return frozen["logit_scale"].float().exp() * (img @ aux["text_features"].T)


@TRAINER_REGISTRY.register()
class ZeroshotCLIP(TrainerBase):
    model_name = "zsclip"
    templates = None  # the dataset's one template
    # the reference serves zero-shot on its fp16 backbone (clip/model.py:917;
    # zsclip.py never floats it): bfloat16 here
    prec_default = "fp16"

    def template_list(self) -> list:
        """The dataset's template, or the ensemble and, but for ImageNet,
        the dataset's template (``zsclip.py:84-91``)."""
        name = self.cfg.DATASET.NAME
        if self.templates is None:
            return [CUSTOM_TEMPLATES[name]]
        return list(self.templates) + ([CUSTOM_TEMPLATES[name]] if name != "ImageNet" else [])

    def build_model(self):
        clip_cfg, params = self.load_clip()
        self.clip_cfg = clip_cfg
        text_features = _encode_templates(params, clip_cfg, self.classnames,
                                          self.template_list(), self.compute_dtype, self.device)
        self.place(frozen=params, aux_class_tree={"text_features": text_features},
                   aux_repl=None, trainable=None)
        self._set_forward(_zs_inference, clip_cfg=clip_cfg, compute_dtype=self.compute_dtype)
        self.model_inference = self.forward

    def train(self):  # zero-shot has nothing to train
        self.test()


@TRAINER_REGISTRY.register()
class ZeroshotCLIP2(ZeroshotCLIP):
    """Prompt ensembling (``zsclip.py:110-113``)."""

    templates = IMAGENET_TEMPLATES_SELECT
