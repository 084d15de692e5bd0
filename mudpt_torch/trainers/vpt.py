"""VPT and MPT: independent deep visual (and text) prompts (counterpart of
``mudpt_tpu/trainers/vpt.py``, reference trainers/vpt.py and mpt.py).

VPT's text prompt is the fixed hand prompt ("a photo of a <cls>."), so its
text features depend on the frozen tower only: they are encoded once at
build and cached (``base._cache_static_text``), and a VPT step runs the
vision tower alone.  MPT owns a learnable layer-0 text context spliced
between SOS and the class-name suffix (mpt.py:77, :95-124) and deep text
prompts.

Trainable tree (whatever the config enables):
  ctx                  (txt_n_ctx, 512)              MPT layer-0 text splice
  visual_ctx           (img_n_ctx, 768)              layer-0 append
  visual_deep_prompts  (vis_depth-1, img_n_ctx, 768) blocks 1..depth-1
  text_deep_prompts    (txt_depth-1, txt_n_ctx, 512) blocks 1..depth-1
"""

from __future__ import annotations

import torch

from mudpt_torch.models.clip import cosine_logits, encode_image
from mudpt_torch.models.text import text_forward
from mudpt_torch.trainers.base import TrainerBase
from mudpt_torch.trainers.prompt_utils import (compose_prompts, ctx_vectors_from_init,
                                               embed_classnames, random_ctx)
from mudpt_torch.utils.registry import TRAINER_REGISTRY
from mudpt_torch.utils.rng import new_rng


def vpt_text_features(trainable, frozen, aux, *, clip_cfg, compute_dtype,
                      mesh_ctx=None):
    ctx = trainable.get("ctx")
    if ctx is not None:  # MPT: the learnable layer-0 text ctx
        prompts = compose_prompts(ctx, aux["token_prefix"], aux["token_suffix"])
    else:  # VPT: the fixed hand prompt's embeddings
        prompts = torch.cat([aux["token_prefix"], aux["token_suffix"]], dim=1)
    return text_forward(frozen["text"], prompts.to(compute_dtype), aux["eot_idx"],
                        n_head=clip_cfg.transformer_heads,
                        deep_prompts=trainable.get("text_deep_prompts"), mesh_ctx=mesh_ctx)


def vpt_image_logits(trainable, frozen, aux, images, txt, *, clip_cfg, compute_dtype,
                     mesh_ctx=None):
    img = encode_image(frozen, images, clip_cfg, compute_dtype=compute_dtype, mesh_ctx=mesh_ctx,
                       layer0_prompt=trainable.get("visual_ctx"),
                       deep_prompts=trainable.get("visual_deep_prompts"))
    return cosine_logits(img.float(), txt.float(), frozen["logit_scale"])


def vpt_forward(trainable, frozen, aux, images, *, clip_cfg, compute_dtype,
                mesh_ctx=None):
    kw = dict(clip_cfg=clip_cfg, compute_dtype=compute_dtype, mesh_ctx=mesh_ctx)
    txt = vpt_text_features(trainable, frozen, aux, **kw)
    return vpt_image_logits(trainable, frozen, aux, images, txt, **kw)


@TRAINER_REGISTRY.register()
class VPT(TrainerBase):
    model_name = "VisualPromptLearner"  # reference vpt.py:159
    hparams_key = "VPT"
    requires_vit = True
    text_l0_ctx = False  # MPT's learnable layer-0 text ctx (mpt.py:77)

    def build_model(self):
        cfg = self.cfg
        hp = getattr(cfg.TRAINER, self.hparams_key)
        clip_cfg, params = self.load_clip()
        self.clip_cfg = clip_cfg
        tdim, vdim = clip_cfg.transformer_width, clip_cfg.vision_width
        g = new_rng(cfg.SEED, self.device)

        trainable = {}
        vis_depth, vis_n = hp.VISUAL_PROMPT_DEPTH, hp.DEEP_VISUAL_N_CTX
        if 0 < vis_depth <= clip_cfg.vision_layers and vis_n > 0:
            trainable["visual_ctx"] = random_ctx(g, (vis_n, vdim))
            if vis_depth > 1:
                trainable["visual_deep_prompts"] = random_ctx(g, (vis_depth - 1, vis_n, vdim))
        txt_depth, txt_n = hp.TEXT_PROMPT_DEPTH, hp.DEEP_TEXT_N_CTX
        if txt_depth > 1 and txt_n > 0:
            trainable["text_deep_prompts"] = random_ctx(g, (txt_depth - 1, txt_n, tdim))
        ctx_init = hp.TEXT_CTX_INIT.replace("_", " ")
        n_ctx_embed = 0
        if self.text_l0_ctx and txt_n > 0:
            # from the first txt_n tokens of TEXT_CTX_INIT (the class prompts
            # keep the whole phrase as prefix, mpt.py:64,79), else random
            if ctx_init:
                trainable["ctx"] = ctx_vectors_from_init(params["text"], ctx_init, txt_n)
                prompt_prefix = ctx_init
            else:
                trainable["ctx"] = random_ctx(g, (txt_n, tdim))
                prompt_prefix = " ".join(["X"] * txt_n)
            n_ctx_embed = txt_n
        else:
            prompt_prefix = ctx_init
        if not trainable:
            raise ValueError(
                f"{cfg.TRAINER.NAME}: no prompts enabled — set "
                "VISUAL_PROMPT_DEPTH/DEEP_VISUAL_N_CTX (and/or TEXT_* for MPT)"
            )
        print(f"Trainable prompts: {sorted(trainable)}")
        # no text-side trainables: the text features are a function of the
        # frozen tower, encoded once at build (vpt.py:96-101 re-encodes
        # every step)
        self.static_text = "text_deep_prompts" not in trainable and "ctx" not in trainable
        aux_cls = embed_classnames(params["text"], self.classnames, n_ctx_embed, prompt_prefix)
        self.place(frozen=params, aux_class_tree=aux_cls.as_device_tree(), aux_repl=None,
                   trainable=trainable)
        self._set_forward(vpt_forward, vpt_text_features, vpt_image_logits,
                          clip_cfg=clip_cfg, compute_dtype=self.compute_dtype)


@TRAINER_REGISTRY.register()
class MPT(VPT):
    """Multi-modal independent prompts (reference trainers/mpt.py:177-293):
    VPT's deep prompts and MPT's learnable layer-0 text context."""

    model_name = "MultiModalPromptLearner"  # reference mpt.py:217
    hparams_key = "MPT"
    text_l0_ctx = True
