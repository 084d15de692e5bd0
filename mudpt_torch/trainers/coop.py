"""CoOp: learnable text context vectors (counterpart of
``mudpt_tpu/trainers/coop.py``, reference trainers/coop.py).

Trainable tree = {"ctx"}: (n_ctx, D) shared, or (n_cls, n_ctx, D) with CSC
(class-specific context, coop.py:66-71).  The class-token position (end,
middle, front) is a per-class index map built once (``prompt_utils``).
Only the text tower trains; the vision tower runs its no-save forward.
"""

from __future__ import annotations

import torch

from mudpt_torch.models.clip import cosine_logits, encode_image
from mudpt_torch.models.text import text_forward
from mudpt_torch.trainers.base import TrainerBase
from mudpt_torch.trainers.prompt_utils import (build_position_index_map, compose_prompts,
                                               ctx_vectors_from_init, embed_classnames,
                                               random_ctx)
from mudpt_torch.utils.registry import TRAINER_REGISTRY
from mudpt_torch.utils.rng import new_rng


def coop_text_features(trainable, frozen, aux, *, clip_cfg, compute_dtype,
                       mesh_ctx=None):
    prompts = compose_prompts(trainable["ctx"], aux["token_prefix"], aux["token_suffix"],
                              aux.get("index_map"))
    return text_forward(frozen["text"], prompts.to(compute_dtype), aux["eot_idx"],
                        n_head=clip_cfg.transformer_heads, mesh_ctx=mesh_ctx)


def coop_image_logits(trainable, frozen, aux, images, txt, *, clip_cfg, compute_dtype,
                      mesh_ctx=None):
    img = encode_image(frozen, images, clip_cfg, compute_dtype=compute_dtype, mesh_ctx=mesh_ctx)
    return cosine_logits(img.float(), txt.float(), frozen["logit_scale"])


def coop_forward(trainable, frozen, aux, images, *, clip_cfg, compute_dtype,
                 mesh_ctx=None):
    kw = dict(clip_cfg=clip_cfg, compute_dtype=compute_dtype, mesh_ctx=mesh_ctx)
    txt = coop_text_features(trainable, frozen, aux, **kw)
    return coop_image_logits(trainable, frozen, aux, images, txt, **kw)


@TRAINER_REGISTRY.register()
class CoOp(TrainerBase):
    model_name = "prompt_learner"  # reference coop.py:270
    hparams_key = "COOP"

    def build_model(self):
        cfg = self.cfg
        hp = getattr(cfg.TRAINER, self.hparams_key)
        clip_cfg, params = self.load_clip()
        self.clip_cfg = clip_cfg
        dim = clip_cfg.transformer_width
        n_ctx = hp.N_CTX
        if hp.CTX_INIT:
            ctx_init = hp.CTX_INIT.replace("_", " ")
            n_ctx = len(ctx_init.split(" "))  # coop.py:56
            ctx = ctx_vectors_from_init(params["text"], ctx_init, n_ctx)
            prompt_prefix = ctx_init
        else:
            shape = (self.n_cls_padded, n_ctx, dim) if hp.CSC else (n_ctx, dim)
            ctx = random_ctx(new_rng(cfg.SEED, self.device), shape)
            prompt_prefix = " ".join(["X"] * n_ctx)
        print(f'Initial context: "{prompt_prefix}" (n_ctx={n_ctx})')

        aux_cls = embed_classnames(params["text"], self.classnames, n_ctx, prompt_prefix)
        class_tree = aux_cls.as_device_tree()
        index_map = build_position_index_map(hp.CLASS_TOKEN_POSITION, aux_cls.name_lens, n_ctx,
                                             aux_cls.effective_length())
        if index_map is not None:
            class_tree["index_map"] = torch.from_numpy(index_map).long()
        self.place(frozen=params, aux_class_tree=class_tree, aux_repl=None,
                   trainable={"ctx": ctx})
        self._set_forward(coop_forward, coop_text_features, coop_image_logits,
                          clip_cfg=clip_cfg, compute_dtype=self.compute_dtype)
