"""UUMuDPT: bidirectional unified multi-modal deep prompt tuning
(counterpart of ``mudpt_tpu/trainers/uumudpt.py``, reference
trainers/uumudpt.py and ``VisionTransformer_UUMuDPT``,
clip/model.py:600-664): UMuDPT's t2v head plus visual prompt residuals and
a v2t head mapping the visual deep prompts back to text space:

  layer-0 visual  = t2v(ctx row) + visual_ctx                (model.py:638-640)
  visual deep     = t2v(deep rows) + visual_ctx_deep_prompts (model.py:643)
  textual prompts = v2t(visual_ctx_deep_prompts)             (model.py:645-652)
  text deep       = deep_prompts + textual prompts           (uumudpt.py:224)
"""

from __future__ import annotations

import torch

from mudpt_torch.models.clip import cosine_logits, encode_image
from mudpt_torch.models.text import text_forward
from mudpt_torch.trainers.prompt_utils import (compose_prompts, init_prompt_transform_head,
                                               prompt_transform_head, random_ctx)
from mudpt_torch.trainers.umudpt import UMuDPT, head_count
from mudpt_torch.utils.registry import TRAINER_REGISTRY


def uumudpt_text_features(trainable, frozen, aux, *, clip_cfg, compute_dtype,
                          mesh_ctx=None):
    v_deep = trainable["visual_ctx_deep_prompts"]  # (d-1, n_ctx, 768)
    v2t = prompt_transform_head(trainable["v2t"], v_deep, head_count(v_deep.shape[-1]))
    prompts = compose_prompts(trainable["ctx"], aux["token_prefix"], aux["token_suffix"])
    return text_forward(frozen["text"], prompts.to(compute_dtype), aux["eot_idx"],
                        n_head=clip_cfg.transformer_heads,
                        deep_prompts=trainable["deep_prompts"] + v2t, mesh_ctx=mesh_ctx)


def uumudpt_image_logits(trainable, frozen, aux, images, txt, *, clip_cfg, compute_dtype,
                         mesh_ctx=None):
    ctx = trainable["ctx"]
    rows = torch.cat([ctx[None], trainable["deep_prompts"]], dim=0)
    t2v = prompt_transform_head(trainable["t2v"], rows, head_count(ctx.shape[-1]))
    img = encode_image(frozen, images, clip_cfg, compute_dtype=compute_dtype, mesh_ctx=mesh_ctx,
                       layer0_prompt=t2v[0] + trainable["visual_ctx"],
                       deep_prompts=t2v[1:] + trainable["visual_ctx_deep_prompts"])
    return cosine_logits(img.float(), txt.float(), frozen["logit_scale"])


def uumudpt_forward(trainable, frozen, aux, images, *, clip_cfg, compute_dtype,
                    mesh_ctx=None):
    kw = dict(clip_cfg=clip_cfg, compute_dtype=compute_dtype, mesh_ctx=mesh_ctx)
    txt = uumudpt_text_features(trainable, frozen, aux, **kw)
    return uumudpt_image_logits(trainable, frozen, aux, images, txt, **kw)


@TRAINER_REGISTRY.register()
class UUMuDPT(UMuDPT):
    model_name = "UnifiedMultimodalDeepPromptTuning"  # reference uumudpt.py:276
    hparams_key = "UUMUDPT"
    forward_fn = staticmethod(uumudpt_forward)
    text_fn = staticmethod(uumudpt_text_features)
    image_fn = staticmethod(uumudpt_image_logits)

    def build_prompt_params(self, g, dim, vdim, n_ctx, depth):
        return {
            "deep_prompts": random_ctx(g, (depth - 1, n_ctx, dim)),
            "t2v": init_prompt_transform_head(g, dim, vdim),
            "visual_ctx": random_ctx(g, (n_ctx, vdim)),
            "visual_ctx_deep_prompts": random_ctx(g, (depth - 1, n_ctx, vdim)),
            "v2t": init_prompt_transform_head(g, vdim, dim),
        }
