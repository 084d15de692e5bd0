"""MuDPT inference: multi-modal deep prompts with bidirectional cross-modal
projections (counterpart of ``mudpt_tpu/trainers/mudpt.py:41-81``).

Coupling math:

  layer-0 visual prompt        = visual_ctx + embed_projection(ctx)
  visual deep prompts (1..d-1) = deep_projections(deep_prompts)
                                 + visual_ctx_deep_prompts
  text deep prompts (1..d-1)   = deep_prompts
                                 + visual_ctx_deep_projections(visual_ctx_deep_prompts)
  text layer-0 prompt          = [SOS, ctx, class tokens...]

The ``MuDPT`` trainer class waits for the engine slice.
"""

from __future__ import annotations

from mudpt_torch.models.clip import cosine_logits, encode_image
from mudpt_torch.models.layers import linear
from mudpt_torch.models.text import text_forward
from mudpt_torch.trainers.prompt_utils import compose_prompts


def mudpt_text_features(trainable, frozen, aux, *, clip_cfg, compute_dtype):
    """Class text features (n_cls, embed_dim), encoded once per prompt set."""
    v2t = linear(trainable["visual_ctx_deep_projections"], trainable["visual_ctx_deep_prompts"])
    text_deep = trainable["deep_prompts"] + v2t
    prompts = compose_prompts(trainable["ctx"], aux["token_prefix"], aux["token_suffix"])
    return text_forward(
        frozen["text"],
        prompts.to(compute_dtype),
        aux["eot_idx"],
        n_head=clip_cfg.transformer_heads,
        deep_prompts=text_deep,
    )


def mudpt_image_logits(trainable, frozen, aux, images, txt, *, clip_cfg, compute_dtype):
    """fp32 logits (B, n_cls) of an image batch against cached text features."""
    shared_ctx = linear(trainable["embed_projection"], trainable["ctx"])
    layer0_visual = trainable["visual_ctx"] + shared_ctx
    visual_deep = (
        linear(trainable["deep_projections"], trainable["deep_prompts"])
        + trainable["visual_ctx_deep_prompts"]
    )
    img = encode_image(
        frozen, images, clip_cfg, compute_dtype=compute_dtype,
        layer0_prompt=layer0_visual, deep_prompts=visual_deep,
    )
    return cosine_logits(img.float(), txt.float(), frozen["logit_scale"])
