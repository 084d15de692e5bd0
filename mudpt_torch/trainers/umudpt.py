"""UMuDPT: unified multi-modal deep prompt tuning (counterpart of
``mudpt_tpu/trainers/umudpt.py``, reference trainers/umudpt.py).

One text-side prompt set; the visual prompts are synthesized from it by the
t2v head, LayerNorm -> LightTransformer over the n_ctx tokens of each depth
row -> LayerNorm -> Linear 512 -> 768 (umudpt.py:121-124, :161-178).  Row 0
becomes the layer-0 visual prompt, rows 1..d-1 the deep visual prompts
(umudpt.py:217-230).  The head trains its own weights, so it runs plain
autograd (``layers.residual_block_trainable``), never the frozen towers'
kernel chains.
"""

from __future__ import annotations

import torch

from mudpt_torch.models.clip import cosine_logits, encode_image
from mudpt_torch.models.text import text_forward
from mudpt_torch.trainers.base import TrainerBase
from mudpt_torch.trainers.prompt_utils import (compose_prompts, ctx_vectors_from_init,
                                               embed_classnames, init_prompt_transform_head,
                                               prompt_transform_head, random_ctx)
from mudpt_torch.utils.registry import TRAINER_REGISTRY
from mudpt_torch.utils.rng import new_rng


def head_count(width: int) -> int:
    """The prompt heads' attention heads: one per 64 channels."""
    return width // 64 or 1


def umudpt_text_features(trainable, frozen, aux, *, clip_cfg, compute_dtype,
                         mesh_ctx=None):
    prompts = compose_prompts(trainable["ctx"], aux["token_prefix"], aux["token_suffix"])
    return text_forward(frozen["text"], prompts.to(compute_dtype), aux["eot_idx"],
                        n_head=clip_cfg.transformer_heads,
                        deep_prompts=trainable["deep_prompts"], mesh_ctx=mesh_ctx)


def umudpt_image_logits(trainable, frozen, aux, images, txt, *, clip_cfg, compute_dtype,
                        mesh_ctx=None):
    ctx = trainable["ctx"]
    rows = torch.cat([ctx[None], trainable["deep_prompts"]], dim=0)  # (d, n_ctx, 512)
    visual = prompt_transform_head(trainable["t2v"], rows, head_count(ctx.shape[-1]))
    img = encode_image(frozen, images, clip_cfg, compute_dtype=compute_dtype, mesh_ctx=mesh_ctx,
                       layer0_prompt=visual[0], deep_prompts=visual[1:])
    return cosine_logits(img.float(), txt.float(), frozen["logit_scale"])


def umudpt_forward(trainable, frozen, aux, images, *, clip_cfg, compute_dtype,
                   mesh_ctx=None):
    kw = dict(clip_cfg=clip_cfg, compute_dtype=compute_dtype, mesh_ctx=mesh_ctx)
    txt = umudpt_text_features(trainable, frozen, aux, **kw)
    return umudpt_image_logits(trainable, frozen, aux, images, txt, **kw)


@TRAINER_REGISTRY.register()
class UMuDPT(TrainerBase):
    model_name = "UnifiedMultimodalDeepPromptTuning"  # reference umudpt.py:270
    hparams_key = "UMUDPT"
    requires_vit = True
    forward_fn = staticmethod(umudpt_forward)
    text_fn = staticmethod(umudpt_text_features)
    image_fn = staticmethod(umudpt_image_logits)

    def build_model(self):
        cfg = self.cfg
        hp = getattr(cfg.TRAINER, self.hparams_key)
        clip_cfg, params = self.load_clip()
        self.clip_cfg = clip_cfg
        dim, vdim = clip_cfg.transformer_width, clip_cfg.vision_width
        n_ctx, depth = hp.N_CTX, hp.DEEP_PROMPT_DEPTH
        if depth <= 0:
            raise ValueError("DEEP_PROMPT_DEPTH should be > 0")
        g = new_rng(cfg.SEED, self.device)
        if hp.CTX_INIT:
            ctx = ctx_vectors_from_init(params["text"], hp.CTX_INIT, n_ctx)
            prompt_prefix = " ".join(hp.CTX_INIT.replace("_", " ").split()[:n_ctx])
        else:
            ctx = random_ctx(g, (n_ctx, dim))
            prompt_prefix = " ".join(["X"] * n_ctx)
        print(f'Initial context: "{prompt_prefix}" (n_ctx={n_ctx}, deep prompt depth={depth})')
        trainable = self.build_prompt_params(g, dim, vdim, n_ctx, depth)
        aux_cls = embed_classnames(params["text"], self.classnames, n_ctx, prompt_prefix)
        self.place(frozen=params, aux_class_tree=aux_cls.as_device_tree(), aux_repl=None,
                   trainable={**trainable, "ctx": ctx})
        self._set_forward(self.forward_fn, self.text_fn, self.image_fn,
                          clip_cfg=clip_cfg, compute_dtype=self.compute_dtype)

    def build_prompt_params(self, g, dim, vdim, n_ctx, depth):
        return {
            "deep_prompts": random_ctx(g, (depth - 1, n_ctx, dim)),
            "t2v": init_prompt_transform_head(g, dim, vdim),
        }
