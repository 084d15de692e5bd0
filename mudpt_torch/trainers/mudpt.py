"""MuDPT forward: multi-modal deep prompts with bidirectional cross-modal
projections (counterpart of ``mudpt_tpu/trainers/mudpt.py:41-87``).

Coupling math:

  layer-0 visual prompt        = visual_ctx + embed_projection(ctx)
  visual deep prompts (1..d-1) = deep_projections(deep_prompts)
                                 + visual_ctx_deep_prompts
  text deep prompts (1..d-1)   = deep_prompts
                                 + visual_ctx_deep_projections(visual_ctx_deep_prompts)
  text layer-0 prompt          = [SOS, ctx, class tokens...]

The registered ``MuDPT`` trainer (``mudpt.py:90-146``) builds the trainable
tree of these prompts and the three projections over a frozen CLIP.
"""

from __future__ import annotations

from mudpt_torch.models.clip import cosine_logits, encode_image
from mudpt_torch.models.layers import linear
from mudpt_torch.models.text import text_forward
from mudpt_torch.trainers.base import TrainerBase
from mudpt_torch.trainers.prompt_utils import (compose_prompts, ctx_vectors_from_init,
                                               embed_classnames, init_linear, random_ctx)
from mudpt_torch.utils.profiling import span
from mudpt_torch.utils.registry import TRAINER_REGISTRY
from mudpt_torch.utils.rng import new_rng


def mudpt_text_features(trainable, frozen, aux, *, clip_cfg, compute_dtype,
                        mesh_ctx=None):
    """Class text features (n_cls, embed_dim), encoded once per prompt set."""
    with span("mudpt.prompts"):
        v2t = linear(trainable["visual_ctx_deep_projections"],
                     trainable["visual_ctx_deep_prompts"])
        text_deep = trainable["deep_prompts"] + v2t
        prompts = compose_prompts(trainable["ctx"], aux["token_prefix"],
                                  aux["token_suffix"]).to(compute_dtype)
    return text_forward(
        frozen["text"],
        prompts,
        aux["eot_idx"],
        n_head=clip_cfg.transformer_heads,
        deep_prompts=text_deep,
        mesh_ctx=mesh_ctx,
    )


def mudpt_image_logits(trainable, frozen, aux, images, txt, *, clip_cfg, compute_dtype,
                       mesh_ctx=None):
    """fp32 logits (B, n_cls) of an image batch against cached text features."""
    with span("mudpt.prompts"):
        shared_ctx = linear(trainable["embed_projection"], trainable["ctx"])
        layer0_visual = trainable["visual_ctx"] + shared_ctx
        visual_deep = (
            linear(trainable["deep_projections"], trainable["deep_prompts"])
            + trainable["visual_ctx_deep_prompts"]
        )
    img = encode_image(
        frozen, images, clip_cfg, compute_dtype=compute_dtype, mesh_ctx=mesh_ctx,
        layer0_prompt=layer0_visual, deep_prompts=visual_deep,
    )
    # cosine_logits casts both sides to fp32 inside its span
    return cosine_logits(img, txt, frozen["logit_scale"])


def mudpt_forward(trainable, frozen, aux, images, *, clip_cfg, compute_dtype,
                  mesh_ctx=None):
    """Training forward: text features, then image logits (``mudpt.py:84-87``)."""
    kw = dict(clip_cfg=clip_cfg, compute_dtype=compute_dtype, mesh_ctx=mesh_ctx)
    txt = mudpt_text_features(trainable, frozen, aux, **kw)
    return mudpt_image_logits(trainable, frozen, aux, images, txt, **kw)


@TRAINER_REGISTRY.register()
class MuDPT(TrainerBase):
    model_name = "MultimodalDeepPromptTuning"  # reference mudpt.py:227
    hparams_key = "MUDPT"
    requires_vit = True

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
        trainable = {
            "ctx": ctx,
            "deep_prompts": random_ctx(g, (depth - 1, n_ctx, dim)),
            "embed_projection": init_linear(g, dim, vdim),
            "deep_projections": init_linear(g, dim, vdim),
            "visual_ctx": random_ctx(g, (n_ctx, vdim)),
            "visual_ctx_deep_prompts": random_ctx(g, (depth - 1, n_ctx, vdim)),
            "visual_ctx_deep_projections": init_linear(g, vdim, dim),
        }
        aux_cls = embed_classnames(params["text"], self.classnames, n_ctx, prompt_prefix)
        self.place(frozen=params, aux_class_tree=aux_cls.as_device_tree(), aux_repl=None,
                   trainable=trainable)
        self._set_forward(mudpt_forward, mudpt_text_features, mudpt_image_logits,
                          clip_cfg=clip_cfg, compute_dtype=self.compute_dtype)
