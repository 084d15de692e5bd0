"""CoCoOp: instance-conditional prompts through a meta-network (counterpart
of ``mudpt_tpu/trainers/cocoop.py``, reference trainers/cocoop.py).

A two-layer meta-net maps each normalized image feature to a bias added to
the shared context (cocoop.py:99-103, :148-163), so each image gets its own
n_cls text encodes.  The per-instance encode is ONE 4-D (B, n_cls, S, D)
``text_forward`` call: its B*n_cls rows go through the tower as one batch,
and the save/recompute rule sees that row count (from 512 x 80 row-tokens
the text layers run the half-blocks with saves off).  Chunked, each chunk of
instances runs under ``torch.utils.checkpoint`` with saves off, so only one
chunk's encode is live at a time and the backward recomputes it.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from mudpt_torch.models import layers
from mudpt_torch.models.clip import encode_image
from mudpt_torch.models.layers import linear
from mudpt_torch.models.text import text_forward
from mudpt_torch.ops.fused_block import saved_acts
from mudpt_torch.trainers.base import TrainerBase
from mudpt_torch.trainers.prompt_utils import (compose_prompts, ctx_vectors_from_init,
                                               embed_classnames, init_linear, random_ctx)
from mudpt_torch.utils.registry import TRAINER_REGISTRY
from mudpt_torch.utils.rng import new_rng


def _resolve_chunk(chunk: int, batch: int, n_cls: int, padded_seq: int = 80,
                   n_shards: int = 1, shard_quantum: int = 1) -> int:
    """Instances per chunk of the per-instance text encode (``cocoop.py:36-86``).

    0 = auto: one chunk's live set capped at 6553 x 80 row-tokens (n_cls x
    chunk x padded_seq), the JAX package's measured budget; unchunked when
    the whole batch fits, else the largest divisor of the batch under the
    cap (a non-dividing chunk pads its last chunk with repeated instances).
    ``n_shards`` scales the budget by the ranks the rows shard over, in
    chunks that are multiples of ``shard_quantum`` (the data axis: each
    chunk's instances split over it).  -1 = never chunk."""
    if chunk == -1:
        return batch
    if chunk == 0:
        base_budget = 6553 * 80
        row_tokens = max(1, n_cls * padded_seq)
        cap = max(1, base_budget * max(1, n_shards) // row_tokens)
        if cap >= batch:
            return batch
        quantum = max(1, shard_quantum)
        for d in range(cap, 0, -1):
            if batch % d == 0 and d % quantum == 0:
                return d
        cap1 = max(1, base_budget // row_tokens)
        for d in range(min(cap1, batch), 0, -1):
            if batch % d == 0:
                return d
        return 1
    return max(1, min(chunk, batch))


def cocoop_forward(trainable, frozen, aux, images, *, clip_cfg, compute_dtype,
                   encode_chunk: int = -1, mesh_ctx=None):
    """fp32 logits (B, n_cls): the frozen image tower, the meta-net bias in
    fp32, then each instance's class prompts through the text tower.  Under
    an int8 tier the text tower, which has no calibrated scales, runs the
    dynamic chain (``layers.py:240-248``).  Under a mesh the images are this
    rank's rows of the 'data' axis and the 4-D text encode splits its
    (instances, classes) blocks over ('data', 'model')."""
    img = encode_image(frozen, images, clip_cfg, compute_dtype=compute_dtype,
                       mesh_ctx=mesh_ctx).float()
    img = img / img.norm(dim=-1, keepdim=True)  # (B, E)
    # meta-net (cocoop.py:99-103, :148-155): Linear -> ReLU -> Linear
    h = torch.relu(linear(trainable["meta_net"]["linear1"], img))
    bias = linear(trainable["meta_net"]["linear2"], h)             # (B, D)
    ctx_shifted = trainable["ctx"][None] + bias[:, None]            # (B, n_ctx, D)
    scale = frozen["logit_scale"].float().exp()
    prefix, suffix = aux["token_prefix"], aux["token_suffix"]
    n_cls = prefix.shape[0]

    def encode_instances(ctx_c, img_c):
        # (C, n_ctx, D), (C, E) -> (C, n_cls) cosine logits
        ctx4 = ctx_c[:, None].expand(-1, n_cls, -1, -1)
        prompts = compose_prompts(ctx4, prefix, suffix, aux.get("index_map"))
        txt = text_forward(frozen["text"], prompts.to(compute_dtype), aux["eot_idx"],
                           n_head=clip_cfg.transformer_heads,
                           mesh_ctx=mesh_ctx).float()  # (C, n_cls, E)
        txt = txt / txt.norm(dim=-1, keepdim=True)
        return scale * torch.einsum("cnd,cd->cn", txt, img_c)

    B = img.shape[0]
    seq = prefix.shape[1] + trainable["ctx"].shape[-2] + suffix.shape[1]
    # the rows shard over the whole mesh when the class axis divides it: the
    # per-device budget scales with the shard count (cocoop.py:133-145).
    # The chunk counts the global batch's instances, a multiple of n_data
    # where it can; this rank encodes its share of each chunk
    n_data, n_shards, shard_quantum = 1, 1, 1
    if mesh_ctx is not None:
        n_data = mesh_ctx.n_data
        if n_cls % mesh_ctx.n_model == 0:
            n_shards, shard_quantum = n_data * mesh_ctx.n_model, n_data
    chunk = _resolve_chunk(encode_chunk, B * n_data, n_cls, -(-seq // 8) * 8, n_shards,
                           shard_quantum)
    chunk = -(-chunk // n_data)
    if chunk >= B:
        return encode_instances(ctx_shifted, img)

    # chunked: the tail padded with the last instance (cocoop.py:162-182).
    # The recompute runs in the backward, after this call's contexts have
    # closed, so the chunk takes the forward's routing state (routes, quant
    # mode, block impl, LN dtype) and saves off inside
    state = layers.routing_state()

    def encode_chunk_fn(ctx_c, img_c):
        with layers.routing(state), saved_acts(False):
            return encode_instances(ctx_c, img_c)

    pad = (-B) % chunk
    if pad:
        ctx_shifted = torch.cat([ctx_shifted, ctx_shifted[-1:].expand(pad, -1, -1)])
        img = torch.cat([img, img[-1:].expand(pad, -1)])
    logits = [checkpoint(encode_chunk_fn, ctx_shifted[i:i + chunk], img[i:i + chunk],
                         use_reentrant=False)
              for i in range(0, B + pad, chunk)]
    return torch.cat(logits)[:B]


@TRAINER_REGISTRY.register()
class CoCoOp(TrainerBase):
    model_name = "prompt_learner"  # reference cocoop.py:241
    hparams_key = "COCOOP"

    def build_model(self):
        cfg = self.cfg
        # the static tiers build, and calibration refuses them as the JAX
        # package's does (no image-independent text features)
        hp = getattr(cfg.TRAINER, self.hparams_key)
        clip_cfg, params = self.load_clip()
        self.clip_cfg = clip_cfg
        dim, vis_dim = clip_cfg.transformer_width, clip_cfg.embed_dim
        n_ctx = hp.N_CTX
        g = new_rng(cfg.SEED, self.device)
        if hp.CTX_INIT:
            ctx_init = hp.CTX_INIT.replace("_", " ")
            n_ctx = len(ctx_init.split(" "))
            ctx = ctx_vectors_from_init(params["text"], ctx_init, n_ctx)
            prompt_prefix = ctx_init
        else:
            ctx = random_ctx(g, (n_ctx, dim))
            prompt_prefix = " ".join(["X"] * n_ctx)
        print(f'Initial context: "{prompt_prefix}" (n_ctx={n_ctx})')
        trainable = {
            "ctx": ctx,
            "meta_net": {
                "linear1": init_linear(g, vis_dim, vis_dim // 16),
                "linear2": init_linear(g, vis_dim // 16, dim),
            },
        }
        aux_cls = embed_classnames(params["text"], self.classnames, n_ctx, prompt_prefix)
        self.place(frozen=params, aux_class_tree=aux_cls.as_device_tree(), aux_repl=None,
                   trainable=trainable)
        # the text features depend on the image: no text/image split, so
        # evaluate() runs the whole forward a batch
        self.forward = functools.partial(cocoop_forward, clip_cfg=clip_cfg,
                                         compute_dtype=self.compute_dtype,
                                         encode_chunk=hp.ENCODE_CHUNK, mesh_ctx=self.mesh)
