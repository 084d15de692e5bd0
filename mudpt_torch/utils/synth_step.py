"""Synthetic MuDPT train step and server: the surfaces of
``mudpt_tpu/utils/synth_step.py`` (what ``bench.py --mode train`` and
``--mode eval`` drive) on random weights -- throughput does not depend on
them.

bf16 backbone, classnames "object number <i>" under the prefix "a photo
of a", fp32 trainable prompts and projections.  The train step is SGD at
lr 2.5e-3 with momentum 0.9 on the mean NLL of the logits; the server
encodes the text features once and caches them, then runs one
vision-tower pass per image batch with the argmax taken on the device.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import torch

from mudpt_torch.models.clip import (TINY_TEST, VIT_B16, VIT_L14, cast_matmul_weights,
                                     init_clip_params)
from mudpt_torch.trainers.mudpt import mudpt_forward, mudpt_image_logits, mudpt_text_features
from mudpt_torch.trainers.prompt_utils import embed_classnames, init_linear, random_ctx
from mudpt_torch.utils.device import resolve_device

MODELS = {"ViT-B/16": VIT_B16, "ViT-L/14": VIT_L14, "test-tiny": TINY_TEST}
LR, MOMENTUM = 2.5e-3, 0.9  # synth_step.py:81


def _setup(model: str, batch: int, n_cls: int, n_ctx: int, depth: int, device, seed: int):
    """The shared set-up: config, bf16 backbone, aux tree, fp32 trainable
    tree, one bf16 image batch and its labels, all from ``seed``."""
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}; known: {sorted(MODELS)}")
    dev = resolve_device(device)
    cfg = MODELS[model]
    gen = lambda k: torch.Generator(device=dev).manual_seed(seed + k)  # noqa: E731
    params = cast_matmul_weights(init_clip_params(cfg, gen(0)), torch.bfloat16)

    classnames = [f"object number {i}" for i in range(n_cls)]
    aux = embed_classnames(params["text"], classnames, n_ctx, "a photo of a").as_device_tree()

    g = gen(1)
    dim, vdim = cfg.transformer_width, cfg.vision_width
    trainable = {
        "ctx": random_ctx(g, (n_ctx, dim)),
        "deep_prompts": random_ctx(g, (depth - 1, n_ctx, dim)),
        "embed_projection": init_linear(g, dim, vdim),
        "deep_projections": init_linear(g, dim, vdim),
        "visual_ctx": random_ctx(g, (n_ctx, vdim)),
        "visual_ctx_deep_prompts": random_ctx(g, (depth - 1, n_ctx, vdim)),
        "visual_ctx_deep_projections": init_linear(g, vdim, dim),
    }
    # the reference casts images to the compute dtype before the patch conv
    images = torch.randn(
        (batch, cfg.image_resolution, cfg.image_resolution, 3), generator=gen(2), device=dev
    ).to(torch.bfloat16)
    labels = torch.randint(0, n_cls, (batch,), generator=gen(3), device=dev)
    return cfg, params, aux, trainable, images, labels


def leaves(tree: dict) -> list:
    """The tensors of a nested dict, in key order."""
    out = []
    for v in tree.values():
        out.extend(leaves(v) if isinstance(v, dict) else [v])
    return out


def nll_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of the labels (``synth_step.py:88-91``)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels[:, None].long()).mean()


def build_synth_mudpt_step(
    model: str, batch: int, n_cls: int, n_ctx: int, depth: int,
    device=None, seed: int = 0,
) -> SimpleNamespace:
    """Returns a namespace with ``clip_cfg, params, aux, trainable,
    optimizer, images, labels`` and

      ``loss_fn(images, labels)`` -> the loss, differentiable in the
      trainable leaves (which require grad);
      ``train_step(images, labels)`` -> the loss (detached, on the device):
      zero_grad, forward, backward and one SGD step.

    ``device=None`` means the card; it raises when CUDA is absent."""
    cfg, params, aux, trainable, images, labels = _setup(
        model, batch, n_cls, n_ctx, depth, device, seed)
    for t in leaves(trainable):
        t.requires_grad_(True)
    optimizer = torch.optim.SGD(leaves(trainable), lr=LR, momentum=MOMENTUM)
    forward = functools.partial(mudpt_forward, clip_cfg=cfg, compute_dtype=torch.bfloat16)

    def loss_fn(images, labels):
        return nll_loss(forward(trainable, params, aux, images), labels)

    def train_step(images, labels):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(images, labels)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return SimpleNamespace(
        clip_cfg=cfg, params=params, aux=aux, trainable=trainable, optimizer=optimizer,
        images=images, labels=labels, loss_fn=loss_fn, train_step=train_step,
    )


def build_synth_mudpt_server(
    model: str, batch: int, n_cls: int, n_ctx: int, depth: int,
    device=None, seed: int = 0,
) -> SimpleNamespace:
    """Returns a namespace with ``clip_cfg, params, aux, trainable, images``
    and the serving functions

      ``text_features(trainable, params, aux)`` -> (n_cls, embed_dim),
      ``image_logits(trainable, params, aux, images, txt)`` -> fp32 logits,
      ``eval_step_cached(trainable, params, aux, images, txt)`` -> int32 argmax.

    ``device=None`` means the card; it raises when CUDA is absent."""
    cfg, params, aux, trainable, images, _ = _setup(
        model, batch, n_cls, n_ctx, depth, device, seed)
    kw = dict(clip_cfg=cfg, compute_dtype=torch.bfloat16)
    text_features = torch.inference_mode()(functools.partial(mudpt_text_features, **kw))
    image_logits = torch.inference_mode()(functools.partial(mudpt_image_logits, **kw))

    @torch.inference_mode()
    def eval_step_cached(tr, frozen, aux, images, txt):
        return image_logits(tr, frozen, aux, images, txt).argmax(-1).to(torch.int32)

    return SimpleNamespace(
        clip_cfg=cfg, params=params, aux=aux, trainable=trainable, images=images,
        text_features=text_features, image_logits=image_logits,
        eval_step_cached=eval_step_cached,
    )
