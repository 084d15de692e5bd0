"""Synthetic MuDPT train step and server: the surfaces of
``mudpt_tpu/utils/synth_step.py`` (what ``bench.py --mode train`` and
``--mode eval`` drive) on random weights -- throughput does not depend on
them.

bf16 backbone, classnames "object number <i>" under the prefix "a photo
of a", fp32 trainable prompts and projections.  The train step is SGD at
lr 2.5e-3 with momentum 0.9 on the mean NLL of the logits; the server
encodes the text features once and caches them, then runs one
vision-tower pass per image batch with the argmax taken on the device.

``quant`` takes the place of ``bench.py --quant`` with its rules
(``bench.py:141-147``): the server takes 'int8' or 'int8_static', the step
'int8_ste' or 'int8_ste_static'.  Both towers' weights are then quantized
once (``quant_block.quantize_blocks``, ``quantize_s`` seconds); the static
tiers calibrate their activation scales at build, in ``bench.py``'s order,
on the build's image batch (``calibration_s``); every function of the
namespace runs under the quant mode.
"""

from __future__ import annotations

import functools
import time
from types import SimpleNamespace

import torch

from mudpt_torch.models.clip import (TINY_TEST, VIT_B16, VIT_L14, VIT_L14_336,
                                     cast_matmul_weights, init_clip_params, leaves)
from mudpt_torch.models.layers import quantized
from mudpt_torch.ops import quant_block
from mudpt_torch.trainers.mudpt import mudpt_forward, mudpt_image_logits, mudpt_text_features
from mudpt_torch.trainers.prompt_utils import embed_classnames, init_linear, random_ctx
from mudpt_torch.utils.device import resolve_device

MODELS = {"ViT-B/16": VIT_B16, "ViT-L/14": VIT_L14, "ViT-L/14@336px": VIT_L14_336,
          "test-tiny": TINY_TEST}
LR, MOMENTUM = 2.5e-3, 0.9  # synth_step.py:81
SERVER_QUANT = ("none", "int8", "int8_static")
STEP_QUANT = ("none", "int8_ste", "int8_ste_static")


def _check_quant(quant: str, allowed: tuple, what: str) -> None:
    """``bench.py:141-147``: the int8 serving tiers have no backward, the
    quantization-aware ones are for training."""
    if quant in allowed:
        return
    if quant in SERVER_QUANT + STEP_QUANT:
        hint = ("inference-only; for training, 'int8_ste' is the straight-through variant"
                if quant in SERVER_QUANT else
                "the TRAINING variant; for serving use 'int8' (identical forward)")
        raise ValueError(f"quant {quant!r} is {hint}")
    raise ValueError(f"unknown quant {quant!r}; the {what} takes {allowed}")


def _quantize_towers(params: dict, dev) -> float:
    """Both towers' projection weights quantized once; returns the seconds."""
    t0 = time.perf_counter()
    for tower in ("visual", "text"):
        params[tower]["blocks"] = quant_block.quantize_blocks(params[tower]["blocks"])
    return _synced_seconds(t0, dev)


def _in_mode(quant: str, fn):
    """``fn`` run under the quant mode."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with quantized(quant):
            return fn(*args, **kwargs)
    return run


def _synced_seconds(t0: float, dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


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


def nll_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of the labels (``synth_step.py:88-91``)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels[:, None].long()).mean()


def build_synth_mudpt_step(
    model: str, batch: int, n_cls: int, n_ctx: int, depth: int,
    device=None, seed: int = 0, quant: str = "none",
) -> SimpleNamespace:
    """Returns a namespace with ``clip_cfg, params, aux, trainable,
    optimizer, images, labels, quant, quantize_s, calibration_s`` and

      ``loss_fn(images, labels)`` -> the loss, differentiable in the
      trainable leaves (which require grad);
      ``train_step(images, labels)`` -> the loss (detached, on the device):
      zero_grad, forward, backward and one SGD step.

    ``quant`` 'int8_ste' or 'int8_ste_static' trains the prompts against the
    int8 backbone (quantization-aware); 'int8_ste_static' first calibrates
    both towers (``bench.py:398-425``: the text tower with its output, then
    the vision tower on the image batch and that output), which takes
    ``calibration_s`` seconds.  ``device=None`` means the card; it raises
    when CUDA is absent."""
    _check_quant(quant, STEP_QUANT, "train step")
    cfg, params, aux, trainable, images, labels = _setup(
        model, batch, n_cls, n_ctx, depth, device, seed)
    kw = dict(clip_cfg=cfg, compute_dtype=torch.bfloat16)
    quantize_s = calibration_s = None
    if quant != "none":
        quantize_s = _quantize_towers(params, images.device)
    if quant == "int8_ste_static":
        t0 = time.perf_counter()
        tscales, txt = quant_block.calibrate(functools.partial(mudpt_text_features, **kw),
                                             trainable, params, aux, with_output=True)
        params["text"]["blocks"] = quant_block.attach_scales(params["text"]["blocks"], tscales)
        vscales = quant_block.calibrate(functools.partial(mudpt_image_logits, **kw),
                                        trainable, params, aux, images, txt)
        params["visual"]["blocks"] = quant_block.attach_scales(params["visual"]["blocks"],
                                                               vscales)
        calibration_s = _synced_seconds(t0, images.device)
    for t in leaves(trainable):
        t.requires_grad_(True)
    optimizer = torch.optim.SGD(leaves(trainable), lr=LR, momentum=MOMENTUM)
    forward = functools.partial(mudpt_forward, **kw)

    @functools.partial(_in_mode, quant)
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
        quant=quant, quantize_s=quantize_s, calibration_s=calibration_s,
    )


def build_synth_mudpt_server(
    model: str, batch: int, n_cls: int, n_ctx: int, depth: int,
    device=None, seed: int = 0, quant: str = "none",
) -> SimpleNamespace:
    """Returns a namespace with ``clip_cfg, params, aux, trainable, images,
    quant, quantize_s, calibration_s`` and the serving functions

      ``text_features(trainable, params, aux)`` -> (n_cls, embed_dim),
      ``image_logits(trainable, params, aux, images, txt)`` -> fp32 logits,
      ``eval_step_cached(trainable, params, aux, images, txt)`` -> int32 argmax.

    ``quant`` 'int8' or 'int8_static' serves the int8 backbone;
    'int8_static' first calibrates (``bench.py:283-319``): the text features
    under dynamic int8, the vision tower's scales on ``images`` with them,
    the text tower's, both attached, which takes ``calibration_s`` seconds;
    ``text_features`` then encodes under the static tier.  ``device=None``
    means the card; it raises when CUDA is absent."""
    _check_quant(quant, SERVER_QUANT, "server")
    cfg, params, aux, trainable, images, _ = _setup(
        model, batch, n_cls, n_ctx, depth, device, seed)
    kw = dict(clip_cfg=cfg, compute_dtype=torch.bfloat16)
    text_features = _in_mode(quant, torch.inference_mode()(
        functools.partial(mudpt_text_features, **kw)))
    image_logits = _in_mode(quant, torch.inference_mode()(
        functools.partial(mudpt_image_logits, **kw)))

    @torch.inference_mode()
    def eval_step_cached(tr, frozen, aux, images, txt):
        return image_logits(tr, frozen, aux, images, txt).argmax(-1).to(torch.int32)

    quantize_s = calibration_s = None
    if quant != "none":
        quantize_s = _quantize_towers(params, images.device)
    if quant == "int8_static":
        t0 = time.perf_counter()
        txt = text_features(trainable, params, aux)  # no scales yet: dynamic int8
        vscales = quant_block.calibrate(functools.partial(mudpt_image_logits, **kw),
                                        trainable, params, aux, images, txt)
        tscales = quant_block.calibrate(functools.partial(mudpt_text_features, **kw),
                                        trainable, params, aux)
        params["visual"]["blocks"] = quant_block.attach_scales(params["visual"]["blocks"],
                                                               vscales)
        params["text"]["blocks"] = quant_block.attach_scales(params["text"]["blocks"], tscales)
        calibration_s = _synced_seconds(t0, images.device)
    return SimpleNamespace(
        clip_cfg=cfg, params=params, aux=aux, trainable=trainable, images=images,
        text_features=text_features, image_logits=image_logits,
        eval_step_cached=eval_step_cached, quant=quant, quantize_s=quantize_s,
        calibration_s=calibration_s,
    )
