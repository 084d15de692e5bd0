"""Serving artifacts: export a trained (or zero-shot) classifier as a
``torch.export`` program and a params file, loadable WITHOUT the model code
(counterpart of ``mudpt_tpu/serving.py``).

Artifact layout (a directory; the port's own format, the JAX package's
``meta.json`` fields):

  program.pt2   ``torch.export.save`` of an ``ExportedProgram``
  params.npz    the operand leaves (bf16 stored as uint16 views)
  meta.json     classnames, preprocessing constants, leaf dtypes, input
                spec, platforms, tier, torch version

Exported call signature: ``logits = f(*leaves, images)`` with ``images`` a
float32 ``(B, H, W, 3)`` batch normalized with the CLIP mean and std in
``meta.json``.  The tiers keep the JAX package's names:

  xla                 the XLA block route (``models/layers``): PyTorch ops
                      only, a symbolic batch (``torch.export.Dim``), served
                      on the CPU or the card
  pallas              the hand-written kernel chains, as ``torch.library``
                      custom ops (``ops/library.py``); a pinned batch
  pallas_int8         the int8 chains, dynamic activation scales
  pallas_int8_static  the int8 chains, calibrated static scales

The kernel tiers' platform is the card; loaded with ``device='cpu'`` their
custom ops run the kernels' plain versions.  A program runs on the device
it was exported on; loaded onto another, ``torch.export.passes.
move_to_device_pass`` moves it (the masks and index vectors the towers
build carry their device).  Loading and predicting import no
``mudpt_torch.models`` or ``mudpt_torch.trainers`` module; the kernel tiers
import ``mudpt_torch.ops.library`` to register the custom ops.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

ARTIFACT_VERSION = 1
_PROGRAM = "program.pt2"
_PARAMS = "params.npz"
_META = "meta.json"
TIERS = ("xla", "pallas", "pallas_int8", "pallas_int8_static")
_TIER_QUANT = {"pallas": "none", "pallas_int8": "int8", "pallas_int8_static": "int8_static"}
PLATFORMS = ("cpu", "cuda")


@contextlib.contextmanager
def _block_impl(name: str):
    """The tier's block impl and quant mode inside the context, the previous
    ones after it (``serving.py:48-76``): the kernel tiers run the kernel
    route under their quant mode; 'xla' runs unquantized, whatever quant
    mode an earlier trainer build left set."""
    from mudpt_torch.models import layers

    prev_impl, prev_quant = layers.block_impl(), layers.quant_mode()
    if name.startswith("pallas"):
        layers.set_block_impl("pallas")
        layers.set_quant_mode(_TIER_QUANT[name])
    else:
        layers.set_block_impl(name)
        layers.set_quant_mode("none")
    try:
        yield
    finally:
        layers.set_block_impl(prev_impl)
        layers.set_quant_mode(prev_quant)


# ---------------------------------------------------------------------------
# operand trees <-> leaves (dicts by sorted key, as jax.tree_util orders them)
# ---------------------------------------------------------------------------

def _flatten(tree, out: list):
    if isinstance(tree, dict):
        return ("dict", [(k, _flatten(tree[k], out)) for k in sorted(tree)])
    if isinstance(tree, (list, tuple)):
        return ("list", [_flatten(v, out) for v in tree])
    if tree is None:
        return ("none",)
    out.append(tree)
    return ("leaf",)


def _unflatten(spec, leaves):
    kind = spec[0]
    if kind == "dict":
        return {k: _unflatten(s, leaves) for k, s in spec[1]}
    if kind == "list":
        return [_unflatten(s, leaves) for s in spec[1]]
    if kind == "none":
        return None
    return next(leaves)


class _Program(torch.nn.Module):
    """``f(*leaves, images) = score_fn(operands, images)``: the function
    ``torch.export`` traces."""

    def __init__(self, score_fn, spec):
        super().__init__()
        self.score_fn, self.spec = score_fn, spec

    def forward(self, *args):
        return self.score_fn(_unflatten(self.spec, iter(args[:-1])), args[-1])


def _strip(tree, names: tuple):
    if isinstance(tree, dict):
        return {k: _strip(v, names) for k, v in tree.items() if k not in names}
    return tree


def _quantize_visual(frozen: dict) -> dict:
    """The vision tower's projections quantized once (``q8_weights``), so an
    int8 artifact ships their codes instead of quantizing every call."""
    from mudpt_torch.ops import quant_block

    vis = frozen["visual"]
    if "q8_weights" in vis["blocks"]:
        return frozen
    return dict(frozen, visual=dict(vis, blocks=quant_block.quantize_blocks(vis["blocks"])))


def _attach_visual_scales(frozen: dict, scales) -> dict:
    from mudpt_torch.ops import quant_block

    vis = frozen["visual"]
    return dict(frozen, visual=dict(vis, blocks=quant_block.attach_scales(vis["blocks"], scales)))


def export_classifier(
    path: str,
    score_fn,
    operands,
    *,
    image_shape: Sequence[int],
    classnames: Optional[Sequence[str]] = None,
    batch: Optional[int] = None,
    platforms: Optional[Sequence[str]] = None,
    extra_meta: Optional[dict] = None,
    block_impl: str = "xla",
) -> None:
    """Export ``score_fn(operands, images) -> logits`` as a serving artifact
    (``serving.py:90``).

    ``operands`` is a tree (dicts, lists) of tensors on one device, the
    device the program is traced for; ``image_shape`` is the per-image
    (H, W, C); ``batch=None`` exports a symbolic batch dimension, an int
    pins it.  ``platforms`` defaults to ``("cpu", "cuda")`` under 'xla' and
    must be ``("cuda",)`` under the kernel tiers, which also need a pinned
    batch, as the JAX package's Mosaic tiers do."""
    from mudpt_torch.models import layers

    if block_impl in _TIER_QUANT:
        platforms = list(platforms or ("cuda",))
        if platforms != ["cuda"]:
            raise ValueError(
                f"block_impl={block_impl!r} artifacts are CUDA-only; pass "
                "platforms=('cuda',) (the kernels have no other platform)"
            )
        if batch is None:
            raise ValueError(
                f"block_impl={block_impl!r} needs a pinned batch, as the JAX "
                "package's Mosaic tiers do; pass batch=<serving batch size>"
            )
    elif block_impl == "xla":
        platforms = list(platforms or PLATFORMS)
        if not platforms or any(p not in PLATFORMS for p in platforms):
            raise ValueError(f"platforms {platforms}: expected a subset of {PLATFORMS}")
    else:
        raise ValueError(f"block_impl must be one of {TIERS}, got {block_impl!r}")

    leaves: list = []
    spec = _flatten(operands, leaves)
    leaves = [t.detach() for t in leaves]
    devices = {t.device for t in leaves}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    b = 2 if batch is None else int(batch)
    images = torch.zeros((b, *image_shape), dtype=torch.float32, device=device)
    image_dims = None if batch is not None else {0: torch.export.Dim("batch", min=1, max=1 << 16)}
    dynamic = (tuple([None] * len(leaves) + [image_dims]),)
    with torch.no_grad(), _block_impl(block_impl), layers.exporting():
        program = torch.export.export(_Program(score_fn, spec), (*leaves, images),
                                      dynamic_shapes=dynamic)

    # the program keeps its example inputs, every leaf again: params.npz
    # holds those, so the saved program carries the graph alone
    program.example_inputs = None
    os.makedirs(path, exist_ok=True)
    torch.export.save(program, os.path.join(path, _PROGRAM))
    arrays, dtypes = {}, []
    for i, leaf in enumerate(leaves):
        t = leaf.cpu().contiguous()
        dtypes.append(str(t.dtype).replace("torch.", ""))
        if t.dtype == torch.bfloat16:  # npz has no bf16: store raw bits
            t = t.view(torch.int16)
            arr = t.numpy().view(np.uint16)
        else:
            arr = t.numpy()
        arrays[f"leaf_{i:05d}"] = arr
    np.savez(os.path.join(path, _PARAMS), **arrays)

    from mudpt_torch.data.transforms import CLIP_MEAN, CLIP_STD

    meta = {
        "artifact_version": ARTIFACT_VERSION,
        "torch_version": torch.__version__,
        "platforms": platforms,
        "block_impl": block_impl,
        "export_device": device.type,
        "image_shape": list(image_shape),
        "batch": batch,
        "n_leaves": len(leaves),
        "leaf_dtypes": dtypes,
        "classnames": list(classnames) if classnames is not None else None,
        "preprocess": {
            "resize_then_center_crop": image_shape[0],
            "mean": list(CLIP_MEAN),
            "std": list(CLIP_STD),
        },
        **(extra_meta or {}),
    }
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f, indent=1)


def _unmeshed(fn):
    """Rebind a trainer-bound forward's ``mesh_ctx`` to None
    (``serving.py:79-85``): an artifact is a one-device program (replicate
    it to serve a fleet), and a process group would not serialize."""
    if isinstance(fn, functools.partial) and "mesh_ctx" in fn.keywords:
        return functools.partial(fn.func, *fn.args, **dict(fn.keywords, mesh_ctx=None))
    return fn


def trainer_program(trainer, *, block_impl: str = "xla", calib_images=None):
    """``(score, operands, extra_meta)`` of a built trainer's inference path,
    what :func:`export_trainer` exports (``serving.py:203-378``); calling
    ``score(operands, images)`` under the tier's :func:`_block_impl` gives
    the served logits in process.

    Text features are encoded once, eagerly and unquantized, whenever the
    method's prompts are image-independent (every trainer but CoCoOp), and
    the text tower is left out; the zero-shot trainers' ``model_inference``
    reads text features cached at build; CoCoOp exports its full forward."""
    from mudpt_torch.config.perf import perf_snapshot
    from mudpt_torch.models import layers
    from mudpt_torch.ops import quant_block

    if block_impl not in TIERS:
        raise ValueError(f"block_impl must be one of {TIERS}, got {block_impl!r}")
    n_cls = trainer.num_classes
    # a static_text trainer's train-time text cache: the artifact carries
    # its own (ops["txt"]), so the aux copy would be dead weight
    aux = {k: v for k, v in trainer.aux.items() if k != "static_text_features"}
    ops = {"trainable": trainer.trainable, "frozen": trainer.frozen, "aux": aux}
    inference = _unmeshed(trainer.model_inference)
    text_fn = getattr(trainer, "forward_text", None)
    if inference is not None:  # the zero-shot pair: text features cached in aux
        ops["frozen"] = _strip(trainer.frozen, ("text",))

        def score(o, images):
            return inference(o["trainable"], o["frozen"], o["aux"], images)[:, :n_cls]

    elif text_fn is not None:
        # the eager text encode runs outside the tier's context, unquantized,
        # so an ambient quant mode neither raises nor bakes quantized class
        # features into the artifact
        with torch.no_grad(), layers.quantized("none"):
            ops["txt"] = text_fn(trainer.trainable, trainer.frozen, trainer.aux)
        ops["frozen"] = _strip(trainer.frozen, ("text",))
        img_fn = _unmeshed(trainer.forward_image)

        def score(o, images):
            return img_fn(o["trainable"], o["frozen"], o["aux"], images, o["txt"])[:, :n_cls]

    else:  # CoCoOp: instance-conditional prompts, the full forward
        fwd = _unmeshed(trainer.forward)

        def score(o, images):
            return fwd(o["trainable"], o["frozen"], o["aux"], images)[:, :n_cls]

    def cast_score(o, images):
        return score(o, images.to(trainer.compute_dtype)).float()

    extra_meta = {
        "trainer": trainer.cfg.TRAINER.NAME,
        "perf": {k: str(v) for k, v in perf_snapshot().items()},
    }
    if block_impl == "pallas_int8_static":
        if inference is None and text_fn is None:
            raise ValueError(
                "pallas_int8_static needs image-independent prompts to calibrate "
                "the vision tower (this trainer re-encodes text per instance); use "
                "block_impl='pallas_int8' (dynamic activation scales)"
            )
        has_scales = "q8_scales" in ops["frozen"]["visual"]["blocks"]
        if calib_images is None and has_scales:
            # TRAIN.QUANT 'int8_static'/'int8_ste_static' calibrated the towers
            # already: the artifact serves the numerics the prompts trained against
            extra_meta["calibration"] = {"reused_trainer_scales": True}
        elif calib_images is None:
            raise ValueError(
                "pallas_int8_static requires calib_images: a float32 (N, H, W, 3) "
                "batch of representative preprocessed images to calibrate the static "
                "activation scales on (or build the trainer with TRAIN.QUANT "
                "int8_static/int8_ste_static to reuse its calibration)"
            )
        else:
            calib = torch.as_tensor(np.asarray(calib_images, np.float32), device=trainer.device)
            frozen = _strip(ops["frozen"], ("q8_scales",))
            scales = quant_block.calibrate(cast_score, dict(ops, frozen=frozen), calib)
            ops["frozen"] = _attach_visual_scales(frozen, scales)
            extra_meta["calibration"] = {"n_images": int(len(calib))}
        ops["frozen"] = _quantize_visual(ops["frozen"])
    else:
        if calib_images is not None:
            raise ValueError("calib_images is only used by pallas_int8_static")
        # a trainer built under a quant mode carries q8_scales and q8_weights
        # leaves: a tier that does not read them must not ship them
        drop = ("q8_scales",) if block_impl == "pallas_int8" else ("q8_scales", "q8_weights")
        ops["frozen"] = _strip(ops["frozen"], drop)
        if block_impl == "pallas_int8":
            ops["frozen"] = _quantize_visual(ops["frozen"])
    return cast_score, ops, extra_meta


def export_trainer(path: str, trainer, *, batch: Optional[int] = None,
                   platforms: Optional[Sequence[str]] = None,
                   block_impl: str = "xla", calib_images=None) -> None:
    """Export a built trainer's inference path (``serving.py:203``): the
    program of :func:`trainer_program`.  CoCoOp needs a pinned ``batch``
    (its per-instance text encode); ``pallas_int8_static`` calibrates on
    ``calib_images``, a float32 (N, H, W, 3) batch of preprocessed images,
    or reuses the scales of a trainer built under a static quant mode."""
    if (trainer.model_inference is None and getattr(trainer, "forward_text", None) is None
            and batch is None):
        raise ValueError(
            "this trainer's forward needs static shapes (per-instance text "
            "encode); pass batch=<serving batch size>"
        )
    score, ops, extra_meta = trainer_program(trainer, block_impl=block_impl,
                                             calib_images=calib_images)
    res = trainer.clip_cfg.image_resolution
    export_classifier(path, score, ops, image_shape=(res, res, 3),
                      classnames=list(trainer.classnames), batch=batch, platforms=platforms,
                      extra_meta=extra_meta, block_impl=block_impl)


def export_zero_shot(
    path: str,
    clip_cfg,
    params,
    classnames: Sequence[str],
    templates: Sequence[str] = ("a photo of a {}.",),
    *,
    batch: Optional[int] = None,
    platforms: Optional[Sequence[str]] = None,
    compute_dtype=None,
    block_impl: str = "xla",
    calib_images=None,
) -> None:
    """Export a template-ensembled zero-shot classifier
    (``api.zero_shot_classifier``'s scoring; ``serving.py:380``).

    The class text is encoded once, in fp32 on the XLA route (a JAX host
    without a TPU encodes it on XLA too), and the text tower is left out of
    the artifact.  ``compute_dtype`` (default float32) is the vision
    tower's; every tier takes float32 or ``torch.bfloat16`` on the card,
    the kernel tiers through the kernels of that dtype."""
    from mudpt_torch.ops import quant_block
    from mudpt_torch.trainers.zsclip import _encode_templates, _zs_inference

    compute_dtype = compute_dtype or torch.float32
    device = params["logit_scale"].device
    with _block_impl("xla"):
        txt = _encode_templates(params, clip_cfg, list(classnames), list(templates),
                                torch.float32, device)
    params = _strip(params, ("text",))

    def score(o, images):
        return _zs_inference(None, o["params"], {"text_features": o["txt"]}, images,
                             clip_cfg=clip_cfg, compute_dtype=compute_dtype).float()

    if block_impl == "pallas_int8_static":
        if calib_images is None:
            raise ValueError(
                "pallas_int8_static requires calib_images (float32 (N, H, W, 3) "
                "preprocessed batch) to calibrate on"
            )
        calib = torch.as_tensor(np.asarray(calib_images, np.float32), device=device)
        scales = quant_block.calibrate(score, {"params": params, "txt": txt}, calib)
        params = _attach_visual_scales(params, scales)
    elif calib_images is not None:
        raise ValueError("calib_images is only used by pallas_int8_static")
    if block_impl in ("pallas_int8", "pallas_int8_static"):
        params = _quantize_visual(params)
    export_classifier(
        path, score, {"params": params, "txt": txt},
        image_shape=(clip_cfg.image_resolution,) * 2 + (3,), classnames=classnames,
        batch=batch, platforms=platforms, extra_meta={"trainer": "zero-shot"},
        block_impl=block_impl,
    )


def _resolve(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "serving runs on CUDA by default and no CUDA device is available; "
            "pass device='cpu' (the kernel tiers then run their plain versions)"
        )
    return dev


class ServingClassifier:
    """A loaded artifact (``serving.py:460``): torch and numpy, no model
    code.  The leaves are put on the device once, at load."""

    def __init__(self, program, leaves, meta, device: torch.device):
        self.meta = meta
        self.classnames = meta.get("classnames")
        self.device = device
        self._leaves = tuple(leaves)
        self._module = program.module()

    @classmethod
    def load(cls, path: str, device=None) -> "ServingClassifier":
        """``device`` None means the card (raises without CUDA); 'cpu' serves
        on the CPU, the kernel tiers through the kernels' plain versions."""
        dev = _resolve(device)
        with open(os.path.join(path, _META)) as f:
            meta = json.load(f)
        if meta["artifact_version"] > ARTIFACT_VERSION:
            raise ValueError(
                f"artifact version {meta['artifact_version']} is newer than this "
                f"loader ({ARTIFACT_VERSION})"
            )
        if meta["block_impl"] != "xla":
            from mudpt_torch.ops import library  # noqa: F401  (registers mudpt::*)
        program = torch.export.load(os.path.join(path, _PROGRAM))
        if meta["export_device"] != dev.type:
            # the program's device-built tensors (masks, index vectors) carry
            # the export device
            from torch.export.passes import move_to_device_pass

            program = move_to_device_pass(program, str(dev))
        leaves = []
        with np.load(os.path.join(path, _PARAMS)) as npz:
            for i, dt in enumerate(meta["leaf_dtypes"]):
                arr = npz[f"leaf_{i:05d}"]
                if dt == "bfloat16":
                    t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                else:
                    t = torch.from_numpy(arr)
                leaves.append(t.to(dev))
        return cls(program, leaves, meta, dev)

    def _check_batch(self, n: int) -> None:
        batch = self.meta.get("batch")
        if batch is not None and n != batch:
            raise ValueError(f"artifact was pinned to batch {batch}; got {n}")

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """Logits of a float32 (B, H, W, 3) batch already on the device, on
        the device."""
        self._check_batch(images.shape[0])
        with torch.no_grad():
            return self._module(*self._leaves, images)

    def predict(self, images) -> np.ndarray:
        """images: float32 (B, H, W, 3), normalized per meta['preprocess'].
        Returns float32 logits (B, n_classes)."""
        self._check_batch(len(images))
        x = torch.as_tensor(np.asarray(images, np.float32)).to(self.device)
        return self.forward(x).float().cpu().numpy()


def load(path: str, device=None) -> ServingClassifier:
    return ServingClassifier.load(path, device)
