"""Trainer engine (counterpart of ``mudpt_tpu/trainers/base.py``), the
Dassl ``TrainerX`` equivalent, on one device or across the ranks of a mesh.

Responsibilities (reference call stack SURVEY.md §3.1): data manager, model
build, optimizer and schedule, the train step (forward, ``loss.backward()``
with respect to the PROMPT tree only, one optimizer step: the frozen
backbone's blocks run the dx-only kernel chains), the epoch loop with
print-freq logging, per-epoch checkpoints, SIGTERM preemption with an exact
mid-epoch resume, evaluation with the class text encoded once per pass and
the argmax on the device, and the load-for-transfer semantics
(class-dependent buffers rebuilt from the live dataset, learned prompts
restored; reference trainers/mudpt.py:270-303).

The JAX package's ``devices`` argument becomes the port's device: ``None``
means the card and raises without CUDA (``utils/device.resolve_device``);
``"cpu"`` runs the kernels' plain versions.  Under ``torch.distributed``
each rank drives one device of the ``PARALLEL.DATA x PARALLEL.MODEL`` mesh
(``parallel/mesh.py``): its rows of the batch, its block of the text
tower's class rows, and the gradients summed over the mesh before each
optimizer step, so every rank takes the step of one process on the global
batch.  The primary rank writes the checkpoints and makes the decisions
that read them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import glob
import os
import re
import signal
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from mudpt_torch.config.perf import apply_perf_config
from mudpt_torch.data import DataManager
from mudpt_torch.models import layers
from mudpt_torch.models.clip import (RN50, RN50X4, RN50X16, RN50X64, RN101, TINY_TEST, VIT_B16,
                                     VIT_B32, VIT_L14, VIT_L14_336, _map, cast_matmul_weights,
                                     init_clip_params, leaves)
from mudpt_torch.models.convert import load_clip_checkpoint
from mudpt_torch.ops import quant_block
from mudpt_torch.parallel.mesh import (build_mesh, data_sum, reduce_grads, replicate,
                                       shard_batch, shard_class_tree)
from mudpt_torch.parallel.multihost import (broadcast_from_primary, host_local_batch_to_global,
                                            is_primary)
from mudpt_torch.trainers.optim import build_optimizer, make_lr_schedule
from mudpt_torch.utils.checkpoint import (load_checkpoint, restore_into, save_checkpoint,
                                          to_numpy)
from mudpt_torch.utils.device import resolve_device
from mudpt_torch.utils.logging import MetricsLogger
from mudpt_torch.utils.metrics import build_evaluator
from mudpt_torch.utils.profiling import profile_trace, window_edge
from mudpt_torch.utils.registry import TRAINER_REGISTRY
from mudpt_torch.utils.rng import new_rng, set_seed

# the quant tiers whose activation scales are calibrated at build
STATIC_QUANT = ("int8_static", "int8_ste_static")
# base.py:72-97.  The RN presets serve the text-prompt trainers:
# ZeroshotCLIP(2), CoOp, CoCoOp
NAMED_CONFIGS = {
    "ViT-B/16": VIT_B16,
    "ViT-B/32": VIT_B32,
    "ViT-L/14": VIT_L14,
    "ViT-L/14@336px": VIT_L14_336,
    "RN50": RN50,
    "RN101": RN101,
    "RN50x4": RN50X4,
    "RN50x16": RN50X16,
    "RN50x64": RN50X64,
    "test-tiny-rn": dataclasses.replace(
        TINY_TEST, vision_width=8, vision_patch_size=0, vision_arch="resnet",
        vision_layers_per_stage=(1, 1, 1, 1), vision_layers=4,
    ),
    "test-tiny": TINY_TEST,
}


def load_backbone(cfg, device):
    """CLIP backbone (``base.py:101-158``): from a local ``.pt`` or ``.npz``
    (MODEL.BACKBONE.PATH), the ``~/.cache/clip`` download cache (downloading
    on a miss, as the reference's ``clip.load``, clip/clip.py:95-109), or
    random init for the named architecture, ONLY when PATH='random' is
    explicit: a fresh host never trains prompts on a random-weight CLIP
    silently.  Returns the config and an fp32 tree on ``device``."""
    path = cfg.MODEL.BACKBONE.PATH
    name = cfg.MODEL.BACKBONE.NAME
    if path and path != "random":
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"MODEL.BACKBONE.PATH={path!r} not found. This environment has "
                "no network access; provide a local OpenAI CLIP .pt/.npz file."
            )
        clip_cfg, params = load_clip_checkpoint(path)
        return clip_cfg, _to_device(params, device)
    if path == "random":
        if name not in NAMED_CONFIGS:
            raise KeyError(f"Unknown backbone {name!r}; known: {list(NAMED_CONFIGS)}")
        clip_cfg = NAMED_CONFIGS[name]
        return clip_cfg, init_clip_params(clip_cfg, new_rng(0, device))
    # PATH unset: pretrained weights are required, a cache hit or a download
    from mudpt_torch.models import download

    # the cache file is the download URL's basename: 'ViT-L-14-336px.pt'
    # for 'ViT-L/14@336px', which name.replace('/', '-') would miss
    basename = (os.path.basename(download._MODELS[name]) if name in download._MODELS
                else name.replace("/", "-") + ".pt")
    cache = os.path.expanduser(os.path.join("~/.cache/clip", basename))
    if os.path.exists(cache):
        clip_cfg, params = load_clip_checkpoint(cache)
        return clip_cfg, _to_device(params, device)
    if name in download._MODELS:
        try:
            clip_cfg, params = load_clip_checkpoint(download.download_model(name))
        except Exception as e:  # URLError, socket timeout, checksum, ...
            raise RuntimeError(
                f"Pretrained CLIP {name!r} is not cached at {cache} and the "
                f"download failed ({type(e).__name__}: {e}). Place the OpenAI "
                f".pt file at that path (or set MODEL.BACKBONE.PATH to a local "
                f".pt/.npz), or opt into random weights explicitly with "
                f"MODEL.BACKBONE.PATH='random'."
            ) from e
        return clip_cfg, _to_device(params, device)
    raise RuntimeError(
        f"Backbone {name!r} has no pretrained checkpoint (not cached at "
        f"{cache}, not a known download). Set MODEL.BACKBONE.PATH to a local "
        f".pt/.npz file, or request random init explicitly with "
        f"MODEL.BACKBONE.PATH='random'."
    )


def _to_device(tree, device):
    return _map(tree, lambda t: t.to(device))


class TrainerBase:
    """Shared engine.  Subclasses implement ``build_model`` and set:

      self.clip_cfg   CLIPConfig
      self.frozen     backbone tree (device)
      self.aux        static buffers tree (device)
      self.trainable  prompt tree (device, fp32 leaves that require grad)
      self.forward    fn(trainable, frozen, aux, images) -> (B, n_cls_padded) logits
      self.model_name checkpoint subdirectory name
    """

    model_name = "prompt_learner"
    # trainers that splice prompts into the visual tower set this
    requires_vit = False
    # PREC when the trainer has no PREC hparam (see __init__)
    prec_default = "fp32"
    forward: Callable = None
    # the zero-shot trainers' forward, whose text features are encoded at
    # build: static calibration reads the vision tower through it
    model_inference: Optional[Callable] = None

    def __init__(self, cfg, dataset=None, devices=None):
        self.cfg = cfg
        self.device = resolve_device(devices)
        set_seed(cfg.SEED)
        self.mesh = build_mesh(cfg, device=self.device)
        if not self.mesh.in_mesh:
            # a JAX device past the mesh idles; a rank is a process that
            # would wait for collectives it is not part of
            raise ValueError(
                f"rank {self.mesh.rank} lies outside the PARALLEL mesh "
                f"(data={self.mesh.n_data}, model={self.mesh.n_model}): launch "
                f"{self.mesh.n_data * self.mesh.n_model} ranks"
            )
        if cfg.TRAIN.QUANT not in layers.QUANT_MODES:
            raise ValueError(
                f"TRAIN.QUANT must be 'none', 'int8' (eval-only, dynamic "
                f"activation scales), 'int8_static' (eval-only, scales "
                f"calibrated on a training batch), 'int8_ste' "
                f"(quantization-aware training), or 'int8_ste_static' "
                f"(QAT against the calibrated static serving tier); got "
                f"{cfg.TRAIN.QUANT!r}"
            )
        # the mode is process-global: set on every build, so a 'none'
        # trainer clears a mode left by an earlier build in the process
        layers.set_quant_mode(cfg.TRAIN.QUANT)
        self.perf_resolved = apply_perf_config(cfg.PERF)
        self.dm = DataManager(cfg, dataset, n_data=self.mesh.n_data,
                              data_index=self.mesh.data_index)
        self.num_classes = self.dm.num_classes
        self.classnames = self.dm.classnames
        self.metrics = MetricsLogger(cfg.OUTPUT_DIR)
        self.metrics.log({"kind": "perf_config", **self.perf_resolved})
        # the class axis padded to a multiple of the model axis; the loss and
        # evaluation slice back to num_classes (base.py:218-221)
        self.n_cls_padded = -(-self.num_classes // self.mesh.n_model) * self.mesh.n_model
        self.epoch = 0
        self._best_val = -1.0
        self._preempt = False        # set by the SIGTERM handler
        self._preempt_saved = False  # run_epoch wrote a mid-epoch checkpoint
        self._skip_batches = 0       # mid-epoch resume fast-forward

        hp = cfg.trainer_params() if cfg.TRAINER.NAME else None
        prec = getattr(hp, "PREC", self.prec_default) if hp is not None else self.prec_default
        # fp16 and amp -> bfloat16 (base.py:229-236)
        self.compute_dtype = torch.bfloat16 if prec in ("fp16", "amp") else torch.float32

        self.build_model()
        if self.trainable is not None and cfg.MODEL.INIT_WEIGHTS:
            # warm-start the prompt learner from a previous run's output
            # directory (reference trainers/mudpt.py:220-221)
            print(f"Initializing prompt weights from {cfg.MODEL.INIT_WEIGHTS}")
            self.load_model(
                cfg.MODEL.INIT_WEIGHTS,
                epoch=self._resolve_checkpoint_epoch(cfg.MODEL.INIT_WEIGHTS),
            )
        if cfg.TRAIN.QUANT != "none":
            # the frozen towers' projections quantized once, as the
            # synthetic builders do (the JAX package quantizes per call:
            # the same codes)
            self._set_frozen({
                k: dict(v, blocks=quant_block.quantize_blocks(v["blocks"]))
                if isinstance(v, dict) and "blocks" in v else v
                for k, v in self.frozen.items()
            })
        if self.trainable is not None:
            self._build_train_state()
        self._bind_steps()
        if cfg.TRAIN.QUANT in STATIC_QUANT:
            self._calibrate_static_quant()
        self._cache_static_text()

    # ------------------------------------------------------------------
    # model plumbing helpers for subclasses
    # ------------------------------------------------------------------
    def load_clip(self):
        clip_cfg, params = load_backbone(self.cfg, self.device)
        if self.requires_vit and clip_cfg.vision_arch != "vit":
            raise ValueError(
                f"{type(self).__name__} injects visual prompts and needs a "
                f"ViT backbone; got vision_arch={clip_cfg.vision_arch!r} "
                f"(RN-family backbones work with the text-prompt trainers: "
                f"ZeroshotCLIP, CoOp, CoCoOp)"
            )
        if self.compute_dtype == torch.bfloat16:
            params = cast_matmul_weights(params, torch.bfloat16)
        return clip_cfg, params

    def _set_forward(self, forward_fn, text_fn=None, image_fn=None, **kw):
        """Bind the trainer's forward and, when its text features do not
        depend on the image, the text/image split that lets evaluate()
        encode the class prompts once per pass (``base.py:280-297``).
        Contract: forward(tr, fz, aux, img) == image_fn(tr, fz, aux, img,
        text_fn(tr, fz, aux)).  The mesh is threaded through, so that the
        towers split their rows over it (``base.py:288-293``)."""
        kw.setdefault("mesh_ctx", self.mesh)
        self.forward = functools.partial(forward_fn, **kw)
        if text_fn is not None:
            self.forward_text = functools.partial(text_fn, **kw)
            self.forward_image = functools.partial(image_fn, **kw)

    def place(self, frozen, aux_class_tree, aux_repl, trainable):
        """Placement through the mesh (``base.py:298-308``): the frozen and
        trainable trees whole on every rank, the class buffers padded to
        ``n_cls_padded``; the trainable leaves fp32 leaf tensors that
        require grad."""
        self.frozen = replicate(self.mesh, frozen)
        aux = replicate(self.mesh, dict(aux_repl or {}))
        aux.update(shard_class_tree(self.mesh, aux_class_tree, pad_to=self.n_cls_padded))
        self.aux = aux
        self.trainable = None
        if trainable is not None:
            self.trainable = replicate(self.mesh, trainable)
            for t in leaves(self.trainable):
                t.requires_grad_(True)

    def _calibrate_static_quant(self):
        """TRAIN.QUANT 'int8_static' / 'int8_ste_static': calibrate per-tensor
        activation scales on one training batch and attach them to the
        frozen towers' blocks (``base.py:312-367``): the text tower's from
        the class prompts' encode, the vision tower's from the batch against
        those features, or, for the zero-shot trainers, whose text features
        are encoded at build, the vision tower's alone."""
        fwd_text = getattr(self, "forward_text", None)
        inference = self.model_inference
        if fwd_text is None and inference is None:
            raise ValueError(
                "TRAIN.QUANT 'int8_static'/'int8_ste_static' needs "
                "image-independent text features to calibrate on (this "
                "trainer re-encodes text per instance); use the dynamic "
                "tiers instead: TRAIN.QUANT 'int8' (eval) or 'int8_ste' "
                "(QAT — verified for CoCoOp, tests/test_quant_block.py)"
            )
        # the fetch must not advance the loader's epoch: every pipeline's
        # __iter__ counts it, and an exact resume (set_epoch, then the
        # preempted batches decoded and dropped) assumes only run_epoch
        # iterated
        loader = self.dm.train_loader
        prev_epoch = getattr(loader, "_epoch", None)
        batch = next(iter(loader))
        if prev_epoch is not None:
            loader._epoch = prev_epoch
        if self.dm.host_sharded:
            # every rank calibrates on the global batch: one set of scales
            batch = host_local_batch_to_global(self.mesh, batch)
        images = self._device_batch(batch)["image"]
        frozen = dict(self.frozen)
        if inference is not None:
            vscales = quant_block.calibrate(inference, self.trainable, self.frozen, self.aux,
                                            images)
        else:
            tscales, txt = quant_block.calibrate(fwd_text, self.trainable, self.frozen, self.aux,
                                                 with_output=True)
            frozen["text"] = dict(frozen["text"], blocks=quant_block.attach_scales(
                frozen["text"]["blocks"], tscales))
            vscales = quant_block.calibrate(self.forward_image, self.trainable, self.frozen,
                                            self.aux, images, txt)
        frozen["visual"] = dict(frozen["visual"], blocks=quant_block.attach_scales(
            frozen["visual"]["blocks"], vscales))
        self._set_frozen(frozen)
        self._static_calibrated = True

    def _set_frozen(self, frozen):
        """Every post-build change of the frozen tree goes through here: the
        static text cache is a function of it and is refreshed with it."""
        self.frozen = frozen
        if "static_text_features" in (getattr(self, "aux", None) or {}):
            self._cache_static_text()

    def _cache_static_text(self):
        """Trainers whose text features do not depend on the trainable tree
        (``static_text``) encode the class prompts once and train against
        the cached rows (``base.py:379-401``)."""
        if not getattr(self, "static_text", False):
            return
        fn = getattr(self, "_text_features", None)
        if fn is None or self.trainable is None:
            return
        aux = {k: v for k, v in self.aux.items() if k != "static_text_features"}
        self.aux["static_text_features"] = fn(self.trainable, self.frozen, aux)

    # ------------------------------------------------------------------
    def _build_train_state(self):
        steps_per_epoch = max(1, len(self.dm.train_loader))
        self._params = leaves(self.trainable)
        self.optimizer, self.scheduler = build_optimizer(
            self._params, self.cfg.OPTIM, steps_per_epoch)
        self.lr_schedule = make_lr_schedule(self.cfg.OPTIM, steps_per_epoch)
        self.global_step = 0

    def _bind_steps(self):
        """The eval steps and the text-feature function, with the argmax on
        the device (``base.py:455-486``)."""
        forward = self.forward
        n_cls = self.num_classes
        fwd_text = getattr(self, "forward_text", None)
        fwd_image = getattr(self, "forward_image", None)

        @torch.no_grad()
        def eval_step(trainable, frozen, aux, images):
            logits = forward(trainable, frozen, aux, images)
            return logits[:, :n_cls].float().argmax(-1).to(torch.int32)

        self._eval_step = eval_step
        if fwd_text is not None:
            self._text_features = torch.no_grad()(fwd_text)

            @torch.no_grad()
            def eval_step_cached(trainable, frozen, aux, images, txt):
                logits = fwd_image(trainable, frozen, aux, images, txt)
                return logits[:, :n_cls].float().argmax(-1).to(torch.int32)

            self._eval_step_cached = eval_step_cached

    def loss_fn(self, batch):
        """(loss, accuracy) of a device batch: the NLL and top-1 over the
        rows ``valid`` marks (``base.py:422-438``).  Under a mesh the batch
        is this rank's rows, and both divide by the GLOBAL count of valid
        rows: the data group's values sum to the global batch's."""
        fwd_image = getattr(self, "forward_image", None)
        if getattr(self, "static_text", False) and "static_text_features" in self.aux:
            logits = fwd_image(self.trainable, self.frozen, self.aux, batch["image"],
                               self.aux["static_text_features"])
        else:
            logits = self.forward(self.trainable, self.frozen, self.aux, batch["image"])
        logits = logits[:, :self.num_classes].float()
        labels = batch["label"]
        valid = batch["valid"].float()
        nll = -torch.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
        denom = data_sum(self.mesh, valid.sum()).clamp_min(1.0)
        loss = (nll * valid).sum() / denom
        acc = ((logits.argmax(-1) == labels).float() * valid).sum() / denom
        return loss, acc

    def _train_step(self, batch):
        """One step: forward, ``loss.backward()``, the gradients summed over
        the mesh, the optimizer and the schedule stepped; returns the
        detached (loss, accuracy) of the global batch.  The ranks of a model
        group hold the same images, so each backpropagates 1/n_model of its
        loss: the model group's share of the text tower's gradient meets in
        the gather's backward, and the mesh's sum counts every image once."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, acc = self.loss_fn(batch)
        (loss / self.mesh.n_model).backward()
        reduce_grads(self.mesh, self._params)
        self.optimizer.step()
        self.scheduler.step()
        return data_sum(self.mesh, loss.detach()), data_sum(self.mesh, acc.detach())

    # ------------------------------------------------------------------
    # training loop
    # ------------------------------------------------------------------
    def train(self):
        cfg = self.cfg
        max_epoch = cfg.OPTIM.MAX_EPOCH
        num_batches = len(self.dm.train_loader)
        start_epoch = self.resume_if_requested()
        print(f"Start training: {max_epoch} epochs x {num_batches} batches")
        restore_handler = (
            self._install_sigterm_handler()
            if cfg.TRAIN.CHECKPOINT_ON_SIGTERM and self.trainable is not None
            else None
        )
        try:
            for self.epoch in range(start_epoch, max_epoch):
                if self._preempt:
                    # the signal landed at an epoch boundary: record it
                    self._save_preempt(0)
                    return self._stop_preempted()
                self.run_epoch()
                if self._preempt and self._preempt_saved:
                    return self._stop_preempted()  # stopped strictly mid-epoch
                # a signal on the epoch's last batch falls through: the
                # epoch completed, so after_epoch runs, then the loop top stops
                self.after_epoch()
        finally:
            if restore_handler is not None:
                restore_handler()
        self.after_train()

    def _stop_preempted(self):
        print(f"Training preempted — set RESUME {self.cfg.OUTPUT_DIR} to continue exactly")
        self.metrics.close()

    def _install_sigterm_handler(self):
        """SIGTERM -> finish the in-flight step, checkpoint, stop cleanly.
        Returns a restore callable, or None off the main thread."""
        def handler(signum, frame):
            self._preempt = True
            print("SIGTERM received — checkpointing at the next step boundary", flush=True)

        try:
            prev = signal.signal(signal.SIGTERM, handler)
        except ValueError:  # not the main thread
            return None
        return lambda: signal.signal(signal.SIGTERM, prev)

    def _opt_state_keys(self) -> tuple:
        """The per-parameter state of the optimizer, in saved order."""
        if isinstance(self.optimizer, torch.optim.SGD):
            return ("momentum_buffer",) if self.cfg.OPTIM.MOMENTUM else ()
        return ("exp_avg", "exp_avg_sq", "step")

    def _opt_leaves(self) -> list:
        """The optimizer state as arrays: the schedule's step, then each
        parameter's state tensors (this package's own leaf order)."""
        leaves = [np.asarray(self.scheduler.last_epoch, np.int64)]
        for p in self._params:
            state = self.optimizer.state.get(p, {})
            leaves.extend(to_numpy(state[k]) for k in self._opt_state_keys() if k in state)
        return leaves

    def _save_preempt(self, batches_done: int):
        """Mid-epoch checkpoint after SIGTERM: weights, optimizer state and
        the exact position (0-based epoch, batches_done, global_step)."""
        if self.trainable is None:
            return
        self._preempt_saved = True  # every rank takes the same train() branch
        if not is_primary():
            return
        path = save_checkpoint(
            self.cfg.OUTPUT_DIR, self.model_name, self.epoch, self.trainable,
            opt_state=self._opt_leaves(),
            meta={
                "trainer": self.cfg.TRAINER.NAME,
                "batches_done": int(batches_done),
                "global_step": int(self.global_step),
                "best_val": float(self._best_val),
            },
            tag="preempt",
        )
        print(f"Preemption checkpoint saved to {path} "
              f"(epoch {self.epoch + 1}, batch {batches_done})")

    def resume_if_requested(self) -> int:
        """cfg.RESUME: reload the newest checkpoint under that directory
        (weights and optimizer state) and continue from its position; with
        the stateless data order the resumed run equals an uninterrupted
        one (``base.py:592-642``)."""
        if not self.cfg.RESUME or self.trainable is None:
            return 0
        num_batches = max(1, len(self.dm.train_loader))
        last = self._latest_epoch(self.cfg.RESUME)
        pre = self._ckpt_meta(self.cfg.RESUME, tag="preempt")
        if pre is not None and pre["global_step"] > last * num_batches:
            self.load_model(self.cfg.RESUME, tag="preempt")
            self._restore_opt_state(self.cfg.RESUME, tag="preempt")
            epoch_idx, done = pre["epoch"], pre["batches_done"]
            if done >= num_batches:  # the signal landed on the epoch's last batch
                start = epoch_idx + 1
            else:
                start = epoch_idx
                self._skip_batches = done
            self.dm.train_loader.set_epoch(start)
            self.global_step = epoch_idx * num_batches + done
            self._best_val = pre.get("best_val", -1.0)
            print(f"Resumed from preemption checkpoint (epoch {epoch_idx + 1}, "
                  f"batch {done}/{num_batches})")
            return start
        if not last:
            print("RESUME requested but no checkpoints under "
                  f"{os.path.join(self.cfg.RESUME, self.model_name)}")
            return 0
        self.load_model(self.cfg.RESUME, epoch=last)
        self._restore_opt_state(self.cfg.RESUME, epoch=last)
        self.dm.train_loader.set_epoch(last)
        self.global_step = last * num_batches
        meta = self._ckpt_meta(self.cfg.RESUME, epoch=last)
        self._best_val = meta.get("best_val", -1.0) if meta else -1.0
        print(f"Resumed from epoch {last}")
        return last

    def _on_primary(self, fn):
        """``fn()`` as the primary rank computes it, on every rank
        (``broadcast_from_primary``): each decision that reads the
        filesystem is made once, since the ranks' disks may differ.  An
        error on the primary is raised on every rank (not on the primary
        alone, which would leave the others waiting in the broadcast)."""
        if not self.mesh.distributed:
            return fn()
        out = (None, None)
        if is_primary():
            try:
                out = (fn(), None)
            except Exception as e:  # noqa: BLE001 -- raised on every rank below
                out = (None, e)
        value, err = broadcast_from_primary(out, group=self.mesh.group)
        if err is not None:
            raise err
        return value

    def _ckpt_meta(self, directory: str, epoch=None, tag=None):
        """Position and score metadata of a checkpoint, from the npz itself,
        as the primary reads it; None when absent.  A torn file is reported
        and treated as absent."""
        return self._on_primary(lambda: self._read_ckpt_meta(directory, epoch, tag))

    def _read_ckpt_meta(self, directory: str, epoch=None, tag=None):
        fname = f"model-{tag}.pth.tar" if tag else f"model.pth.tar-{epoch}"
        p = os.path.join(directory, self.model_name, fname)
        if not os.path.exists(p):
            return None
        try:
            with np.load(p, allow_pickle=False) as data:
                meta = {k[len("meta/"):]: data[k].item() for k in data.files
                        if k.startswith("meta/") and data[k].ndim == 0
                        and data[k].dtype.kind in "ifu"}
        except (OSError, ValueError, KeyError) as e:
            print(f"WARNING: unreadable checkpoint meta at {p} "
                  f"({type(e).__name__}: {e}) — ignoring it")
            return None
        return {"epoch": int(meta.get("epoch", 0)),
                "batches_done": int(meta.get("batches_done", 0)),
                "global_step": int(meta.get("global_step", 0)),
                "best_val": float(meta.get("best_val", -1.0))}

    def _restore_opt_state(self, directory: str, epoch: int = 0, tag: Optional[str] = None):
        """Put the checkpoint's optimizer state into the live optimizer and
        schedule; a checkpoint without matching state resumes with a fresh
        optimizer, loudly."""
        _, leaves, _ = self._on_primary(
            lambda: load_checkpoint(directory, self.model_name, epoch, tag=tag))
        keys = self._opt_state_keys()
        if leaves is None or len(leaves) != 1 + len(keys) * len(self._params):
            print("WARNING: checkpoint has no matching optimizer state — "
                  "resuming with a FRESH optimizer (momentum reset)")
            return
        step, it = int(leaves[0]), iter(leaves[1:])
        for p in self._params:
            state = self.optimizer.state[p]
            for k in keys:
                a = next(it)
                if k == "step":
                    state[k] = torch.tensor(float(a), dtype=torch.float32)
                else:
                    state[k] = torch.from_numpy(np.array(a, copy=True)).to(p.device, p.dtype)
        self.scheduler.last_epoch = step
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_schedule(step)

    def _device_batch(self, batch):
        """A host batch on the device: images in the compute dtype (cast on
        the host, which halves the copy under bf16, as ``_cast_images``),
        labels int64, ``valid`` bool."""
        image = torch.from_numpy(np.asarray(batch["image"])).to(self.compute_dtype)
        label = torch.from_numpy(np.asarray(batch["label"])).long()
        valid = torch.from_numpy(np.asarray(batch["valid"]))
        if self.device.type == "cuda":
            image, label, valid = (t.pin_memory().to(self.device, non_blocking=True)
                                   for t in (image, label, valid))
        return {"image": image, "label": label, "valid": valid}

    def _device_prefetch(self, loader):
        """This rank's rows of the next batch to the device while the current
        step runs."""
        prev = None
        for batch in loader:
            cur = self._device_batch(shard_batch(self.mesh, batch, self.dm.host_sharded))
            if prev is not None:
                yield prev
            prev = cur
        if prev is not None:
            yield prev

    def run_epoch(self):
        cfg = self.cfg
        num_batches = len(self.dm.train_loader)
        t0 = time.time()
        skip = self._skip_batches
        self._skip_batches = 0
        src = self.dm.train_loader
        if skip:
            # mid-epoch resume: decode and drop the batches the preempted
            # run consumed; the loader is deterministic per (seed, epoch)
            def _fast_forward(loader=src, k=skip):
                it = iter(loader)
                for _ in range(k):
                    next(it)
                yield from it

            src = _fast_forward()
        # TRAIN.PROFILE_DIR traces batch 1 of epoch 0, as the JAX package
        # does (base.py:780-781).  The window opens before the epoch's first
        # batch, which runs as the profiler's warmup step (its events
        # dropped), so the CUDA collection is on before batch 1's first
        # launch; it closes after batch 1.  A run resumed at batch 1 warms up
        # on the loader's fast-forward and first copies alone.
        trace_dir = (cfg.TRAIN.PROFILE_DIR if self.epoch == 0 and skip <= 1 < num_batches
                     else None)
        window = contextlib.ExitStack()
        prof = window.enter_context(profile_trace(trace_dir, warmup=1))
        # the step time a print reports: the host clock's mean over the
        # steps since the last print, read after the print's loss fetch, so
        # no step waits for the card to be timed
        t_print, steps = time.perf_counter(), 0
        with window:
            for offset, batch in enumerate(self._device_prefetch(src)):
                batch_idx = skip + offset
                if prof is not None and batch_idx == 1:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    prof.step()  # the warmup ends: batch 1 is the window
                    window_edge(self.device)
                loss, acc = self._train_step(batch)
                steps += 1
                if prof is not None and batch_idx == 1:
                    window_edge(self.device)
                    window.close()  # writes the trace
                    prof = None
                self.global_step += 1
                if (batch_idx + 1) % max(1, cfg.TRAIN.PRINT_FREQ) == 0 \
                        or batch_idx + 1 == num_batches:
                    loss_v, acc_v = float(loss), float(acc)
                    now = time.perf_counter()
                    step_s = (now - t_print) / steps
                    t_print, steps = now, 0
                    lr = float(self.lr_schedule(self.global_step - 1))
                    bsz = cfg.DATALOADER.TRAIN_X.BATCH_SIZE
                    print(
                        f"epoch [{self.epoch + 1}/{cfg.OPTIM.MAX_EPOCH}] "
                        f"batch [{batch_idx + 1}/{num_batches}] "
                        f"loss {loss_v:.4f} acc {100 * acc_v:.2f} lr {lr:.2e} "
                        f"step {step_s * 1e3:.0f}ms "
                        f"{bsz / step_s:.1f}img/s ({time.time() - t0:.1f}s)"
                    )
                    self.metrics.log({
                        "kind": "train", "epoch": self.epoch + 1, "step": self.global_step,
                        "loss": loss_v, "acc": acc_v, "lr": lr, "step_time": step_s,
                        "imgs_per_sec": bsz / step_s,
                    })
                if self._preempt and batch_idx + 1 < num_batches:
                    # strictly mid-epoch: record the exact position (a window
                    # still in its warmup closes without writing a trace)
                    self._save_preempt(batch_idx + 1)
                    return

    def after_epoch(self):
        cfg = self.cfg
        is_last = self.epoch + 1 == cfg.OPTIM.MAX_EPOCH
        freq = cfg.TRAIN.CHECKPOINT_FREQ
        do_val = cfg.TEST.FINAL_MODEL == "best_val" and self.dm.val_loader is not None
        is_best = False
        if do_val:
            score = self.evaluate(self.dm.val_loader, split="val")["accuracy"]
            if score > self._best_val:
                self._best_val, is_best = score, True
        if is_last or is_best or (freq > 0 and (self.epoch + 1) % freq == 0):
            self.save_model(is_best=is_best)

    def after_train(self):
        if not self.cfg.TEST.NO_TEST:
            best = os.path.join(self.cfg.OUTPUT_DIR, self.model_name, "model-best.pth.tar")
            has_best = self._on_primary(lambda: os.path.exists(best))
            if self.cfg.TEST.FINAL_MODEL == "best_val" and self.trainable is not None and has_best:
                print("Testing with the best-on-val checkpoint")
                self.load_model(self.cfg.OUTPUT_DIR, epoch=None)
            self.test()
        self.metrics.close()

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def evaluate(self, loader, split: str = "test") -> Dict[str, float]:
        """Accuracy and F1 over ``loader``; the class text is encoded once
        per pass, lazily on the first batch (``base.py:859-921``).  Each rank
        scores its rows of every batch (the loader's own rows where
        DataManager split the split, ``host_sharded_eval``), and the
        confusion matrices are summed over the data group."""
        evaluator = build_evaluator(self.cfg, self.num_classes, self.classnames)
        eval_sharded = getattr(loader, "host_sharded_eval", False)
        if loader is None:  # an empty split reports zero samples
            loader = ()
        text_fn = getattr(self, "_text_features", None)
        txt = self.aux.get("static_text_features") if self.aux else None
        eval_aux = ({k: v for k, v in self.aux.items() if k != "static_text_features"}
                    if txt is not None else self.aux)
        for batch in loader:
            if text_fn is not None and txt is None:
                txt = text_fn(self.trainable, self.frozen, self.aux)
            rows = shard_batch(self.mesh, batch, eval_sharded)
            images = self._device_batch(rows)["image"]
            preds = (self._eval_step(self.trainable, self.frozen, self.aux, images)
                     if txt is None else
                     self._eval_step_cached(self.trainable, self.frozen, eval_aux, images, txt))
            preds = preds.cpu().numpy()[:len(rows["label"])]
            evaluator.process_preds(preds, rows["label"], rows["valid"])
        if self.mesh.distributed:
            evaluator.all_reduce(self.mesh.data_group, self.mesh.device)
        results = evaluator.evaluate()
        print(f"=> result on {split}: " + " ".join(
            f"{k}: {v:.2f}" if isinstance(v, float) else f"{k}: {v}"
            for k, v in results.items() if not isinstance(v, dict)))
        self.metrics.log({"kind": "eval", "split": split, "epoch": self.epoch + 1,
                          **{k: v for k, v in results.items() if not isinstance(v, dict)}})
        return results

    def test(self) -> Dict[str, float]:
        split = self.cfg.TEST.SPLIT
        loader = self.dm.val_loader if split == "val" else self.dm.test_loader
        return self.evaluate(loader, split=split)

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------
    def save_model(self, is_best: bool = False):
        if self.trainable is None or not is_primary():
            return  # the primary rank owns the checkpoint files
        path = save_checkpoint(
            self.cfg.OUTPUT_DIR, self.model_name, self.epoch + 1, self.trainable,
            opt_state=self._opt_leaves() if hasattr(self, "optimizer") else None,
            is_best=is_best,
            meta={"trainer": self.cfg.TRAINER.NAME, "best_val": float(self._best_val)},
        )
        print(f"Checkpoint saved to {path}")
        # an epoch-boundary checkpoint supersedes a preemption checkpoint of
        # the segment that led to it (npz first: resume keys on it)
        pre = os.path.join(self.cfg.OUTPUT_DIR, self.model_name, "model-preempt.pth.tar")
        for p in (pre, pre + ".json"):
            if os.path.exists(p):
                os.remove(p)

    def _latest_epoch(self, directory: str) -> int:
        """Highest saved epoch under <directory>/<model_name> (0 if none), as
        the primary sees it."""
        def latest():
            eps = [0]
            for path in glob.glob(os.path.join(directory, self.model_name, "model.pth.tar-*")):
                m = re.search(r"model\.pth\.tar-(\d+)$", path)
                if m:
                    eps.append(int(m.group(1)))
            return max(eps)

        return self._on_primary(latest)

    def _resolve_checkpoint_epoch(self, directory: str) -> Optional[int]:
        """None (= model-best.pth.tar) when a best checkpoint exists, else
        the highest saved epoch."""
        sub = os.path.join(directory, self.model_name)
        if self._on_primary(lambda: os.path.exists(os.path.join(sub, "model-best.pth.tar"))):
            return None
        latest = self._latest_epoch(directory)
        if latest == 0:
            raise FileNotFoundError(
                f"No checkpoints under {sub!r} (neither model-best.pth.tar "
                "nor model.pth.tar-<epoch>) — check MODEL.INIT_WEIGHTS"
            )
        return latest

    def load_model(self, directory: Optional[str], epoch: Optional[int] = None,
                   tag: Optional[str] = None):
        """Load learned prompt weights into the live trainable leaves (the
        optimizer keeps them); class-dependent buffers stay as built
        (``base.py:1000-1057``).  The primary reads the file and every rank
        takes its weights."""
        if not directory:
            print("load_model() skipped: no pretrained model given")
            return
        loaded, _, meta = self._on_primary(
            lambda: load_checkpoint(directory, self.model_name, epoch, tag=tag))
        tree = restore_into(self.trainable, loaded)
        with torch.no_grad():
            for dst, src in zip(leaves(self.trainable), leaves(tree)):
                if src is not dst:
                    dst.copy_(src)
        e = meta.get("epoch")
        print(f"Loading weights for {self.model_name} from {directory} "
              f"(epoch={int(e) if e is not None else -1})")
        # static int8: activation ranges depend (mildly) on the prompts, so a
        # post-build load (--eval_only, base-to-new) recalibrates; a warm
        # start at build loads before the first calibration
        if getattr(self, "_static_calibrated", False):
            self._calibrate_static_quant()

    # -- abstract -------------------------------------------------------
    def build_model(self):  # pragma: no cover
        raise NotImplementedError


def build_trainer(cfg, devices=None):
    """The registered trainer ``cfg.TRAINER.NAME`` on ``devices`` (None:
    the card)."""
    import mudpt_torch.trainers  # noqa: F401  (registration of every trainer)

    cls = TRAINER_REGISTRY.get(cfg.TRAINER.NAME)
    return cls(cfg, devices=devices)
