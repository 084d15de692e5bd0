"""Optimizer and LR schedule factory on ``torch.optim`` (counterpart of
``mudpt_tpu/trainers/optim.py:22-123``, Dassl's ``build_optimizer`` /
``build_lr_scheduler`` for the configurations the reference ships):

  lr(epoch) = WARMUP_CONS_LR                      for epoch < WARMUP_EPOCH
            = LR * 0.5 * (1 + cos(pi*epoch/MAX))  otherwise

per step, quantized to epoch boundaries.  ``optim_cfg`` is any object with
the field names of ``OptimCfg`` (NAME, LR, MAX_EPOCH, LR_SCHEDULER,
WARMUP_EPOCH, WARMUP_TYPE, WARMUP_CONS_LR, MOMENTUM, WEIGHT_DECAY,
SGD_DAMPNING, SGD_NESTEROV).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Tuple

import torch


def make_lr_schedule(optim_cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """step -> learning rate (``optim.py:22-53``)."""
    max_epoch = optim_cfg.MAX_EPOCH
    warmup_epoch = optim_cfg.WARMUP_EPOCH
    base_lr = optim_cfg.LR
    warmup_lr = optim_cfg.WARMUP_CONS_LR
    scheduler = optim_cfg.LR_SCHEDULER
    warmup_type = optim_cfg.WARMUP_TYPE
    if scheduler not in ("cosine", "single_step"):
        raise NotImplementedError(f"LR_SCHEDULER={scheduler!r}")
    if warmup_epoch > 0 and warmup_type not in ("constant", "linear"):
        raise NotImplementedError(f"WARMUP_TYPE={warmup_type!r}")
    spe = max(1, steps_per_epoch)

    def schedule(step: int) -> float:
        epoch = step // spe
        if warmup_epoch > 0 and epoch < warmup_epoch:
            if warmup_type == "constant":
                return warmup_lr
            return warmup_lr + (step + 1) / (warmup_epoch * spe) * (base_lr - warmup_lr)
        if scheduler == "cosine":
            return base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch / max_epoch))
        return base_lr

    return schedule


class _StepSchedule(torch.optim.lr_scheduler.LRScheduler):
    """Sets every group's lr to ``schedule(step)``; step t's update uses
    schedule(t), as optax's schedules count updates from 0."""

    def __init__(self, optimizer, schedule):
        self._schedule = schedule
        super().__init__(optimizer)

    def get_lr(self):
        return [self._schedule(self.last_epoch) for _ in self.optimizer.param_groups]


def build_optimizer(
    params: Iterable[torch.Tensor], optim_cfg, steps_per_epoch: int
) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LRScheduler]:
    """(optimizer, scheduler) of ``optim.py:81-123``; call
    ``scheduler.step()`` after each ``optimizer.step()``.

    - sgd: coupled weight decay, momentum, nesterov and torch's dampening
      (buf_0 = g_0, then buf = momentum*buf + (1-dampening)*g);
    - adam: coupled weight decay (decay added to the gradient);
    - adamw: decoupled weight decay.
    """
    schedule = make_lr_schedule(optim_cfg, steps_per_epoch)
    params = list(params)
    name = optim_cfg.NAME.lower()
    lr = schedule(0)
    if name == "sgd":
        opt = torch.optim.SGD(
            params, lr=lr, momentum=optim_cfg.MOMENTUM,
            dampening=getattr(optim_cfg, "SGD_DAMPNING", 0.0),  # the reference's spelling
            weight_decay=optim_cfg.WEIGHT_DECAY, nesterov=optim_cfg.SGD_NESTEROV,
        )
    elif name == "adam":
        opt = torch.optim.Adam(params, lr=lr, weight_decay=optim_cfg.WEIGHT_DECAY)
    elif name == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, weight_decay=optim_cfg.WEIGHT_DECAY)
    else:
        raise NotImplementedError(f"OPTIM.NAME={optim_cfg.NAME!r}")
    return opt, _StepSchedule(opt, schedule)
