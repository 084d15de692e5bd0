"""Evaluators: accuracy + macro/micro F1 (+ optional per-class report); a
copy of ``mudpt_tpu/utils/metrics.py``, its all-reduce on
``torch.distributed``.

The reference delegates to Dassl's ``Classification`` evaluator (accuracy /
macro_f1 printed at test time) and its scripts reference a
``Microf1Classification`` evaluator that does not exist in the repo
(SURVEY.md §2.5, scripts/zsclip/run_zsclip.sh:23-31) — both are provided
here for real.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from mudpt_torch.utils.registry import EVALUATOR_REGISTRY


def f1_scores(conf: np.ndarray) -> Dict[str, float]:
    """Macro and micro F1 from a (C, C) confusion matrix (rows=true)."""
    tp = np.diag(conf).astype(np.float64)
    support = conf.sum(axis=1)
    predicted = conf.sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(predicted > 0, tp / predicted, 0.0)
        recall = np.where(support > 0, tp / support, 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall / denom, 0.0)
    macro = float(f1[support > 0].mean()) if (support > 0).any() else 0.0
    total_tp = tp.sum()
    micro_p = total_tp / max(predicted.sum(), 1)
    micro_r = total_tp / max(support.sum(), 1)
    micro = (
        2 * micro_p * micro_r / (micro_p + micro_r) if micro_p + micro_r > 0 else 0.0
    )
    return {"macro_f1": macro, "micro_f1": float(micro)}


@EVALUATOR_REGISTRY.register()
class Classification:
    """Streaming classification evaluator."""

    primary = "accuracy"

    def __init__(self, num_classes: int, classnames: Optional[List[str]] = None,
                 per_class: bool = False):
        self.num_classes = num_classes
        self.classnames = classnames
        self.per_class = per_class
        self.reset()

    def reset(self) -> None:
        self._conf = np.zeros((self.num_classes, self.num_classes), np.int64)

    def process(self, logits, labels, valid=None) -> None:
        """Accumulate a batch.  ``valid`` masks padded rows."""
        self.process_preds(np.asarray(logits).argmax(axis=-1), labels, valid)

    def process_preds(self, preds, labels, valid=None) -> None:
        """Accumulate from predicted class ids (argmax already applied —
        e.g. on device, so only (B,) int32 crosses the host link)."""
        preds = np.asarray(preds)
        labels = np.asarray(labels)
        if valid is not None:
            mask = np.asarray(valid)
            preds, labels = preds[mask], labels[mask]
        np.add.at(self._conf, (labels, preds), 1)

    def all_reduce(self, group=None, device="cpu") -> None:
        """Sum the confusion matrices over ``group`` (``metrics.py:69-81``),
        so that every rank computes the same global metrics.  Under a mesh
        the group is the data group: the ranks of a model group scored the
        same images, and each test image counts once.  The sum runs on
        ``device``'s tensors (NCCL takes no CPU tensor)."""
        if not dist.is_initialized():
            return
        conf = torch.from_numpy(self._conf).to(device)
        dist.all_reduce(conf, group=group)
        self._conf = conf.cpu().numpy()

    def evaluate(self) -> Dict[str, float]:
        total = int(self._conf.sum())
        correct = int(np.diag(self._conf).sum())
        results = {
            "total": total,
            "correct": correct,
            "accuracy": 100.0 * correct / max(total, 1),
            "error": 100.0 * (total - correct) / max(total, 1),
        }
        results.update({k: 100.0 * v for k, v in f1_scores(self._conf).items()})
        if self.per_class and self.classnames:
            per: Dict[str, float] = {}
            for c, name in enumerate(self.classnames):
                support = self._conf[c].sum()
                if support:
                    per[name] = 100.0 * self._conf[c, c] / support
            results["per_class_accuracy"] = per
        return results


@EVALUATOR_REGISTRY.register()
class Microf1Classification(Classification):
    """Same statistics; micro-F1 is the headline metric."""

    primary = "micro_f1"


def build_evaluator(cfg, num_classes: int, classnames=None):
    cls = EVALUATOR_REGISTRY.get(cfg.TEST.EVALUATOR)
    return cls(num_classes, classnames, per_class=cfg.TEST.PER_CLASS_RESULT)
