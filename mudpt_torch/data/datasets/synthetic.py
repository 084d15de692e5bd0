"""Synthetic in-memory dataset for tests and benchmarks.

Not present in the reference (which has no test suite at all — SURVEY.md §4);
this provides a deterministic K-class dataset of random-noise images with a
class-dependent mean shift so that a working trainer can actually fit it.
A copy of ``mudpt_tpu/data/datasets/synthetic.py``: the same seed draws the
same images.
"""

from __future__ import annotations

import numpy as np

from mudpt_torch.data.datum import DatasetBase, Datum, subsample_classes
from mudpt_torch.utils.registry import DATASET_REGISTRY

_NAMES = [
    "cat", "dog", "car", "tree", "house", "bird", "fish", "chair",
    "boat", "plane", "horse", "flower", "clock", "phone", "lamp", "shoe",
]


@DATASET_REGISTRY.register()
class Synthetic(DatasetBase):
    dataset_dir = "synthetic"

    @classmethod
    def build(cls, cfg, num_classes: int = 0, per_class: int = 0, size: int = 0):
        num_classes = num_classes or cfg.DATASET.SYNTHETIC_NUM_CLASSES
        per_class = per_class or cfg.DATASET.SYNTHETIC_PER_CLASS
        size = size or cfg.INPUT.SIZE[0]
        rng = np.random.RandomState(cfg.SEED)
        # distinct RGB tints per class: global color is the class signal
        colors = rng.rand(num_classes, 3) * 0.8 + 0.1
        splits = {"train": [], "val": [], "test": []}
        for label in range(num_classes):
            mean = colors[label]
            for split, count in (("train", per_class), ("val", 2), ("test", 4)):
                for _ in range(count):
                    img = rng.rand(size, size, 3).astype(np.float32) * 0.15 + mean
                    splits[split].append(
                        Datum(
                            label=label,
                            classname=(_NAMES[label] if label < len(_NAMES)
                                       else f"{_NAMES[label % len(_NAMES)]} {label}"),
                            array=np.clip(img, 0, 1),
                        )
                    )
        train, val, test = subsample_classes(
            splits["train"], splits["val"], splits["test"],
            subsample=cfg.DATASET.SUBSAMPLE_CLASSES,
        )
        self = cls.__new__(cls)
        DatasetBase.__init__(self, train_x=train, val=val, test=test)
        return self
