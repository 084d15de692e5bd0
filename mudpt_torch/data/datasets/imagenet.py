"""ImageNet loader (reference datasets/imagenet.py:11-135): classnames.txt
(wnid -> classname), folder-per-wnid under images/{train,val}; the val split
doubles as test, and few-shot applies to train only.

Unlike ``mudpt_tpu``'s copy, the cached splits pass through ``_revive``
as ``DatasetBase.build``'s do, so a cache another package wrote (Dassl's,
or ``mudpt_tpu``'s) gives this package's ``Datum`` items."""

from __future__ import annotations

import os
from collections import OrderedDict

from mudpt_torch.data.datum import (
    DatasetBase,
    Datum,
    _revive,
    generate_fewshot,
    read_split_cache,
    subsample_classes,
    write_split_cache,
)
from mudpt_torch.data.datasets.common import listdir_nohidden
from mudpt_torch.utils.registry import DATASET_REGISTRY


def read_classnames(text_file: str) -> "OrderedDict[str, str]":
    classnames: "OrderedDict[str, str]" = OrderedDict()
    with open(text_file) as f:
        for line in f:
            parts = line.strip().split(" ")
            classnames[parts[0]] = " ".join(parts[1:])
    return classnames


def read_wnid_folders(image_dir: str, split_dir: str, classnames) -> list:
    split_dir = os.path.join(image_dir, split_dir)
    folders = sorted(f.name for f in os.scandir(split_dir) if f.is_dir())
    items = []
    for label, folder in enumerate(folders):
        classname = classnames[folder]
        for imname in listdir_nohidden(os.path.join(split_dir, folder)):
            items.append(
                Datum(
                    impath=os.path.join(split_dir, folder, imname),
                    label=label,
                    classname=classname,
                )
            )
    return items


@DATASET_REGISTRY.register()
class ImageNet(DatasetBase):
    dataset_dir = "imagenet"

    @classmethod
    def build(cls, cfg):
        self = cls.__new__(cls)
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, cls.dataset_dir)
        image_dir = os.path.join(self.dataset_dir, "images")
        preprocessed = os.path.join(self.dataset_dir, "preprocessed.pkl")

        cached = read_split_cache(preprocessed)
        if cached is not None:
            train, test = _revive(cached["train"]), _revive(cached["test"])
        else:
            classnames = read_classnames(
                os.path.join(self.dataset_dir, "classnames.txt")
            )
            train = read_wnid_folders(image_dir, "train", classnames)
            test = read_wnid_folders(image_dir, "val", classnames)
            try:
                write_split_cache(preprocessed, {"train": train, "test": test})
            except OSError:
                pass

        num_shots = cfg.DATASET.NUM_SHOTS
        if num_shots >= 1:
            cache = os.path.join(
                self.dataset_dir,
                "split_fewshot",
                f"shot_{num_shots}-seed_{cfg.SEED}.pkl",
            )
            cached = read_split_cache(cache)
            if cached is not None:
                train = _revive(cached["train"])
            else:
                train = generate_fewshot(train, num_shots)
                try:
                    write_split_cache(cache, {"train": train})
                except OSError:
                    pass

        train, test = subsample_classes(
            train, test, subsample=cfg.DATASET.SUBSAMPLE_CLASSES
        )
        DatasetBase.__init__(self, train_x=train, val=test, test=test)
        return self
