"""Domain-shift ImageNet variants, all test-only (train_x = test = data):

  * ImageNetV2 (reference datasets/imagenetv2.py:10-52): folders named by
    label int, matched-frequency val format;
  * ImageNetSketch (imagenet_sketch.py:10-48): folder-per-wnid;
  * ImageNetA / ImageNetR (imagenet_a.py:12-44, imagenet_r.py:12-42):
    200-class folder-per-wnid, skipping README.txt.

All reuse ImageNet's classnames.txt so classnames align with
ImageNet-trained prompts for domain-generalization eval."""

from __future__ import annotations

import os

from mudpt_torch.data.datum import DatasetBase, Datum
from mudpt_torch.data.datasets.common import listdir_nohidden
from mudpt_torch.data.datasets.imagenet import read_classnames
from mudpt_torch.utils.registry import DATASET_REGISTRY

TO_BE_IGNORED = ["README.txt"]


class _TestOnlyVariant(DatasetBase):
    image_subdir = ""

    @classmethod
    def build(cls, cfg):
        self = cls.__new__(cls)
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, cls.dataset_dir)
        classnames = read_classnames(
            os.path.join(self.dataset_dir, "classnames.txt")
        )
        data = self.read_items(
            os.path.join(self.dataset_dir, cls.image_subdir), classnames
        )
        DatasetBase.__init__(self, train_x=data, val=[], test=data)
        return self

    @staticmethod
    def read_items(image_dir, classnames):
        folders = [
            f for f in listdir_nohidden(image_dir) if f not in TO_BE_IGNORED
        ]
        items = []
        for label, folder in enumerate(folders):
            classname = classnames[folder]
            for imname in listdir_nohidden(os.path.join(image_dir, folder)):
                items.append(
                    Datum(
                        impath=os.path.join(image_dir, folder, imname),
                        label=label,
                        classname=classname,
                    )
                )
        return items


@DATASET_REGISTRY.register()
class ImageNetV2(_TestOnlyVariant):
    dataset_dir = "imagenetv2"
    image_subdir = "imagenetv2-matched-frequency-format-val"

    @staticmethod
    def read_items(image_dir, classnames):
        # folders are stringified ImageNet label ints (imagenetv2.py:41-44)
        wnids = list(classnames.keys())
        items = []
        for label in range(1000):
            class_dir = os.path.join(image_dir, str(label))
            classname = classnames[wnids[label]]
            for imname in listdir_nohidden(class_dir):
                items.append(
                    Datum(
                        impath=os.path.join(class_dir, imname),
                        label=label,
                        classname=classname,
                    )
                )
        return items


@DATASET_REGISTRY.register()
class ImageNetSketch(_TestOnlyVariant):
    dataset_dir = "imagenet-sketch"
    image_subdir = "images"


@DATASET_REGISTRY.register()
class ImageNetA(_TestOnlyVariant):
    dataset_dir = "imagenet-adversarial"
    image_subdir = "imagenet-a"


@DATASET_REGISTRY.register()
class ImageNetR(_TestOnlyVariant):
    dataset_dir = "imagenet-rendition"
    image_subdir = "imagenet-r"
