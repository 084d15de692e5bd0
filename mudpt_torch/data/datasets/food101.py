"""Food101 loader (reference datasets/food101.py:11-96): folder-per-class
under images/, random 50/20/30 split."""

from __future__ import annotations

import os

from mudpt_torch.data.datum import DatasetBase
from mudpt_torch.data.datasets.common import folder_per_class_split
from mudpt_torch.utils.registry import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class Food101(DatasetBase):
    dataset_dir = "food-101"

    def read_data(self):
        return folder_per_class_split(os.path.join(self.dataset_dir, "images"))
