"""DescribableTextures (DTD) loader (reference datasets/dtd.py:11-96):
folder-per-class under images/, random 50/20/30 split."""

from __future__ import annotations

import os

from mudpt_torch.data.datum import DatasetBase
from mudpt_torch.data.datasets.common import folder_per_class_split
from mudpt_torch.utils.registry import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class DescribableTextures(DatasetBase):
    dataset_dir = "dtd"

    def read_data(self):
        return folder_per_class_split(os.path.join(self.dataset_dir, "images"))
