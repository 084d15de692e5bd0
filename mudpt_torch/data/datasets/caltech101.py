"""Caltech101 loader (reference datasets/caltech101.py:18-40): folder-per-
class under caltech-101/101_ObjectCategories, with background/duplicate
folders ignored and a handful of classname renames applied."""

from __future__ import annotations

import os

from mudpt_torch.data.datum import DatasetBase
from mudpt_torch.data.datasets.common import folder_per_class_split
from mudpt_torch.utils.registry import DATASET_REGISTRY

IGNORED = ["BACKGROUND_Google", "Faces_easy"]
NEW_CNAMES = {
    "airplanes": "airplane",
    "Faces": "face",
    "Leopards": "leopard",
    "Motorbikes": "motorbike",
}


@DATASET_REGISTRY.register()
class Caltech101(DatasetBase):
    dataset_dir = "caltech101"

    def read_data(self):
        return folder_per_class_split(
            os.path.join(self.dataset_dir, "caltech-101", "101_ObjectCategories"),
            ignored=IGNORED,
            new_cnames=NEW_CNAMES,
        )
