"""EuroSAT loader (reference datasets/eurosat.py:24-106): folder-per-class
under 2750/, random 50/20/30 split.

NOTE: the reference defines NEW_CNAMES renames but never applies them (its
``update_classname`` is dead code and ``read_data`` is called without
``new_cnames`` — SURVEY.md §2.5); we reproduce that behavior for parity and
expose the renames behind the same constant for callers who want them.
"""

from __future__ import annotations

import os

from mudpt_torch.data.datum import DatasetBase
from mudpt_torch.data.datasets.common import folder_per_class_split
from mudpt_torch.utils.registry import DATASET_REGISTRY

NEW_CNAMES = {
    "AnnualCrop": "Annual Crop Land",
    "Forest": "Forest",
    "HerbaceousVegetation": "Herbaceous Vegetation Land",
    "Highway": "Highway or Road",
    "Industrial": "Industrial Buildings",
    "Pasture": "Pasture Land",
    "PermanentCrop": "Permanent Crop Land",
    "Residential": "Residential Buildings",
    "River": "River",
    "SeaLake": "Sea or Lake",
}


@DATASET_REGISTRY.register()
class EuroSAT(DatasetBase):
    dataset_dir = "eurosat"

    def read_data(self):
        return folder_per_class_split(os.path.join(self.dataset_dir, "2750"))
