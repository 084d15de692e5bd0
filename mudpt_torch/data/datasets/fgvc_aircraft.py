"""FGVCAircraft loader (reference datasets/fgvc_aircraft.py:10-80):
variants.txt class list + official images_variant_{split}.txt splits."""

from __future__ import annotations

import os

from mudpt_torch.data.datum import DatasetBase, Datum
from mudpt_torch.utils.registry import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class FGVCAircraft(DatasetBase):
    dataset_dir = "fgvc_aircraft"

    def read_data(self):
        image_dir = os.path.join(self.dataset_dir, "images")
        with open(os.path.join(self.dataset_dir, "variants.txt")) as f:
            classnames = [line.strip() for line in f]
        cname2lab = {c: i for i, c in enumerate(classnames)}

        def read(split_file):
            items = []
            with open(os.path.join(self.dataset_dir, split_file)) as f:
                for line in f:
                    parts = line.strip().split(" ")
                    classname = " ".join(parts[1:])
                    items.append(
                        Datum(
                            impath=os.path.join(image_dir, parts[0] + ".jpg"),
                            label=cname2lab[classname],
                            classname=classname,
                        )
                    )
            return items

        return (
            read("images_variant_train.txt"),
            read("images_variant_val.txt"),
            read("images_variant_test.txt"),
        )
