"""OxfordPets loader (reference datasets/oxford_pets.py:11-105):
annotations/{trainval,test}.txt, breed from filename, 80/20 trainval split."""

from __future__ import annotations

import os

from mudpt_torch.data.datum import DatasetBase, Datum
from mudpt_torch.data.datasets.common import split_trainval
from mudpt_torch.utils.registry import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class OxfordPets(DatasetBase):
    dataset_dir = "oxford_pets"

    def read_data(self):
        image_dir = os.path.join(self.dataset_dir, "images")
        anno_dir = os.path.join(self.dataset_dir, "annotations")

        def read(split_file):
            items = []
            with open(os.path.join(anno_dir, split_file)) as f:
                for line in f:
                    imname, label, _species, _ = line.strip().split(" ")
                    breed = "_".join(imname.split("_")[:-1]).lower()
                    items.append(
                        Datum(
                            impath=os.path.join(image_dir, imname + ".jpg"),
                            label=int(label) - 1,
                            classname=breed,
                        )
                    )
            return items

        trainval = read("trainval.txt")
        test = read("test.txt")
        train, val = split_trainval(trainval, p_val=0.2)
        return train, val, test
