"""StanfordCars loader (reference datasets/stanford_cars.py:14-100): devkit
.mat annotations; the model year is moved to the front of the classname."""

from __future__ import annotations

import os

from mudpt_torch.data.datum import DatasetBase, Datum
from mudpt_torch.data.datasets.common import split_trainval
from mudpt_torch.utils.registry import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class StanfordCars(DatasetBase):
    dataset_dir = "stanford_cars"

    def read_data(self):
        from scipy.io import loadmat

        meta = loadmat(os.path.join(self.dataset_dir, "devkit", "cars_meta.mat"))
        names = meta["class_names"][0]

        def year_first(classname: str) -> str:
            parts = classname.split(" ")
            year = parts.pop(-1)
            return " ".join([year] + parts)

        def read(image_dir, anno_path):
            annos = loadmat(anno_path)["annotations"][0]
            items = []
            for anno in annos:
                label = int(anno["class"][0, 0]) - 1
                items.append(
                    Datum(
                        impath=os.path.join(
                            self.dataset_dir, image_dir, anno["fname"][0]
                        ),
                        label=label,
                        classname=year_first(names[label][0]),
                    )
                )
            return items

        trainval = read(
            "cars_train",
            os.path.join(self.dataset_dir, "devkit", "cars_train_annos.mat"),
        )
        test = read(
            "cars_test",
            os.path.join(self.dataset_dir, "cars_test_annos_withlabels.mat"),
        )
        train, val = split_trainval(trainval, p_val=0.2)
        return train, val, test
