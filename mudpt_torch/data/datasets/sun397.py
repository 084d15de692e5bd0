"""SUN397 loader (reference datasets/sun397.py:12-100): ClassName.txt class
paths, Training_01/Testing_01 split files, leading "/" stripped, words
reversed (indoor/outdoor first)."""

from __future__ import annotations

import os

from mudpt_torch.data.datum import DatasetBase, Datum
from mudpt_torch.data.datasets.common import split_trainval
from mudpt_torch.utils.registry import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class SUN397(DatasetBase):
    dataset_dir = "sun397"

    def read_data(self):
        image_dir = os.path.join(self.dataset_dir, "SUN397")

        cname2lab = {}
        with open(os.path.join(image_dir, "ClassName.txt")) as f:
            for i, line in enumerate(f):
                cname2lab[line.strip()[1:]] = i  # strip leading "/"

        def read(split_file):
            items = []
            with open(os.path.join(self.dataset_dir, split_file)) as f:
                for line in f:
                    imname = line.strip()[1:]
                    classname = os.path.dirname(imname)
                    label = cname2lab[classname]
                    names = classname.split("/")[1:]  # drop the a/b/... letter
                    classname_out = " ".join(names[::-1])
                    items.append(
                        Datum(
                            impath=os.path.join(image_dir, imname),
                            label=label,
                            classname=classname_out,
                        )
                    )
            return items

        trainval = read("Training_01.txt")
        test = read("Testing_01.txt")
        train, val = split_trainval(trainval, p_val=0.2)
        return train, val, test
