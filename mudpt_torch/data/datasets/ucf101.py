"""UCF101 loader (reference datasets/ucf101.py:13-110): ucfTrainTestlist
split files over mid-frame jpgs; CamelCase action names underscored."""

from __future__ import annotations

import os
import re

from mudpt_torch.data.datum import DatasetBase, Datum
from mudpt_torch.data.datasets.common import split_trainval
from mudpt_torch.utils.registry import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class UCF101(DatasetBase):
    dataset_dir = "ucf101"

    def read_data(self):
        image_dir = os.path.join(self.dataset_dir, "UCF-101-midframes")

        cname2lab = {}
        with open(
            os.path.join(self.dataset_dir, "ucfTrainTestlist", "classInd.txt")
        ) as f:
            for line in f:
                label, classname = line.strip().split(" ")
                cname2lab[classname] = int(label) - 1

        def read(split_file):
            items = []
            with open(
                os.path.join(self.dataset_dir, "ucfTrainTestlist", split_file)
            ) as f:
                for line in f:
                    line = line.strip().split(" ")[0]  # "Action/file.avi [label]"
                    action, filename = line.split("/")
                    renamed = "_".join(re.findall("[A-Z][^A-Z]*", action))
                    items.append(
                        Datum(
                            impath=os.path.join(
                                image_dir, renamed, filename.replace(".avi", ".jpg")
                            ),
                            label=cname2lab[action],
                            classname=renamed,
                        )
                    )
            return items

        trainval = read("trainlist01.txt")
        test = read("testlist01.txt")
        train, val = split_trainval(trainval, p_val=0.2)
        return train, val, test
