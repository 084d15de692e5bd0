"""OxfordFlowers loader (reference datasets/oxford_flowers.py:13-96):
imagelabels.mat + cat_to_name.json, per-class 50/20/30 split."""

from __future__ import annotations

import json
import os
import random
from collections import defaultdict

from mudpt_torch.data.datum import DatasetBase, Datum
from mudpt_torch.utils.registry import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class OxfordFlowers(DatasetBase):
    dataset_dir = "oxford_flowers"

    def read_data(self, p_trn=0.5, p_val=0.2):
        from scipy.io import loadmat

        image_dir = os.path.join(self.dataset_dir, "jpg")
        labels = loadmat(os.path.join(self.dataset_dir, "imagelabels.mat"))["labels"][0]
        with open(os.path.join(self.dataset_dir, "cat_to_name.json")) as f:
            lab2cname = json.load(f)

        tracker = defaultdict(list)
        for i, label in enumerate(labels):
            impath = os.path.join(image_dir, f"image_{i + 1:05d}.jpg")
            tracker[int(label)].append(impath)

        train, val, test = [], [], []
        for label, impaths in tracker.items():
            random.shuffle(impaths)
            n_total = len(impaths)
            n_train = round(n_total * p_trn)
            n_val = round(n_total * p_val)
            assert n_train > 0 and n_val > 0 and (n_total - n_train - n_val) > 0
            cname = lab2cname[str(label)]
            mk = lambda im: Datum(impath=im, label=label - 1, classname=cname)
            train.extend(mk(im) for im in impaths[:n_train])
            val.extend(mk(im) for im in impaths[n_train : n_train + n_val])
            test.extend(mk(im) for im in impaths[n_train + n_val :])
        return train, val, test
