"""Shared split-construction helpers for the dataset zoo.

The reference duplicates the same three read patterns across 15 files; here
they are factored once:

  * :func:`folder_per_class_split` — scan class folders, random p_trn /
    p_val / rest split per class (reference datasets/dtd.py:58-96, used by
    DTD/EuroSAT/Food101/Caltech101);
  * :func:`split_trainval` — per-class 80/20 train/val split of a combined
    trainval list (reference datasets/oxford_pets.py:86-105, used by
    Pets/Cars/SUN397/UCF101);
  * :func:`listdir_nohidden` — the Dassl utility both rely on.
"""

from __future__ import annotations

import os
import random
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

from mudpt_torch.data.datum import Datum


def listdir_nohidden(path: str, sort: bool = True) -> List[str]:
    items = [f for f in os.listdir(path) if not f.startswith(".")]
    if sort:
        items.sort()
    return items


def split_trainval(trainval: Sequence[Datum], p_val: float = 0.2):
    """Per-class shuffle; first round(n*p_val) to val, rest to train."""
    tracker: Dict[int, List[int]] = defaultdict(list)
    for idx, item in enumerate(trainval):
        tracker[item.label].append(idx)

    train, val = [], []
    for label, idxs in tracker.items():
        n_val = round(len(idxs) * p_val)
        assert n_val > 0
        random.shuffle(idxs)
        for n, idx in enumerate(idxs):
            (val if n < n_val else train).append(trainval[idx])
    return train, val


def folder_per_class_split(
    image_dir: str,
    p_trn: float = 0.5,
    p_val: float = 0.2,
    ignored: Optional[Sequence[str]] = None,
    new_cnames: Optional[Dict[str, str]] = None,
):
    """Folder-per-class layout -> random (p_trn, p_val, rest) per-class split."""
    categories = [
        c for c in listdir_nohidden(image_dir) if not ignored or c not in ignored
    ]
    categories.sort()

    train, val, test = [], [], []
    for label, category in enumerate(categories):
        cat_dir = os.path.join(image_dir, category)
        images = [os.path.join(cat_dir, im) for im in listdir_nohidden(cat_dir)]
        random.shuffle(images)
        n_total = len(images)
        n_train = round(n_total * p_trn)
        n_val = round(n_total * p_val)
        assert n_train > 0 and n_val > 0 and (n_total - n_train - n_val) > 0

        cname = new_cnames[category] if new_cnames and category in new_cnames else category
        mk = lambda im: Datum(impath=im, label=label, classname=cname)
        train.extend(mk(im) for im in images[:n_train])
        val.extend(mk(im) for im in images[n_train : n_train + n_val])
        test.extend(mk(im) for im in images[n_train + n_val :])
    return train, val, test
