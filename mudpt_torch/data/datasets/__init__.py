# Importing this package registers all dataset plugins
# (mirrors the import side effects at reference train.py:15-29).  Each
# reader is a copy of its namesake in mudpt_tpu/data/datasets: the same
# tree gives the same items, and the caches either package writes
# (preprocessed.pkl, split_fewshot/*.pkl) read equal in the other.
from mudpt_torch.data.datasets import (  # noqa: F401
    caltech101,
    dtd,
    eurosat,
    fgvc_aircraft,
    food101,
    imagenet,
    imagenet_variants,
    oxford_flowers,
    oxford_pets,
    stanford_cars,
    sun397,
    synthetic,
    ucf101,
)
