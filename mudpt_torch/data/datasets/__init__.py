# Importing this package registers the dataset plugins the port has
# (mirrors the import side effects at reference train.py:15-29).  The other
# readers of mudpt_tpu/data/datasets wait (ROADMAP.md A, 'the dataset readers').
from mudpt_torch.data.datasets import synthetic  # noqa: F401
