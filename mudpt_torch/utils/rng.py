"""Seed discipline (counterpart of ``mudpt_tpu/utils/rng.py``).

The reference seeds python, numpy and torch (reference train.py:155-157).
The port's model code takes explicit ``torch.Generator``s, so the ambient
state seeded here is what the data pipeline draws from (few-shot sampling,
split shuffles) and any library default."""

from __future__ import annotations

import random
from typing import Optional, Union

import numpy as np
import torch


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def new_rng(seed: int, device: Optional[Union[str, torch.device]] = "cpu") -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (``new_rng`` returns a
    JAX key; its draws differ from these)."""
    return torch.Generator(device=device).manual_seed(seed)
