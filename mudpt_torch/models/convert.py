"""Carry a parameter tree across from numpy (counterpart of the tree
handling in ``mudpt_tpu/models/convert.py``).

``params_from_numpy`` turns a parameter, trainable or aux tree whose leaves
are numpy arrays (for example ``np.asarray`` of each leaf of a JAX tree)
into the port's tensors, keeping names and layouts.  bfloat16 leaves come
as ``ml_dtypes`` arrays (dtype name ``bfloat16``) or as their ``uint16``
bit views; both become ``torch.bfloat16`` through a bit view, without a
round trip through float.  The port itself never imports ``ml_dtypes``.
A tower's calibrated ``q8_scales`` leaf (the JAX ``quant_block.attach_scales``,
(L, 4) fp32) crosses over like any other, and each layer reads its row.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        bits = np.ascontiguousarray(a).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, device) -> dict:
    """Map every array leaf of a nested dict to a tensor on ``device``;
    other leaves (ints, strings, lists) are kept as they are."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, np.generic)) or hasattr(tree, "__array__"):
        return _leaf(tree, device)
    return tree
