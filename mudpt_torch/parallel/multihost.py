"""Multi-process support on ``torch.distributed`` (counterpart of
``mudpt_tpu/parallel/multihost.py``).

One process drives one device (a "rank").  ``maybe_initialize_distributed``
joins the process group that the launcher describes in the environment:
torchrun's (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) or the JAX package's (``COORDINATOR_ADDRESS``,
``NUM_PROCESSES``, ``PROCESS_ID``, ``multihost.py:31-37``).  The backend is
the caller's: NCCL for ranks on their own cards, gloo on the CPU, or gloo
for ranks that share one card (NCCL refuses two ranks on one device).
Nothing here picks another backend or device when the named one fails: a
rank that cannot reach its device, or a collective that fails, raises.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def default_backend(device=None) -> str:
    """'gloo' for a rank on the CPU, else 'nccl' (``None`` is the card)."""
    return "gloo" if device is not None and torch.device(device).type == "cpu" else "nccl"


def maybe_initialize_distributed(backend: Optional[str] = None) -> bool:
    """Join the process group the launcher's environment describes; a
    process launched alone is left as it is.  Returns True if a
    multi-process group is active.  ``backend`` defaults to NCCL, which
    needs CUDA: without it this raises rather than take another backend."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    backend = backend or "nccl"
    coord = os.environ.get("COORDINATOR_ADDRESS")
    if coord:
        kw = dict(init_method=f"tcp://{coord}", world_size=int(os.environ["NUM_PROCESSES"]),
                  rank=int(os.environ["PROCESS_ID"]))
    elif any(k in os.environ for k in ("RANK", "WORLD_SIZE")):
        missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise ValueError(
                f"a torchrun launch sets {', '.join(_TORCHRUN_ENV)}; "
                f"{', '.join(missing)} missing from the environment"
            )
        kw = dict(init_method="env://", world_size=int(os.environ["WORLD_SIZE"]),
                  rank=int(os.environ["RANK"]))
    else:
        return False
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(
            "backend 'nccl' needs CUDA and no CUDA device is available; launch the "
            "ranks on the CPU with backend 'gloo' (train.py: --device cpu)"
        )
    dist.init_process_group(backend, **kw)
    return dist.get_world_size() > 1


def local_rank() -> int:
    """The rank's index among the ranks of its host (torchrun's LOCAL_RANK)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    return process_index() == 0


def broadcast_from_primary(tree, group=None):
    """Rank 0's host-side tree (numpy arrays, Python scalars and strings)
    on every rank of ``group`` (default: all).  Single-process: identity.
    Decisions that read the filesystem (which checkpoint exists, its
    weights) are made once, on the primary, whose disk may differ from the
    others'."""
    if process_count() == 1:
        return tree
    obj = [tree]
    dist.broadcast_object_list(obj, src=0, group=group)
    return obj[0]


def host_local_batch_to_global(mesh_ctx, batch: dict) -> dict:
    """The global batch from each data index's local rows: the data group's
    local batches concatenated in data order (numpy), on every rank.  The
    ranks of a model group hold the same rows, so one data group suffices."""
    if mesh_ctx.data_group is None:
        return {k: np.asarray(v) for k, v in batch.items()}
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        # gloo takes no bool: every leaf travels as its bytes
        t = torch.from_numpy(np.ascontiguousarray(v).view(np.uint8)).to(mesh_ctx.device)
        parts = [torch.empty_like(t) for _ in range(mesh_ctx.n_data)]
        dist.all_gather(parts, t, group=mesh_ctx.data_group)
        out[k] = np.concatenate([p.cpu().numpy().view(v.dtype) for p in parts])
    return out
