"""The data x model mesh on ``torch.distributed`` (counterpart of
``mudpt_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a 2-D ``Mesh(('data', 'model'))``:

  * ``data``  shards the image batch (data parallelism);
  * ``model`` shards the class rows of the text tower, which re-encodes all
    n_cls class prompts every step, so at ImageNet's 1,000 classes it is the
    larger cost.

The port runs one process per device (a rank): world = n_data x n_model,
and rank r sits at (d, m) = divmod(r, n_model), the row-major reshape of
``build_mesh`` (``mesh.py:83-85``).  Two kinds of process group join the
ranks: a data group (one m, every d) and a model group (one d, every m).

Where the JAX package annotates global arrays and lets XLA insert the
collectives, a rank holds:

  * its own rows of the image batch (``shard_batch``): the data axis needs
    no collective in the forward;
  * every class row, padded to a multiple of n_model (``shard_class_tree``),
    as the JAX package's global view of the class-sharded buffers; the text
    tower encodes the rank's block of them and gathers the features across
    the model group (``shard_rows``), whose backward is an all-reduce across
    the model group followed by the rank's slice.

Each rank's loss is its data index's share of the global batch's loss
divided by n_model (the ranks of a model group hold the same images), so
the sum of the ranks' gradients (``reduce_grads``) is the gradient of one
process on the global batch.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from mudpt_torch.models.clip import _map
from mudpt_torch.parallel.multihost import process_count, process_index


class MeshContext:
    """The mesh's shape, this rank's place in it and its process groups
    (``groups`` None: a layout without processes, one rank's view)."""

    def __init__(self, n_data: int, n_model: int, rank: int = 0, groups: Optional[dict] = None,
                 device="cpu"):
        self.n_data, self.n_model = int(n_data), int(n_model)
        self.rank = int(rank)
        # a rank past n_data x n_model has no place in the mesh (build_mesh
        # warns that the mesh leaves ranks unused; a trainer refuses it)
        self.in_mesh = self.rank < self.n_data * self.n_model
        self.data_index, self.model_index = (divmod(self.rank, self.n_model) if self.in_mesh
                                             else (0, 0))
        groups = groups or {}
        self.group = groups.get("mesh")
        self.data_group = groups.get("data")
        self.model_group = groups.get("model")
        # collectives run on tensors of this device (NCCL takes no CPU tensor)
        self.device = torch.device(device)

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}

    def __repr__(self) -> str:
        return (f"MeshContext(data={self.n_data}, model={self.n_model}, rank={self.rank} at "
                f"({self.data_index}, {self.model_index}), distributed={self.distributed})")


def _new_groups(n_data: int, n_model: int, rank: int) -> dict:
    """Every rank creates every group, in one order (``new_group`` is
    collective); each keeps its own."""
    used = n_data * n_model
    groups = {"mesh": dist.new_group(list(range(used)))}
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if rank < used and rank % n_model == m:
            groups["data"] = g
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if rank < used and rank // n_model == d:
            groups["model"] = g
    return groups


def build_mesh(cfg=None, world: Optional[int] = None, device="cpu") -> MeshContext:
    """The mesh of ``cfg.PARALLEL`` over ``world`` ranks (default: the
    process group's size, 1 without one), with the checks, errors and
    warning of ``mesh.py:60-85``.  Process groups are made when a process
    group is initialized."""
    n = int(world if world is not None else process_count())
    n_model = (cfg.PARALLEL.MODEL if cfg is not None else 1) or 1
    if n_model > n:
        raise ValueError(f"PARALLEL.MODEL={n_model} exceeds the {n} available devices")
    n_data = (cfg.PARALLEL.DATA if cfg is not None else 0) or (n // n_model)
    if n_data * n_model > n:
        raise ValueError(
            f"PARALLEL.DATA x PARALLEL.MODEL = {n_data}x{n_model} exceeds "
            f"the {n} available devices"
        )
    if n_data * n_model < n:
        warnings.warn(
            f"mesh uses {n_data * n_model} of {n} devices "
            f"(data={n_data}, model={n_model}); set PARALLEL.DATA/MODEL to "
            "cover every chip",
            stacklevel=2,
        )
    rank = process_index()
    groups = _new_groups(n_data, n_model, rank) if dist.is_initialized() else None
    return MeshContext(n_data, n_model, rank, groups, device)


def _require_groups(ctx: MeshContext) -> None:
    if not ctx.distributed:
        raise RuntimeError(f"{ctx} spans {ctx.n_data * ctx.n_model} ranks and has no process "
                           "group: initialize torch.distributed before build_mesh")


def _all_gather_cat(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` (not the last) in rank
    order.  16-bit floats travel as their bytes: a gather copies, and gloo
    gathers no 16-bit type of a CUDA tensor."""
    x = x.contiguous()
    raw = x.view(torch.uint8) if x.dtype in (torch.bfloat16, torch.float16) else x
    parts = [torch.empty_like(raw) for _ in range(n)]
    dist.all_gather(parts, raw, group=group)
    out = torch.cat(parts, dim)
    return out.view(x.dtype) if raw is not x else out


class _GatherModel(torch.autograd.Function):
    """Forward: the model group's blocks along ``dim``.  Backward: the
    gradient summed across the model group (in fp32), then this rank's
    block of it."""

    @staticmethod
    def forward(ctx, x, dim: int, mesh: MeshContext):
        ctx.dim, ctx.mesh, ctx.rows = dim, mesh, x.shape[dim]
        return _all_gather_cat(x, dim, mesh.model_group, mesh.n_model)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        total = g.to(torch.float32, copy=True).contiguous()
        dist.all_reduce(total, group=mesh.model_group)
        block = total.narrow(ctx.dim, mesh.model_index * ctx.rows, ctx.rows)
        return block.to(g.dtype), None, None


def _shard_rows_nd(ctx: Optional[MeshContext], axis_names, fn, x, *replicated):
    """Run ``fn(x, *replicated)`` with x's leading axes split over
    ``axis_names``: the ONE implementation behind :func:`shard_rows` and
    :func:`shard_rows_2d`.

    A rank's batch already is its shard of the data axis, so a 'data' axis
    runs ``fn`` on the rows as they are.  On the 'model' axis x holds every
    (padded) class row: ``fn`` runs on this rank's block and the output is
    gathered across the model group.  Falls back to a plain call, each rank
    computing every row, where the JAX wrapper does (``mesh.py:109-120``):
    no mesh, the axes span one device, the block does not divide, or the
    XLA block impl is active; and so does static-int8 calibration, whose
    capture the JAX package runs on XLA blocks: each rank's scales then
    come from every row."""
    if ctx is None:
        return fn(x, *replicated)
    sizes = [ctx.shape.get(a, 1) for a in axis_names]
    total = 1
    for s in sizes:
        total *= s
    model = [i for i, a in enumerate(axis_names) if a == "model"]
    if total <= 1 or any(x.shape[i] % sizes[i] for i in model):
        return fn(x, *replicated)
    from mudpt_torch.models.layers import calibrating, resolve_block_impl

    if resolve_block_impl() != "pallas" or calibrating() or not model or ctx.n_model == 1:
        return fn(x, *replicated)
    _require_groups(ctx)
    dim = model[0]
    rows = x.shape[dim] // ctx.n_model
    block = x.narrow(dim, ctx.model_index * rows, rows)
    return _GatherModel.apply(fn(block, *replicated), dim, ctx)


def shard_rows(ctx: Optional[MeshContext], axis_name: str, fn, x, *replicated):
    """x's leading axis split over ``axis_name`` (see _shard_rows_nd)."""
    return _shard_rows_nd(ctx, (axis_name,), fn, x, *replicated)


def shard_rows_2d(ctx: Optional[MeshContext], axis_names, fn, x, *replicated):
    """x's leading TWO axes split over ``axis_names = (a0, a1)``: the CoCoOp
    layout (instances, classes, seq, D), instances on 'data' and classes on
    'model' (see _shard_rows_nd)."""
    return _shard_rows_nd(ctx, tuple(axis_names), fn, x, *replicated)


def _pad_rows(v: np.ndarray, target: int) -> np.ndarray:
    widths = [(0, target - v.shape[0])] + [(0, 0)] * (v.ndim - 1)
    return np.pad(v, widths)


def shard_batch(ctx: MeshContext, batch: dict, host_local: bool = False) -> dict:
    """This rank's rows of a global batch: padded to a multiple of n_data,
    pad rows ``valid=False`` (``mesh.py:187-197``), then the data index's
    block.  ``host_local`` (DATALOADER.HOST_SHARD): ``batch`` already is
    this data index's rows (``mesh.py:161-186``, one rank a process: the
    JAX package's rows_unit is 1), returned as it is.  Numpy arrays."""
    if host_local:
        return {k: np.asarray(v) for k, v in batch.items()}
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        rem = v.shape[0] % ctx.n_data
        if rem:
            pad = ctx.n_data - rem
            v = _pad_rows(v, v.shape[0] + pad)
            if k == "valid":
                v[-pad:] = False
        rows = v.shape[0] // ctx.n_data
        out[k] = v[ctx.data_index * rows:(ctx.data_index + 1) * rows]
    return out


def host_rows_slice(ctx: MeshContext, n_local: int) -> slice:
    """Where this rank's ``n_local`` (unpadded) items sit in the global
    batch that ``host_local_batch_to_global`` assembles from host-sharded
    batches (``mesh.py:205-214`` with one rank a process: the data index's
    block, blocks in data order)."""
    start = ctx.data_index * n_local
    return slice(start, start + n_local)


def shard_class_tree(ctx: MeshContext, tree, pad_to: Optional[int] = None):
    """The class tree's leading (class) axis padded with zero rows to
    ``pad_to`` (default: a multiple of n_model), on the mesh's device.  The
    rank holds every padded row, the JAX package's global view; the text
    tower runs its model block of them (``shard_rows``)."""

    def place(x):
        n = x.shape[0]
        target = pad_to or (-(-n // ctx.n_model) * ctx.n_model)
        if isinstance(x, np.ndarray):
            return _pad_rows(x, target) if target != n else x
        if target != n:
            x = torch.cat([x, x.new_zeros((target - n,) + tuple(x.shape[1:]))])
        return x.to(ctx.device)

    return _map(tree, place) if isinstance(tree, dict) else place(tree)


def replicate(ctx: MeshContext, tree):
    """Every rank holds the whole tree, on the mesh's device."""
    return _map(tree, lambda t: t.to(ctx.device))


def data_sum(ctx: Optional[MeshContext], t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data group (a new tensor; no gradient)."""
    if ctx is None or not ctx.distributed:
        return t
    out = t.detach().to(torch.float32 if t.is_floating_point() else t.dtype, copy=True)
    dist.all_reduce(out, group=ctx.data_group)
    return out.to(t.dtype)


def reduce_grads(ctx: Optional[MeshContext], params) -> None:
    """Sum the parameters' gradients over the mesh in place, in one flat
    fp32 all-reduce: every rank then holds one process's gradient on the
    global batch and takes the same optimizer step.  Leaves without a
    gradient stay without one (the same leaves on every rank)."""
    if ctx is None or not ctx.distributed:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
    dist.all_reduce(flat, group=ctx.group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
