"""The data x model mesh and multi-process support (counterpart of
``mudpt_tpu/parallel``)."""

from mudpt_torch.parallel.mesh import (
    MeshContext,
    build_mesh,
    host_rows_slice,
    replicate,
    shard_batch,
    shard_class_tree,
)

__all__ = [
    "MeshContext",
    "build_mesh",
    "host_rows_slice",
    "shard_batch",
    "shard_class_tree",
    "replicate",
]
