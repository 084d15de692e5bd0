"""The port's kernels and the chains that call them; the entry points the
JAX package exports from ``mudpt_tpu.ops``, found here by the same names."""

from mudpt_torch.ops.fused_block import (
    attn_halfblock,
    mlp_halfblock,
    mlp_halfblock_chunked,
    set_save_acts,
)

__all__ = [
    "attn_halfblock",
    "mlp_halfblock",
    "mlp_halfblock_chunked",
    "set_save_acts",
]
