"""The model's work, counted from shapes: the operations and bytes that the
per-layer metrics divide by the H100's peaks.

Each :class:`Op` is one product or one attention of the model, with its
family (``gemm`` or ``attention``), the precision its operations run at
(``bf16`` or ``s8``), its operations (a multiply-add counts 2) and its
bytes, each input read once and each output written once.  What counts:

* a tower's four projections per layer (2 x 12 D^2 operations a token);
  under the int8 tier they are s8 products, their inputs int8 codes;
* attention's two score-sized products, 4 S_k D operations a query in the
  forward and 8 in the dx-only backward; a causal text query counts its
  earlier keys only, and a prompt's queries only up to its EOT;
* text rows only up to each prompt's EOT (what a prompt's features need);
* the patch embedding, the two output projections and the cosine logits;
* no weight-gradient product of the frozen backbone, no recompute, and not
  the trainable prompts' own small linears (below a millionth of a step).

The backward of a product is its dx product, of the same size.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence

# H100 SXM, NVIDIA's data sheet, dense, at the 700 W limit
PEAK_OPS = {"bf16": 989e12, "s8": 1979e12}
PEAK_BYTES = 3.35e12


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    family: str
    precision: str
    ops: float
    bytes: float

    def least_s(self) -> float:
        """The roofline's least time: operations at the precision's peak or
        bytes at the memory's, whichever is longer."""
        return max(self.ops / PEAK_OPS[self.precision], self.bytes / PEAK_BYTES)

    def ops_s(self) -> float:
        """The operations alone at the precision's peak (what MFU counts)."""
        return self.ops / PEAK_OPS[self.precision]


def gemm(name: str, m: float, k: int, n: int, a_bytes: float = 2, w_bytes: float = 2,
         out_bytes: float = 2, precision: str = "bf16") -> Op:
    """(m, k) @ (k, n)."""
    return Op(name, "gemm", precision, 2.0 * m * k * n,
              m * k * a_bytes + k * n * w_bytes + m * n * out_bytes)


def tower_gemms(tag: str, tokens: float, width: int, layers: int, tier: str,
                backward: bool) -> List[Op]:
    """A tower's projections over ``tokens`` rows: qkv, out, fc, proj per
    layer; with ``backward`` also their dx products (bf16 operands, the
    weights read again)."""
    D = width
    shapes = (("attn_qkv", D, 3 * D), ("attn_out", D, D), ("mlp_fc", D, 4 * D),
              ("mlp_proj", 4 * D, D))
    ops = []
    for name, k, n in shapes:
        if tier == "int8":
            fwd = gemm(f"{tag}.{name}", tokens, k, n, a_bytes=1, w_bytes=1, precision="s8")
        else:
            fwd = gemm(f"{tag}.{name}", tokens, k, n)
        ops.append(_times(fwd, layers))
        if backward:
            ops.append(_times(gemm(f"{tag}.{name}.dx", tokens, n, k), layers))
    return ops


def attention(tag: str, query_keys: float, queries: float, width: int, layers: int,
              backward: bool, out_bytes: float = 2) -> List[Op]:
    """Attention over ``query_keys`` (the sum over queries of the keys each
    attends to) and ``queries`` rows of q, k, v: the forward reads q, k, v
    and writes o; the dx-only backward reads q, k, v, o, do and writes dq,
    dk, dv."""
    D = width
    ops = [_times(Op(f"{tag}.attention", "attention", "bf16", 4.0 * query_keys * D,
                     queries * D * (3 * 2 + out_bytes)), layers)]
    if backward:
        ops.append(_times(Op(f"{tag}.attention.dx", "attention", "bf16", 8.0 * query_keys * D,
                             queries * D * 2 * 8), layers))
    return ops


def _times(op: Op, k: float) -> Op:
    return dataclasses.replace(op, ops=op.ops * k, bytes=op.bytes * k)


def vision_ops(cfg: dict, images: int, tier: str, backward: bool) -> List[Op]:
    """The vision tower over ``images``: [CLS, patches, n_ctx prompts]."""
    grid = cfg["image_resolution"] // cfg["vision_patch_size"]
    S = grid * grid + 1 + cfg["n_ctx"]
    W, L = cfg["vision_width"], cfg["vision_layers"]
    P = cfg["vision_patch_size"]
    ops = [gemm("vision.patch_embed", images * grid * grid, 3 * P * P, W)]
    ops += tower_gemms("vision", images * S, W, L, tier, backward)
    ops += attention("vision", images * S * S, images * S, W, L, backward,
                     out_bytes=4 if tier == "int8" else 2)
    ops.append(gemm("vision.proj", images, W, cfg["embed_dim"]))
    if backward:
        ops.append(gemm("vision.proj.dx", images, cfg["embed_dim"], W))
    return ops


def text_ops(cfg: dict, eot: Sequence[int], tier: str, backward: bool) -> List[Op]:
    """The text tower over prompts whose EOT positions are ``eot``."""
    W, L = cfg["transformer_width"], cfg["transformer_layers"]
    lengths = [int(e) + 1 for e in eot]
    tokens = sum(lengths)
    query_keys = sum(t * (t + 1) // 2 for t in lengths)
    ops = tower_gemms("text", tokens, W, L, tier, backward)
    ops += attention("text", query_keys, tokens, W, L, backward,
                     out_bytes=4 if tier == "int8" else 2)
    ops.append(gemm("text.proj", len(lengths), W, cfg["embed_dim"]))
    if backward:
        ops.append(gemm("text.proj.dx", len(lengths), cfg["embed_dim"], W))
    return ops


def logits_ops(cfg: dict, images: int, n_cls: int, backward: bool) -> List[Op]:
    E = cfg["embed_dim"]
    ops = [gemm("logits", images, E, n_cls, a_bytes=4, w_bytes=4, out_bytes=4)]
    if backward:  # d image features and d text features
        ops += [gemm("logits.dimg", images, n_cls, E, 4, 4, 4),
                gemm("logits.dtxt", n_cls, images, E, 4, 4, 4)]
    return ops


def train_step_ops(cfg: dict, batch: int, eot: Sequence[int], tier: str) -> List[Op]:
    """One MuDPT step: both towers forward and dx-only backward, the logits."""
    return (vision_ops(cfg, batch, tier, True) + text_ops(cfg, eot, tier, True)
            + logits_ops(cfg, batch, len(eot), True))


def request_ops(cfg: dict, images: int, n_cls: int, tier: str) -> List[Op]:
    """One served request against cached text features."""
    return vision_ops(cfg, images, tier, False) + logits_ops(cfg, images, n_cls, False)


def total(ops: Iterable[Op], family: str = None, kind: str = "least") -> float:
    """Seconds at the peaks of ``ops`` (of one family if given): the
    roofline's least time, or with ``kind`` 'ops' the operations alone."""
    f = Op.least_s if kind == "least" else Op.ops_s
    return sum(f(op) for op in ops if family is None or op.family == family)
