"""The serving forwards of the kernel chains as ``torch.library`` custom ops
under the namespace ``mudpt``, the form ``torch.export`` traces.

The wrappers of ``ops/fused_block.py`` and ``ops/quant_block.py`` launch
their kernels through ``ctypes`` with raw device pointers, which a trace
with fake tensors cannot follow.  Each op here calls one wrapper, so the
boundary sits above every pointer, build and launch: a CUDA tensor launches
the kernels (and counts in ``fused_block.LAUNCHES``), a CPU tensor runs
their plain versions, nothing falls back.  Each op has a fake (shape)
function for the trace.  The ops are the tower LayerNorm
(``mudpt::layernorm_fwd``), ``layer_fullblock``'s no-save forward, the two
half-block forwards and the two int8 serving layers; a served program
holds them as graph nodes (``serving.py``), and importing this module
registers them, as the TPU runtime provides the Mosaic calls of a JAX
artifact.

The mask spec of the chains (False, True or ``(period, valid)``) travels as
an int list: ``[]``, ``[-1]`` or ``[period, valid]``.
"""

from __future__ import annotations

from typing import List

import torch

from mudpt_torch.ops import fused_block as FB
from mudpt_torch.ops import quant_block as QB

Tensor = torch.Tensor


def mask_spec(causal: FB.Causal) -> List[int]:
    """The chains' mask spec as the ops' int list."""
    if causal is False:
        return []
    if causal is True:
        return [-1]
    period, valid = causal
    return [int(period), int(valid)]


def _causal(spec: List[int]) -> FB.Causal:
    if not spec:
        return False
    if list(spec) == [-1]:
        return True
    period, valid = spec
    return (int(period), int(valid))


@torch.library.custom_op("mudpt::layernorm_fwd", mutates_args=())
def layernorm_fwd(x: Tensor, scale: Tensor, bias: Tensor, eps: float) -> Tensor:
    return FB.layer_norm_fwd(x, scale, bias, eps)


@torch.library.custom_op("mudpt::layer_fullblock", mutates_args=())
def layer_fullblock(x: Tensor, ln1_s: Tensor, ln1_b: Tensor, qkv_w: Tensor, qkv_b: Tensor,
                    out_w: Tensor, out_b: Tensor, ln2_s: Tensor, ln2_b: Tensor,
                    fc_w: Tensor, fc_b: Tensor, proj_w: Tensor, proj_b: Tensor,
                    n_head: int, spec: List[int]) -> Tensor:
    return FB.layer_fullblock(x, ln1_s, ln1_b, qkv_w, qkv_b, out_w, out_b,
                              ln2_s, ln2_b, fc_w, fc_b, proj_w, proj_b, n_head, _causal(spec))


@torch.library.custom_op("mudpt::attn_halfblock", mutates_args=())
def attn_halfblock(x: Tensor, ln_s: Tensor, ln_b: Tensor, qkv_w: Tensor, qkv_b: Tensor,
                   out_w: Tensor, out_b: Tensor, n_head: int, spec: List[int]) -> Tensor:
    return FB.attn_halfblock(x, ln_s, ln_b, qkv_w, qkv_b, out_w, out_b, n_head, _causal(spec))


@torch.library.custom_op("mudpt::mlp_halfblock", mutates_args=())
def mlp_halfblock(x: Tensor, ln_s: Tensor, ln_b: Tensor, fc_w: Tensor, fc_b: Tensor,
                  proj_w: Tensor, proj_b: Tensor) -> Tensor:
    return FB.mlp_halfblock(x, ln_s, ln_b, fc_w, fc_b, proj_w, proj_b)


@torch.library.custom_op("mudpt::layer_fullblock_q8", mutates_args=())
def layer_fullblock_q8(x: Tensor, ln1_s: Tensor, ln1_b: Tensor, qkv_wq: Tensor,
                       qkv_ws: Tensor, qkv_b: Tensor, out_wq: Tensor, out_ws: Tensor,
                       out_b: Tensor, ln2_s: Tensor, ln2_b: Tensor, fc_wq: Tensor,
                       fc_ws: Tensor, fc_b: Tensor, proj_wq: Tensor, proj_ws: Tensor,
                       proj_b: Tensor, n_head: int, spec: List[int]) -> Tensor:
    return QB.layer_fullblock_q8(x, ln1_s, ln1_b, qkv_wq, qkv_ws, qkv_b, out_wq, out_ws, out_b,
                                 ln2_s, ln2_b, fc_wq, fc_ws, fc_b, proj_wq, proj_ws, proj_b,
                                 n_head, _causal(spec))


@torch.library.custom_op("mudpt::layer_fullblock_q8_static", mutates_args=())
def layer_fullblock_q8_static(x: Tensor, ln1_s: Tensor, ln1_b: Tensor, qkv_wq: Tensor,
                              qkv_ws: Tensor, qkv_b: Tensor, out_wq: Tensor, out_ws: Tensor,
                              out_b: Tensor, ln2_s: Tensor, ln2_b: Tensor, fc_wq: Tensor,
                              fc_ws: Tensor, fc_b: Tensor, proj_wq: Tensor, proj_ws: Tensor,
                              proj_b: Tensor, r: Tensor, n_head: int,
                              spec: List[int]) -> Tensor:
    return QB.layer_fullblock_q8_static(x, ln1_s, ln1_b, qkv_wq, qkv_ws, qkv_b, out_wq, out_ws,
                                        out_b, ln2_s, ln2_b, fc_wq, fc_ws, fc_b, proj_wq,
                                        proj_ws, proj_b, r, n_head, _causal(spec))


def _like_x(x, *args):
    return torch.empty_like(x)


for _op in (layernorm_fwd, layer_fullblock, attn_halfblock, mlp_halfblock,
            layer_fullblock_q8, layer_fullblock_q8_static):
    _op.register_fake(_like_x)


def residual_block(p: dict, x: Tensor, n_head: int, causal: FB.Causal) -> Tensor:
    """``models/layers.residual_block``'s kernel route through the ops: the
    whole layer while saves are on and D <= 768, else the two halves."""
    ln_1, attn, ln_2, mlp = p["ln_1"], p["attn"], p["ln_2"], p["mlp"]
    spec = mask_spec(causal)
    if FB.save_acts_enabled() and x.shape[-1] <= FB.FULLBLOCK_MAX_WIDTH:
        return torch.ops.mudpt.layer_fullblock(
            x, ln_1["scale"], ln_1["bias"], attn["qkv_w"], attn["qkv_b"], attn["out_w"],
            attn["out_b"], ln_2["scale"], ln_2["bias"], mlp["fc_w"], mlp["fc_b"],
            mlp["proj_w"], mlp["proj_b"], n_head, spec)
    x = torch.ops.mudpt.attn_halfblock(x, ln_1["scale"], ln_1["bias"], attn["qkv_w"],
                                       attn["qkv_b"], attn["out_w"], attn["out_b"], n_head, spec)
    return torch.ops.mudpt.mlp_halfblock(x, ln_2["scale"], ln_2["bias"], mlp["fc_w"],
                                         mlp["fc_b"], mlp["proj_w"], mlp["proj_b"])


def residual_block_q8(p: dict, x: Tensor, n_head: int, causal: FB.Causal,
                      static: bool) -> Tensor:
    """``quant_block.residual_block_q8`` (or ``_q8_static`` with ``static``)
    through the ops: the weights' int8 codes from the block's ``q8_weights``
    entry, or quantized in the traced program."""
    spec = mask_spec(causal)
    if static:
        qp, r = QB._quantize_layer_static(QB._params12(p), p["q8_scales"], p.get("q8_weights"))
        return torch.ops.mudpt.layer_fullblock_q8_static(x, *qp, r, n_head, spec)
    qp = QB._quantize_layer(QB._params12(p), p.get("q8_weights"))
    return torch.ops.mudpt.layer_fullblock_q8(x, *qp, n_head, spec)
