"""Primitive layers as plain functions over parameter dicts (counterpart of
``mudpt_tpu/models/layers.py``).

LayerNorm computes in float32 and casts back to the input dtype (in the
input dtype under :func:`set_ln_dtype` ``'bf16'``); QuickGELU is
``x * sigmoid(1.702 x)``; weights use the ``(in, out)`` layout.

:func:`residual_block` is the dispatch of ``layers.py:209-285``: the whole
layer (``layer_fullblock``) or its two halves (``attn_halfblock``,
``mlp_halfblock``) as the JAX package picks them; a CUDA tensor goes to
their hand-written kernels (the saving forward and the kernel backward when
x needs a gradient), a CPU tensor to the kernels' plain versions.  A CUDA
tensor the kernels cannot take raises; it never quietly runs the plain
body.  :func:`plain_blocks` lets a reference run ask for the plain versions
on the card explicitly.

The XLA route, ``x + attention(LN x)`` then ``+ mlp(LN x)`` with an
additive mask, is the counterpart of the JAX package's XLA blocks, built
from PyTorch ops on any device and dtype: under :func:`set_block_impl`
``'xla'``, for towers wider than 1024 and for an additive mask that is not
causal, as JAX routes (``layers.py:249``, :283-285).  Under a quant mode
(:func:`set_quant_mode`, :func:`quantized`) every block runs an int8 tier
of ``ops/quant_block.py`` instead (``layers.py:182-248``), and the XLA
route raises as JAX's does.  :func:`calibration_capture` selects the XLA
route, whose four quant sites record their absmax (``layers.py:28-53``).

While :func:`exporting` is open (``serving.export_classifier``), the
kernel route calls the chains as ``torch.library`` custom ops
(``ops/library.py``), the form ``torch.export`` traces.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from mudpt_torch.ops import fused_block, quant_block

_PLAIN_ON_CUDA = False

# 'auto' | 'pallas' | 'xla' (``layers.py:139-179``): 'auto' and 'pallas' are
# the kernel route (kernels on CUDA tensors, their plain versions on CPU
# tensors), 'xla' the XLA route on either device
BLOCK_IMPLS = ("auto", "pallas", "xla")
_BLOCK_IMPL = "auto"
# 'fp32' (reference numerics) | 'bf16' (normalize in the input dtype): the
# XLA route's and the towers' LayerNorms (``layers.py:56-80``); the kernel
# chains normalize in fp32 whatever is set, as the Pallas kernels do
LN_DTYPES = ("fp32", "bf16")
_LN_DTYPE = "fp32"
# set while torch.export traces a served function (:func:`exporting`)
_EXPORTING = False
# set by the towers under REMAT 'selective' (models/transformer.py): the XLA
# route's attention recomputes its fp32 scores and probs in the backward
_RECOMPUTE_PROBS = False

# The activation-absmax sink of calibration_capture: while installed, the
# plain route's attention and mlp record the absmax of their four quant
# sites (LN1 output, MHA output, LN2 output, post-GELU), 4 values a block
_CALIB_SINK: Optional[list] = None

# 'none' | 'int8' | 'int8_static' | 'int8_ste' | 'int8_ste_static' (the JAX
# package's quant modes, layers.py:182-206, without MUDPT_TPU_QUANT)
QUANT_MODES = ("none", "int8", "int8_static", "int8_ste", "int8_ste_static")
_QUANT_MODE = "none"


def set_quant_mode(name: str) -> None:
    """'int8': every block's projections s8 x s8 -> s32 with dynamic per-row
    activation scales, serving only (a backward raises).  'int8_static':
    blocks with a ``q8_scales`` leaf quantize activations by calibrated
    per-tensor scales, the others fall back to 'int8'.  'int8_ste' /
    'int8_ste_static': the same forwards with a straight-through backward
    (quantization-aware prompt tuning)."""
    if name not in QUANT_MODES:
        raise ValueError(f"quant mode {name!r}: expected one of {QUANT_MODES}")
    global _QUANT_MODE
    _QUANT_MODE = name


def quant_mode() -> str:
    return _QUANT_MODE


@contextlib.contextmanager
def quantized(name: str):
    """The quant mode inside the context, the previous one after it."""
    prev = _QUANT_MODE
    set_quant_mode(name)
    try:
        yield
    finally:
        set_quant_mode(prev)


def set_block_impl(name: str) -> None:
    """'xla', 'pallas' or 'auto' (``layers.py:163-172``).  'pallas' and 'auto'
    run the hand-written kernel chains on CUDA tensors and their plain
    versions on CPU tensors; 'xla' runs every block on the XLA route and
    every LayerNorm on PyTorch ops, which take fp32 activations on the card
    too."""
    if name not in BLOCK_IMPLS:
        raise ValueError(f"block impl {name!r}: expected one of {BLOCK_IMPLS}")
    global _BLOCK_IMPL
    _BLOCK_IMPL = name


def block_impl() -> str:
    return _BLOCK_IMPL


def resolve_block_impl() -> str:
    """'xla' or 'pallas' (``layers.py:175-178``): the port's 'auto' is the
    kernel route on either device (its plain versions on CPU tensors), where
    JAX's picks Pallas on a TPU only."""
    return "xla" if _BLOCK_IMPL == "xla" else "pallas"


def set_ln_dtype(name: str) -> None:
    """'fp32' (reference numerics) or 'bf16' (normalize in the input dtype,
    not reference numerics) (``layers.py:59-64``)."""
    if name not in LN_DTYPES:
        raise ValueError(f"LN dtype {name!r}: expected one of {LN_DTYPES}")
    global _LN_DTYPE
    _LN_DTYPE = name


def ln_dtype() -> str:
    return _LN_DTYPE


@contextlib.contextmanager
def calibration_capture(sink: list):
    """Install an activation-absmax sink; every block takes the XLA route,
    unquantized, and every LayerNorm its PyTorch version meanwhile, on
    either device (``layers.py:37-48``: the JAX capture forces XLA blocks)."""
    global _CALIB_SINK, _QUANT_MODE, _PLAIN_ON_CUDA
    prev = (_CALIB_SINK, _QUANT_MODE, _PLAIN_ON_CUDA)
    _CALIB_SINK, _QUANT_MODE, _PLAIN_ON_CUDA = sink, "none", True
    try:
        yield
    finally:
        _CALIB_SINK, _QUANT_MODE, _PLAIN_ON_CUDA = prev


@contextlib.contextmanager
def exporting():
    """The kernel route as ``torch.library`` custom ops inside the context
    (``serving.export_classifier``), the wrappers' direct calls after it."""
    global _EXPORTING
    from mudpt_torch.ops import library  # noqa: F401  (registers the ops)

    prev, _EXPORTING = _EXPORTING, True
    try:
        yield
    finally:
        _EXPORTING = prev


@contextlib.contextmanager
def recomputing_probs(on: bool):
    """REMAT 'selective' inside the context: the XLA route's attention keeps
    q, k and v and recomputes its scores and probs in the backward
    (``layers.py:120-124`` names them for JAX's policy)."""
    global _RECOMPUTE_PROBS
    prev, _RECOMPUTE_PROBS = _RECOMPUTE_PROBS, on
    try:
        yield
    finally:
        _RECOMPUTE_PROBS = prev


def calibrating() -> bool:
    return _CALIB_SINK is not None


def _calib_record(x: torch.Tensor) -> None:
    if _CALIB_SINK is not None:
        _CALIB_SINK.append(x.float().abs().amax())


def routes() -> tuple:
    """The process-global routing state the blocks read at forward time:
    (plain versions on the card, quant mode).  A recompute that runs after
    its caller's contexts have closed (``torch.utils.checkpoint``) enters
    :func:`routed` with this snapshot to take the forward's route."""
    return _PLAIN_ON_CUDA, _QUANT_MODE


@contextlib.contextmanager
def routed(state: tuple):
    """The routing state of :func:`routes` inside the context, the previous
    one after it."""
    global _PLAIN_ON_CUDA, _QUANT_MODE
    prev = (_PLAIN_ON_CUDA, _QUANT_MODE)
    _PLAIN_ON_CUDA, _QUANT_MODE = state
    try:
        yield
    finally:
        _PLAIN_ON_CUDA, _QUANT_MODE = prev


def routing_state() -> tuple:
    """Everything the blocks read at forward time: :func:`routes`, the block
    impl, the LN dtype and the save policy (``ops/fused_block
    .save_acts_enabled``).  A layer recomputed in the backward under REMAT
    'full' re-enters it with :func:`routing`."""
    return routes(), _BLOCK_IMPL, _LN_DTYPE, fused_block.save_acts_enabled()


@contextlib.contextmanager
def routing(state: tuple):
    """The state of :func:`routing_state` inside the context, the previous
    one after it."""
    global _BLOCK_IMPL, _LN_DTYPE
    route, impl, ln, saves = state
    prev = (_BLOCK_IMPL, _LN_DTYPE)
    _BLOCK_IMPL, _LN_DTYPE = impl, ln
    try:
        with routed(route), fused_block.saved_acts(saves):
            yield
    finally:
        _BLOCK_IMPL, _LN_DTYPE = prev


@contextlib.contextmanager
def plain_blocks():
    """Run every residual block and tower LayerNorm through the plain
    versions on any device while the context is open (the layer's saving
    forward and backward too): the reference that the kernels are held
    against on the card."""
    global _PLAIN_ON_CUDA
    prev, _PLAIN_ON_CUDA = _PLAIN_ON_CUDA, True
    try:
        yield
    finally:
        _PLAIN_ON_CUDA = prev


class LayerNormFn(torch.autograd.Function):
    """A tower LayerNorm whose input needs a gradient: ``layernorm_fwd``
    forward, ``layernorm_bwd`` backward (no residual, the upstream gradient
    in x's dtype as dxn), dx only (JAX: XLA's autodiff of ``layer_norm``
    :67-80, with scale and bias frozen)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            raise ValueError("LayerNormFn returns dx only: scale and bias must not require grad")
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return fused_block.layer_norm_fwd(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        return fused_block.layer_norm_bwd(g.contiguous(), x, scale, None, ctx.eps), None, None, None


def _xla_layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """JAX's ``layer_norm`` (``layers.py:67-80``) from PyTorch ops: fp32
    statistics and affine cast back to x's dtype, or, under LN 'bf16', all
    of it in x's dtype."""
    if _LN_DTYPE == "bf16":
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + eps)
        return y * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)
    return fused_block.layer_norm_plain(x, p["scale"], p["bias"], eps)


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """A tower LayerNorm: fp32 statistics, cast back to x's dtype; on the
    card through the ``layernorm_fwd`` kernel of x's dtype (bf16 or fp32)
    and, when x needs a gradient, ``layernorm_bwd``.  Under block impl 'xla'
    or LN 'bf16' it is JAX's ``layer_norm`` on PyTorch ops, on any device."""
    if _PLAIN_ON_CUDA or _BLOCK_IMPL == "xla" or _LN_DTYPE == "bf16":
        return _xla_layer_norm(p, x, eps)
    if _EXPORTING:
        return torch.ops.mudpt.layernorm_fwd(x.contiguous(), p["scale"], p["bias"], eps)
    x = x.contiguous()
    if torch.is_grad_enabled() and x.requires_grad:
        return LayerNormFn.apply(x, p["scale"], p["bias"], eps)
    return fused_block.layer_norm_fwd(x, p["scale"], p["bias"], eps)


def layer_norm_trainable(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """A LayerNorm whose scale and bias train: ``F.layer_norm`` on autograd
    with the fp32 statistics and affine of ``layers.py:67-80``, cast back to
    x's dtype (under LN 'bf16' in x's dtype), on any device (JAX runs it on
    XLA's autodiff).  Only the
    trained prompt heads take it (:func:`residual_block_trainable`,
    ``trainers/prompt_utils.prompt_transform_head``); a frozen tower's
    LayerNorm is :func:`layer_norm`."""
    if _LN_DTYPE == "bf16":
        return _xla_layer_norm(p, x, eps)
    y = torch.nn.functional.layer_norm(x.float(), x.shape[-1:], p["scale"].float(),
                                       p["bias"].float(), eps)
    return y.to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, p["w"].to(x.dtype)) + p["b"].to(x.dtype)


def _attend(q, k, v, mask):
    """softmax(q k^T / sqrt(hd) + mask) v, the scores and their softmax in
    fp32, the probs cast to v's dtype (``layers.py:115-126``)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def attention(p: dict, x: torch.Tensor, n_head: int,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain multi-head self-attention, (B, S, D) -> (B, S, D), with an
    optional additive (S, S) mask (``layers.py:91-128``): explicit products
    and an fp32 softmax, the probs cast to x's dtype, where JAX rounds."""
    B, S, D = x.shape
    hd = D // n_head
    _calib_record(x)  # site 1: the qkv product's input (LN1 output)
    qkv = torch.matmul(x, p["qkv_w"].to(x.dtype)) + p["qkv_b"].to(x.dtype)
    q, k, v = qkv.reshape(B, S, 3, n_head, hd).permute(2, 0, 3, 1, 4)  # (B, H, S, hd)
    if _RECOMPUTE_PROBS and torch.is_grad_enabled():
        out = checkpoint(_attend, q, k, v, mask, use_reentrant=False)
    else:
        out = _attend(q, k, v, mask)
    out = out.permute(0, 2, 1, 3).reshape(B, S, D)
    _calib_record(out)  # site 2: the out-projection's input (MHA output)
    return torch.matmul(out, p["out_w"].to(x.dtype)) + p["out_b"].to(x.dtype)


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``layers.py:131-136``."""
    _calib_record(x)  # site 3: the fc product's input (LN2 output)
    h = quick_gelu(torch.matmul(x, p["fc_w"].to(x.dtype)) + p["fc_b"].to(x.dtype))
    _calib_record(h)  # site 4: the proj product's input (post-GELU)
    return torch.matmul(h, p["proj_w"].to(x.dtype)) + p["proj_b"].to(x.dtype)


def _additive_mask(S: int, causal: fused_block.Causal, device) -> Optional[torch.Tensor]:
    """The XLA route's (S, S) mask: none; causal, -inf above the diagonal
    (``text.causal_mask``); packed ``(period, valid)``, -1e30 outside each
    block's causal window and at pad keys (``fused_block._causal_mask``)."""
    if causal is False:
        return None
    row = torch.arange(S, device=device)[:, None]
    col = torch.arange(S, device=device)[None, :]
    if causal is True:
        return torch.where(col > row, float("-inf"), 0.0)
    period, valid = causal
    ok = (col <= row) & (row // period == col // period) & (col % period < valid)
    return torch.where(ok, 0.0, fused_block.NEG)


def _xla_route(p: dict, x: torch.Tensor, n_head: int, causal: fused_block.Causal,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x + attention(LN x)``, then ``+ mlp(LN x)`` (``layers.py:283-285``),
    with ``mask``, or the additive form of the mask spec ``causal``."""
    if mask is None:
        mask = _additive_mask(x.shape[1], causal, x.device)
    x = x + attention(p["attn"], _xla_layer_norm(p["ln_1"], x), n_head, mask)
    return x + mlp(p["mlp"], _xla_layer_norm(p["ln_2"], x))


def _valid_mask_spec(causal) -> bool:
    if isinstance(causal, bool):
        return True
    return (isinstance(causal, tuple) and len(causal) == 2
            and all(isinstance(v, int) for v in causal))


def _quant_block(p: dict, x: torch.Tensor, n_head: int, causal,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The quant dispatch (``layers.py:218-248``): the int8 tiers exist only
    as the q8 chains, so block impl 'xla', an unsupported mask or a width
    above 1024 raises rather than serve an unquantized block the caller did
    not ask for.  The chains take bf16 or fp32 activations with the block's
    weights and biases in the same dtype; a mix (or fp16) raises on either
    device, as the kernels' dispatch does on the card (nothing casts)."""
    D = x.shape[-1]
    if not (resolve_block_impl() == "pallas" and _valid_mask_spec(causal)
            and (mask is None or causal) and D <= fused_block.MAX_WIDTH):
        raise ValueError(
            f"quant mode {_QUANT_MODE!r} requires the q8 layer chains (block impl "
            f"'pallas', causal or unmasked attention, width <= {fused_block.MAX_WIDTH}; "
            f"got impl={resolve_block_impl()!r}, mask spec {causal!r}, D={D}); "
            "set_quant_mode('none') or set_block_impl('pallas')"
        )
    fused_block.kernel_for("gemm_s8_epilogue", x.dtype,
                           *(p[g][f"{n}_{kind}"].dtype for g, n in quant_block._PROJ
                             for kind in ("w", "b")))
    plain = _PLAIN_ON_CUDA
    if _QUANT_MODE in ("int8_ste", "int8_ste_static"):
        return quant_block.residual_block_q8_ste(p, x, n_head, causal, plain)
    static = _QUANT_MODE == "int8_static" and "q8_scales" in p
    if _EXPORTING:
        from mudpt_torch.ops import library

        return library.residual_block_q8(p, x, n_head, causal, static)
    if static:
        return quant_block.residual_block_q8_static(p, x, n_head, causal, plain)
    # 'int8', or 'int8_static' on a tower without calibrated scales
    return quant_block.residual_block_q8(p, x, n_head, causal, plain)


def residual_block(p: dict, x: torch.Tensor, n_head: int,
                   causal: fused_block.Causal = False,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One pre-LN residual block (mask spec ``causal``: False, True or
    ``(period, valid)``; ``mask`` an optional additive (S, S) mask), routed
    as ``layers.py:209-285`` routes it on either device: the XLA route under
    block impl 'xla', wider than 1024, or for a mask that is not causal;
    else ``layer_fullblock`` while saves are on and D <= 768, else
    ``attn_halfblock`` then ``mlp_halfblock``, on bf16 or fp32 activations
    alike (the gates do not look at the dtype, as JAX's do not).  Under a
    quant mode the int8 tiers run instead, on bf16 or fp32 activations
    alike; under :func:`calibration_capture` the XLA route."""
    if _CALIB_SINK is not None:
        return _xla_route(p, x, n_head, causal, mask)
    if _QUANT_MODE != "none":
        return _quant_block(p, x, n_head, causal, mask)
    D = x.shape[-1]
    if _BLOCK_IMPL == "xla" or (mask is not None and not causal) or D > fused_block.MAX_WIDTH:
        return _xla_route(p, x, n_head, causal, mask)
    plain = _PLAIN_ON_CUDA
    if _EXPORTING:
        from mudpt_torch.ops import library

        return library.residual_block(p, x, n_head, causal)
    ln_1, attn, ln_2, mlp_p = p["ln_1"], p["attn"], p["ln_2"], p["mlp"]
    if fused_block.save_acts_enabled() and D <= fused_block.FULLBLOCK_MAX_WIDTH:
        return fused_block.layer_fullblock(
            x, ln_1["scale"], ln_1["bias"], attn["qkv_w"], attn["qkv_b"],
            attn["out_w"], attn["out_b"], ln_2["scale"], ln_2["bias"],
            mlp_p["fc_w"], mlp_p["fc_b"], mlp_p["proj_w"], mlp_p["proj_b"],
            n_head, causal, plain=plain)
    x = fused_block.attn_halfblock(
        x, ln_1["scale"], ln_1["bias"], attn["qkv_w"], attn["qkv_b"],
        attn["out_w"], attn["out_b"], n_head, causal, plain=plain)
    return fused_block.mlp_halfblock(
        x, ln_2["scale"], ln_2["bias"], mlp_p["fc_w"], mlp_p["fc_b"],
        mlp_p["proj_w"], mlp_p["proj_b"], plain=plain)


def residual_block_trainable(p: dict, x: torch.Tensor, n_head: int,
                             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A pre-LN residual block whose weights receive gradients
    (``layers.py:288-300``): plain autograd ops on any device and dtype,
    never the dx-only kernel chains, which raise when a weight requires
    grad.  JAX runs this block on XLA's autodiff, not on Pallas.  Only the
    UMuDPT/UUMuDPT prompt heads' LightTransformer takes it."""
    x = x + attention(p["attn"], layer_norm_trainable(p["ln_1"], x), n_head, mask)
    return x + mlp(p["mlp"], layer_norm_trainable(p["ln_2"], x))
