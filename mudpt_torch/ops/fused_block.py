"""``layer_fullblock``, ``attn_halfblock``, ``mlp_halfblock`` and
``mlp_halfblock_chunked`` as chains of hand-written Hopper kernels.

Counterpart of ``mudpt_tpu/ops/fused_block.py`` :297-456 and :678-959.  The
attention half ``y = x + out(MHA(LN x))`` (``attn_halfblock`` :679:
``_attn_fwd_kernel`` :318, the saving ``_attn_fwd_save_kernel`` :326, the
backwards ``_attn_bwd_save_kernel`` :369 and ``_attn_bwd_kernel`` :358) and
the MLP half ``y = x + proj(QuickGELU(fc(LN x)))`` (``mlp_halfblock`` :753:
``_mlp_fwd_kernel`` :403, ``_mlp_fwd_save_kernel`` :415, the backwards
``_mlp_bwd_save_kernel`` :451 and ``_mlp_bwd_kernel`` :444); the whole layer
is the two halves (``layer_fullblock`` :908: ``_layer_fwd_nosave_kernel``
:851, ``_layer_fwd_kernel`` :831, ``_layer_bwd_kernel`` :868).  The Pallas
programs hold a half's or a layer's weights for one image in VMEM; an SM's
shared memory cannot, so each becomes a chain of tiled kernels (``csrc/``):

  attention  forward   LN -> qkv GEMM -> attention -> out-proj GEMM + residual
             backward  [LN -> qkv GEMM, when qkv was not saved]
                       -> GEMM g.out_w^T -> attention dq/dk/dv
                       -> GEMM dqkv.qkv_w^T -> LN dx + g
  MLP        forward   LN -> fc GEMM + QuickGELU -> proj GEMM + residual
             backward  GEMM g.proj_w^T * QuickGELU'(h), h the saved h;
                       or LN -> fc GEMM storing QuickGELU'(h32) in fp32, then
                       GEMM g.proj_w^T * that (h32 unrounded, when h was not
                       saved) -> GEMM dh.fc_w^T -> LN dx + g

and the MLP half streamed over the hidden dim in chunks of c columns
(``mlp_halfblock_chunked`` :587: ``_mlp_chunk_fwd_kernel`` :477 and
``_mlp_chunk_bwd_kernel`` :500, c from ``_pick_chunk`` :535), y rounded
after every chunk:

  chunked    forward   LN -> per chunk: fc GEMM + QuickGELU (a column chunk
                       of fc_w read in place) -> proj GEMM adding into y
             backward  LN -> per chunk: fc GEMM storing QuickGELU'(h32) ->
                       GEMM g.proj_w^T * that -> GEMM dh.fc_w^T adding into
                       the fp32 dxn -> LN dx + g

with activations and weights in one dtype dt, bf16 or fp32 as the Pallas
functions take either (they cast their operands to x.dtype and round to it),
fp32 LayerNorm parameters and statistics, fp32 accumulation, and rounding to
dt at the same points as the Pallas code (no-ops in fp32).  A saving forward
also writes qkv (attention) or h (MLP) in dt; a backward returns dx only, as
the Pallas VJPs do (the weights are frozen).  Which half saves what is the
JAX package's policy (:69-136), copied here without its environment
variables; like JAX's, it does not look at the dtype.

Every kernel has a wrapper and a plain PyTorch version beside it.  A wrapper
given CPU tensors runs the plain version (the CPU tests); given CUDA tensors
it launches the kernel of their dtype (:func:`kernel_for`: bf16 and fp32
each have their own) or raises -- it never falls back, and never casts.
Each launch adds one to that kernel's count in :data:`LAUNCHES`, so a run
can show which kernels it went through.

Mask spec (``causal``), as in the Pallas wrapper: ``False`` (none), ``True``
(causal), or ``(period, valid)`` (packed rows: attention within each block
of ``period`` tokens, causal inside it, keys at ``col % period >= valid``
masked).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple, Union

import torch

from mudpt_torch.ops import _build

NEG = -1e30  # additive mask value of the Pallas kernels (fused_block._NEG)
HEAD_DIM = 64  # the attention kernels' head dim (every CLIP tower's)
FULLBLOCK_MAX_WIDTH = 768  # widest tower layer_fullblock takes (models/layers.py:257)
MAX_WIDTH = 1024  # widest tower the half-blocks take (models/layers.py:249)
# widest row the LayerNorm kernels and so the chunked MLP half take on the
# card (rows wider than 1024 in multiples of 64, the GEMM's K step)
CHUNKED_MAX_WIDTH = 2048

# epilogue -> (kernel mode, W given as (N, K) and read transposed).  The
# forward epilogues take W in its (in, out) = (K, N) layout; the backward
# ones compute A . W^T with W in the same stored layout, which is (N, K).
EPILOGUES = {
    "qkv": (0, False),
    "residual": (1, False),
    "fc_gelu": (2, False),
    "fc_gelu_save": (3, False),
    "gelu_bwd": (4, True),
    "store_bf16": (5, True),  # to the activation dtype (bf16 or fp32)
    "store_f32": (6, True),
    "fc_gelu_grad": (7, False),
    "mul_f32": (8, True),
    "chunk_residual": (9, False),
    "add_f32": (10, True),
}
_BIASED = ("qkv", "residual", "fc_gelu", "fc_gelu_save", "fc_gelu_grad")
# a second (M, N) operand, in the activation dtype but mul_f32's (fp32)
_EXTRA = ("residual", "gelu_bwd", "mul_f32", "chunk_residual")
_F32_OUT = ("store_f32", "fc_gelu_grad", "add_f32")
_IN_PLACE = ("chunk_residual", "add_f32")  # may write (add_f32: must) into ``out``
# the GEMM kernel's schedules (csrc/gemm_bf16_epilogue.cu): chosen by the
# shape; ping-pong consumers owning 128 x 128 tiles; both consumers
# cooperating on one 128 x 256 tile
_GEMM_SCHEDULES = ("auto", "pingpong", "cooperative")

# the activation dtypes the kernel chains take
ACT_DTYPES = (torch.bfloat16, torch.float32)
# every kernel, by its launch count: (csrc source, C entry point).  The fp32
# LayerNorms (layernorm_q8_f32 too) are instances of the bf16 sources'
# templates, chosen by a flag
KERNELS = {
    "layernorm_fwd": ("layernorm_fwd", "layernorm_fwd"),
    "gemm_bf16_epilogue": ("gemm_bf16_epilogue", "gemm_bf16_epilogue"),
    "attention_fwd": ("attention_fwd", "attention_fwd"),
    "layernorm_bwd": ("layernorm_bwd", "layernorm_bwd"),
    "attention_bwd": ("attention_bwd", "attention_bwd"),
    "layernorm_fwd_f32": ("layernorm_fwd", "layernorm_fwd"),
    "gemm_f32_epilogue": ("gemm_f32_epilogue", "gemm_f32_epilogue"),
    "attention_fwd_f32": ("attention_f32", "attention_fwd_f32"),
    "layernorm_bwd_f32": ("layernorm_bwd", "layernorm_bwd"),
    "attention_bwd_f32": ("attention_f32", "attention_bwd_f32"),
    # the int8 tiers (ops/quant_block.py); quant_rows takes fp32 rows, the
    # attention accumulator and g, on either activation dtype
    "layernorm_q8": ("layernorm_q8", "layernorm_q8"),
    "gemm_s8_epilogue": ("gemm_s8_epilogue", "gemm_s8_epilogue"),
    "quant_rows": ("quant_rows", "quant_rows"),
    "layernorm_q8_f32": ("layernorm_q8", "layernorm_q8"),
    "gemm_s8_epilogue_f32": ("gemm_s8_epilogue", "gemm_s8_epilogue_f32"),
    # the probes of tools/ (ops/probe.py): the tensor-core rate probe, and
    # the q8 layer's quantizer ablations as instances of the int8 sources
    "probe_mma_bf16": ("probe_mma", "probe_mma"),
    "probe_mma_s8": ("probe_mma", "probe_mma"),
    "quant_rows_recip": ("quant_rows", "quant_rows_mode"),
    "quant_rows_noclip": ("quant_rows", "quant_rows_mode"),
    "quant_rows_floor": ("quant_rows", "quant_rows_mode"),
    "layernorm_q8_recip": ("layernorm_q8", "layernorm_q8_mode"),
    "layernorm_q8_noclip": ("layernorm_q8", "layernorm_q8_mode"),
    "layernorm_q8_floor": ("layernorm_q8", "layernorm_q8_mode"),
    "gemm_s8_epilogue_floor": ("gemm_s8_epilogue", "gemm_s8_epilogue"),
}
# the kernel that each dtype-generic wrapper launches, by activation dtype
DTYPE_KERNELS = {
    "layernorm_fwd": {torch.bfloat16: "layernorm_fwd", torch.float32: "layernorm_fwd_f32"},
    "layernorm_bwd": {torch.bfloat16: "layernorm_bwd", torch.float32: "layernorm_bwd_f32"},
    "gemm_epilogue": {torch.bfloat16: "gemm_bf16_epilogue",
                      torch.float32: "gemm_f32_epilogue"},
    "attention_fwd": {torch.bfloat16: "attention_fwd", torch.float32: "attention_fwd_f32"},
    "attention_bwd": {torch.bfloat16: "attention_bwd", torch.float32: "attention_bwd_f32"},
    "layernorm_q8": {torch.bfloat16: "layernorm_q8", torch.float32: "layernorm_q8_f32"},
    "gemm_s8_epilogue": {torch.bfloat16: "gemm_s8_epilogue",
                         torch.float32: "gemm_s8_epilogue_f32"},
}
# the chains' counts: one a call of a half-block, layer or int8 layer
CHAINS = (
    "layer_fullblock", "layer_fullblock_bwd", "attn_halfblock", "attn_halfblock_bwd",
    "mlp_halfblock", "mlp_halfblock_bwd", "mlp_halfblock_chunked", "mlp_halfblock_chunked_bwd",
    "layer_fullblock_q8", "layer_fullblock_q8_static", "layer_fullblock_q8_ste",
    "layer_fullblock_q8_ste_static", "layer_fullblock_q8_ste_bwd",
)
LAUNCHES = dict.fromkeys((*KERNELS, *CHAINS), 0)

Causal = Union[bool, Tuple[int, int]]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_for(op: str, *dtypes: torch.dtype) -> str:
    """The launch count (a key of :data:`KERNELS`) of the kernel that the
    wrapper ``op`` (a key of :data:`DTYPE_KERNELS`) launches for tensors of
    ``dtypes``: their activation dtype, one for all of them (a mix raises),
    bf16 or fp32 (any other raises)."""
    if not dtypes or any(dt != dtypes[0] for dt in dtypes):
        raise TypeError(f"{op}: expected tensors of one activation dtype, got "
                        f"{', '.join(sorted(set(map(str, dtypes))))}")
    key = DTYPE_KERNELS[op].get(dtypes[0])
    if key is None:
        raise TypeError(f"{op}: no kernel for {dtypes[0]} activations; the kernels take "
                        f"{', '.join(map(str, DTYPE_KERNELS[op]))}")
    return key


# ---------------------------------------------------------------------------
# what the training forward saves (fused_block.py:69-136), without the
# environment variables: the same kernels run as in the JAX package
# ---------------------------------------------------------------------------

_SAVE_ACTS = True
_SAVE_MLP_WIDE = "auto"
# row-token budget of the MLP h-save at 768 < D <= 1024 under "auto": 112
# images x 264 padded tokens, the JAX package's budget (:89), set for a
# TPU's memory and kept so that both packages pick the same kernels; the
# H100's memory at ViT-L stands in PERF.md
_WIDE_SAVE_ROW_TOKENS = 112 * 264


def set_save_acts(on: bool) -> None:
    """Save qkv and h in the training forward (True), or recompute them in
    the backward (False)."""
    global _SAVE_ACTS
    _SAVE_ACTS = bool(on)


def save_acts_enabled() -> bool:
    return _SAVE_ACTS


@contextlib.contextmanager
def saved_acts(on: bool):
    """The save policy inside the context (:124-136): the forward values
    are the same; only what the forward keeps for the backward changes."""
    prev = _SAVE_ACTS
    set_save_acts(on)
    try:
        yield
    finally:
        set_save_acts(prev)


def set_save_mlp_wide(mode: str) -> None:
    """The MLP h-save at 768 < D <= 1024: "auto" within the row-token
    budget, "1" always, "0" never (:92-95)."""
    if str(mode) not in ("auto", "1", "0"):
        raise ValueError(f"save_mlp_wide mode {mode!r}: expected 'auto', '1' or '0'")
    global _SAVE_MLP_WIDE
    _SAVE_MLP_WIDE = str(mode)


def wide_mlp_save(row_tokens: Optional[int] = None) -> bool:
    """Whether the MLP h-save applies at 768 < D <= 1024 for a call over
    ``row_tokens`` = rows x sequence (:98-105; None: the budget unknown)."""
    if _SAVE_MLP_WIDE == "auto":
        return row_tokens is None or row_tokens <= _WIDE_SAVE_ROW_TOKENS
    return _SAVE_MLP_WIDE == "1"


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _require(t: torch.Tensor, what: str, dtype: torch.dtype, shape=None,
             strided_rows: bool = False) -> None:
    """The kernels take contiguous, 16-byte-aligned CUDA tensors only; with
    ``strided_rows``, a matrix whose rows lie a multiple of 16 bytes apart
    (a column chunk of a wider weight, which the GEMM reads in place)."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if strided_rows:
        if (t.dim() != 2 or t.stride(1) != 1 or t.stride(0) < t.shape[1]
                or t.stride(0) * t.element_size() % 16):
            raise ValueError(f"{what}: expected contiguous rows a multiple of 16 bytes "
                             f"apart, got strides {t.stride()}")
    elif not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: data pointer is not 16-byte aligned")


def quick_gelu_grad(h):
    """d/dh of h*sigmoid(1.702h) (``fused_block._quick_gelu_grad`` :387)."""
    s = torch.sigmoid(1.702 * h)
    return s + 1.702 * h * s * (1.0 - s)


# ---------------------------------------------------------------------------
# LayerNorm forward (csrc/layernorm_fwd.cu) and dx (csrc/layernorm_bwd.cu)
# ---------------------------------------------------------------------------

def _ln_stats(x32, eps):
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    return (x32 - mean) * inv, inv


def layer_norm_plain(x, scale, bias, eps: float = 1e-5):
    """fp32 statistics and affine, cast back to x's dtype
    (``fused_block._ln_fp32`` :150 with the casts at :303, :394)."""
    xhat, _ = _ln_stats(x.float(), eps)
    return (xhat * scale.float() + bias.float()).to(x.dtype)


def _check_ln_width(D: int, what: str) -> None:
    if D % 8 or D > CHUNKED_MAX_WIDTH or (D > 1024 and D % 64):
        raise ValueError(f"{what}: D={D} must be a multiple of 8 and <= 1024, or of 64 "
                         f"and <= {CHUNKED_MAX_WIDTH}")


def layer_norm_fwd(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the last dim of x (bf16 or fp32), any leading shape."""
    if not x.is_cuda:
        return layer_norm_plain(x, scale, bias, eps)
    D = x.shape[-1]
    _check_ln_width(D, "layernorm_fwd")
    key = kernel_for("layernorm_fwd", x.dtype)
    _require(x, "layernorm_fwd x", x.dtype)
    _require(scale, "layernorm_fwd scale", torch.float32, (D,))
    _require(bias, "layernorm_fwd bias", torch.float32, (D,))
    y = torch.empty_like(x)
    lib = _build.load()["layernorm_fwd"]
    _build.check(lib.layernorm_fwd(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                   y.data_ptr(), x.numel() // D, D, eps,
                                   int(x.dtype == torch.float32), _stream()), key)
    LAUNCHES[key] += 1
    return y


def layer_norm_bwd_plain(dxn, x, scale, residual=None, eps: float = 1e-5):
    """dx of LayerNorm from the gradient ``dxn`` on its normalized output,
    statistics recomputed from x in fp32 (``fused_block._ln_bwd_dx`` :160
    with ``_ln_fp32``), plus an optional residual gradient, rounded once to
    x's dtype: ``dt(f32(r) + ln_bwd_dx)`` (:353-355, :439-441)."""
    xhat, inv = _ln_stats(x.float(), eps)
    g = dxn.float() * scale.float()
    gm = g.mean(-1, keepdim=True)
    gx = (g * xhat).mean(-1, keepdim=True)
    dx = (g - gm - xhat * gx) * inv
    if residual is not None:
        dx = residual.float() + dx
    return dx.to(x.dtype)


def layer_norm_bwd(dxn, x, scale, residual=None, eps: float = 1e-5):
    """LayerNorm dx over the last dim, any leading shape: x and the optional
    residual in one activation dtype; ``dxn`` fp32 or, beside bf16 rows,
    bf16."""
    if not x.is_cuda:
        return layer_norm_bwd_plain(dxn, x, scale, residual, eps)
    D = x.shape[-1]
    _check_ln_width(D, "layernorm_bwd")
    key = kernel_for("layernorm_bwd", x.dtype,
                     *(() if residual is None else (residual.dtype,)))
    _require(x, "layernorm_bwd x", x.dtype)
    dxn_dtypes = (torch.float32,) if x.dtype == torch.float32 else (torch.float32, torch.bfloat16)
    if dxn.dtype not in dxn_dtypes:
        raise TypeError(f"layernorm_bwd dxn: expected one of {dxn_dtypes} beside {x.dtype} "
                        f"rows, got {dxn.dtype}")
    _require(dxn, "layernorm_bwd dxn", dxn.dtype, x.shape)
    _require(scale, "layernorm_bwd scale", torch.float32, (D,))
    if residual is not None:
        _require(residual, "layernorm_bwd residual", x.dtype, x.shape)
    dx = torch.empty_like(x)
    lib = _build.load()["layernorm_bwd"]
    r_ptr = residual.data_ptr() if residual is not None else None
    _build.check(lib.layernorm_bwd(dxn.data_ptr(), int(dxn.dtype == torch.bfloat16),
                                   x.data_ptr(), scale.data_ptr(), r_ptr, dx.data_ptr(),
                                   x.numel() // D, D, eps, int(x.dtype == torch.float32),
                                   _stream()), key)
    LAUNCHES[key] += 1
    return dx


# ---------------------------------------------------------------------------
# GEMM with the layer's epilogues (csrc/gemm_bf16_epilogue.cu, and
# csrc/gemm_f32_epilogue.cu on fp32 activations)
# ---------------------------------------------------------------------------

def _epilogue(epilogue: str):
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; known: {sorted(EPILOGUES)}")
    return EPILOGUES[epilogue]


def gemm_epilogue_plain(a, w, bias, epilogue: str, extra=None, out=None):
    """``epilogue(a @ W)`` with fp32 accumulation and the Pallas rounding
    points (dt = a's dtype; W is w, or w^T for the backward epilogues):

      qkv           dt(acc) + dt(b)                        (:304-307)
      residual      r + (dt(acc) + dt(b)), r = extra       (:310-315, :861-865)
      fc_gelu       dt(quickgelu(acc + f32(b)))            (:392-400, :860)
      fc_gelu_save  (dt(h32), dt(quickgelu(h32))), h32 = acc + f32(b)  (:841-843)
      gelu_bwd      dt(acc * quickgelu'(f32(h))), h = extra (:430-434)
      store_bf16    dt(acc)                                (:340-343, :274-275)
      store_f32     acc                                    (:435-438, :349-352)
      fc_gelu_grad  quickgelu'(h32), h32 = acc + f32(b), fp32  (:447, :434)
      mul_f32       dt(acc * f), f = extra (fp32)          (:430-434)
      chunk_residual  dt(r' + dt(acc)), r' = dt(r + dt(b)) with a bias b,
                    else r; r = extra                      (:486, :493-497)
      add_f32       out + acc, fp32, into out              (:522-525)

    ``fc_gelu_grad`` and ``mul_f32`` are the recompute backward's
    ``dt(da * quickgelu'(h32))`` with h32 never rounded (``_mlp_bwd_kernel``
    :444): the fc product stores the factor, the g.proj_w^T product applies
    it.  The last two carry the chunked MLP half across its chunks
    (``_mlp_chunk_fwd_kernel`` :477, ``_mlp_chunk_bwd_kernel`` :500): y
    starts as dt(x + dt(proj_b)) and takes each chunk's rounded product,
    rounded again; dxn sums the chunks' products in fp32.  Both write into
    ``out`` where it is given (``chunk_residual``'s may be ``extra``).
    """
    _, w_nk = _epilogue(epilogue)
    dt = a.dtype
    acc = torch.matmul(a.float(), w.float().t() if w_nk else w.float())
    if epilogue in ("fc_gelu", "fc_gelu_save"):
        h = acc + bias.float()
        act = (h * torch.sigmoid(1.702 * h)).to(dt)
        return (h.to(dt), act) if epilogue == "fc_gelu_save" else act
    if epilogue == "fc_gelu_grad":
        return quick_gelu_grad(acc + bias.float())
    if epilogue == "gelu_bwd":
        return (acc * quick_gelu_grad(extra.float())).to(dt)
    if epilogue == "mul_f32":
        return (acc * extra.float()).to(dt)
    if epilogue == "store_bf16":
        return acc.to(dt)
    if epilogue == "store_f32":
        return acc
    if epilogue == "add_f32":
        return out.add_(acc)
    if epilogue == "chunk_residual":
        r = extra if bias is None else extra + bias.to(dt)
        y = r + acc.to(dt)
        return y if out is None else out.copy_(y)
    res = acc.to(dt) + bias.to(dt)
    return res if epilogue == "qkv" else extra + res


def gemm_epilogue(a, w, bias, epilogue: str, extra=None, out=None):
    """(..., K) times W, then the epilogue: W is (K, N) for the forward
    epilogues and (N, K), read transposed, for the backward ones; its rows
    may lie further apart than its width (a column chunk of a wider weight,
    read in place).  ``extra`` is the residual r (``residual``,
    ``chunk_residual``), the saved pre-activation h (``gelu_bwd``) or the
    fp32 factor (``mul_f32``).  ``fc_gelu_save`` returns (h, a).  ``out``
    receives ``chunk_residual``'s result (it may be ``extra``: y in place)
    and is the fp32 accumulator that ``add_f32`` adds to.  On the card the
    kernel chooses its schedule by the shape: ping-pong where the epilogue
    weighs against the products, else cooperative."""
    return _gemm_epilogue(a, w, bias, epilogue, extra, out, "auto")


def _gemm_epilogue(a, w, bias, epilogue, extra, out, schedule):
    """:func:`gemm_epilogue` with the kernel's schedule forced on the card
    (one of ``_GEMM_SCHEDULES``; the fp32 kernel has one, "auto"), for the
    card's checks that every schedule gives the same bits, and for timing
    each."""
    if not a.is_cuda:
        return gemm_epilogue_plain(a, w, bias, epilogue, extra, out)
    mode, w_nk = _epilogue(epilogue)
    # one activation dtype for a, W, the bias and the second operand but
    # mul_f32's fp32 factor
    key = kernel_for("gemm_epilogue", a.dtype, w.dtype,
                     *(() if bias is None else (bias.dtype,)),
                     *(() if extra is None or epilogue == "mul_f32" else (extra.dtype,)))
    act = a.dtype
    K = a.shape[-1]
    M = a.numel() // K
    N = w.shape[0] if w_nk else w.shape[1]
    if K % 64 or N % 8:
        raise ValueError(f"{key}: K={K} must be a multiple of 64, N={N} of 8")
    if schedule not in (_GEMM_SCHEDULES if act == torch.bfloat16 else ("auto",)):
        raise ValueError(f"{key}: schedule {schedule!r} not one of the kernel's")
    out_shape = (*a.shape[:-1], N)
    _require(a, "gemm a", act)
    _require(w, "gemm w", act, (N, K) if w_nk else (K, N), strided_rows=True)
    if epilogue in _BIASED or (epilogue == "chunk_residual" and bias is not None):
        _require(bias, "gemm bias", act, (N,))
    elif bias is not None:
        raise ValueError(f"epilogue {epilogue!r} takes no bias")
    if epilogue in _EXTRA:
        _require(extra, f"gemm {epilogue} operand",
                 torch.float32 if epilogue == "mul_f32" else act, out_shape)
    elif extra is not None:
        raise ValueError(f"epilogue {epilogue!r} takes no second operand")
    dt = torch.float32 if epilogue in _F32_OUT else act
    r = extra
    if out is not None:
        if epilogue not in _IN_PLACE:
            raise ValueError(f"epilogue {epilogue!r} takes no out")
        _require(out, f"gemm {epilogue} out", dt, out_shape)
        base = out.untyped_storage().data_ptr()
        if a.untyped_storage().data_ptr() == base or (
                extra is not None and extra is not out
                and extra.untyped_storage().data_ptr() == base):
            raise ValueError(f"gemm {epilogue}: out must not share memory with a, nor "
                             "with extra unless it is extra")
        if extra is out:
            r = None  # y in place: the kernel reads the residual through C
        c = out
    elif epilogue == "add_f32":
        raise ValueError("epilogue 'add_f32' adds into out, the fp32 accumulator")
    else:
        c = torch.empty(out_shape, dtype=dt, device=a.device)
    c2 = torch.empty_like(c) if epilogue == "fc_gelu_save" else None
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    args = (a.data_ptr(), w.data_ptr(), ptr(bias), ptr(r), c.data_ptr(), ptr(c2),
            M, N, K, w.stride(0), mode)
    if act == torch.bfloat16:
        err = _build.load()["gemm_bf16_epilogue"].gemm_bf16_epilogue(
            *args, _GEMM_SCHEDULES.index(schedule), _stream())
    else:
        err = _build.load()["gemm_f32_epilogue"].gemm_f32_epilogue(*args, _stream())
    _build.check(err, key)
    LAUNCHES[key] += 1
    return (c, c2) if c2 is not None else c


# ---------------------------------------------------------------------------
# attention forward (csrc/attention_fwd.cu) and backward (csrc/attention_bwd.cu),
# on fp32 activations both in csrc/attention_f32.cu
# ---------------------------------------------------------------------------

def _block_spec(S: int, causal: Causal):
    """(block length, causal inside the block, valid keys per block):
    ``fused_block._attn_block_spec`` :208 / ``_causal_mask`` :168."""
    if isinstance(causal, tuple):
        period, valid = causal
        if S % period:
            raise ValueError(f"packed period {period} does not divide S={S}")
        return period, True, valid
    return S, bool(causal), S


def _split_heads(qkv, n_head: int, causal: Causal):
    """q, k, v as (n, H, L, hd) per sequence block, and the block spec."""
    B, S, D3 = qkv.shape
    hd = D3 // 3 // n_head
    L, is_causal, valid = _block_spec(S, causal)
    q, k, v = qkv.reshape(B * (S // L), L, 3, n_head, hd).permute(2, 0, 3, 1, 4)
    return q, k, v, L, is_causal, valid


def _probs_plain(q, k, L: int, is_causal: bool, valid: int):
    """fp32 softmax(q k^T * hd^-0.5 + mask) (``_head_probs`` :197)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    row = torch.arange(L, device=q.device)[:, None]
    col = torch.arange(L, device=q.device)[None, :]
    masked = col >= valid
    if is_causal:
        masked = masked | (col > row)
    if is_causal or valid < L:
        scores = scores + torch.where(masked, NEG, 0.0)
    return torch.softmax(scores, dim=-1)


def attention_plain(qkv, n_head: int, causal: Causal = False, out_f32: bool = False):
    """Multi-head attention from a packed (B, S, 3D) qkv -> (B, S, D):
    scores fp32(q k^T) * hd^-0.5 + mask (-1e30), fp32 softmax, probabilities
    cast to qkv's dtype before P.V, fp32 accumulation, output in qkv's dtype
    (``_mha_acc`` :222, ``_head_probs`` :197) or, with ``out_f32``, in fp32
    unrounded (the int8 layers' fp32 accumulator, ``quant_block.py:146``)."""
    B, S, D3 = qkv.shape
    q, k, v, L, is_causal, valid = _split_heads(qkv, n_head, causal)
    p = _probs_plain(q, k, L, is_causal, valid).to(qkv.dtype)
    o = torch.matmul(p.float(), v.float())  # (n, H, L, hd)
    if not out_f32:
        o = o.to(qkv.dtype)
    return o.permute(0, 2, 1, 3).reshape(B, S, D3 // 3)


def attention_fwd(qkv, n_head: int, causal: Causal = False, out_f32: bool = False):
    """Attention per (sequence block, head) on the card, any block length;
    the output in qkv's dtype (bf16 or fp32), or fp32 with ``out_f32``."""
    if not qkv.is_cuda:
        return attention_plain(qkv, n_head, causal, out_f32)
    B, S, D3 = qkv.shape
    D = D3 // 3
    if D != n_head * HEAD_DIM:
        raise ValueError(f"attention_fwd: head dim must be {HEAD_DIM} (D={D}, heads={n_head})")
    L, is_causal, valid = _block_spec(S, causal)
    key = kernel_for("attention_fwd", qkv.dtype)
    _require(qkv, "attention qkv", qkv.dtype)
    f32 = qkv.dtype == torch.float32
    out = torch.empty((B, S, D), dtype=torch.float32 if out_f32 or f32 else torch.bfloat16,
                      device=qkv.device)
    args = (qkv.data_ptr(), out.data_ptr(), B * (S // L), L, D, n_head, int(is_causal), valid,
            HEAD_DIM ** -0.5)
    if f32:
        err = _build.load()["attention_f32"].attention_fwd_f32(*args, _stream())
    else:
        err = _build.load()["attention_fwd"].attention_fwd(*args, int(out_f32), _stream())
    _build.check(err, key)
    LAUNCHES[key] += 1
    return out


def attention_bwd_plain(qkv, do, n_head: int, causal: Causal = False):
    """dq, dk, dv of every (sequence block, head) packed as (B, S, 3D) in
    qkv's dtype (``_mha_grads_into`` :242, ``_head_grads`` :267): the fp32
    softmax p recomputed from the saved q and k; dp = do.v^T and
    dv = dt(p)^T.do in fp32; ds = p * (dp - rowsum(dp * p)) * hd^-0.5 in
    fp32; dq = dt(ds).k and dk = dt(ds)^T.q in fp32; each stored in dt."""
    B, S, D3 = qkv.shape
    dt = qkv.dtype
    q, k, v, L, is_causal, valid = _split_heads(qkv, n_head, causal)
    hd = q.shape[-1]
    dO = do.reshape(q.shape[0], L, n_head, hd).permute(0, 2, 1, 3).float()
    p = _probs_plain(q, k, L, is_causal, valid)
    dp = torch.matmul(dO, v.float().transpose(-1, -2))
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), dO)
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True)) * hd ** -0.5).to(dt).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    # (3, n, H, L, hd) -> (n, L, 3, H, hd): the layout of the packed qkv
    return torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(B, S, D3).to(dt)


def attention_bwd(qkv, do, n_head: int, causal: Causal = False):
    """dqkv per (sequence block, head) on the card, any block length, from
    the saved qkv and the gradient ``do`` of the attention output, both of
    one activation dtype (bf16 or fp32)."""
    if not qkv.is_cuda:
        return attention_bwd_plain(qkv, do, n_head, causal)
    B, S, D3 = qkv.shape
    D = D3 // 3
    if D != n_head * HEAD_DIM:
        raise ValueError(f"attention_bwd: head dim must be {HEAD_DIM} (D={D}, heads={n_head})")
    L, is_causal, valid = _block_spec(S, causal)
    key = kernel_for("attention_bwd", qkv.dtype, do.dtype)
    _require(qkv, "attention_bwd qkv", qkv.dtype)
    _require(do, "attention_bwd do", qkv.dtype, (B, S, D))
    dqkv = torch.empty_like(qkv)
    # each row's statistics (max, 1 / sum, rowsum(dp * p), 0): written by
    # the kernel's query-major pass, read by its key-major pass
    stats = torch.empty((B * n_head * S, 4), dtype=torch.float32, device=qkv.device)
    args = (qkv.data_ptr(), do.data_ptr(), dqkv.data_ptr(), stats.data_ptr(), B * (S // L), L,
            D, n_head, int(is_causal), valid, HEAD_DIM ** -0.5, _stream())
    if qkv.dtype == torch.float32:
        err = _build.load()["attention_f32"].attention_bwd_f32(*args)
    else:
        err = _build.load()["attention_bwd"].attention_bwd(*args)
    _build.check(err, key)
    LAUNCHES[key] += 1
    return dqkv


# ---------------------------------------------------------------------------
# the half-blocks and the layer
# ---------------------------------------------------------------------------

_PLAIN = (layer_norm_plain, gemm_epilogue_plain, attention_plain,
          layer_norm_bwd_plain, attention_bwd_plain)
_KERNELS = (layer_norm_fwd, gemm_epilogue, attention_fwd, layer_norm_bwd, attention_bwd)


def _attn_chain(fns, x, ln_s, ln_b, qkv_w, qkv_b, out_w, out_b, n_head, causal):
    """(y, qkv) of the attention half (``_attn_fwd_save_kernel`` :326;
    ``_attn_fwd_kernel`` :318 drops qkv)."""
    ln, gemm, attn = fns[:3]
    qkv = gemm(ln(x, ln_s, ln_b), qkv_w, qkv_b, "qkv")
    return gemm(attn(qkv, n_head, causal), out_w, out_b, "residual", x), qkv


def _attn_bwd_chain(fns, x, qkv, g, ln_s, ln_b, qkv_w, qkv_b, out_w, n_head, causal):
    """dx of the attention half (``_attn_bwd_core`` :336) from the saved qkv
    (``_attn_bwd_save_kernel`` :369) or, with qkv None, from qkv recomputed
    (``_attn_bwd_kernel`` :358)."""
    ln, gemm, ln_bwd, attn_bwd = fns[0], fns[1], fns[3], fns[4]
    if qkv is None:
        qkv = gemm(ln(x, ln_s, ln_b), qkv_w, qkv_b, "qkv")
    dqkv = attn_bwd(qkv, gemm(g, out_w, None, "store_bf16"), n_head, causal)
    return ln_bwd(gemm(dqkv, qkv_w, None, "store_f32"), x, ln_s, g)


def _mlp_chain(fns, x, ln_s, ln_b, fc_w, fc_b, proj_w, proj_b, save):
    """(y, h) of the MLP half, h the pre-activation in dt when ``save``
    (``_mlp_fwd_save_kernel`` :415), else None (``_mlp_fwd_kernel`` :403)."""
    ln, gemm = fns[:2]
    xn = ln(x, ln_s, ln_b)
    if not save:
        return gemm(gemm(xn, fc_w, fc_b, "fc_gelu"), proj_w, proj_b, "residual", x), None
    h, act = gemm(xn, fc_w, fc_b, "fc_gelu_save")
    return gemm(act, proj_w, proj_b, "residual", x), h


def _mlp_bwd_chain(fns, x, h, g, ln_s, ln_b, fc_w, fc_b, proj_w):
    """dx of the MLP half (``_mlp_bwd_core`` :429): QuickGELU' of the saved
    h in dt (``_mlp_bwd_save_kernel`` :451) or, with h None, of the fp32 h32
    recomputed and never rounded (``_mlp_bwd_kernel`` :444)."""
    ln, gemm, ln_bwd = fns[0], fns[1], fns[3]
    if h is None:
        f = gemm(ln(x, ln_s, ln_b), fc_w, fc_b, "fc_gelu_grad")
        dh = gemm(g, proj_w, None, "mul_f32", f)
        del f  # fp32 and 4D wide: free it before the next product allocates
    else:
        dh = gemm(g, proj_w, None, "gelu_bwd", h)
    return ln_bwd(gemm(dh, fc_w, None, "store_f32"), x, ln_s, g)


def _check_width(x, what: str, max_width: int) -> None:
    if x.shape[-1] > max_width:
        raise ValueError(f"{what} takes D <= {max_width}, got {x.shape[-1]}")
    if x.dtype not in ACT_DTYPES:
        raise TypeError(f"{what} x: no kernels for {x.dtype} activations; they take "
                        f"{', '.join(map(str, ACT_DTYPES))}")
    _require(x, f"{what} x", x.dtype)


def _mlp_saves(x) -> bool:
    """Whether the MLP half's training forward saves h (``_mlp_fwd`` :771)."""
    B, S, D = x.shape
    return _SAVE_ACTS and D <= (MAX_WIDTH if wide_mlp_save(B * S) else FULLBLOCK_MAX_WIDTH)


def attn_halfblock_plain(x, ln_s, ln_b, qkv_w, qkv_b, out_w, out_b,
                         n_head: int, causal: Causal = False):
    """The attention half from the kernels' plain versions, on any device."""
    return _attn_chain(_PLAIN, x, ln_s, ln_b, qkv_w, qkv_b, out_w, out_b, n_head, causal)[0]


def attn_halfblock_fwd_save_plain(x, ln_s, ln_b, qkv_w, qkv_b, out_w, out_b,
                                  n_head: int, causal: Causal = False):
    """(y, qkv) from the plain versions (``_attn_fwd`` :705)."""
    return _attn_chain(_PLAIN, x, ln_s, ln_b, qkv_w, qkv_b, out_w, out_b, n_head, causal)


def attn_halfblock_bwd_plain(x, qkv, g, ln_s, ln_b, qkv_w, qkv_b, out_w,
                             n_head: int, causal: Causal = False):
    """dx from the plain versions (``_attn_bwd`` :725); qkv None recomputes."""
    return _attn_bwd_chain(_PLAIN, x, qkv, g, ln_s, ln_b, qkv_w, qkv_b, out_w, n_head, causal)


def mlp_halfblock_plain(x, ln_s, ln_b, fc_w, fc_b, proj_w, proj_b):
    """The MLP half from the kernels' plain versions, on any device."""
    return _mlp_chain(_PLAIN, x, ln_s, ln_b, fc_w, fc_b, proj_w, proj_b, False)[0]


def mlp_halfblock_fwd_save_plain(x, ln_s, ln_b, fc_w, fc_b, proj_w, proj_b):
    """(y, h) from the plain versions (``_mlp_fwd`` :772)."""
    return _mlp_chain(_PLAIN, x, ln_s, ln_b, fc_w, fc_b, proj_w, proj_b, True)


def mlp_halfblock_bwd_plain(x, h, g, ln_s, ln_b, fc_w, fc_b, proj_w):
    """dx from the plain versions (``_mlp_bwd`` :789); h None recomputes."""
    return _mlp_bwd_chain(_PLAIN, x, h, g, ln_s, ln_b, fc_w, fc_b, proj_w)


class AttnHalfblockFn(torch.autograd.Function):
    """``attn_halfblock.defvjp(_attn_fwd, _attn_bwd)`` (:696-749): the
    forward saves its input x and, when ``save``, qkv; the backward
    recomputes qkv where it was not saved and returns dx and no weight
    gradient.  ``plain`` runs the plain versions of both chains (the
    reference on the card); otherwise the kernel wrappers, which on CPU
    tensors run the same plain versions."""

    @staticmethod
    def forward(ctx, x, ln_s, ln_b, qkv_w, qkv_b, out_w, out_b, n_head, causal, save, plain):
        if any(ctx.needs_input_grad[1:7]):
            raise ValueError("attn_halfblock returns dx only: its weights must not "
                             "require grad (the frozen-backbone regime)")
        y, qkv = _attn_chain(_PLAIN if plain else _KERNELS, x, ln_s, ln_b, qkv_w, qkv_b,
                             out_w, out_b, n_head, causal)
        ctx.save_for_backward(x, ln_s, ln_b, qkv_w, qkv_b, out_w, qkv if save else None)
        ctx.n_head, ctx.causal, ctx.plain = n_head, causal, plain
        if x.is_cuda and not plain:
            LAUNCHES["attn_halfblock"] += 1
        return y

    @staticmethod
    def backward(ctx, g):
        x, ln_s, ln_b, qkv_w, qkv_b, out_w, qkv = ctx.saved_tensors
        dx = _attn_bwd_chain(_PLAIN if ctx.plain else _KERNELS, x, qkv, g.contiguous(),
                             ln_s, ln_b, qkv_w, qkv_b, out_w, ctx.n_head, ctx.causal)
        if x.is_cuda and not ctx.plain:
            LAUNCHES["attn_halfblock_bwd"] += 1
        return (dx,) + (None,) * 10


class MlpHalfblockFn(torch.autograd.Function):
    """``mlp_halfblock.defvjp(_mlp_fwd, _mlp_bwd)`` (:765-806): the forward
    saves its input x and, when ``save``, h in dt; the backward takes
    QuickGELU' of that h, or of the fp32 h32 it recomputes, and returns dx
    and no weight gradient.  ``plain`` as in :class:`AttnHalfblockFn`."""

    @staticmethod
    def forward(ctx, x, ln_s, ln_b, fc_w, fc_b, proj_w, proj_b, save, plain):
        if any(ctx.needs_input_grad[1:7]):
            raise ValueError("mlp_halfblock returns dx only: its weights must not "
                             "require grad (the frozen-backbone regime)")
        y, h = _mlp_chain(_PLAIN if plain else _KERNELS, x, ln_s, ln_b, fc_w, fc_b,
                          proj_w, proj_b, save)
        ctx.save_for_backward(x, ln_s, ln_b, fc_w, fc_b, proj_w, h)
        ctx.plain = plain
        if x.is_cuda and not plain:
            LAUNCHES["mlp_halfblock"] += 1
        return y

    @staticmethod
    def backward(ctx, g):
        x, ln_s, ln_b, fc_w, fc_b, proj_w, h = ctx.saved_tensors
        dx = _mlp_bwd_chain(_PLAIN if ctx.plain else _KERNELS, x, h, g.contiguous(),
                            ln_s, ln_b, fc_w, fc_b, proj_w)
        if x.is_cuda and not ctx.plain:
            LAUNCHES["mlp_halfblock_bwd"] += 1
        return (dx,) + (None,) * 8


def attn_halfblock(x, ln_s, ln_b, qkv_w, qkv_b, out_w, out_b,
                   n_head: int, causal: Causal = False, plain: bool = False):
    """y = x + out(MHA(LN x)), x (B, S, D) -> (B, S, D); the Pallas
    wrapper's signature and mask spec (``attn_halfblock`` :679).  When x
    needs a gradient it runs :class:`AttnHalfblockFn`, saving qkv under the
    save policy (:704); otherwise the no-save forward.  ``plain`` runs the
    plain versions on any device."""
    args = (x, ln_s, ln_b, qkv_w, qkv_b, out_w, out_b)
    if x.is_cuda and not plain:
        _check_width(x, "attn_halfblock", MAX_WIDTH)
    if torch.is_grad_enabled() and x.requires_grad:
        save = _SAVE_ACTS and x.shape[-1] <= MAX_WIDTH
        return AttnHalfblockFn.apply(*args, n_head, causal, save, plain)
    y = _attn_chain(_PLAIN if plain else _KERNELS, *args, n_head, causal)[0]
    if x.is_cuda and not plain:
        LAUNCHES["attn_halfblock"] += 1
    return y


def mlp_halfblock(x, ln_s, ln_b, fc_w, fc_b, proj_w, proj_b, plain: bool = False):
    """y = x + proj(QuickGELU(fc(LN x))), x (B, S, D) -> (B, S, D)
    (``mlp_halfblock`` :753).  When x needs a gradient it runs
    :class:`MlpHalfblockFn`, saving h under the save policy and the wide-MLP
    budget (:771); otherwise the no-save forward."""
    args = (x, ln_s, ln_b, fc_w, fc_b, proj_w, proj_b)
    if x.is_cuda and not plain:
        _check_width(x, "mlp_halfblock", MAX_WIDTH)
    if torch.is_grad_enabled() and x.requires_grad:
        return MlpHalfblockFn.apply(*args, _mlp_saves(x), plain)
    y = _mlp_chain(_PLAIN if plain else _KERNELS, *args, False)[0]
    if x.is_cuda and not plain:
        LAUNCHES["mlp_halfblock"] += 1
    return y


# ---------------------------------------------------------------------------
# the MLP half streamed over hidden-dim chunks (fused_block.py:459-616)
# ---------------------------------------------------------------------------

def _pick_chunk(dh: int, d: int) -> int:
    """The chunk width of ``mlp_halfblock_chunked`` (``_pick_chunk`` :535),
    chosen for a TPU's VMEM; kept because y is rounded after every chunk,
    so the width is part of the numerics: 1536 at ViT-B/16 (K = 2), 512 at
    ViT-L/14 and any D > 768 with Dh % 512 == 0."""
    max_chunk = 2048 if d <= 768 else 512
    for c in (2048, 1536, 1024, 512):
        if c <= max_chunk and dh % c == 0:
            return c
    return dh


def _chunks(D: int, Dh: int):
    c = _pick_chunk(Dh, D)
    return [slice(k * c, (k + 1) * c) for k in range(Dh // c)]


def _mlp_chunked_chain(fns, x, ln_s, ln_b, fc_w, fc_b, proj_w, proj_b):
    """y of the chunked MLP half (``_mlp_chunk_fwd_kernel`` :477): xn once,
    then per chunk a = dt(quickgelu(xn.fc_w[:, k] + fc_b[k])) and
    y = dt(y + dt(a.proj_w[k])), y starting as dt(x + dt(proj_b)).  One
    (M, c) activation at a time; the fc weight's column chunk is read in
    place."""
    ln, gemm = fns[:2]
    xn = ln(x, ln_s, ln_b)
    y = None
    for k, cols in enumerate(_chunks(x.shape[-1], fc_w.shape[1])):
        a = gemm(xn, fc_w[:, cols], fc_b[cols], "fc_gelu")
        if k == 0:
            y = gemm(a, proj_w[cols], proj_b, "chunk_residual", x)
        else:
            gemm(a, proj_w[cols], None, "chunk_residual", y, out=y)
        del a  # free it before the next chunk's allocates
    return y


def _mlp_chunked_bwd_chain(fns, x, g, ln_s, ln_b, fc_w, fc_b, proj_w):
    """dx of the chunked MLP half (``_mlp_chunk_bwd_kernel`` :500): xn
    once; per chunk h32 recomputed and never rounded, dh =
    dt(g.proj_w[k]^T * quickgelu'(h32)), dxn += dh.fc_w[:, k]^T in fp32;
    then dx = dt(f32(g) + LN_dx(dxn)).  One (M, c) fp32 factor, one (M, c)
    dh in dt and the (M, D) fp32 dxn at a time."""
    ln, gemm, ln_bwd = fns[0], fns[1], fns[3]
    xn = ln(x, ln_s, ln_b)
    dxn = None
    for k, cols in enumerate(_chunks(x.shape[-1], fc_w.shape[1])):
        f = gemm(xn, fc_w[:, cols], fc_b[cols], "fc_gelu_grad")
        dh = gemm(g, proj_w[cols], None, "mul_f32", f)
        del f
        if k == 0:
            dxn = gemm(dh, fc_w[:, cols], None, "store_f32")
        else:
            gemm(dh, fc_w[:, cols], None, "add_f32", out=dxn)
        del dh
    return ln_bwd(dxn, x, ln_s, g)


def mlp_halfblock_chunked_plain(x, ln_s, ln_b, fc_w, fc_b, proj_w, proj_b):
    """The chunked MLP half from the kernels' plain versions, on any device."""
    return _mlp_chunked_chain(_PLAIN, x, ln_s, ln_b, fc_w, fc_b, proj_w, proj_b)


def mlp_halfblock_chunked_bwd_plain(x, g, ln_s, ln_b, fc_w, fc_b, proj_w):
    """dx of the chunked MLP half from the plain versions (``_mlp_chunk_bwd``
    :604)."""
    return _mlp_chunked_bwd_chain(_PLAIN, x, g, ln_s, ln_b, fc_w, fc_b, proj_w)


class MlpHalfblockChunkedFn(torch.autograd.Function):
    """``mlp_halfblock_chunked.defvjp(_mlp_chunk_fwd, _mlp_chunk_bwd)``
    (:586-616): the forward saves its input x and the weights, nothing
    else; the backward recomputes h32 chunk by chunk and returns dx and no
    weight gradient.  ``plain`` as in :class:`AttnHalfblockFn`."""

    @staticmethod
    def forward(ctx, x, ln_s, ln_b, fc_w, fc_b, proj_w, proj_b, plain):
        if any(ctx.needs_input_grad[1:7]):
            raise ValueError("mlp_halfblock_chunked returns dx only: its weights must not "
                             "require grad (the frozen-backbone regime)")
        y = _mlp_chunked_chain(_PLAIN if plain else _KERNELS, x, ln_s, ln_b, fc_w, fc_b,
                               proj_w, proj_b)
        ctx.save_for_backward(x, ln_s, ln_b, fc_w, fc_b, proj_w)
        ctx.plain = plain
        if x.is_cuda and not plain:
            LAUNCHES["mlp_halfblock_chunked"] += 1
        return y

    @staticmethod
    def backward(ctx, g):
        x, ln_s, ln_b, fc_w, fc_b, proj_w = ctx.saved_tensors
        dx = _mlp_chunked_bwd_chain(_PLAIN if ctx.plain else _KERNELS, x, g.contiguous(),
                                    ln_s, ln_b, fc_w, fc_b, proj_w)
        if x.is_cuda and not ctx.plain:
            LAUNCHES["mlp_halfblock_chunked_bwd"] += 1
        return (dx,) + (None,) * 7


def mlp_halfblock_chunked(x, ln_s, ln_b, fc_w, fc_b, proj_w, proj_b, plain: bool = False):
    """y = x + proj(QuickGELU(fc(LN x))), x (B, S, D) -> (B, S, D), with the
    hidden dim streamed in chunks and y rounded after each
    (``mlp_halfblock_chunked`` :587).  The JAX package routes no layer
    here; it is its own entry point, for towers up to D = 2048 on the card.
    When x needs a gradient it runs :class:`MlpHalfblockChunkedFn`;
    ``plain`` runs the plain versions on any device."""
    args = (x, ln_s, ln_b, fc_w, fc_b, proj_w, proj_b)
    if x.is_cuda and not plain:
        _check_width(x, "mlp_halfblock_chunked", CHUNKED_MAX_WIDTH)
    if torch.is_grad_enabled() and x.requires_grad:
        return MlpHalfblockChunkedFn.apply(*args, plain)
    y = _mlp_chunked_chain(_PLAIN if plain else _KERNELS, *args)
    if x.is_cuda and not plain:
        LAUNCHES["mlp_halfblock_chunked"] += 1
    return y


def _layer_chain(fns, x, ln1_s, ln1_b, qkv_w, qkv_b, out_w, out_b,
                 ln2_s, ln2_b, fc_w, fc_b, proj_w, proj_b, n_head, causal, save):
    """The forward on 3-D tensors, the attention half then the MLP half;
    ``save`` also returns y1, qkv and h (``_layer_fwd_kernel`` :831)."""
    y1, qkv = _attn_chain(fns, x, ln1_s, ln1_b, qkv_w, qkv_b, out_w, out_b, n_head, causal)
    y, h = _mlp_chain(fns, y1, ln2_s, ln2_b, fc_w, fc_b, proj_w, proj_b, save)
    return (y, y1, qkv, h) if save else y


def _layer_bwd_chain(fns, x, y1, qkv, h, g, ln1_s, qkv_w, out_w, ln2_s, fc_w, proj_w,
                     n_head, causal):
    """dx of the layer from the saved tensors (``_layer_bwd_kernel`` :868:
    ``_mlp_bwd_core`` :429, then ``_attn_bwd_core`` :336)."""
    dy1 = _mlp_bwd_chain(fns, y1, h, g, ln2_s, None, fc_w, None, proj_w)
    return _attn_bwd_chain(fns, x, qkv, dy1, ln1_s, None, qkv_w, None, out_w, n_head, causal)


def layer_fullblock_plain(x, ln1_s, ln1_b, qkv_w, qkv_b, out_w, out_b,
                          ln2_s, ln2_b, fc_w, fc_b, proj_w, proj_b,
                          n_head: int, causal: Causal = False):
    """The layer from the kernels' plain versions, on any device."""
    return _layer_chain(_PLAIN, x, ln1_s, ln1_b, qkv_w, qkv_b, out_w, out_b,
                        ln2_s, ln2_b, fc_w, fc_b, proj_w, proj_b, n_head, causal, False)


def layer_fullblock_fwd_save_plain(x, ln1_s, ln1_b, qkv_w, qkv_b, out_w, out_b,
                                   ln2_s, ln2_b, fc_w, fc_b, proj_w, proj_b,
                                   n_head: int, causal: Causal = False):
    """(y, y1, qkv, h) from the plain versions (``_layer_fwd`` :926)."""
    return _layer_chain(_PLAIN, x, ln1_s, ln1_b, qkv_w, qkv_b, out_w, out_b,
                        ln2_s, ln2_b, fc_w, fc_b, proj_w, proj_b, n_head, causal, True)


def layer_fullblock_bwd_plain(x, y1, qkv, h, g, ln1_s, qkv_w, out_w, ln2_s, fc_w, proj_w,
                              n_head: int, causal: Causal = False):
    """dx from the plain versions (``_layer_bwd`` :946)."""
    return _layer_bwd_chain(_PLAIN, x, y1, qkv, h, g, ln1_s, qkv_w, out_w, ln2_s, fc_w,
                            proj_w, n_head, causal)


class LayerFullblockFn(torch.autograd.Function):
    """``layer_fullblock.defvjp(_layer_fwd, _layer_bwd)`` (:926-959): the
    forward saves x, y1, qkv and h; the backward returns dx and no weight
    gradient.  ``plain`` runs the plain versions of both chains (the
    reference on the card); otherwise the kernel wrappers, which on CPU
    tensors run the same plain versions."""

    @staticmethod
    def forward(ctx, x, ln1_s, ln1_b, qkv_w, qkv_b, out_w, out_b,
                ln2_s, ln2_b, fc_w, fc_b, proj_w, proj_b, n_head, causal, plain):
        if any(ctx.needs_input_grad[1:13]):
            raise ValueError("layer_fullblock returns dx only: its weights must not "
                             "require grad (the frozen-backbone regime)")
        fns = _PLAIN if plain else _KERNELS
        y, y1, qkv, h = _layer_chain(fns, x, ln1_s, ln1_b, qkv_w, qkv_b, out_w, out_b,
                                     ln2_s, ln2_b, fc_w, fc_b, proj_w, proj_b,
                                     n_head, causal, True)
        ctx.save_for_backward(x, y1, qkv, h, ln1_s, qkv_w, out_w, ln2_s, fc_w, proj_w)
        ctx.n_head, ctx.causal, ctx.plain = n_head, causal, plain
        if x.is_cuda and not plain:
            LAUNCHES["layer_fullblock"] += 1
        return y

    @staticmethod
    def backward(ctx, g):
        # read once: a checkpointed layer (REMAT 'full') unpacks each saved
        # tensor only once
        saved = ctx.saved_tensors
        x = saved[0]
        dx = _layer_bwd_chain(_PLAIN if ctx.plain else _KERNELS, *saved[:4],
                              g.contiguous(), *saved[4:], ctx.n_head, ctx.causal)
        if x.is_cuda and not ctx.plain:
            LAUNCHES["layer_fullblock_bwd"] += 1
        return (dx,) + (None,) * 15


def layer_fullblock(x, ln1_s, ln1_b, qkv_w, qkv_b, out_w, out_b,
                    ln2_s, ln2_b, fc_w, fc_b, proj_w, proj_b,
                    n_head: int, causal: Causal = False, plain: bool = False):
    """One pre-LN residual CLIP layer, x (B, S, D) -> (B, S, D).  Same
    signature and mask spec as the Pallas wrapper (``layer_fullblock``
    :908).  When x needs a gradient the layer runs :class:`LayerFullblockFn`
    (saving forward, kernel backward); otherwise the no-save forward.
    ``plain`` runs the plain versions on any device."""
    args = (x, ln1_s, ln1_b, qkv_w, qkv_b, out_w, out_b,
            ln2_s, ln2_b, fc_w, fc_b, proj_w, proj_b)
    if x.is_cuda and not plain:
        _check_width(x, "layer_fullblock", FULLBLOCK_MAX_WIDTH)
    if torch.is_grad_enabled() and x.requires_grad:
        return LayerFullblockFn.apply(*args, n_head, causal, plain)
    y = _layer_chain(_PLAIN if plain else _KERNELS, *args, n_head, causal, False)
    if x.is_cuda and not plain:
        LAUNCHES["layer_fullblock"] += 1
    return y
