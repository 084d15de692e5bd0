"""The two probes of the JAX package's ``tools/`` as hand-written Hopper
kernels: the tensor cores' rate, and what the int8 layer pays besides its
products.

Counterparts of the last two Pallas kernels of the repository:

* ``tools/probe_int8_mxu.py`` ``mm_kernel`` (:41, launched :81): ``out[S, DO]
  = sum_{g < G} sum_{i < 16} x_i @ W`` over G sequential grid steps, bf16 x
  bf16 -> fp32 against s8 x s8 -> s32.  :func:`mma_probe` runs it as one
  kernel (``csrc/probe_mma.cu``), the G steps a loop inside it.  Its
  ``quant_kernel`` (:56, launched :124) is the dynamic row quantizer the
  port already has, :func:`quant_block.quantize_rows` (``csrc/quant_rows.cu``).
* ``tools/probe_q8_residual.py`` ``layer_kernel`` (:116, launched :142): one
  ViT-B serving layer under six modes (:230-237).  :func:`probe_layer`:
  ``bf16`` is ``fused_block.layer_fullblock``'s chain, ``q8`` the dynamic q8
  chain (``quant_block._q8_chain``, the probe's body at :121-136 is
  ``_layer_fwd_q8_kernel``), ``q8_static`` the static chain with r = 8.0 at
  all four sites on the unfolded weight scales (the probe's own, :181-186:
  numerically off, for timing only), and ``q8_recip``, ``q8_noclip``,
  ``q8_floor`` the same chain with the probe's quantizers (:76-102) as
  instances of ``quant_rows`` and ``layernorm_q8`` and, for the floor, the
  unscaled epilogues of ``gemm_s8_epilogue`` (:104-114).

XLA converts an out-of-range float to int8 by truncating and saturating
(NaN -> 0); ``Tensor.to(torch.int8)`` wraps.  :func:`sat_s8` is XLA's
convert, and the kernels use the saturating ``cvt``.

Each wrapper runs its plain version on CPU tensors and launches its kernel
(or raises) on CUDA tensors; launches count in ``fused_block.LAUNCHES``.
"""

from __future__ import annotations

import torch

from mudpt_torch.ops import _build
from mudpt_torch.ops import fused_block as FB
from mudpt_torch.ops import quant_block as Q
from mudpt_torch.ops.fused_block import LAUNCHES, _require, _stream

MODES = ("bf16", "q8", "q8_recip", "q8_noclip", "q8_static", "q8_floor")
STATIC_R = 8.0  # the probe's static multiplier at every site (:146)
# the quantizer ablations -> their mode in csrc/quant_rows.cu and layernorm_q8.cu
ABLATIONS = {"q8_recip": 2, "q8_noclip": 3, "q8_floor": 4}
# the rate probe's output tile (csrc/probe_mma.cu)
TILE_M, TILE_N = 128, 256


def sat_s8(v: torch.Tensor) -> torch.Tensor:
    """XLA's fp32 -> int8 convert: toward zero, saturated to [-128, 127],
    NaN to 0."""
    return torch.nan_to_num(v, nan=0.0).trunc().clamp(-128, 127).to(torch.int8)


# ---------------------------------------------------------------------------
# the tensor cores' rate (csrc/probe_mma.cu)
# ---------------------------------------------------------------------------

def mma_probe_plain(xs, wt, g: int):
    """``sum_{g} sum_i xs[i] @ wt^T`` for xs (n, S, D) and wt (DO, D), W
    transposed: int8 -> the exact int32 sum wrapped mod 2^32, as the TPU's
    int32 accumulator wraps (in int64, or float64 on the card, which has no
    integer matmul: exact, each step's sum below 2^53); bf16 -> fp32 in the
    Pallas kernel's order, the slices' sum first, then added into the
    output once a grid step."""
    if xs.dtype == torch.int8:
        if xs.is_cuda:
            step = torch.matmul(xs.double(), wt.double().t()).sum(0).long()
        else:
            step = torch.matmul(xs.long(), wt.long().t()).sum(0)
        return ((step * g + 2 ** 31) % 2 ** 32 - 2 ** 31).int()
    w32 = wt.float().t()
    acc = torch.zeros(xs.shape[1], wt.shape[0], dtype=torch.float32, device=xs.device)
    for x in xs:
        acc = acc + torch.matmul(x.float(), w32)
    out = torch.zeros_like(acc)
    for _ in range(g):
        out = out + acc
    return out


def _tiles(S: int, DO: int) -> int:
    return -(-S // TILE_M) * -(-DO // TILE_N)


def probe_split(S: int, DO: int, products: int, n_sm: int) -> int:
    """Blocks per output tile of :func:`mma_probe`: the least that fill whole
    waves of the SMs (within four times the least for one wave), at most
    one a slice product."""
    tiles = _tiles(S, DO)
    least = -(-n_sm // tiles)
    split = next((s for s in range(least, 4 * least + 1) if tiles * s % n_sm == 0), least)
    return max(1, min(split, products))


def probe_blocks(S: int, DO: int, products: int, n_sm: int) -> int:
    """The blocks :func:`mma_probe` launches (one an SM at a time)."""
    return _tiles(S, DO) * probe_split(S, DO, products, n_sm)


def mma_probe(xs, wt, g: int):
    """:func:`mma_probe_plain` on the card: xs (n, S, D) and wt (DO, D),
    both bf16 or both int8, D and DO multiples of 16; out (S, DO) fp32 or
    int32."""
    if not xs.is_cuda:
        return mma_probe_plain(xs, wt, g)
    if xs.dtype not in (torch.bfloat16, torch.int8):
        raise TypeError(f"probe_mma: x must be bf16 or int8, got {xs.dtype}")
    n, S, D = xs.shape
    DO = wt.shape[0]
    if D % 16 or DO % 16 or g < 1:
        raise ValueError(f"probe_mma: D={D} and DO={DO} must be multiples of 16, G={g} >= 1")
    s8 = xs.dtype == torch.int8
    key = "probe_mma_s8" if s8 else "probe_mma_bf16"
    _require(xs, "probe_mma x", xs.dtype)
    _require(wt, "probe_mma w", xs.dtype, (DO, D))
    out = torch.empty((S, DO), dtype=torch.int32 if s8 else torch.float32, device=xs.device)
    n_sm = torch.cuda.get_device_properties(xs.device).multi_processor_count
    lib = _build.load()["probe_mma"]
    _build.check(lib.probe_mma(xs.data_ptr(), wt.data_ptr(), out.data_ptr(), S, D, DO, n, g,
                               probe_split(S, DO, n * g, n_sm), int(s8), _stream()), key)
    LAUNCHES[key] += 1
    return out


# ---------------------------------------------------------------------------
# the probe's quantizers (csrc/quant_rows.cu, csrc/layernorm_q8.cu)
# ---------------------------------------------------------------------------

def _static_r(mode: str, r):
    """The multiplier the production quantizers take: r under ``q8_static``
    (required), else None."""
    if mode != "q8_static":
        return None
    if r is None:
        raise ValueError("quantizer 'q8_static' needs its multiplier r")
    return r


def quantize_rows_mode_plain(x32, mode: str, r=None):
    """The probe's ``quant_rows(x32, mode, static_r)`` (:76-102) on fp32
    rows: (int8 codes, fp32 (..., 1) scale or None)."""
    if mode in ("q8", "q8_static"):
        return Q.quantize_rows_plain(x32, _static_r(mode, r))
    if mode == "q8_recip":
        m = x32.abs().amax(-1, keepdim=True).clamp_min(1e-8)
        q = torch.round(x32 * (m.new_full((), 127.0) / m)).clamp(-127, 127).to(torch.int8)
        return q, Q._div(m, 127.0)
    if mode == "q8_noclip":
        s = Q._div(x32.abs().amax(-1, keepdim=True), 127.0).clamp_min(1e-8)
        return sat_s8(torch.round(x32 / s)), s
    if mode == "q8_floor":
        return sat_s8(x32), None
    raise ValueError(f"unknown quantizer {mode!r}; known: {MODES[1:]}")


def quantize_rows_mode(x32, mode: str, r=None):
    """:func:`quantize_rows_mode_plain` on the card: ``q8`` and ``q8_static``
    are :func:`quant_block.quantize_rows`, the ablations instances of its
    kernel."""
    if not x32.is_cuda:
        return quantize_rows_mode_plain(x32, mode, r)
    if mode in ("q8", "q8_static"):
        return Q.quantize_rows(x32, _static_r(mode, r))
    if mode not in ABLATIONS:
        raise ValueError(f"unknown quantizer {mode!r}; known: {MODES[1:]}")
    X = x32.shape[-1]
    if X % 4 or X > Q.QUANT_ROWS_MAX:
        raise ValueError(f"quant_rows: X={X} must be a multiple of 4 and <= {Q.QUANT_ROWS_MAX}")
    _require(x32, "quant_rows x", torch.float32)
    q = torch.empty(x32.shape, dtype=torch.int8, device=x32.device)
    s = None if mode == "q8_floor" else torch.empty((*x32.shape[:-1], 1), dtype=torch.float32,
                                                     device=x32.device)
    key = "quant_rows_" + mode[3:]
    lib = _build.load()["quant_rows"]
    _build.check(lib.quant_rows_mode(x32.data_ptr(), q.data_ptr(), Q._ptr(s), None,
                                     x32.numel() // X, X, ABLATIONS[mode], _stream()), key)
    LAUNCHES[key] += 1
    return q, s


def ln_quant_mode_plain(x, scale, bias, mode: str, r=None, eps: float = 1e-5):
    """The fp32 LayerNorm output (``_ln_fp32``) quantized by
    :func:`quantize_rows_mode_plain`."""
    xhat, _ = FB._ln_stats(x.float(), eps)
    return quantize_rows_mode_plain(xhat * scale.float() + bias.float(), mode, r)


def ln_quant_mode(x, scale, bias, mode: str, r=None, eps: float = 1e-5):
    """:func:`ln_quant_mode_plain` on the card: ``q8`` and ``q8_static`` are
    :func:`quant_block.ln_quant`, the ablations instances of its kernel on
    bf16 rows."""
    if not x.is_cuda:
        return ln_quant_mode_plain(x, scale, bias, mode, r, eps)
    if mode in ("q8", "q8_static"):
        return Q.ln_quant(x, scale, bias, _static_r(mode, r), eps)
    if mode not in ABLATIONS:
        raise ValueError(f"unknown quantizer {mode!r}; known: {MODES[1:]}")
    D = x.shape[-1]
    if D % 8 or D > 1024:
        raise ValueError(f"layernorm_q8: D={D} must be a multiple of 8 and <= 1024")
    _require(x, "layernorm_q8 x", torch.bfloat16)
    _require(scale, "layernorm_q8 scale", torch.float32, (D,))
    _require(bias, "layernorm_q8 bias", torch.float32, (D,))
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = None if mode == "q8_floor" else torch.empty((*x.shape[:-1], 1), dtype=torch.float32,
                                                     device=x.device)
    key = "layernorm_" + mode
    lib = _build.load()["layernorm_q8"]
    _build.check(lib.layernorm_q8_mode(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                       q.data_ptr(), Q._ptr(s), x.numel() // D, D, eps,
                                       ABLATIONS[mode], _stream()), key)
    LAUNCHES[key] += 1
    return q, s


# ---------------------------------------------------------------------------
# the layer under each mode
# ---------------------------------------------------------------------------

def probe_operands(params: tuple, mode: str) -> tuple:
    """What :func:`probe_layer` takes in ``mode``, from the 12 layer
    parameters (``quant_block._params12`` order; weights (Din, Dout) and
    biases in x's dtype, LayerNorm parameters fp32): ``bf16`` the 12
    themselves; the q8 modes the 16 operands of ``quant_block._quantize_layer``
    (weights quantized per output channel, the probe's ``quantize_cols``),
    and ``q8_static`` then r, the (4,) multipliers STATIC_R."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; known: {MODES}")
    if mode == "bf16":
        return tuple(params)
    qp = Q._quantize_layer(tuple(params))
    if mode == "q8_static":
        return (*qp, torch.full((4,), STATIC_R, device=params[0].device))
    return qp


def _ablation_fns(mode: str, plain: bool) -> tuple:
    """The q8 chain's (LayerNorm-quant, GEMM, attention, row quantizer) with
    the quantizers of ``mode``; the floor's GEMMs on the unscaled epilogues."""
    lnq = ln_quant_mode_plain if plain else ln_quant_mode
    qrows = quantize_rows_mode_plain if plain else quantize_rows_mode
    gemm = Q.gemm_s8_plain if plain else Q.gemm_s8
    prefix = "q8f_" if mode == "q8_floor" else "q8_"

    def ln(x, s, b, r=None):
        return lnq(x, s, b, mode)

    def rows(v, r=None):
        return qrows(v, mode)

    def mm(a, xs, wq, ws, b, epilogue, **kw):
        return gemm(a, xs, wq, ws, b, prefix + epilogue[3:], **kw)

    return ln, mm, FB.attention_plain if plain else FB.attention_fwd, rows


def probe_layer(x, qp: tuple, mode: str, n_head: int, plain: bool = False):
    """The probe's ``layer_kernel`` in ``mode`` (x (B, S, D), unmasked, no
    gradient): ``qp`` from :func:`probe_operands`; ``plain`` runs the plain
    versions on any device."""
    if mode == "bf16":
        return FB.layer_fullblock(x, *qp, n_head, False, plain)
    if mode == "q8":
        return Q.layer_fullblock_q8(x, *qp, n_head, False, plain)
    if mode == "q8_static":
        return Q.layer_fullblock_q8_static(x, *qp, n_head, False, plain)
    if mode not in ABLATIONS:
        raise ValueError(f"unknown mode {mode!r}; known: {MODES}")
    if x.is_cuda and not plain:
        Q._check_x(x, "probe_layer")
    return Q._q8_chain(_ablation_fns(mode, plain), x, qp, n_head, False)
