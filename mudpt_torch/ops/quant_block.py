"""The int8 (W8A8) tiers of the CLIP layer as chains of hand-written Hopper
kernels: serving (``int8``, dynamic per-row activation scales;
``int8_static``, calibrated per-tensor scales) and quantization-aware prompt
tuning (``int8_ste``, ``int8_ste_static``).

Counterpart of ``mudpt_tpu/ops/quant_block.py``: ``_layer_fwd_q8_kernel``
:89 (``layer_fullblock_q8`` :119), its saving twin ``_layer_fwd_q8_save_kernel``
:178, ``_layer_fwd_q8_static_kernel`` :377 (``layer_fullblock_q8_static``
:418) and ``_layer_fwd_q8_static_save_kernel`` :563.  A Pallas program holds
one image's layer in VMEM; here each is a chain of tiled kernels (``csrc/``):

  x  -> layernorm_q8 -> (xq int8, xs) -> gemm_s8 q8_qkv -> qkv dt
  qkv -> attention_fwd (fp32 out) -> quant_rows -> gemm_s8 q8_residual (+ x) -> y1
  y1 -> layernorm_q8 -> gemm_s8 q8_fc_gelu -> g fp32 [and h dt when saving]
     -> quant_rows -> gemm_s8 q8_residual (+ y1) -> y

with dt the activation dtype, bf16 or fp32, as the Pallas kernels take
either (their qkv, residual adds and saves are ``.astype(x.dtype)``, no-ops
in fp32, their attention runs at ``act_dtype=x.dtype``): ``layernorm_q8``
and ``gemm_s8_epilogue`` launch the kernel of x's dtype
(``fused_block.kernel_for``), attention its fp32 form on fp32 qkv, and
``quant_rows`` takes the fp32 attention accumulator and g in both.

The static chain quantizes by fixed multipliers r (``clip(rint(v * r))``),
so the fc product's epilogue writes int8 g itself (``q8s_fc_gelu``) and the
dequant is ``acc * ws + b`` with ``ws`` carrying the site's ``amax / 127``.
Weights are quantized per output channel (:func:`quantize_cols`) into
(Dout, Din) int8 copies, the K-major B operand of the s8 MMA: once per
parameter tree by :func:`quantize_blocks` (the ``q8_weights`` entry), or per
call for a block without it, as the JAX package's traced code does.

The quantization-aware Functions run the saving q8 forward and the layer
backward (``fused_block._layer_bwd_chain``, ``_layer_bwd_kernel`` :868) of
the activation dtype with the layer's weights in it: straight-through, dx
only.  The serving
forwards are inference-only: a backward raises with the JAX message.

Every kernel has a wrapper and a plain PyTorch version beside it; a CPU
tensor runs the plain version, a CUDA tensor launches or raises; nothing
casts, and a mix of activation dtypes raises.  Launches
count in ``fused_block.LAUNCHES``, beside the other kernels'.
"""

from __future__ import annotations

import torch

from mudpt_torch.ops import _build
from mudpt_torch.ops import fused_block as FB
from mudpt_torch.ops.fused_block import LAUNCHES, Causal, _require, _stream

# epilogue -> kernel mode (csrc/gemm_s8_epilogue.cu); "q8s_" are the static,
# "q8f_" the unscaled floor of tools/probe_q8_residual.py (ops/probe.py)
Q8_EPILOGUES = {"q8_qkv": 0, "q8_residual": 1, "q8_fc_gelu": 2,
                "q8s_qkv": 3, "q8s_residual": 4, "q8s_fc_gelu": 5,
                "q8f_qkv": 6, "q8f_residual": 7, "q8f_fc_gelu": 8}
# the s8 GEMM reads and writes rows of N and K values in 16-byte pieces
# (TMA zero-fills the ragged tile edges): N and K multiples of this
S8_MULTIPLE = 16
QUANT_ROWS_MAX = 4096       # widest row quant_rows holds

INFERENCE_ONLY = (
    "int8 quantized blocks are inference-only (serving/eval); to TRAIN "
    "against the quantized backbone use quant mode 'int8_ste' "
    "(straight-through backward), or unset quant mode for bf16"
)


def _div(a: torch.Tensor, c: float) -> torch.Tensor:
    """``a / c`` as an IEEE division on either device: PyTorch multiplies by
    the reciprocal of a CPU-scalar divisor on CUDA."""
    return a / a.new_full((), c)


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _require_scalar(r: torch.Tensor, what: str) -> None:
    if not (r.is_cuda and r.dtype == torch.float32 and r.numel() == 1):
        raise ValueError(f"{what}: expected one fp32 value on the card, got "
                         f"{r.dtype} {tuple(r.shape)} on {r.device}")


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def quantize_cols(w: torch.Tensor):
    """Symmetric per-output-channel int8 of a (..., Din, Dout) weight
    (``quantize_cols`` :60): (int8 (..., Din, Dout), fp32 (..., 1, Dout))."""
    w32 = w.float()
    s = _div(w32.abs().amax(-2, keepdim=True), 127.0).clamp_min(1e-8)
    return torch.round(w32 / s).clamp(-127, 127).to(torch.int8), s


_PROJ = (("attn", "qkv"), ("attn", "out"), ("mlp", "fc"), ("mlp", "proj"))


def quantize_weights(p: dict) -> dict:
    """The four projection weights of a block, or of stacked blocks, in the
    kernels' layout: ``<name>_wq`` (..., Dout, Din) int8 (K-major) and
    ``<name>_ws`` (..., 1, Dout) fp32, for name in qkv, out, fc, proj."""
    out = {}
    for group, name in _PROJ:
        q, s = quantize_cols(p[group][f"{name}_w"])
        out[f"{name}_wq"] = q.transpose(-1, -2).contiguous()
        out[f"{name}_ws"] = s
    return out


def quantize_blocks(blocks: dict) -> dict:
    """``blocks`` (stacked (L, ...) block parameters) with a ``q8_weights``
    entry: every layer's projections quantized once, for the int8 tiers to
    use instead of quantizing on each call.  The backbone is frozen; a tree
    whose weights change must be quantized again."""
    return dict(blocks, q8_weights=quantize_weights(blocks))


def _params12(p: dict) -> tuple:
    return (p["ln_1"]["scale"], p["ln_1"]["bias"], p["attn"]["qkv_w"], p["attn"]["qkv_b"],
            p["attn"]["out_w"], p["attn"]["out_b"], p["ln_2"]["scale"], p["ln_2"]["bias"],
            p["mlp"]["fc_w"], p["mlp"]["fc_b"], p["mlp"]["proj_w"], p["mlp"]["proj_b"])


def _quantize_layer(params: tuple, qw: dict = None) -> tuple:
    """(12 layer params) -> the 16 operands of the q8 chain (``_quantize_layer``
    :207), the weights from ``qw`` (:func:`quantize_weights`) when given."""
    (ln1_s, ln1_b, qkv_w, qkv_b, out_w, out_b,
     ln2_s, ln2_b, fc_w, fc_b, proj_w, proj_b) = params
    if qw is None:
        qw = quantize_weights({"attn": {"qkv_w": qkv_w, "out_w": out_w},
                               "mlp": {"fc_w": fc_w, "proj_w": proj_w}})
    return (ln1_s, ln1_b, qw["qkv_wq"], qw["qkv_ws"], qkv_b,
            qw["out_wq"], qw["out_ws"], out_b,
            ln2_s, ln2_b, qw["fc_wq"], qw["fc_ws"], fc_b,
            qw["proj_wq"], qw["proj_ws"], proj_b)


_WS = (3, 6, 11, 14)  # positions of the four weight scales among the 16


def _quantize_layer_static(params: tuple, amax: torch.Tensor, qw: dict = None):
    """(12 layer params, (4,) site absmax) -> (the 16 operands with each
    site's dequant factor amax/127 folded into its weight scale, r (4,) the
    quant multipliers 127/amax) (``_quantize_layer_static`` :467)."""
    qp = list(_quantize_layer(params, qw))
    amax = amax.float().clamp_min(1e-8)
    r = amax.new_full((), 127.0) / amax
    dq = _div(amax, 127.0)
    for i, j in enumerate(_WS):
        qp[j] = qp[j] * dq[i]
    return tuple(qp), r


# ---------------------------------------------------------------------------
# row quantization (csrc/quant_rows.cu)
# ---------------------------------------------------------------------------

def quantize_rows_plain(x32, r=None):
    """Per-row symmetric int8 of an fp32 (..., X) tensor: (codes, fp32
    (..., 1) scale) (``_quant_rows`` :70); with r, the static multiplier:
    (codes, None) (``quant_static`` :390)."""
    if r is not None:
        return torch.round(x32 * r).clamp(-127, 127).to(torch.int8), None
    s = _div(x32.abs().amax(-1, keepdim=True), 127.0).clamp_min(1e-8)
    return torch.round(x32 / s).clamp(-127, 127).to(torch.int8), s


def quantize_rows(x32, r=None):
    """:func:`quantize_rows_plain` on the card, one block per row."""
    if not x32.is_cuda:
        return quantize_rows_plain(x32, r)
    X = x32.shape[-1]
    if X % 4 or X > QUANT_ROWS_MAX:
        raise ValueError(f"quant_rows: X={X} must be a multiple of 4 and <= {QUANT_ROWS_MAX}")
    _require(x32, "quant_rows x", torch.float32)
    if r is not None:
        _require_scalar(r, "quant_rows r")
    q = torch.empty(x32.shape, dtype=torch.int8, device=x32.device)
    s = None if r is not None else torch.empty((*x32.shape[:-1], 1), dtype=torch.float32,
                                                device=x32.device)
    lib = _build.load()["quant_rows"]
    _build.check(lib.quant_rows(x32.data_ptr(), q.data_ptr(), _ptr(s), _ptr(r),
                                x32.numel() // X, X, _stream()), "quant_rows")
    LAUNCHES["quant_rows"] += 1
    return q, s


# ---------------------------------------------------------------------------
# LayerNorm quantized at once (csrc/layernorm_q8.cu)
# ---------------------------------------------------------------------------

def ln_quant_plain(x, scale, bias, r=None, eps: float = 1e-5):
    """The fp32 LayerNorm output ``xhat * scale + bias`` (``_ln_fp32`` :150,
    never rounded to x's dtype) quantized by :func:`quantize_rows_plain`."""
    xhat, _ = FB._ln_stats(x.float(), eps)
    return quantize_rows_plain(xhat * scale.float() + bias.float(), r)


def ln_quant(x, scale, bias, r=None, eps: float = 1e-5):
    """:func:`ln_quant_plain` on the card, one warp per row of x (bf16 or
    fp32)."""
    if not x.is_cuda:
        return ln_quant_plain(x, scale, bias, r, eps)
    D = x.shape[-1]
    if D % 8 or D > 1024:
        raise ValueError(f"layernorm_q8: D={D} must be a multiple of 8 and <= 1024")
    key = FB.kernel_for("layernorm_q8", x.dtype)
    _require(x, "layernorm_q8 x", x.dtype)
    _require(scale, "layernorm_q8 scale", torch.float32, (D,))
    _require(bias, "layernorm_q8 bias", torch.float32, (D,))
    if r is not None:
        _require_scalar(r, "layernorm_q8 r")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = None if r is not None else torch.empty((*x.shape[:-1], 1), dtype=torch.float32,
                                                device=x.device)
    lib = _build.load()["layernorm_q8"]
    _build.check(lib.layernorm_q8(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), q.data_ptr(),
                                  _ptr(s), _ptr(r), x.numel() // D, D, eps,
                                  int(x.dtype == torch.float32), _stream()), key)
    LAUNCHES[key] += 1
    return q, s


# ---------------------------------------------------------------------------
# s8 x s8 -> s32 GEMM with the dequantizing epilogues (csrc/gemm_s8_epilogue.cu)
# ---------------------------------------------------------------------------

def _s8_matmul(a, wq):
    """f32 of the exact int32 product a . wq^T, wq (N, K): an int32 matmul
    on the CPU, float64 on the card (no integer matmul kernel there; exact
    below 2^53, and |acc| <= 127^2 * K < 2^26); either rounds to nearest."""
    if a.is_cuda:
        return torch.matmul(a.double(), wq.double().t()).float()
    return torch.matmul(a.int(), wq.int().t()).float()


def gemm_s8_plain(a, xs, wq, ws, bias, epilogue: str, extra=None, r=None,
                  save_h: bool = False, out_dtype=torch.bfloat16):
    """``epilogue(a . wq^T)`` for int8 a (..., K) and wq (N, K):

      v = (f32(acc) * xs) * ws + f32(b)   dynamic "q8_"   (``_q8_matmul`` :79)
      v = f32(acc) * ws + f32(b)          static "q8s_"   (:394-399)
      v = f32(acc) + f32(b)               floor "q8f_" (the probe's, bf16 only)
      qkv       dt(v)
      residual  extra + dt(v), in extra's dtype           (:102, :109)
      fc_gelu   g = v * sigmoid(1.702 v) in fp32; static: int8
                clip(rint(g * r)); with ``save_h`` returns (dt(v), g)

    dt = ``out_dtype``.  Each product and sum is its own rounding."""
    if epilogue not in Q8_EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; known: {sorted(Q8_EPILOGUES)}")
    v = _s8_matmul(a, wq)
    if epilogue.startswith("q8f_"):
        v = v + bias.float()
    else:
        if xs is not None:
            v = v * xs
        v = v * ws + bias.float()
    if epilogue.endswith("qkv"):
        return v.to(out_dtype)
    if epilogue.endswith("residual"):
        return extra + v.to(extra.dtype)
    g = v * torch.sigmoid(1.702 * v)
    if epilogue == "q8s_fc_gelu":
        g = torch.round(g * r).clamp(-127, 127).to(torch.int8)
    return (v.to(out_dtype), g) if save_h else g


def gemm_s8(a, xs, wq, ws, bias, epilogue: str, extra=None, r=None,
            save_h: bool = False, out_dtype=torch.bfloat16):
    """:func:`gemm_s8_plain` on the card: ``xs`` (..., 1) fp32 for the
    dynamic epilogues (None for the static), ``ws`` (1, N) fp32, ``bias`` (N)
    and ``extra`` (the residual) in the activation dtype ``out_dtype``,
    bf16 or fp32, which picks the kernel; ``r`` the static fc multiplier."""
    if not a.is_cuda:
        return gemm_s8_plain(a, xs, wq, ws, bias, epilogue, extra, r, save_h, out_dtype)
    if epilogue not in Q8_EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; known: {sorted(Q8_EPILOGUES)}")
    K = a.shape[-1]
    M, N = a.numel() // K, wq.shape[0]
    if N % S8_MULTIPLE or K % S8_MULTIPLE:
        raise ValueError(f"gemm_s8_epilogue: N={N} and K={K} must be multiples of {S8_MULTIPLE}")
    key = FB.kernel_for("gemm_s8_epilogue", out_dtype, bias.dtype,
                        *(() if extra is None else (extra.dtype,)))
    if epilogue.startswith("q8f_"):
        if out_dtype != torch.bfloat16:
            raise TypeError(f"epilogue {epilogue!r}: bf16 activations only, got {out_dtype}")
        key = "gemm_s8_epilogue_floor"
    dynamic = epilogue.startswith("q8_")
    if dynamic == (xs is None):
        raise ValueError(f"epilogue {epilogue!r}: row scales xs are "
                         f"{'required' if dynamic else 'not taken'}")
    out_shape = (*a.shape[:-1], N)
    _require(a, "gemm_s8 a", torch.int8)
    _require(wq, "gemm_s8 wq", torch.int8, (N, K))
    _require(ws, "gemm_s8 ws", torch.float32, (1, N))
    _require(bias, "gemm_s8 bias", out_dtype, (N,))
    if xs is not None:
        _require(xs, "gemm_s8 xs", torch.float32, (*a.shape[:-1], 1))
    fc = epilogue.endswith("fc_gelu")
    if epilogue.endswith("residual"):
        _require(extra, "gemm_s8 residual", out_dtype, out_shape)
    elif extra is not None:
        raise ValueError(f"epilogue {epilogue!r} takes no residual")
    if epilogue == "q8s_fc_gelu":
        _require_scalar(r, "gemm_s8 r")
    elif r is not None:
        raise ValueError(f"epilogue {epilogue!r} takes no multiplier")
    if save_h and not fc:
        raise ValueError(f"epilogue {epilogue!r} saves no h")
    dt = {"q8_fc_gelu": torch.float32, "q8f_fc_gelu": torch.float32,
          "q8s_fc_gelu": torch.int8}.get(epilogue, out_dtype)
    c = torch.empty(out_shape, dtype=dt, device=a.device)
    c2 = torch.empty(out_shape, dtype=out_dtype, device=a.device) if save_h else None
    source, entry = FB.KERNELS[key]
    fn = getattr(_build.load()[source], entry)
    _build.check(fn(a.data_ptr(), wq.data_ptr(), _ptr(xs), ws.data_ptr(), bias.data_ptr(),
                    _ptr(extra), _ptr(r), c.data_ptr(), _ptr(c2), M, N, K,
                    Q8_EPILOGUES[epilogue], _stream()), key)
    LAUNCHES[key] += 1
    return (c2, c) if save_h else c


# ---------------------------------------------------------------------------
# the layer chains
# ---------------------------------------------------------------------------

_PLAIN_Q = (ln_quant_plain, gemm_s8_plain, FB.attention_plain, quantize_rows_plain)
_KERNELS_Q = (ln_quant, gemm_s8, FB.attention_fwd, quantize_rows)


def _q8_chain(fns, x, qp, n_head, causal, save=False, r=None):
    """The q8 layer forward on 3-D x: dynamic (r None, ``_layer_fwd_q8_kernel``
    :89) or static (r the (4,) multipliers, ``_layer_fwd_q8_static_kernel``
    :377); ``save`` also returns y1, qkv and h in x's dtype (:178, :563)."""
    lnq, gemm, attn, qrows = fns
    (ln1_s, ln1_b, qkv_wq, qkv_ws, qkv_b, out_wq, out_ws, out_b,
     ln2_s, ln2_b, fc_wq, fc_ws, fc_b, proj_wq, proj_ws, proj_b) = qp
    pre = "q8_" if r is None else "q8s_"
    site = (lambda i: None) if r is None else (lambda i: r[i])  # noqa: E731
    xq, xs = lnq(x, ln1_s, ln1_b, site(0))
    qkv = gemm(xq, xs, qkv_wq, qkv_ws, qkv_b, pre + "qkv", out_dtype=x.dtype)
    aq, a_s = qrows(attn(qkv, n_head, causal, out_f32=True), site(1))
    y1 = gemm(aq, a_s, out_wq, out_ws, out_b, pre + "residual", extra=x, out_dtype=x.dtype)
    x2q, x2s = lnq(y1, ln2_s, ln2_b, site(2))
    fc = gemm(x2q, x2s, fc_wq, fc_ws, fc_b, pre + "fc_gelu", r=site(3), save_h=save,
              out_dtype=x.dtype)
    h, g = fc if save else (None, fc)
    gq, gs = (g, None) if r is not None else qrows(g)
    y = gemm(gq, gs, proj_wq, proj_ws, proj_b, pre + "residual", extra=y1, out_dtype=x.dtype)
    return (y, y1, qkv, h) if save else y


def _check_x(x, what: str) -> None:
    if x.dim() != 3:
        raise ValueError(f"{what}: expected x (B, S, D), got {tuple(x.shape)}")
    if x.is_cuda:
        FB._check_width(x, what, FB.MAX_WIDTH)


class _InferenceOnlyFn(torch.autograd.Function):
    """The serving forwards' VJP (``_q8_bwd`` :167): the backward raises."""

    @staticmethod
    def forward(ctx, x, run):
        return run(x)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(INFERENCE_ONLY)


def _serve(x, qp, r, n_head, causal, plain, counter):
    if x.is_cuda and not plain:
        _check_x(x, counter)

    def run(xx):
        y = _q8_chain(_PLAIN_Q if plain else _KERNELS_Q, xx, qp, n_head, causal, False, r)
        if xx.is_cuda and not plain:
            LAUNCHES[counter] += 1
        return y

    if torch.is_grad_enabled() and x.requires_grad:
        return _InferenceOnlyFn.apply(x, run)
    return run(x)


def layer_fullblock_q8(x, ln1_s, ln1_b, qkv_wq, qkv_ws, qkv_b, out_wq, out_ws, out_b,
                       ln2_s, ln2_b, fc_wq, fc_ws, fc_b, proj_wq, proj_ws, proj_b,
                       n_head: int, causal: Causal = False, plain: bool = False):
    """One int8 layer, x (B, S, D) -> (B, S, D) (``layer_fullblock_q8`` :119):
    ``*_wq`` (Dout, Din) int8 and ``*_ws`` (1, Dout) fp32 from
    :func:`quantize_cols`, LayerNorm parameters and biases unquantized.
    Inference-only; ``plain`` runs the plain versions on any device."""
    qp = (ln1_s, ln1_b, qkv_wq, qkv_ws, qkv_b, out_wq, out_ws, out_b,
          ln2_s, ln2_b, fc_wq, fc_ws, fc_b, proj_wq, proj_ws, proj_b)
    return _serve(x, qp, None, n_head, causal, plain, "layer_fullblock_q8")


def layer_fullblock_q8_static(x, ln1_s, ln1_b, qkv_wq, qkv_ws, qkv_b, out_wq, out_ws, out_b,
                              ln2_s, ln2_b, fc_wq, fc_ws, fc_b, proj_wq, proj_ws, proj_b, r,
                              n_head: int, causal: Causal = False, plain: bool = False):
    """The static-scale int8 layer (``layer_fullblock_q8_static`` :418): ``r``
    (4,) fp32 quant multipliers, the ``*_ws`` carrying the dequant factors
    (:func:`_quantize_layer_static`).  Inference-only."""
    qp = (ln1_s, ln1_b, qkv_wq, qkv_ws, qkv_b, out_wq, out_ws, out_b,
          ln2_s, ln2_b, fc_wq, fc_ws, fc_b, proj_wq, proj_ws, proj_b)
    return _serve(x, qp, r, n_head, causal, plain, "layer_fullblock_q8_static")


def q8_save_forward(x, qp, n_head: int, causal: Causal = False, r=None, plain: bool = False):
    """(y, y1, qkv, h) of the saving q8 forward, dynamic (``_q8_save_forward``
    :265) or, with r, static (``_q8_static_save_forward`` :605)."""
    if x.is_cuda and not plain:
        _check_x(x, "q8_save_forward")
    return _q8_chain(_PLAIN_Q if plain else _KERNELS_Q, x, qp, n_head, causal, True, r)


def _ste_forward(ctx, x, params, amax, qw, n_head, causal, plain):
    """``_q8_ste_fwd`` :289 / ``_q8_ste_static_fwd`` :652: the saving q8
    forward under the save policy and the width gate (saves on and D <= 768,
    or <= 1024 within the wide-MLP budget), else the serving forward."""
    if x.is_cuda and not plain:
        _check_x(x, "layer_fullblock_q8_ste")
    B, S, D = x.shape
    limit = FB.MAX_WIDTH if FB.wide_mlp_save(B * S) else FB.FULLBLOCK_MAX_WIDTH
    save = FB.save_acts_enabled() and D <= limit
    if amax is None:
        qp, r = _quantize_layer(params, qw), None
    else:
        qp, r = _quantize_layer_static(params, amax, qw)
    out = _q8_chain(_PLAIN_Q if plain else _KERNELS_Q, x, qp, n_head, causal, save, r)
    y, y1, qkv, h = out if save else (out, None, None, None)
    ln1_s, _, qkv_w, _, out_w, _, ln2_s, _, fc_w, _, proj_w, _ = params
    ctx.save_for_backward(x, y1, qkv, h, ln1_s, qkv_w, out_w, ln2_s, fc_w, proj_w)
    ctx.qp, ctx.r, ctx.n_head, ctx.causal, ctx.plain = qp, r, n_head, causal, plain
    return y


def _ste_backward(ctx, g):
    """``_q8_ste_bwd`` :311 / ``_q8_ste_static_bwd`` :672: the saved
    quantized intermediates, or the saving q8 forward again, then the layer
    backward in x's dtype with the layer's weights (QuickGELU' of the saved
    h)."""
    x, y1, qkv, h, ln1_s, qkv_w, out_w, ln2_s, fc_w, proj_w = ctx.saved_tensors
    if y1 is None:
        _, y1, qkv, h = _q8_chain(_PLAIN_Q if ctx.plain else _KERNELS_Q, x, ctx.qp,
                                  ctx.n_head, ctx.causal, True, ctx.r)
    dx = FB._layer_bwd_chain(FB._PLAIN if ctx.plain else FB._KERNELS, x, y1, qkv, h,
                             g.contiguous(), ln1_s, qkv_w, out_w, ln2_s, fc_w, proj_w,
                             ctx.n_head, ctx.causal)
    if x.is_cuda and not ctx.plain:
        LAUNCHES["layer_fullblock_q8_ste_bwd"] += 1
    return dx


def _frozen(ctx, first: int, last: int, what: str) -> None:
    if any(ctx.needs_input_grad[first:last]):
        raise ValueError(f"{what} returns dx only: its weights and scales must not require "
                         "grad (the frozen-backbone regime)")


class LayerFullblockQ8SteFn(torch.autograd.Function):
    """``layer_fullblock_q8_ste.defvjp(_q8_ste_fwd, _q8_ste_bwd)`` (:223-330):
    the dynamic int8 forward, a straight-through backward, no weight
    gradient.  ``qw`` the prepared weights (:func:`quantize_weights`) or
    None; ``plain`` runs the plain versions of both chains."""

    @staticmethod
    def forward(ctx, x, ln1_s, ln1_b, qkv_w, qkv_b, out_w, out_b,
                ln2_s, ln2_b, fc_w, fc_b, proj_w, proj_b, qw, n_head, causal, plain):
        _frozen(ctx, 1, 13, "layer_fullblock_q8_ste")
        params = (ln1_s, ln1_b, qkv_w, qkv_b, out_w, out_b, ln2_s, ln2_b, fc_w, fc_b,
                  proj_w, proj_b)
        y = _ste_forward(ctx, x, params, None, qw, n_head, causal, plain)
        if x.is_cuda and not plain:
            LAUNCHES["layer_fullblock_q8_ste"] += 1
        return y

    @staticmethod
    def backward(ctx, g):
        return (_ste_backward(ctx, g),) + (None,) * 16


class LayerFullblockQ8SteStaticFn(torch.autograd.Function):
    """``layer_fullblock_q8_ste_static.defvjp(...)`` (:630-690): the static
    int8 forward on the (4,) site absmax ``scales``, the chain of
    :func:`layer_fullblock_q8_static` (bit-identical by construction), and
    the same straight-through backward."""

    @staticmethod
    def forward(ctx, x, scales, ln1_s, ln1_b, qkv_w, qkv_b, out_w, out_b,
                ln2_s, ln2_b, fc_w, fc_b, proj_w, proj_b, qw, n_head, causal, plain):
        _frozen(ctx, 1, 14, "layer_fullblock_q8_ste_static")
        params = (ln1_s, ln1_b, qkv_w, qkv_b, out_w, out_b, ln2_s, ln2_b, fc_w, fc_b,
                  proj_w, proj_b)
        y = _ste_forward(ctx, x, params, scales, qw, n_head, causal, plain)
        if x.is_cuda and not plain:
            LAUNCHES["layer_fullblock_q8_ste_static"] += 1
        return y

    @staticmethod
    def backward(ctx, g):
        return (_ste_backward(ctx, g),) + (None,) * 17


def layer_fullblock_q8_ste(x, ln1_s, ln1_b, qkv_w, qkv_b, out_w, out_b,
                           ln2_s, ln2_b, fc_w, fc_b, proj_w, proj_b,
                           n_head: int, causal: Causal = False, plain: bool = False,
                           qw: dict = None):
    """Quantization-aware prompt tuning (``layer_fullblock_q8_ste`` :223): the
    layer parameters in, the int8 forward out; when x needs a gradient
    :class:`LayerFullblockQ8SteFn`, otherwise the serving forward."""
    params = (ln1_s, ln1_b, qkv_w, qkv_b, out_w, out_b, ln2_s, ln2_b, fc_w, fc_b,
              proj_w, proj_b)
    if torch.is_grad_enabled() and x.requires_grad:
        return LayerFullblockQ8SteFn.apply(x, *params, qw, n_head, causal, plain)
    return layer_fullblock_q8(x, *_quantize_layer(params, qw), n_head, causal, plain)


def layer_fullblock_q8_ste_static(x, scales, ln1_s, ln1_b, qkv_w, qkv_b, out_w, out_b,
                                  ln2_s, ln2_b, fc_w, fc_b, proj_w, proj_b,
                                  n_head: int, causal: Causal = False, plain: bool = False,
                                  qw: dict = None):
    """QAT against the calibrated static tier (``layer_fullblock_q8_ste_static``
    :631); ``scales`` the (4,) site absmax."""
    params = (ln1_s, ln1_b, qkv_w, qkv_b, out_w, out_b, ln2_s, ln2_b, fc_w, fc_b,
              proj_w, proj_b)
    if torch.is_grad_enabled() and x.requires_grad:
        return LayerFullblockQ8SteStaticFn.apply(x, scales, *params, qw, n_head, causal, plain)
    qp, r = _quantize_layer_static(params, scales, qw)
    return layer_fullblock_q8_static(x, *qp, r, n_head, causal, plain)


# ---------------------------------------------------------------------------
# residual blocks (the dispatch targets of models/layers.residual_block)
# ---------------------------------------------------------------------------

def residual_block_q8(p: dict, x, n_head: int, causal: Causal = False, plain: bool = False):
    """Quant mode 'int8' (``residual_block_q8`` :693): the block's weights
    from its ``q8_weights`` entry, or quantized here."""
    qp = _quantize_layer(_params12(p), p.get("q8_weights"))
    return layer_fullblock_q8(x, *qp, n_head, causal, plain)


def residual_block_q8_static(p: dict, x, n_head: int, causal: Causal = False,
                             plain: bool = False):
    """Quant mode 'int8_static' on a block with a ``q8_scales`` (4,) leaf
    (``residual_block_q8_static`` :488)."""
    qp, r = _quantize_layer_static(_params12(p), p["q8_scales"], p.get("q8_weights"))
    return layer_fullblock_q8_static(x, *qp, r, n_head, causal, plain)


def residual_block_q8_ste(p: dict, x, n_head: int, causal: Causal = False,
                          plain: bool = False):
    """Quant modes 'int8_ste' / 'int8_ste_static' (``residual_block_q8_ste``
    :333): a ``q8_scales`` leaf selects the static forward."""
    params, qw = _params12(p), p.get("q8_weights")
    if "q8_scales" in p:
        return layer_fullblock_q8_ste_static(x, p["q8_scales"], *params, n_head, causal,
                                             plain, qw)
    return layer_fullblock_q8_ste(x, *params, n_head, causal, plain, qw)


# ---------------------------------------------------------------------------
# calibration of the static scales
# ---------------------------------------------------------------------------

def calibrate(forward_fn, *args, with_output: bool = False, **kwargs):
    """Run ``forward_fn(*args, **kwargs)`` without gradients under
    activation-absmax capture and return (n_blocks, 4) fp32 per-site absmax
    in block call order, or ``(scales, output)`` with ``with_output``
    (``calibrate`` :508).  The capture runs every block, and the towers'
    LayerNorms, on the plain unquantized route (``models/layers``); combine
    batches with ``torch.maximum``."""
    from mudpt_torch.models import layers

    sink: list = []
    with torch.no_grad(), layers.calibration_capture(sink):
        out = forward_fn(*args, **kwargs)
    if not sink:
        raise ValueError("calibration forward ran no residual blocks")
    if len(sink) % 4:
        raise AssertionError(f"capture recorded {len(sink)} site values (not a multiple "
                             "of 4): the block call pattern is not attention+mlp pairs")
    scales = torch.stack(sink).reshape(-1, 4)
    return (scales, out) if with_output else scales


def attach_scales(blocks: dict, scales) -> dict:
    """``blocks`` (stacked (L, ...) block parameters) with a ``q8_scales``
    (L, 4) fp32 leaf (``attach_scales`` :545): each layer then reads its (4,)
    row, and quant mode 'int8_static' runs the static chain."""
    scales = torch.as_tensor(scales).float()
    n_layers = blocks["ln_1"]["scale"].shape[0]
    if tuple(scales.shape) != (n_layers, 4):
        raise ValueError(f"scales shape {tuple(scales.shape)} != ({n_layers}, 4) for this tower")
    return dict(blocks, q8_scales=scales)
