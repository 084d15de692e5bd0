"""``layer_fullblock`` forward as a chain of hand-written Hopper kernels.

Counterpart of the inference primal of ``mudpt_tpu/ops/fused_block.py``
(``layer_fullblock`` :907, which runs ``_layer_fwd_nosave_kernel`` :851).
The Pallas program holds a whole layer's weights for one image in VMEM; an
SM's shared memory cannot, so the layer becomes a chain of tiled kernels
(``csrc/``):

  LN1 -> qkv GEMM -> attention -> out-proj GEMM + residual (y1)
      -> LN2 -> fc GEMM + QuickGELU -> proj GEMM + residual

with bf16 activations and weights, fp32 LayerNorm parameters and statistics,
fp32 accumulation, and bf16 rounding at the same points as the Pallas code.

Every kernel has a wrapper and a plain PyTorch version beside it.  A wrapper
given CPU tensors runs the plain version (the CPU tests); given CUDA tensors
it launches the kernel or raises -- it never falls back.  Each launch adds
one to :data:`LAUNCHES`, so a run can show which kernels it went through.

Mask spec (``causal``), as in the Pallas wrapper: ``False`` (none), ``True``
(causal), or ``(period, valid)`` (packed rows: attention within each block
of ``period`` tokens, causal inside it, keys at ``col % period >= valid``
masked).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from mudpt_torch.ops import _build

NEG = -1e30  # additive mask value of the Pallas kernels (fused_block._NEG)
HEAD_DIM = 64  # the attention kernel's head dim (every CLIP tower's)
MAX_WIDTH = 768  # widest tower layer_fullblock takes (models/layers.py:257)

EPILOGUES = {"qkv": 0, "residual": 1, "fc_gelu": 2}

LAUNCHES = {
    "layernorm_fwd": 0,
    "gemm_bf16_epilogue": 0,
    "attention_fwd": 0,
    "layer_fullblock": 0,
}

Causal = Union[bool, Tuple[int, int]]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _require(t: torch.Tensor, what: str, dtype: torch.dtype, shape=None) -> None:
    """The kernels take contiguous, 16-byte-aligned CUDA tensors only."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: data pointer is not 16-byte aligned")


# ---------------------------------------------------------------------------
# LayerNorm (csrc/layernorm_fwd.cu)
# ---------------------------------------------------------------------------

def layer_norm_plain(x, scale, bias, eps: float = 1e-5):
    """fp32 statistics and affine, cast back to x's dtype
    (``fused_block._ln_fp32`` :150 with the casts at :303, :394)."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def layer_norm_fwd(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the last dim of a (rows, D) tensor."""
    if not x.is_cuda:
        return layer_norm_plain(x, scale, bias, eps)
    rows, D = x.shape
    if D % 8 or D > 1024:
        raise ValueError(f"layernorm_fwd: D={D} must be a multiple of 8 and <= 1024")
    _require(x, "layernorm_fwd x", torch.bfloat16)
    _require(scale, "layernorm_fwd scale", torch.float32, (D,))
    _require(bias, "layernorm_fwd bias", torch.float32, (D,))
    y = torch.empty_like(x)
    lib = _build.load()["layernorm_fwd"]
    _build.check(lib.layernorm_fwd(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                   y.data_ptr(), rows, D, eps, _stream()), "layernorm_fwd")
    LAUNCHES["layernorm_fwd"] += 1
    return y


# ---------------------------------------------------------------------------
# GEMM with the layer's three epilogues (csrc/gemm_bf16_epilogue.cu)
# ---------------------------------------------------------------------------

def gemm_epilogue_plain(a, w, bias, epilogue: str, residual=None):
    """``epilogue(a @ w)`` with fp32 accumulation and the Pallas rounding
    points (dt = a's dtype):

      qkv       dt(acc) + dt(b)                        (:304-307)
      residual  r + (dt(acc) + dt(b))                  (:310-315, :861-865)
      fc_gelu   dt(quickgelu(acc + f32(b))) in fp32    (:392-400, :860)
    """
    dt = a.dtype
    acc = torch.matmul(a.float(), w.float())
    if epilogue == "fc_gelu":
        h = acc + bias.float()
        return (h * torch.sigmoid(1.702 * h)).to(dt)
    out = acc.to(dt) + bias.to(dt)
    if epilogue == "qkv":
        return out
    if epilogue == "residual":
        return residual + out
    raise ValueError(f"unknown epilogue {epilogue!r}; known: {sorted(EPILOGUES)}")


def gemm_epilogue(a, w, bias, epilogue: str, residual=None):
    """(M, K) @ (K, N) with W in its (in, out) layout, then the epilogue."""
    if not a.is_cuda:
        return gemm_epilogue_plain(a, w, bias, epilogue, residual)
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; known: {sorted(EPILOGUES)}")
    M, K = a.shape
    N = w.shape[1]
    if K % 64 or N % 8:
        raise ValueError(f"gemm_bf16_epilogue: K={K} must be a multiple of 64, N={N} of 8")
    _require(a, "gemm a", torch.bfloat16)
    _require(w, "gemm w", torch.bfloat16, (K, N))
    _require(bias, "gemm bias", torch.bfloat16, (N,))
    if epilogue == "residual":
        _require(residual, "gemm residual", torch.bfloat16, (M, N))
    elif residual is not None:
        raise ValueError(f"epilogue {epilogue!r} takes no residual")
    c = torch.empty((M, N), dtype=torch.bfloat16, device=a.device)
    lib = _build.load()["gemm_bf16_epilogue"]
    r_ptr = residual.data_ptr() if residual is not None else None
    _build.check(lib.gemm_bf16_epilogue(a.data_ptr(), w.data_ptr(), bias.data_ptr(), r_ptr,
                                        c.data_ptr(), M, N, K, EPILOGUES[epilogue],
                                        _stream()), "gemm_bf16_epilogue")
    LAUNCHES["gemm_bf16_epilogue"] += 1
    return c


# ---------------------------------------------------------------------------
# attention (csrc/attention_fwd.cu)
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


def attention_plain(qkv, n_head: int, causal: Causal = False):
    """Multi-head attention from a packed (B, S, 3D) qkv -> (B, S, D):
    scores fp32(q k^T) * hd^-0.5 + mask (-1e30), fp32 softmax, probabilities
    cast to qkv's dtype before P.V, fp32 accumulation, output in qkv's dtype
    (``_mha_acc`` :222, ``_head_probs`` :197)."""
    B, S, D3 = qkv.shape
    D = D3 // 3
    hd = D // n_head
    L, is_causal, valid = _block_spec(S, causal)
    n = B * (S // L)
    q, k, v = qkv.reshape(n, L, 3, n_head, hd).permute(2, 0, 3, 1, 4)  # (n, H, L, hd)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
    row = torch.arange(L, device=qkv.device)[:, None]
    col = torch.arange(L, device=qkv.device)[None, :]
    masked = col >= valid
    if is_causal:
        masked = masked | (col > row)
    if is_causal or valid < L:
        scores = scores + torch.where(masked, NEG, 0.0)
    p = torch.softmax(scores, dim=-1).to(qkv.dtype)
    o = torch.matmul(p.float(), v.float()).to(qkv.dtype)  # (n, H, L, hd)
    return o.permute(0, 2, 1, 3).reshape(B, S, D)


def attention_fwd(qkv, n_head: int, causal: Causal = False):
    """Attention per (sequence block, head, 64-query tile) on the card."""
    if not qkv.is_cuda:
        return attention_plain(qkv, n_head, causal)
    B, S, D3 = qkv.shape
    D = D3 // 3
    if D != n_head * HEAD_DIM:
        raise ValueError(f"attention_fwd: head dim must be {HEAD_DIM} (D={D}, heads={n_head})")
    L, is_causal, valid = _block_spec(S, causal)
    if L > 400:
        raise ValueError(f"attention_fwd: sequence block {L} > 400 does not fit shared memory")
    _require(qkv, "attention qkv", torch.bfloat16)
    out = torch.empty((B, S, D), dtype=torch.bfloat16, device=qkv.device)
    lib = _build.load()["attention_fwd"]
    _build.check(lib.attention_fwd(qkv.data_ptr(), out.data_ptr(), B * (S // L), L, D,
                                   n_head, int(is_causal), valid, HEAD_DIM ** -0.5,
                                   _stream()), "attention_fwd")
    LAUNCHES["attention_fwd"] += 1
    return out


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def _layer_chain(ln, gemm, attn, x, ln1_s, ln1_b, qkv_w, qkv_b, out_w, out_b,
                 ln2_s, ln2_b, fc_w, fc_b, proj_w, proj_b, n_head, causal):
    B, S, D = x.shape
    x2 = x.reshape(B * S, D)
    qkv = gemm(ln(x2, ln1_s, ln1_b), qkv_w, qkv_b, "qkv")
    a = attn(qkv.reshape(B, S, 3 * D), n_head, causal).reshape(B * S, D)
    y1 = gemm(a, out_w, out_b, "residual", x2)
    h = gemm(ln(y1, ln2_s, ln2_b), fc_w, fc_b, "fc_gelu")
    return gemm(h, proj_w, proj_b, "residual", y1).reshape(B, S, D)


def layer_fullblock_plain(x, ln1_s, ln1_b, qkv_w, qkv_b, out_w, out_b,
                          ln2_s, ln2_b, fc_w, fc_b, proj_w, proj_b,
                          n_head: int, causal: Causal = False):
    """The layer from the kernels' plain versions, on any device."""
    return _layer_chain(layer_norm_plain, gemm_epilogue_plain, attention_plain,
                        x, ln1_s, ln1_b, qkv_w, qkv_b, out_w, out_b,
                        ln2_s, ln2_b, fc_w, fc_b, proj_w, proj_b, n_head, causal)


def layer_fullblock(x, ln1_s, ln1_b, qkv_w, qkv_b, out_w, out_b,
                    ln2_s, ln2_b, fc_w, fc_b, proj_w, proj_b,
                    n_head: int, causal: Causal = False):
    """One pre-LN residual CLIP layer, x (B, S, D) -> (B, S, D), forward
    only.  Same signature and mask spec as the Pallas wrapper
    (``fused_block.layer_fullblock`` :907)."""
    if not x.is_cuda:
        return layer_fullblock_plain(x, ln1_s, ln1_b, qkv_w, qkv_b, out_w, out_b,
                                     ln2_s, ln2_b, fc_w, fc_b, proj_w, proj_b,
                                     n_head, causal)
    if x.shape[-1] > MAX_WIDTH:
        raise ValueError(f"layer_fullblock takes D <= {MAX_WIDTH}, got {x.shape[-1]}")
    _require(x, "layer_fullblock x", torch.bfloat16)
    y = _layer_chain(layer_norm_fwd, gemm_epilogue, attention_fwd,
                     x, ln1_s, ln1_b, qkv_w, qkv_b, out_w, out_b,
                     ln2_s, ln2_b, fc_w, fc_b, proj_w, proj_b, n_head, causal)
    LAUNCHES["layer_fullblock"] += 1
    return y
