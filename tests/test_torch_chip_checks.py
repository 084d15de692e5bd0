"""``chip_smoke.check_close`` -- the limits each kernel is held to on the
card -- catches a systematic fault that stays inside the max-error limit:
emulated on the CPU with the plain versions, a GELU of the wrong form and a
missing bf16 rounding of the accumulator fail, and so do the backward
faults (the softmax gradient from the bf16 probabilities, the QuickGELU
gradient of the unrounded pre-activation where the bf16 h was saved and of
the bf16 h where the recompute backward keeps h32 unrounded, a second
rounding before the residual of the LayerNorm dx) and two faults of
``attention_bwd``'s row tiling at ViT-L/14's 259-token blocks, while a
change of fp32 sum order passes."""

import importlib.util
from pathlib import Path

import pytest
import torch
import torch.nn.functional as tf

from mudpt_torch.ops import fused_block as F

ROOT = Path(__file__).resolve().parent.parent
M, K, N = 512, 768, 768


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _operands(seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(M, K, generator=g).bfloat16()
    w = (torch.randn(K, N, generator=g) * K ** -0.5).bfloat16()
    b = (torch.randn(N, generator=g) * 0.1).bfloat16()
    return a, w, b


def _acc(a, w):
    return torch.matmul(a.float(), w.float())


FAULTS = {
    # erf GELU for QuickGELU: within 0.02 of each other
    "erf_gelu": ("fc_gelu", lambda a, w, b: tf.gelu(_acc(a, w) + b.float()).bfloat16()),
    # one rounding of acc + b instead of bf16(acc) + bf16(b)
    "no_acc_rounding": ("qkv", lambda a, w, b: (_acc(a, w) + b.float()).bfloat16()),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_check_close_catches_fault(fault):
    C = _chip_smoke()
    epilogue, faulty = FAULTS[fault]
    a, w, b = _operands(0)
    ref = F.gemm_epilogue_plain(a, w, b, epilogue)
    got = faulty(a, w, b)
    assert (got.float() - ref.float()).abs().max() <= C.MAX_ERR_OF_MAX * ref.float().abs().max()
    # the fault changes far more elements than the limit lets through
    assert (got != ref).float().mean() > 16 * C.DIFFER_SHARE
    with pytest.raises(AssertionError, match="share of differing|relative norm"):
        C.check_close(fault, got, ref)


@pytest.mark.parametrize("epilogue", ["qkv", "fc_gelu"])
def test_check_close_passes_sum_order_change(epilogue):
    C = _chip_smoke()
    a, w, b = _operands(1)
    ref = F.gemm_epilogue_plain(a, w, b, epilogue)
    h = K // 2
    acc = _acc(a[:, :h], w[:h]) + _acc(a[:, h:], w[h:])
    if epilogue == "qkv":
        got = acc.bfloat16() + b
    else:
        got = acc + b.float()
        got = (got * torch.sigmoid(1.702 * got)).bfloat16()
    C.check_close(epilogue, got, ref)


def _attention_bwd_ds_from_bf16_p(qkv, do, n_head):
    """attention_bwd_plain with ds built from bf16(p) instead of fp32 p."""
    B, S, D3 = qkv.shape
    q, k, v, L, is_causal, valid = F._split_heads(qkv, n_head, False)
    dO = do.reshape(q.shape[0], L, n_head, -1).permute(0, 2, 1, 3).float()
    p = F._probs_plain(q, k, L, is_causal, valid)
    dp = torch.matmul(dO, v.float().transpose(-1, -2))
    dv = torch.matmul(p.bfloat16().float().transpose(-1, -2), dO)
    p_lo = p.bfloat16().float()
    ds = (p_lo * (dp - (dp * p).sum(-1, keepdim=True)) * q.shape[-1] ** -0.5).bfloat16().float()
    dq, dk = torch.matmul(ds, k.float()), torch.matmul(ds.transpose(-1, -2), q.float())
    return torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(B, S, D3).bfloat16()


def _bwd_case(fault):
    g = torch.Generator().manual_seed(2)
    rn = lambda *s, std=1.0: (torch.randn(*s, generator=g) * std)  # noqa: E731
    if fault == "ds_from_bf16_p":
        qkv, do = rn(4, 64, 3 * 128).bfloat16(), rn(4, 64, 128, std=0.1).bfloat16()
        return (_attention_bwd_ds_from_bf16_p(qkv, do, 2),
                F.attention_bwd_plain(qkv, do, 2, False))
    if fault == "gelu_grad_of_h32":
        a, w, h32 = rn(M, K).bfloat16(), (rn(N, K) * K ** -0.5).bfloat16(), rn(M, N) * 2
        acc = torch.matmul(a.float(), w.float().t())
        return ((acc * F.quick_gelu_grad(h32)).bfloat16(),
                F.gemm_epilogue_plain(a, w, None, "gelu_bwd", h32.bfloat16()))
    if fault in ("mul_f32_of_bf16_h", "fc_gelu_grad_of_bf16_h"):
        # the recompute backward's QuickGELU' taken of bf16(h32), as the
        # port's old route through layer_fullblock's chain did.  Readings:
        # the product 0.236 of the elements not bit-equal, norm err 1.3e-3;
        # the fp32 factor alone max err 1.0e-3 of its largest value
        a, w, fc_a = rn(M, K).bfloat16(), (rn(N, K) * K ** -0.5).bfloat16(), rn(M, K).bfloat16()
        fc_w, fc_b = (rn(K, N) * K ** -0.5).bfloat16(), (rn(N) * 0.1).bfloat16()
        f = F.gemm_epilogue_plain(fc_a, fc_w, fc_b, "fc_gelu_grad")
        h32 = torch.matmul(fc_a.float(), fc_w.float()) + fc_b.float()
        if fault == "fc_gelu_grad_of_bf16_h":
            return F.quick_gelu_grad(h32.bfloat16().float()), f
        return (F.gemm_epilogue_plain(a, w, None, "gelu_bwd", h32.bfloat16()),
                F.gemm_epilogue_plain(a, w, None, "mul_f32", f))
    # the LayerNorm dx rounded to bf16 before the residual is added
    x, dxn, r = rn(M, K).bfloat16(), rn(M, K), rn(M, K).bfloat16()
    s = rn(K) * 0.1 + 1
    return (r + F.layer_norm_bwd_plain(dxn, x, s), F.layer_norm_bwd_plain(dxn, x, s, r))


@pytest.mark.parametrize("fault", ["ds_from_bf16_p", "gelu_grad_of_h32", "mul_f32_of_bf16_h",
                                   "fc_gelu_grad_of_bf16_h", "ln_bwd_residual_rounding"])
def test_check_close_catches_backward_fault(fault):
    C = _chip_smoke()
    got, ref = _bwd_case(fault)
    assert (got.float() - ref.float()).abs().max() <= C.MAX_ERR_OF_MAX * ref.float().abs().max()
    if fault == "fc_gelu_grad_of_bf16_h":
        # an fp32 output, held as chip_smoke holds the GEMM's fp32 epilogues
        with pytest.raises(AssertionError, match="max abs err|relative norm"):
            C.check_close(fault, got, ref, max_limit=C.F32_MAX_ERR,
                          norm_limit=C.F32_NORM_ERR, share_limit=None)
        return
    assert (got != ref).float().mean() > 16 * C.DIFFER_SHARE
    with pytest.raises(AssertionError, match="share of differing|relative norm"):
        C.check_close(fault, got, ref)


def _attention_bwd_tiling_fault(qkv, do, n_head, fault):
    """attention_bwd_plain at one 259-token block with a fault of the
    kernel's row tiling (17 tiles of 16 rows over 12 warps).  Readings:
    max err 0.78 and 0.58 of the largest value."""
    dqkv = F.attention_bwd_plain(qkv, do, n_head)
    if fault == "last_tile_skipped":  # the partial 17th tile never stored
        dqkv = dqkv.clone()
        dqkv[:, 256:] = 0
        return dqkv
    # "second_query_pass_dropped": dk and dv of each key tile summed over
    # the queries of the first 12 tiles only (phase C's loop over the
    # warps' tiles, not the whole block)
    B, S, D3 = qkv.shape
    q, k, v, L, _, _ = F._split_heads(qkv, n_head, False)
    dO = do.reshape(B, L, n_head, -1).permute(0, 2, 1, 3).float()
    p = F._probs_plain(q, k, L, False, L)
    dp = torch.matmul(dO, v.float().transpose(-1, -2))
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True)) * q.shape[-1] ** -0.5).bfloat16().float()
    kept = (torch.arange(L) < 12 * 16).float()[:, None]
    dv = torch.matmul((p.bfloat16().float() * kept).transpose(-1, -2), dO)
    dk = torch.matmul((ds * kept).transpose(-1, -2), q.float())
    dq = torch.matmul(ds, k.float())
    return torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(B, S, D3).bfloat16()


@pytest.mark.parametrize("fault", ["last_tile_skipped", "second_query_pass_dropped"])
def test_check_close_catches_attention_bwd_tiling_fault(fault):
    C = _chip_smoke()
    g = torch.Generator().manual_seed(3)
    qkv = torch.randn(2, 259, 3 * 128, generator=g).bfloat16()
    do = (torch.randn(2, 259, 128, generator=g) * 0.1).bfloat16()
    got, ref = _attention_bwd_tiling_fault(qkv, do, 2, fault), F.attention_bwd_plain(qkv, do, 2)
    with pytest.raises(AssertionError, match="max abs err|share of differing|relative norm"):
        C.check_close(fault, got, ref)
