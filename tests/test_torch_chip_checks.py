"""``chip_smoke.check_close`` -- the limits each kernel is held to on the
card -- catches a systematic fault that stays inside the max-error limit:
emulated on the CPU with the plain versions, a GELU of the wrong form and a
missing bf16 rounding of the accumulator fail, and so do the backward
faults (the softmax gradient from the bf16 probabilities, the QuickGELU
gradient of the unrounded pre-activation where the bf16 h was saved and of
the bf16 h where the recompute backward keeps h32 unrounded, a second
rounding before the residual of the LayerNorm dx), two faults of a row
tiling of ``attention_bwd`` and three of its key-tiled passes at ViT-L/14's
259-token blocks (dk and dv cut short of the last query tile, row
statistics of the first key tile only, a masked key tile let into dq), and
two of the ping-pong GEMM's epilogue (one slab adding the neighbouring
tile's residual, an fp32 part stored at the wrong columns), which
``check_equal`` rejects too, while a change of fp32 sum order passes; two
faults of the chunked MLP half (y
rounded once after the whole product, proj_b folded into the first chunk's
product) fail the chain check or the epilogue check that chip_smoke runs
for them.  The int8 kernels' limits (codes within
one step, few of them differing) reject the attention output rounded to
bf16 before the row quantizer, rounding half away from zero, and the LN1
output quantized from bf16, and pass LayerNorm statistics summed in
another order."""

import importlib.util
from pathlib import Path

import pytest
import torch
import torch.nn.functional as tf

from mudpt_torch.ops import fused_block as F
from mudpt_torch.ops import quant_block as Q

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


def _attention_bwd_redesign_fault(qkv, do, n_head, fault):
    """attention_bwd_plain with a fault of the key-tiled kernels' passes
    (64-row tiles): "dkdv_last_query_tile_dropped", dk and dv summed over
    all query tiles but the last (the key-major pass's item loop cut
    short); "stats_from_first_key_tile", each row's max, sum and
    rowsum(dp * p) taken over the first key tile only (the query-major
    pass's first loop cut short); "masked_tile_in_dq", causal, a key tile
    that the mask covers whole for a query tile skipped in the statistics
    but not in dq (its p taken unmasked against the right statistics)."""
    B, S, D3 = qkv.shape
    causal = fault == "masked_tile_in_dq"
    q, k, v, L, is_causal, valid = F._split_heads(qkv, n_head, causal)
    hd = q.shape[-1]
    dO = do.reshape(B, L, n_head, hd).permute(0, 2, 1, 3).float()
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
    p = F._probs_plain(q, k, L, is_causal, valid)
    dp = torch.matmul(dO, v.float().transpose(-1, -2))
    if fault == "stats_from_first_key_tile":
        m = s[..., :64].amax(-1, keepdim=True)
        p = torch.exp(s - m) / torch.exp(s[..., :64] - m).sum(-1, keepdim=True)
        dsum = (dp * p)[..., :64].sum(-1, keepdim=True)
    else:
        dsum = (dp * p).sum(-1, keepdim=True)
    ds = (p * (dp - dsum) * hd ** -0.5).bfloat16().float()
    dv = torch.matmul(p.bfloat16().float().transpose(-1, -2), dO)
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dq = torch.matmul(ds, k.float())
    if fault == "dkdv_last_query_tile_dropped":
        kept = (torch.arange(L) < (L - 1) // 64 * 64).float()[:, None]
        dv = torch.matmul((p.bfloat16().float() * kept).transpose(-1, -2), dO)
        dk = torch.matmul((ds * kept).transpose(-1, -2), q.float())
    if fault == "masked_tile_in_dq":
        i = torch.arange(L)
        masked = i[None, :] > i[:, None]
        whole = (i[None, :] // 64) > (i[:, None] // 64)  # a key tile after the query tile
        m = s.masked_fill(masked, -float("inf")).amax(-1, keepdim=True)
        l = torch.exp(s - m).masked_fill(masked, 0).sum(-1, keepdim=True)  # noqa: E741
        p_dq = torch.where(whole, torch.exp(s - m) / l, p)
        dq = torch.matmul((p_dq * (dp - dsum) * hd ** -0.5).bfloat16().float(), k.float())
    return torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(B, S, D3).bfloat16()


@pytest.mark.parametrize("fault", ["dkdv_last_query_tile_dropped", "stats_from_first_key_tile",
                                   "masked_tile_in_dq"])
def test_check_close_catches_attention_bwd_key_tiled_fault(fault):
    """Readings at 2 x 259 x 2 heads (max err of the largest value, norm
    err, share not bit-equal): dk and dv cut short 0.29, 0.082, 0.64;
    statistics of one tile 4.1, 3.3, 1.0; a masked tile in dq 240, 50,
    0.32.  check_equal (the launched-twice check) rejects each too."""
    C = _chip_smoke()
    g = torch.Generator().manual_seed(4)
    qkv = torch.randn(2, 259, 3 * 128, generator=g).bfloat16()
    do = (torch.randn(2, 259, 128, generator=g) * 0.1).bfloat16()
    causal = fault == "masked_tile_in_dq"
    got = _attention_bwd_redesign_fault(qkv, do, 2, fault)
    ref = F.attention_bwd_plain(qkv, do, 2, causal)
    with pytest.raises(AssertionError, match="max abs err|share of differing|relative norm"):
        C.check_close(fault, got, ref)
    with pytest.raises(AssertionError):
        C.check_equal(fault, got, ref)


def _gemm_pingpong_fault(fault):
    """(faulty, plain) outputs of the ping-pong GEMM's epilogue faults, 128 x
    128 tiles: "residual_slab_slip", one 64-row slab of a tile adding the
    residual of the tile below it (the other consumer's); "f32_subtile_wrong
    _columns", store_f32's second 64-column part of a tile stored over its
    first, the second left unwritten.  Readings (max err of the largest
    value, norm err, share): 0.94, 0.15, 0.021; 1.2, 0.25, 0.042."""
    a, w, b = _operands(8)
    g = torch.Generator().manual_seed(9)
    if fault == "residual_slab_slip":
        r = torch.randn(M, N, generator=g).bfloat16()
        ref = F.gemm_epilogue_plain(a, w, b, "residual", r)
        slipped = r.clone()
        slipped[64:128, 0:128] = r[192:256, 0:128]
        return F.gemm_epilogue_plain(a, w, b, "residual", slipped), ref
    w_nk = w.t().contiguous()  # (N, K): the backward epilogues' layout
    ref = F.gemm_epilogue_plain(a, w_nk, None, "store_f32")
    got = ref.clone()
    got[0:128, 0:64] = ref[0:128, 64:128]
    got[0:128, 64:128] = 0
    return got, ref


@pytest.mark.parametrize("fault", ["residual_slab_slip", "f32_subtile_wrong_columns"])
def test_check_close_catches_gemm_pingpong_fault(fault):
    C = _chip_smoke()
    got, ref = _gemm_pingpong_fault(fault)
    if fault == "residual_slab_slip":
        with pytest.raises(AssertionError, match="max abs err|share of differing|relative norm"):
            C.check_close(fault, got, ref)
    else:  # an fp32 output, held as chip_smoke holds the GEMM's fp32 epilogues
        with pytest.raises(AssertionError, match="max abs err|relative norm"):
            C.check_close(fault, got, ref, max_limit=C.F32_MAX_ERR,
                          norm_limit=C.F32_NORM_ERR, share_limit=None)
    with pytest.raises(AssertionError):
        C.check_equal(fault, got, ref)


def _chunked_mlp_case(fault):
    """(the faulty y, the plain chain's y) of the chunked MLP half at
    ViT-L/14's width (D = 1024, K = 8 chunks of 512), weights at
    chip_smoke's scales; for "proj_b_folded" also (the faulty first-chunk
    epilogue, the plain one): the residual epilogue's r + (dt(acc) + dt(b))
    in place of dt(dt(r + dt(b)) + dt(acc))."""
    g = torch.Generator().manual_seed(5)
    rn = lambda *s, std=1.0: (torch.randn(*s, generator=g) * std).bfloat16()  # noqa: E731
    D, Dh = 1024, 4096
    x = rn(M, D)
    ln_s = torch.randn(D, generator=g) * 0.1 + 1
    ln_b = torch.randn(D, generator=g) * 0.1
    fc_w, fc_b = rn(D, Dh, std=D ** -0.5), rn(Dh, std=0.1)
    proj_w, proj_b = rn(Dh, D, std=Dh ** -0.5), rn(D, std=0.1)
    ref = F.mlp_halfblock_chunked_plain(x, ln_s, ln_b, fc_w, fc_b, proj_w, proj_b)
    xn = F.layer_norm_plain(x, ln_s, ln_b)
    acts = [(F.gemm_epilogue_plain(xn, fc_w[:, c], fc_b[c], "fc_gelu"), proj_w[c])
            for c in F._chunks(D, Dh)]
    accs = [a.float() @ w.float() for a, w in acts]
    if fault == "y_rounded_once":  # the half-block's rounding: one, after the fp32 sum
        return (x + proj_b) + sum(accs).bfloat16(), ref
    y = x + (accs[0].bfloat16() + proj_b)
    for acc in accs[1:]:
        y = y + acc.bfloat16()
    a0, w0 = acts[0]
    return (y, ref, x + (accs[0].bfloat16() + proj_b),
            F.gemm_epilogue_plain(a0, w0, proj_b, "chunk_residual", x))


# Readings (max err of the largest value, relative norm err, share not
# bit-equal), against the plain chain: y rounded once 0.010, 5.0e-3, 0.60;
# proj_b folded 0.010, 3.1e-3, 0.14; the first chunk's epilogue with proj_b
# folded 0.0061, 2.8e-3, 0.28.  The correct chain reads 2.8e-4-4.6e-4 in
# norm on the card (PERF.md), 2.1x inside the chain's limit of 2^-10
def _chain_check(C, what, got, ref):
    """The chain's y check as chip_smoke holds it: no share (one-ulp flips
    carry on), its own norm limit."""
    C.check_close(what, got, ref, norm_limit=C.CHUNK_Y_NORM_ERR, share_limit=None)


def test_check_close_catches_chunked_mlp_y_rounded_once():
    """The chain check rejects y rounded once by its norm limit, 5.1x over
    it (1.3x over the 2^-8 that the chain was held to before)."""
    C = _chip_smoke()
    got, ref = _chunked_mlp_case("y_rounded_once")
    assert (got.float() - ref.float()).abs().max() <= C.MAX_ERR_OF_MAX * ref.float().abs().max()
    norm = ((got.float() - ref.float()).norm() / ref.float().norm()).item()
    assert norm > 5 * C.CHUNK_Y_NORM_ERR
    with pytest.raises(AssertionError, match="relative norm"):
        _chain_check(C, "y rounded once", got, ref)


def test_check_close_catches_chunked_mlp_proj_b_folded():
    """proj_b folded as the residual epilogue folds it: the chain check
    rejects it by its norm limit (3.2x over), and chip_smoke's check of the
    first chunk's epilogue alone by the share of differing elements, 70x
    over that limit."""
    C = _chip_smoke()
    got, ref, ep_got, ep_ref = _chunked_mlp_case("proj_b_folded")
    with pytest.raises(AssertionError, match="relative norm"):
        _chain_check(C, "proj_b folded, chain", got, ref)
    assert (ep_got.float() - ep_ref.float()).abs().max() <= (
        C.MAX_ERR_OF_MAX * ep_ref.float().abs().max())
    with pytest.raises(AssertionError, match="share of differing"):
        C.check_close("proj_b folded, first chunk", ep_got, ep_ref)


def _ln_quant_sum_order(x, s, b):
    """ln_quant_plain with the LayerNorm statistics summed in float64, then
    rounded: another order of the same fp32 sums, as the kernel's warp
    reduction has."""
    x64 = x.double()
    mean = x64.mean(-1, keepdim=True).float()
    var = (x.float() - mean).double().square().mean(-1, keepdim=True).float()
    xn = (x.float() - mean) * torch.rsqrt(var + 1e-5) * s + b
    return Q.quantize_rows_plain(xn)[0]


def _q8_case(fault):
    """(codes of the fault, codes of the plain version) of an int8 kernel."""
    g = torch.Generator().manual_seed(4)
    if fault == "attention_out_rounded_to_bf16":
        qkv = torch.randn(4, 64, 3 * 128, generator=g).bfloat16()
        ref = F.attention_plain(qkv, 2, False, out_f32=True)
        return (Q.quantize_rows_plain(F.attention_plain(qkv, 2, False).float())[0],
                Q.quantize_rows_plain(ref)[0])
    if fault == "round_half_away_from_zero":
        # chip_smoke's probe of exact ties: rows of k + 1/2, largest 127
        ties = torch.randint(-127, 127, (64, 768), generator=g).float() + 0.5
        ties[:, 0] = 127.0
        q, s = Q.quantize_rows_plain(ties)
        v = ties / s
        away = (v.sign() * (v.abs() + 0.5).floor()).clamp(-127, 127).to(torch.int8)
        return away, q
    x = (torch.randn(512, 768, generator=g) * 2).bfloat16()
    s, b = torch.randn(768, generator=g) * 0.1 + 1, torch.randn(768, generator=g) * 0.1
    ref = Q.ln_quant_plain(x, s, b)[0]
    if fault == "ln1_quantized_from_bf16":
        return Q.quantize_rows_plain(F.layer_norm_plain(x, s, b).float())[0], ref
    return _ln_quant_sum_order(x, s, b), ref


# Readings: the share of codes not equal to the plain version's, and the
# largest step: attention output rounded to bf16 0.064, 1; half away from
# zero on the ties probe 0.50, 1; LN1 output quantized from bf16 0.052, 1;
# the LayerNorm statistics summed in another order 0, 0.  The bf16-rounded
# attention output itself: norm error 1.7e-3, max 2.9e-3 of the largest
@pytest.mark.parametrize("fault", ["attention_out_rounded_to_bf16", "round_half_away_from_zero",
                                   "ln1_quantized_from_bf16"])
def test_check_codes_catches_int8_fault(fault):
    """Each fault moves codes by one step only, which the step limit lets
    through; the share of differing codes, or their norm error, rejects it."""
    C = _chip_smoke()
    got, ref = _q8_case(fault)
    assert (got.int() - ref.int()).abs().max() <= C.CODE_STEP
    assert (got != ref).float().mean() > 4 * C.CODE_SHARE
    with pytest.raises(AssertionError, match="share of differing|relative norm"):
        C.check_codes(fault, got, ref)
    with pytest.raises(AssertionError):
        C.check_equal(fault, got, ref)


def test_check_close_catches_attention_output_rounded_to_bf16():
    """The fp32 attention output itself, held as chip_smoke holds
    attention_fwd's fp32 mode: bf16 rounding exceeds the norm limit."""
    C = _chip_smoke()
    qkv = torch.randn(4, 64, 3 * 128, generator=torch.Generator().manual_seed(4)).bfloat16()
    ref = F.attention_plain(qkv, 2, False, out_f32=True)
    with pytest.raises(AssertionError, match="relative norm"):
        C.check_close("attention fp32", F.attention_plain(qkv, 2, False).float(), ref,
                      max_limit=C.ATTN_F32_MAX_ERR, norm_limit=C.ATTN_F32_NORM_ERR,
                      share_limit=None)


def test_check_codes_passes_ln_sum_order_change():
    C = _chip_smoke()
    got, ref = _q8_case("ln_sum_order")
    C.check_codes("ln sum order", got, ref)


# ---------------------------------------------------------------------------
# the key-tiled attention_fwd and the wgmma s8 GEMM: their order of sums
# passes, the faults their designs invite do not
# ---------------------------------------------------------------------------

def _vision_qkv():
    """A vision-shaped packed qkv: 2 images x 199 tokens x 2 heads of 64."""
    return torch.randn(2, 199, 3 * 128, generator=torch.Generator().manual_seed(6)).bfloat16()


def _attention_flash_rounding(qkv, n_head):
    """The online-softmax (flash) order: p = exp(s - max) rounded to bf16
    before it is normalized, O = (P.V) / sum at the end."""
    B, S, D3 = qkv.shape
    q, k, v, L, _, _ = F._split_heads(qkv, n_head, False)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.matmul(e.bfloat16().float(), v.float()) / e.sum(-1, keepdim=True)
    return o.bfloat16().permute(0, 2, 1, 3).reshape(B, S, D3 // 3)


def _attention_key_tiled(qkv, n_head, tile=64):
    """attention_fwd's order on the card: per 64-key tile the row max of
    the scores times c = hd^-0.5 * log2(e), and the sum of exp2(s * c -
    max) rescaled once per tile, the exponent one fused multiply-add
    (emulated in float64, exact for a product of two fp32 values); then p =
    bf16(exp2(s * c - max) * (1 / sum)) and P.V in fp32."""
    B, S, D3 = qkv.shape
    q, k, v, L, _, _ = F._split_heads(qkv, n_head, False)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    c = torch.tensor(q.shape[-1] ** -0.5 * 1.4426950408889634, dtype=torch.float32)
    expo = lambda m: (s.double() * c.double() - m.double()).float()  # noqa: E731
    m = torch.full(s.shape[:-1] + (1,), -float("inf"))
    total = torch.zeros_like(m)
    for k0 in range(0, L, tile):
        m_new = torch.maximum(m, s[..., k0:k0 + tile].amax(-1, keepdim=True) * c)
        total = (total * torch.exp2(m - m_new)
                 + torch.exp2(expo(m_new)[..., k0:k0 + tile]).sum(-1, keepdim=True))
        m = m_new
    p = (torch.exp2(expo(m)) * (1.0 / total)).bfloat16()
    o = torch.matmul(p.float(), v.float()).bfloat16()
    return o.permute(0, 2, 1, 3).reshape(B, S, D3 // 3)


# Readings against attention_plain at 2 x 199 x 2 heads (max err of the
# largest value, relative norm err, share not bit-equal): the flash order
# 0.0056, 3.0e-3, 0.48 -- inside the max-error limit, 0.77x the norm limit,
# 124x the share limit; the key-tiled order 6.9e-4, 3.0e-5, 2.7e-4, 0.07x
# the share limit (its exp2 and reciprocal move a p across a bf16 rounding
# boundary now and then)
def test_check_close_catches_attention_flash_rounding():
    C = _chip_smoke()
    qkv = _vision_qkv()
    got, ref = _attention_flash_rounding(qkv, 2), F.attention_plain(qkv, 2)
    assert (got.float() - ref.float()).abs().max() <= C.MAX_ERR_OF_MAX * ref.float().abs().max()
    assert (got != ref).float().mean() > 16 * C.DIFFER_SHARE
    with pytest.raises(AssertionError, match="share of differing|relative norm"):
        C.check_close("attention, flash rounding", got, ref)


def test_check_close_passes_attention_key_tiled_order():
    C = _chip_smoke()
    qkv = _vision_qkv()
    C.check_close("attention, key-tiled", _attention_key_tiled(qkv, 2), F.attention_plain(qkv, 2))


def test_check_equal_catches_s8_dequant_fma():
    """The dynamic dequant (v * xs) * ws + b contracted into one FMA, the
    last product and the sum rounded once: the qkv epilogue is held
    bit-equal, and the contraction moves one bf16 output of the 196,608
    here, by one ulp (4.8e-7): only bit-equality sees it."""
    C = _chip_smoke()
    g = torch.Generator().manual_seed(7)
    x32 = torch.randn(256, 768, generator=g)
    wq, ws = Q.quantize_cols((torch.randn(768, 768, generator=g) * 768 ** -0.5).bfloat16())
    wq = wq.t().contiguous()
    a, xs = Q.quantize_rows_plain(x32)
    bias = (torch.randn(768, generator=g) * 0.1).bfloat16()
    ref = Q.gemm_s8_plain(a, xs, wq, ws, bias, "q8_qkv")
    vx = Q._s8_matmul(a, wq) * xs  # rounded, as the kernel rounds it
    # fma: the exact product plus b, one rounding (float64 holds the
    # product of two fp32 values exactly)
    fused = (vx.double() * ws.double() + bias.double()).float().bfloat16()
    assert (fused.float() - ref.float()).abs().max() <= C.MAX_ERR_OF_MAX * ref.float().abs().max()
    assert (fused != ref).any()
    with pytest.raises(AssertionError):
        C.check_equal("s8 qkv, dequant contracted", fused, ref)
