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
another order.  The engine's resume check rejects a loss or a leaf one ulp
off, and the bench check a value 11% off its phase's images/s.  The zoo's
leaf check (every trainable leaf's gradient finite and not zero) rejects a
CoCoOp meta-net whose bias was detached and a prompt head whose LayerNorms
ran the dx-only ``LayerNormFn``, and its launch check a chunked CoCoOp
count without the checkpoint's recompute.  ``[datasets]`` rejects a grain
eval batch one pixel off the threads loader's, a calibration that advanced
the training loader's epoch, an int8_ste_static step counted without the
static chain, and, under the grain pipeline, a resumed loss one ulp off.
``[remat]`` rejects a loss or a gradient one ulp off and a peak that did
not fall; ``[export]`` rejects an artifact's logits with the classes
shifted or the scale 10% off, and a ``pallas`` artifact rate 11% under
``[serving]``'s.  ``[mesh]`` passes one process's record against itself
and rejects the vision prompts' gradient counted once per model rank and a
loss over the local count of valid rows.  ``[fp32]``'s limits reject a GEMM
whose operands were rounded to TF32 and an fp32 attention half with its qkv
rounded once to bf16, and pass a change of fp32 sum order and products
split into three TF32 products (3xTF32, the fp32 kernels' tensor-core
design) at K = 768 and 3072, in the 199-row attention backward and in the
forward's online-softmax order at 199 and 16 causal rows, where one TF32
pass fails; the fp32 chain bound prices the bf16 form's work at the 3xTF32
rate and 4-byte activations; ``--times-of`` times every fp32 GEMM mode,
attention_f32 case both ways, fp32 s8 GEMM case and fp32 LayerNorm case
and ``--steps-of`` both fp32 trainers' steps (rehearsed with stubbed
timers); the fp32 LayerNorms' order of work (lane
sums, the shuffle tree, one or two rows a warp) meets their limit against
fp64 at 1,663 rows, while one row's statistics applied to its warp's other
row, a skipped tail of rows and a tail that lost its residual fail it; its launch
checks reject an fp32 run that launched a bf16 or int8 kernel, one that
launched no fp32 ``attention_bwd``, and one routed to XLA (no launch).
``[fp32 int8]``'s bit-equal check rejects an fp32 s8 epilogue that rounds
qkv or R + v through bf16, its code check LayerNorm-quant codes two steps
off, and its launch checks an fp32 int8 path that launched the bf16
LayerNorm-quant or s8 GEMM and a quantization-aware fp32 step without the
fp32 layer backward; its CoCoOp chunk probe a kernel site whose rows depend
on the batch and text features' gradients that differ chunked.  ``[probes]``'s
bit-equal checks reject an s8 rate-probe sum that saturates instead of
wrapping, a q8_recip quantizer that divides, a floor GEMM that applies the
weight scales, a q8_noclip code a step off q8's, and a floor convert that
wraps as torch's does.  The end-of-run process check rejects a child process
left running.  ``[text switches]``' case check rejects a pack, truncation or
recompute switch that the text module ignores, and its 77-token attention
check an attention that lets in the pad keys of packed (80, 77) rows;
``[tools]``' line check rejects a tool line that lacks a key, and its trace
check a profiler trace that holds fewer launches of a kernel than the
counter (or launches of a kernel the counter did not count).
``[periphery]``'s checks reject a Dassl export with two leaves' keys
swapped (the eval's prompts and the imported tree differ from the
trainer's), fp32 features off by one bf16 rounding, and a feature file
whose labels are out of the split's order.  ``[api]``'s checks reject a
``clip_forward`` launch count one off, a ``validate_zeroshot`` line whose
accuracy is not ``test()``'s, a ``--remat full`` final loss one ulp off
``none``'s, and a trainer's trace missing one launch; ``[export]``'s
serving child waits for the parent's word before its request."""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as tf

from mudpt_torch.ops import fused_block as F
from mudpt_torch.ops import quant_block as Q
from mudpt_torch.tools import f32_variants, ln_variants

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


def _run_leaves(seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(2, 512, generator=g), torch.randn(8, 2, 768, generator=g)]


def test_check_resumed_catches_last_bit():
    """[engine]'s resume check: a resumed loss or leaf one ulp off fails,
    the same values pass."""
    C = _chip_smoke()
    losses = [2.772588729858398, 2.7514, 2.70153546333313]
    leaves = _run_leaves(3)
    C.check_resumed(losses, list(losses), leaves, [t.clone() for t in leaves])
    off = list(losses)
    off[1] = float(np.nextafter(np.float32(off[1]), np.float32(0)))
    with pytest.raises(AssertionError, match="losses"):
        C.check_resumed(losses, off, leaves, leaves)
    with pytest.raises(AssertionError, match="losses"):
        C.check_resumed(losses, losses[:2], leaves, leaves)
    moved = [t.clone() for t in leaves]
    moved[1][3, 1, 5] = torch.nextafter(moved[1][3, 1, 5], torch.tensor(0.0))
    with pytest.raises(AssertionError, match="leaves"):
        C.check_resumed(losses, losses, leaves, moved)


@pytest.mark.parametrize("factor,ok", [(1.11, False), (0.89, False), (1.09, True),
                                       (0.91, True)])
def test_check_bench_holds_ten_percent(factor, ok):
    """[bench]: a value 11% off [train]'s or [serving]'s fails, 9% passes."""
    C = _chip_smoke()
    if ok:
        C.check_bench("train", 4578.0 * factor, 4578.0)
    else:
        with pytest.raises(AssertionError, match="limit 10%"):
            C.check_bench("train", 4578.0 * factor, 4578.0)


def test_parse_bench_line():
    C = _chip_smoke()
    line = ('{"metric": "MuDPT ViT-B/16 prompt-tuning train throughput", "value": 4500.0, '
            '"unit": "images/sec/chip", "device": "NVIDIA H100 80GB HBM3", "card": "x"}')
    assert C.parse_bench_line(line + "\n")["value"] == 4500.0
    with pytest.raises(AssertionError, match="lines"):
        C.parse_bench_line(line + "\n" + line)
    with pytest.raises(AssertionError, match="lacks"):
        C.parse_bench_line('{"metric": "m", "value": 1.0, "unit": "images/sec/chip"}')


def test_chain_bound_counts_the_layer():
    """The chain bound of the ViT-B/16 vision layer: its products at the
    bf16 peak (forward, then with the dx-only backward), the int8 forward's
    projections at the int8 peak, and a causal block's attended keys."""
    C = _chip_smoke()
    M, D, S = 384 * 199, 768, 199
    fwd = 2 * M * 12 * D * D + 4 * M * S * D
    assert C.chain_bound(384, S, D, False) == f"bound {fwd / 989e12 * 1e3:.4f} (operations)"
    both = 2 * fwd + 4 * M * S * D  # the backward: four score-sized products
    assert C.chain_bound(384, S, D, False, bwd=True) == f"bound {both / 989e12 * 1e3:.4f} (operations)"
    q8 = 2 * M * 12 * D * D / 1979e12 + 4 * M * S * D / 989e12
    assert C.chain_bound(384, S, D, False, int8=True) == f"bound {q8 * 1e3:.4f} (operations)"
    causal = 2 * 1600 * 12 * 512 ** 2 + 4 * 1600 * 8.5 * 512
    assert C.chain_bound(100, 16, 512, True) == f"bound {causal / 989e12 * 1e3:.4f} (operations)"


def test_chain_bound_fp32_prices_the_same_work_at_3xtf32_and_4_bytes():
    """The fp32 form of the chain bound counts the bf16 form's products and
    bytes: every product fp32-accurate as three TF32 products at 494.7
    TFLOP/s (but the int8 forward's projections, at the int8 peak), every
    activation and weight at 4 bytes (the int8 forward's weights at 1)."""
    C = _chip_smoke()
    M, D, S = 384 * 199, 768, 199
    proj, att = 2 * M * 12 * D * D, 4 * M * S * D
    tf32 = lambda ops: f"bound {3 * ops / 494.7e12 * 1e3:.4f} (operations)"  # noqa: E731
    assert C.chain_bound(384, S, D, False, fp32=True) == tf32(proj + att)
    assert C.chain_bound(384, S, D, False, bwd=True, fp32=True) == tf32(2 * proj + 3 * att)
    assert C.chain_bound(384, S, D, False, ("mlp",), bwd=True, fp32=True) == tf32(
        2 * 2 * M * 8 * D * D)
    q8 = proj / 1979e12 + 3 * att / 494.7e12
    assert C.chain_bound(384, S, D, False, int8=True, fp32=True) == f"bound {q8 * 1e3:.4f} (operations)"
    q8_train = proj / 1979e12 + 3 * (proj + 3 * att) / 494.7e12
    assert C.chain_bound(384, S, D, False, bwd=True, int8=True, fp32=True) == (
        f"bound {q8_train * 1e3:.4f} (operations)")
    # one causal text block of 16 rows: bound by its bytes, x and y and the
    # weights at 4 bytes (the int8 forward's weights at 1, its backward's at 4)
    nbytes = 16 * 512 * 4 * 2 + 12 * 512 ** 2 * 4
    assert C.chain_bound(1, 16, 512, True, fp32=True) == f"bound {nbytes / 3.35e12 * 1e3:.4f} (bytes)"
    nbytes = 16 * 512 * 4 * 4 + 12 * 512 ** 2 * (1 + 4)
    assert C.chain_bound(1, 16, 512, True, bwd=True, int8=True, fp32=True) == (
        f"bound {nbytes / 3.35e12 * 1e3:.4f} (bytes)")


@pytest.mark.parametrize("source", sorted(p.name for p in (ROOT / "mudpt_torch" / "csrc").glob("*.cu")))
def test_device_time_by_kernel_names_every_kernel_of_the_sources(source):
    """Every ``__global__`` of a ``mudpt_torch/csrc`` source, as the profiler
    names an instance of it, falls under a kernel of ``device_time_by_kernel``
    and none under 'other' (device time outside the kernels): a kernel that
    is renamed or added is still read in the traced steps."""
    import re
    from types import SimpleNamespace

    C = _chip_smoke()
    sample = {"int": "1", "bool": "true", "typename": "float"}
    events = []
    text = (ROOT / "mudpt_torch" / "csrc" / source).read_text()
    for m in re.finditer(r"(?:template\s*<([^>]*)>\s*)?__global__\s+void\s+"
                         r"(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(", text):
        params, name = m.group(1), m.group(2)
        args = ("<" + ", ".join(sample[p.split()[0]] for p in params.split(",")) + ">"
                if params else "")
        events.append(SimpleNamespace(key=f"void {name}{args}(float const*, int)",
                                      device_type=torch.autograd.DeviceType.CUDA,
                                      self_device_time_total=1.0))
    assert events, f"no kernel found in {source}"
    cats, by_kernel, others = C.device_time_by_kernel(
        SimpleNamespace(key_averages=lambda: events))
    assert others == {} and cats["other"] == 0.0
    assert sum(by_kernel.values()) == len(events)
    assert cats["forward kernels"] + cats["backward kernels"] == len(events)


def _tiny_zoo():
    """A tiny CLIP and its class buffers, on the CPU in fp32."""
    from mudpt_torch.models.clip import CLIPConfig, init_clip_params
    from mudpt_torch.trainers.prompt_utils import embed_classnames
    from mudpt_torch.utils.rng import new_rng

    cfg = CLIPConfig(embed_dim=64, image_resolution=32, vision_layers=2, vision_width=64,
                     vision_patch_size=16, transformer_width=64, transformer_heads=2,
                     transformer_layers=2)
    g = new_rng(0)
    params = init_clip_params(cfg, g)
    aux = embed_classnames(params["text"], ["cat", "dog", "bird"], 2, "X X").as_device_tree()
    images = torch.randn(2, 32, 32, 3, generator=g)
    return cfg, g, params, aux, images


def _leaf_grads(forward, trainable, params, aux, images, cfg):
    from mudpt_torch.models.clip import leaves

    for t in leaves(trainable):
        t.requires_grad_(True)
    logits = forward(trainable, params, aux, images, clip_cfg=cfg, compute_dtype=torch.float32)
    loss = tf.cross_entropy(logits, torch.tensor([0, 2]))
    return torch.autograd.grad(loss, leaves(trainable), allow_unused=True)


def test_leaf_check_catches_detached_meta_net_bias(monkeypatch):
    """A meta-net bias cut from the graph leaves both of its layers without
    a gradient; the sound forward gives every leaf one."""
    from mudpt_torch.models import layers
    from mudpt_torch.trainers import cocoop
    from mudpt_torch.trainers.prompt_utils import init_linear, random_ctx

    C = _chip_smoke()
    cfg, g, params, aux, images = _tiny_zoo()
    trainable = {"ctx": random_ctx(g, (2, 64)),
                 "meta_net": {"linear1": init_linear(g, 64, 4), "linear2": init_linear(g, 4, 64)}}
    names = C.leaf_names(trainable)
    C.check_leaf_grads(names, _leaf_grads(cocoop.cocoop_forward, trainable, params, aux,
                                          images, cfg))

    def detached_bias(p, x):
        y = layers.linear(p, x)
        return y.detach() if p is trainable["meta_net"]["linear2"] else y

    monkeypatch.setattr(cocoop, "linear", detached_bias)
    grads = _leaf_grads(cocoop.cocoop_forward, trainable, params, aux, images, cfg)
    with pytest.raises(AssertionError, match="meta_net/linear1/w: none or all zero"):
        C.check_leaf_grads(names, grads)


def test_leaf_check_catches_head_on_dx_only_layernorm(monkeypatch):
    """UMuDPT's t2v head with its LayerNorms on the towers' dx-only
    ``LayerNormFn`` (scale and bias taken as constants, as that Function
    needs): their leaves get no gradient."""
    from mudpt_torch.models import layers
    from mudpt_torch.trainers import prompt_utils, umudpt

    C = _chip_smoke()
    cfg, g, params, aux, images = _tiny_zoo()
    trainable = {"ctx": prompt_utils.random_ctx(g, (2, 64)),
                 "deep_prompts": prompt_utils.random_ctx(g, (1, 2, 64)),
                 "t2v": prompt_utils.init_prompt_transform_head(g, 64, 64)}
    names = C.leaf_names(trainable)
    C.check_leaf_grads(names, _leaf_grads(umudpt.umudpt_forward, trainable, params, aux,
                                          images, cfg))

    def dx_only(p, x, eps=1e-5):
        return layers.LayerNormFn.apply(x.contiguous(), p["scale"].detach(),
                                        p["bias"].detach(), eps)

    monkeypatch.setattr(prompt_utils, "layer_norm_trainable", dx_only)
    monkeypatch.setattr(layers, "layer_norm_trainable", dx_only)
    grads = _leaf_grads(umudpt.umudpt_forward, trainable, params, aux, images, cfg)
    with pytest.raises(AssertionError, match="t2v/ln_pre/scale: none or all zero"):
        C.check_leaf_grads(names, grads)


def test_launch_check_catches_chunked_count_without_recompute():
    """Chunked, each chunk's text forward runs twice (the checkpoint
    recomputes it in the backward); a count without that forward fails."""
    from mudpt_torch.models.clip import VIT_B32

    C = _chip_smoke()
    keys, cfg = F.LAUNCHES, VIT_B32
    want = C.cocoop_launches(keys, cfg, 2)
    without = C.expect(keys, (cfg.vision_layers, "full"), (1, C.tower_lns(2)),
                       (2 * cfg.transformer_layers, "half_train_saves_off"),
                       (2, C.tower_lns(1, 1)))
    with pytest.raises(AssertionError, match="launches differ"):
        C.check_launches("CoCoOp chunks of 2", without, want)
    recompute = C.expect(keys, (2 * cfg.transformer_layers, "half"), (2, C.tower_lns(1)))
    assert {k: want[k] - without[k] for k in keys} == recompute
    assert C.cocoop_launches(keys, cfg, 1) == C.expect(
        keys, (cfg.vision_layers, "full"), (1, C.tower_lns(2)),
        (cfg.transformer_layers, "half_train_saves_off"), (1, C.tower_lns(1, 1)))
    C.check_launches("CoCoOp chunks of 2", dict(want), want)


# ---------------------------------------------------------------------------
# [datasets]: its holds on the CPU (the loaders, the trainer and the CLI run
# here; on the card only their numbers change)
# ---------------------------------------------------------------------------

def _jpeg_items(tmp_path, n=9):
    from PIL import Image

    from mudpt_torch.data.datum import Datum

    rng = np.random.RandomState(4)
    items = []
    for i in range(n):
        p = tmp_path / f"{i}.jpg"
        Image.fromarray(rng.randint(0, 256, (24, 30, 3)).astype(np.uint8)).save(p)
        items.append(Datum(impath=str(p), label=i % 3, classname=f"c{i % 3}"))
    return items


def test_batches_check_catches_a_pixel_off(tmp_path):
    """grain's and the threads loader's eval batches (both EvalTransform)
    pass bit-equal; one pixel of one grain batch one ulp off fails."""
    from mudpt_torch.data.grain_pipeline import GrainLoader
    from mudpt_torch.data.loader import DataLoader
    from mudpt_torch.data.transforms import EvalTransform

    C = _chip_smoke()
    items = _jpeg_items(tmp_path)
    grain = list(GrainLoader(items, EvalTransform(size=16), 4))
    threads = list(DataLoader(items, EvalTransform(size=16), 4, num_workers=2))
    assert C.check_batches_equal("eval", grain, threads) == "3 batches bit-equal"
    grain[1]["image"] = grain[1]["image"].copy()
    grain[1]["image"][2, 5, 7, 1] = np.nextafter(grain[1]["image"][2, 5, 7, 1], np.float32(9))
    with pytest.raises(AssertionError, match="batch 1 image differs"):
        C.check_batches_equal("eval", grain, threads)
    with pytest.raises(AssertionError, match="no batch"):
        C.check_batches_equal("eval", [], threads)


def test_epoch_check_catches_calibration_that_advanced_the_loader(tmp_path):
    """A static-int8 build leaves the training loader at epoch 0; a
    calibration fetch that does not restore the epoch (the loader's
    ``__iter__`` counts it) fails."""
    from mudpt_torch.models import layers
    from tests.test_torch_static_calib import port_cfg
    from mudpt_torch.trainers import build_trainer

    C = _chip_smoke()
    try:
        tr = build_trainer(port_cfg("MuDPT", tmp_path, "int8_static"), devices="cpu")
    finally:
        layers.set_quant_mode("none")
    loader = tr.dm.train_loader
    C.check_epoch_kept("build", loader, 0)
    next(iter(loader))  # the fetch, without the restore
    with pytest.raises(AssertionError, match="epoch moved 0 -> 1"):
        C.check_epoch_kept("calibration", loader, 0)


def test_launch_check_catches_step_without_static_chain():
    """An int8_ste_static step runs the static chain (row 17) in both
    towers; a count of the dynamic chain (quant_rows twice a layer, no
    static Function) fails."""
    from mudpt_torch.models.clip import VIT_B16

    C = _chip_smoke()
    keys = F.LAUNCHES
    want = C.step_launches(F, VIT_B16, "q8s_train", "q8s_train")
    dynamic = C.step_launches(F, VIT_B16, "q8_train", "q8_train")
    with pytest.raises(AssertionError, match="launches differ"):
        C.check_launches("int8_ste_static step", dynamic, want)
    assert want["layer_fullblock_q8_ste_static"] == 24 and want["quant_rows"] == 24
    assert want == C.expect(keys, (12, "q8s_train"), (12, "q8s_train"),
                            (1, C.tower_lns(3, 3)))


def test_resume_check_under_grain_catches_last_bit(tmp_path):
    """Under DATALOADER.PIPELINE grain a run preempted after batch 2 and
    resumed (the engine on the CPU, JPEGs in the Caltech101 layout) passes
    [datasets]' resume check; a resumed loss one ulp off fails."""
    from PIL import Image

    from mudpt_torch.config import load_config
    from mudpt_torch.models.clip import leaves
    from mudpt_torch.trainers import build_trainer

    C = _chip_smoke()
    img_root = tmp_path / "data" / "caltech101" / "caltech-101" / "101_ObjectCategories"
    rng = np.random.RandomState(5)
    for c in range(4):
        (img_root / f"object_{c}").mkdir(parents=True)
        for i in range(10):
            Image.fromarray(rng.randint(0, 256, (24, 30, 3)).astype(np.uint8)).save(
                img_root / f"object_{c}" / f"{i}.jpg")

    def trainer(out, *more):
        cfg = load_config("configs/datasets/caltech101.yaml", "configs/trainers/test/tiny.yaml",
                          opts=["TRAINER.NAME", "MuDPT", "DATASET.ROOT", str(tmp_path / "data"),
                                "DATALOADER.PIPELINE", "grain", "DATALOADER.TRAIN_X.BATCH_SIZE",
                                "4", "TRAIN.PRINT_FREQ", "1", "TEST.NO_TEST", "True",
                                "OUTPUT_DIR", str(out), *more])
        return build_trainer(cfg, devices="cpu")

    full = trainer(tmp_path / "full")
    full.train()
    part = trainer(tmp_path / "part")
    step = part._train_step

    def preempting(b):
        out = step(b)
        if part.global_step == 1:
            part._preempt = True
        return out

    part._train_step = preempting
    part.train()
    resumed = trainer(tmp_path / "part", "RESUME", str(tmp_path / "part"))
    resumed.train()
    losses = C._train_losses(str(tmp_path / "full"))
    got = C._train_losses(str(tmp_path / "part"))
    assert len(losses) == len(full.dm.train_loader) == 5
    C.check_resumed(losses, got, leaves(full.trainable), leaves(resumed.trainable))
    got[3] = float(np.nextafter(np.float32(got[3]), np.float32(0)))
    with pytest.raises(AssertionError, match="losses"):
        C.check_resumed(losses, got, leaves(full.trainable), leaves(resumed.trainable))


def test_process_check_catches_a_process_left_running():
    """The end-of-run check passes a process with nothing left running; a
    child still running fails it, and is stopped by it."""
    import subprocess
    import sys

    C = _chip_smoke()
    assert C.check_no_process_left() == "no process left running"
    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(120)"])
    try:
        assert child.pid in C.descendants(os.getpid())
        with pytest.raises(AssertionError, match="processes left running"):
            C.check_no_process_left()
        assert child.poll() is not None
        assert C.descendants(os.getpid()) == []
    finally:
        child.kill()
        child.wait()


def _remat_readings(seed):
    g = torch.Generator().manual_seed(seed)
    loss = torch.tensor(2.7725887, dtype=torch.float32)
    return loss, [torch.randn(2, 512, generator=g), torch.randn(8, 2, 768, generator=g)]


def test_remat_check_catches_one_ulp_and_a_peak_that_did_not_fall():
    """[remat]: REMAT 'full' against 'none' passes bit-equal readings and a
    lower peak; a gradient or the loss one ulp off fails, and so does a
    peak that did not fall."""
    C = _chip_smoke()
    none = _remat_readings(5)
    same = (none[0].clone(), [t.clone() for t in none[1]])
    peaks = (58.9 * 2 ** 30, 17.2 * 2 ** 30)
    assert "bit-equal" in C.check_remat("336px", none, same, peaks)
    grads = [t.clone() for t in none[1]]
    grads[1][7, 1, 300] = torch.nextafter(grads[1][7, 1, 300], torch.tensor(0.0))
    with pytest.raises(AssertionError, match=r"gradients of leaves \[1\]"):
        C.check_remat("336px", none, (none[0], grads), peaks)
    loss = torch.nextafter(none[0], torch.tensor(0.0))
    with pytest.raises(AssertionError, match="loss"):
        C.check_remat("336px", none, (loss, none[1]), peaks)
    with pytest.raises(AssertionError, match="did not fall"):
        C.check_remat("336px", none, same, (peaks[0], peaks[0]))


def test_hold_logits_catches_shifted_classes_and_a_scale_off():
    """[export]: an artifact's logits against the tier in process.  A
    one-ulp rounding passes; the classes shifted by one (a classname order
    the program does not serve) and the logit scale 10% off fail."""
    C = _chip_smoke()
    g = torch.Generator().manual_seed(9)
    img = tf.normalize(torch.randn(384, 512, generator=g), dim=-1)
    txt = tf.normalize(torch.randn(100, 512, generator=g), dim=-1)
    ref = 100.0 * img @ txt.T
    C.hold_logits(torch.nextafter(ref, torch.zeros(())), ref)
    with pytest.raises(AssertionError):
        C.hold_logits(ref.roll(1, dims=-1), ref)
    with pytest.raises(AssertionError, match="drift"):
        C.hold_logits(ref * 0.9, ref)


@pytest.mark.parametrize("factor,ok", [(0.89, False), (1.11, False), (0.91, True),
                                       (1.09, True)])
def test_artifact_rate_holds_ten_percent(factor, ok):
    """[export]: the pallas artifact's images/s 11% under (or over)
    [serving]'s fails, 9% passes."""
    C = _chip_smoke()
    if ok:
        C.check_artifact_rate(11868.3 * factor, 11868.3)
    else:
        with pytest.raises(AssertionError, match="limit 10%"):
            C.check_artifact_rate(11868.3 * factor, 11868.3)


# ---------------------------------------------------------------------------
# the int8 surface at ViT-L/14, over the zoo and in CoCoOp; the RN trunk
# ---------------------------------------------------------------------------

def test_qat_route_and_launch_check_catch_the_saving_branch_at_384():
    """[train ViT-L/14 int8_ste]: at D = 1024 the quantization-aware layer
    saves within the wide-MLP row-token budget (batch 32) and recomputes
    over it (batch 384); a step counted on the saving branch at 384 fails
    the launch check."""
    from mudpt_torch.models.clip import VIT_L14

    C = _chip_smoke()
    rows = VIT_L14.vision_seq_len + 2
    assert C.qat_route(F, 1024, 384 * rows, "int8_ste") == "q8_train_recompute"
    assert C.qat_route(F, 1024, 32 * rows, "int8_ste") == "q8_train"
    assert C.qat_route(F, 768, 384 * rows, "int8_ste_static") == "q8s_train"
    with F.saved_acts(False):
        assert C.qat_route(F, 768, 32 * rows, "int8_ste") == "q8_train_recompute"
    want = C.step_launches(F, VIT_L14, "q8_train", "q8_train_recompute")
    saving = C.step_launches(F, VIT_L14, "q8_train", "q8_train")
    with pytest.raises(AssertionError, match="launches differ"):
        C.check_launches("train ViT-L/14 int8_ste at 384", saving, want)
    # the recompute is the q8 forward once more in each vision layer's backward
    again = C.expect(F.LAUNCHES, (VIT_L14.vision_layers, dict(
        layernorm_q8=2, gemm_s8_epilogue=4, attention_fwd=1, quant_rows=2)))
    assert {k: want[k] - saving[k] for k in want} == again


def test_launch_check_catches_cocoop_int8_on_the_unquantized_chain():
    """[cocoop int8]: a CoCoOp logit computed on the bf16 chains (the quant
    mode lost, or a chunk's recompute routed without it) launches
    layer_fullblock and the half-blocks instead of the q8 chain: the launch
    check fails; under int8_ste chunked, a count without the checkpoint's
    quantization-aware forward fails too."""
    from mudpt_torch.models.clip import VIT_B32

    C = _chip_smoke()
    keys, cfg = F.LAUNCHES, VIT_B32
    want = C.cocoop_launches(keys, cfg, 2, "int8")
    unquantized = C.expect(keys, (cfg.vision_layers, "full"), (1, C.tower_lns(2)),
                           (2 * cfg.transformer_layers, "half"), (2, C.tower_lns(1)))
    with pytest.raises(AssertionError, match="launches differ"):
        C.check_launches("CoCoOp int8", unquantized, want)
    C.check_launches("CoCoOp int8", dict(want), want)
    ste = C.cocoop_launches(keys, cfg, 2, "int8_ste")
    without = C.expect(keys, (cfg.vision_layers, "q8"), (1, C.tower_lns(2)),
                       (2 * cfg.transformer_layers, "q8_train_recompute"),
                       (2, C.tower_lns(1, 1)))
    with pytest.raises(AssertionError, match="launches differ"):
        C.check_launches("CoCoOp int8_ste chunks of 2", without, ste)
    assert ste["layer_fullblock_q8_ste"] == 4 * cfg.transformer_layers


def test_bit_equal_check_catches_a_chunked_qat_loss_one_ulp_off():
    """[cocoop int8]: chunked against unchunked under int8_ste passes
    bit-equal outputs; a loss (or a gradient) one ulp off fails."""
    C = _chip_smoke()
    g = torch.Generator().manual_seed(3)
    out = (torch.randn(4, 1000, generator=g), torch.randn(4, 512, generator=g))
    same = tuple(t.clone() for t in out)
    assert "2 outputs bit-equal" in C.check_bit_equal("CoCoOp int8_ste", same, out)
    loss = torch.tensor(6.9077, dtype=torch.float32)
    with pytest.raises(AssertionError, match=r"outputs \[0\]"):
        C.check_bit_equal("chunked QAT loss", (torch.nextafter(loss, torch.zeros(())),),
                          (loss,))
    grad = out[1].clone()
    grad[2, 100] = torch.nextafter(grad[2, 100], torch.zeros(()))
    with pytest.raises(AssertionError, match=r"outputs \[1\]"):
        C.check_bit_equal("CoCoOp int8_ste", (out[0], grad), out)


def test_rn_feature_check_catches_batch_norm_folded_in_bf16(monkeypatch):
    """[rn]: the bf16 RN tower's features against its fp32 run, with
    ``rn_bn_stats``' statistics, at RN50's stages (64 px, 4 images): the
    tower as written passes RN50's limit; BatchNorm folded in the compute
    dtype (scale and bias from bf16 statistics) fails it."""
    import dataclasses

    from mudpt_torch.models import resnet
    from mudpt_torch.models.clip import RN50, _init_resnet_visual

    C = _chip_smoke()
    cfg = dataclasses.replace(RN50, image_resolution=64)
    g = torch.Generator().manual_seed(0)
    visual = _init_resnet_visual(g, cfg)
    images = torch.randn(4, 64, 64, 3, generator=g)
    limit = C.RN_FEATURE_NORM_ERR
    assert "relative norm error" in C.rn_feature_check(visual, cfg, images, "RN50", limit)

    def folded_in_compute_dtype(p, x, eps=1e-5):
        scale = p["scale"].to(x.dtype) * torch.rsqrt(p["var"].to(x.dtype) + eps)
        bias = p["bias"].to(x.dtype) - p["mean"].to(x.dtype) * scale
        return x * scale[:, None, None] + bias[:, None, None]

    monkeypatch.setattr(resnet, "batch_norm", folded_in_compute_dtype)
    with pytest.raises(AssertionError, match="bf16 features vs fp32"):
        C.rn_feature_check(visual, cfg, images, "RN50", limit)


# the [mesh] phase's check at test-tiny on the CPU: one process's record of
# MuDPT's steps (chip_smoke.mesh_record) passes against itself; a record
# whose first step counted the vision prompts' gradient twice (a plain
# all-reduce over a model axis of 2, whose ranks hold the same images) and
# one whose loss divided by the local count of valid rows (a data axis of
# 2) fail
MESH_TINY = ("MODEL.BACKBONE.NAME", "test-tiny", "INPUT.SIZE", "(32, 32)",
             "TRAINER.MUDPT.PREC", "fp32", "DATALOADER.TRAIN_X.BATCH_SIZE", "16",
             "DATALOADER.TEST.BATCH_SIZE", "16", "DATASET.SYNTHETIC_PER_CLASS", "8")


@pytest.fixture(scope="module")
def mesh_record(tmp_path_factory):
    """chip_smoke.mesh_record of MuDPT at test-tiny on the CPU, and the
    trainer's first global batch with its vision and text gradient parts."""
    import torch.nn.functional as F_

    from mudpt_torch.config import load_config
    from mudpt_torch.trainers.base import build_trainer

    C = _chip_smoke()
    C.MESH_DEVICE = "cpu"
    C.MESH_OPTS = C.MESH_OPTS + MESH_TINY
    tmp = tmp_path_factory.mktemp("mesh_check")
    prev_threads, sync = torch.get_num_threads(), torch.cuda.synchronize
    torch.set_num_threads(2)
    torch.cuda.synchronize = lambda *a: None
    try:
        ref = C.mesh_record(ROOT, "MuDPT", C.ENGINE_FILES[1], (), str(tmp / "ref"))
        cfg = load_config(*(str(ROOT / f) for f in C.ENGINE_FILES), opts=[
            *C.ENGINE_OPTS, *C.MESH_OPTS, "OUTPUT_DIR", str(tmp / "parts")])
        tr = build_trainer(cfg, devices="cpu")
        batch = next(iter(tr.dm.train_loader))
        b = tr._device_batch(batch)
        n = tr.num_classes

        def grads(logits_fn, denom_of):
            nll = F_.cross_entropy(logits_fn()[:, :n], b["label"], reduction="none")
            loss = sum(nll[rows].sum() / denom_of(rows) for rows in (slice(0, 8), slice(8, 16)))
            gs = torch.autograd.grad(loss, tr._params, allow_unused=True)
            return float(loss.detach()), [np.zeros(tuple(p.shape), np.float32) if g is None
                                          else g.numpy() for g, p in zip(gs, tr._params)]

        full = lambda: tr.forward(tr.trainable, tr.frozen, tr.aux, b["image"])  # noqa: E731
        txt = tr.forward_text(tr.trainable, tr.frozen, tr.aux).detach()
        vision = lambda: tr.forward_image(tr.trainable, tr.frozen, tr.aux, b["image"], txt)  # noqa: E731
        parts = {"vision": grads(vision, lambda rows: 16)[1],
                 "local": grads(full, lambda rows: 8)}
    finally:
        torch.set_num_threads(prev_threads)
        torch.cuda.synchronize = sync
    return C, ref, C.leaf_names(tr.trainable), parts


def test_mesh_check_passes_one_process_against_itself(mesh_record):
    C, ref, _, _ = mesh_record
    reading = C.check_mesh_run("MuDPT (1,2)", [dict(ref), dict(ref)], ref)
    assert "replicas bit-equal" in reading


def test_mesh_check_catches_vision_gradient_counted_per_model_rank(mesh_record):
    """A world all-reduce without the 1/n_model share: the text part of
    each gradient is right (each rank sent its class block), the vision
    part counted twice.  Mixed leaves (ctx feeds both towers) shift too."""
    C, ref, names, parts = mesh_record
    fault = dict(ref)
    for k, g in zip(names, parts["vision"]):
        fault[f"grad/{k}"] = ref[f"grad/{k}"] + g
    with pytest.raises(AssertionError, match="rank 0 vs one process: gradients"):
        C.check_mesh_run("MuDPT (1,2)", [fault, fault], ref)


def test_mesh_check_catches_loss_over_local_valid_rows(mesh_record):
    """Each of two data ranks divides by its own 8 valid rows: the data
    group's sum is twice the global batch's mean."""
    C, ref, names, parts = mesh_record
    loss, grads = parts["local"]
    fault = dict(ref, losses=np.asarray([loss] + list(ref["losses"][1:])))
    fault.update({f"grad/{k}": g for k, g in zip(names, grads)})
    with pytest.raises(AssertionError, match="rank 0 vs one process: first loss .*; gradients"):
        C.check_mesh_run("MuDPT (2,1)", [fault, fault], ref)


# ---- [fp32]: the fp32 kernels and chains against plain fp32 torch ops


def _f32_operands(seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(M, K, generator=g), torch.randn(K, N, generator=g) * K ** -0.5,
            torch.randn(N, generator=g) * 0.1)


def _tf32(t):
    """``t`` rounded to TF32's 10-bit mantissa, to nearest even: a
    single-pass TF32 product's operands."""
    i = t.view(torch.int32)
    return ((i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF).view(torch.float32)


def test_fp32_kernel_limit_catches_tf32_products_and_passes_sum_order():
    """A GEMM whose operands were rounded to TF32 reads 2^-11.7 of the fp32
    product (the limit 2^-14); the fp32 product summed in two halves of K,
    another order, passes."""
    C = _chip_smoke()
    a, w, b = _f32_operands(3)
    ref = F.gemm_epilogue_plain(a, w, b, "qkv")
    tf32 = F.gemm_epilogue_plain(_tf32(a), _tf32(w), b, "qkv")
    norm = ((tf32 - ref).norm() / ref.norm()).item()
    assert 2.0 ** -13 < norm < 2.0 ** -9
    with pytest.raises(AssertionError, match="relative norm|max abs err"):
        C.check_f32("gemm_f32 qkv, TF32 operands", tf32, ref)
    h = K // 2
    C.check_f32("gemm_f32 qkv, two halves of K", a[:, :h] @ w[:h] + a[:, h:] @ w[h:] + b, ref)


def _tf32x3_matmul(a, b):
    """``a @ b`` as the fp32 kernels' tensor cores compute it: each operand
    split into hi = _tf32(x) and lo = _tf32(x - hi), then lo.hi + hi.lo +
    hi.hi in fp32 sums, lo.lo dropped."""
    a_hi, b_hi = _tf32(a.contiguous()), _tf32(b.contiguous())
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    mm = torch.Tensor.__matmul__
    return mm(a_lo, b_hi) + mm(a_hi, b_lo) + mm(a_hi, b_hi)


def _tf32_matmul(a, b):
    return torch.Tensor.__matmul__(_tf32(a.contiguous()), _tf32(b.contiguous()))


def _attention_online(qkv, n_head: int, causal, step: int = 32):
    """attention_fwd_f32's order of work: one pass over ``step``-row key
    steps, each row's running max m and sum l of exp2(u - m) (u = s *
    log2(e), masked scores at -1e30), the output rescaled by exp2(m_old -
    m) as m grows and multiplied by 1 / l at the end; every product through
    torch.matmul."""
    B, S, D3 = qkv.shape
    q, k, v, L, is_causal, valid = F._split_heads(qkv, n_head, causal)
    row = torch.arange(L)[:, None]
    m = torch.full((*q.shape[:-1], 1), -float("inf"))
    l, o = torch.zeros_like(m), torch.zeros_like(q)
    for k0 in range(0, L, step):
        col = torch.arange(k0, min(k0 + step, L))[None, :]
        s = torch.matmul(q, k[..., k0:k0 + step, :].transpose(-1, -2)) * q.shape[-1] ** -0.5
        masked = (col >= valid) | ((col > row) & is_causal)
        u = torch.where(masked, s + F.NEG, s) * 1.4426950408889634
        m_new = torch.maximum(m, u.amax(-1, keepdim=True))
        alpha, p = torch.exp2(m - m_new), torch.exp2(u - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + torch.matmul(p, v[..., k0:k0 + step, :])
        m = m_new
    return (o * (1 / l)).permute(0, 2, 1, 3).reshape(B, S, D3 // 3)


@pytest.mark.parametrize("case", ["qkv K=768", "store_f32 K=3072", "attention_bwd L=199",
                                  "attention_fwd L=199", "attention_fwd causal L=16"])
def test_fp32_kernel_limit_passes_3xtf32_and_catches_one_tf32_pass(case, monkeypatch):
    """The premise of the fp32 GEMM's and attention's tensor-core design:
    every product as three TF32 products (3xTF32) meets the fp32 kernels'
    limits (2^-14 in norm, 2^-12 of the largest value) at the GEMM's K =
    768 and 3072, at the attention backward's 199-row blocks (its five
    products over the head dim and over the block) and in the forward's
    one-pass online-softmax order at the vision tower's 199-row blocks and
    a causal text block of 16 rows, each against the plain version, while
    one TF32 pass fails them."""
    C = _chip_smoke()
    g = torch.Generator().manual_seed(17)
    if case.startswith("attention_fwd"):
        S = int(case.rsplit("L=", 1)[1])
        causal = "causal" in case
        qkv = torch.randn(4 if causal else 2, S, 3 * 128, generator=g)
        fn = lambda: _attention_online(qkv, 2, causal)  # noqa: E731
        ref = F.attention_plain(qkv, 2, causal)
    elif case.startswith("attention"):
        qkv = torch.randn(2, 199, 3 * 128, generator=g)
        do = torch.randn(2, 199, 128, generator=g) * 0.1
        fn = lambda: F.attention_bwd_plain(qkv, do, 2)  # noqa: E731
    else:
        ep, k = case.split(" K=")
        k = int(k)
        a = torch.randn(M, k, generator=g)
        w = torch.randn(N, k, generator=g) * k ** -0.5
        b = None
        if ep == "qkv":
            w, b = w.t().contiguous(), torch.randn(N, generator=g) * 0.1
        fn = lambda: F.gemm_epilogue_plain(a, w, b, ep)  # noqa: E731
    if not case.startswith("attention_fwd"):
        ref = fn()
    with monkeypatch.context() as mp:
        mp.setattr(torch, "matmul", _tf32x3_matmul)
        split = fn()
    with monkeypatch.context() as mp:
        mp.setattr(torch, "matmul", _tf32_matmul)
        one_pass = fn()
    C.check_f32(f"{case}, 3xTF32", split, ref)
    with pytest.raises(AssertionError, match="relative norm|max abs err"):
        C.check_f32(f"{case}, one TF32 pass", one_pass, ref)


@pytest.mark.parametrize("variant", range(len(f32_variants.VARIANTS)))
def test_f32_variants_replace_text_the_sources_hold_once(variant):
    """``mudpt_torch.tools.f32_variants`` builds each variant by replacing
    one constant or condition of a kernel source: each must stand in the
    source exactly once, or the variant would silently be the kernel."""
    from mudpt_torch.ops import _build

    name, _, old, new = f32_variants.VARIANTS[variant]
    text = (_build.CSRC / f"{name}.cu").read_text()
    assert text.count(old) == 1 and old != new


def test_f32_variants_refuse_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no card"):
        f32_variants.main()


@pytest.mark.parametrize("variant", range(len(ln_variants.VARIANTS)))
def test_ln_variants_replace_text_the_sources_hold_once(variant):
    """``mudpt_torch.tools.ln_variants`` builds each variant of the bf16
    LayerNorm dx and of LayerNorm-quant by replacing one constant of its
    source: each must stand in the source exactly once."""
    from mudpt_torch.ops import _build

    name, _, old, new = ln_variants.VARIANTS[variant]
    text = (_build.CSRC / f"{name}.cu").read_text()
    assert text.count(old) == 1 and old != new


def test_ln_variants_refuse_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no card"):
        ln_variants.main()


def test_chip_smoke_layernorm_widths_cover_every_preset():
    """``[kernels*]`` holds the bf16 LayerNorm dx, and ``[kernels int8*]``
    LayerNorm-quant, at every width that a preset of the port reaches: the
    towers of ``synth_step.MODELS`` and of the named backbones (the RN
    presets' text towers among them; the CPU's test-tiny sizes aside), and,
    for the dx, the chunked half's ``CHUNKED`` shapes and its widest D
    (``CHUNKED_MAX_WIDTH``).  ``--times-of`` reads both kernels at every
    one of these widths too."""
    from mudpt_torch.trainers.base import NAMED_CONFIGS
    from mudpt_torch.utils.synth_step import MODELS

    C = _chip_smoke()
    towers = set()
    for name, cfg in {**MODELS, **NAMED_CONFIGS}.items():
        if name.startswith("test-tiny"):
            continue
        towers.add(cfg.transformer_width)
        if cfg.vision_arch == "vit":
            towers.add(cfg.vision_width)
    assert towers == {512, 640, 768, 1024}
    chunked = {D for *_, D in C.CHUNKED} | {F.CHUNKED_MAX_WIDTH}
    assert towers | chunked <= C.ln_bwd_widths()
    assert towers <= C.q8_ln_widths()
    assert towers | chunked <= {D for _, D, *_ in C.LN_BWD_AB}
    assert towers <= {D for _, D, *_ in C.Q8_LN_AB}
    # a width missing from the list fails the check
    lacking = {c[1] for c in C.SHAPES["ViT-B/16"]["ln_bwd"] if c[1] != 640}
    assert not towers <= lacking | {D for _, D, _ in C.CHUNKED_LN_BWD}


def test_times_of_times_and_digests_every_layernorm_case(monkeypatch):
    """``--times-of`` times, and digests the bits of, the bf16 LayerNorm dx
    at every case of ``LN_BWD_AB`` (fp32 and bf16 dxn, with a residual and
    without) and LayerNorm-quant at every case of ``Q8_LN_AB`` (bf16 and
    fp32 rows, dynamic, static and the probe's three ablations), the
    cases also queued, through the public wrappers: rehearsed
    on the CPU at small row counts with the card's timers stubbed and the
    GEMM cases left out; each call's output is its plain version's."""
    from mudpt_torch.ops import probe as P

    C = _chip_smoke()
    cpu = torch.Generator().manual_seed(6)

    def randn_fn(seed):
        return lambda *shape, std=1.0, dtype=torch.bfloat16: (
            torch.randn(shape, generator=cpu) * std).to(dtype)

    timed = []
    monkeypatch.setattr(C, "randn_fn", randn_fn)
    monkeypatch.setattr(C, "time_ms", lambda fn, iters=10: timed.append(fn()) or 1.0)
    monkeypatch.setattr(C, "queued_ms", lambda fn, iters=10: (1.0, 2.0))
    for name in ("Q8_GEMM", "F32_Q8_GEMM", "FP32_GEMM", "FP32_ATTN_BWD", "FP32_LN"):
        monkeypatch.setattr(C, name, ())
    monkeypatch.setattr(C, "SHAPES", {})
    monkeypatch.setattr(C, "M_B", 24)
    monkeypatch.setattr(C, "M_L", 12)
    ln = tuple((rows // 8192 + 3, *more) for rows, *more in C.LN_BWD_AB)
    q8 = tuple((rows // 8192 + 3, *more) for rows, *more in C.Q8_LN_AB)
    monkeypatch.setattr(C, "LN_BWD_AB", ln)
    monkeypatch.setattr(C, "Q8_LN_AB", q8)
    want_ln = {f"layernorm_bwd {rows}x{D} {C.DTYPE_TAGS[dt]} dxn{' + r' if r else ''}"
               for rows, D, dt, r in ln}
    assert {k.split()[2] for k in want_ln} == {"fp32", "bf16"}
    want_q8 = set()
    for rows, D, dt, modes in q8:
        for mode in modes:
            name = "layernorm_q8" + ("_f32" if dt == "float32" else "")
            want_q8.add(f"{name}_{mode[3:]} {rows}x{D}" if mode in P.ABLATIONS else
                        f"{name} {rows}x{D} {'static' if mode == 'q8_static' else 'dynamic'}")
    assert len(want_ln) == len(ln) == 14 and len(want_q8) == 16
    assert {k.split()[0] for k in want_q8} == {
        "layernorm_q8", "layernorm_q8_f32", "layernorm_q8_recip", "layernorm_q8_noclip",
        "layernorm_q8_floor"}
    times = C.kernel_times(F)
    cases = want_ln | want_q8 | {f"quant_rows 24x{X} {kind}" for X in (768, 3072)
                                 for kind in ("dynamic", "static")}
    assert set(times) == {k + how for k in cases for how in ("", " device", " host us")}
    assert all(torch.isfinite(t.float()).all() for r in timed
               for t in (r if isinstance(r, tuple) else (r,)) if t is not None)
    digests = C.kernel_digests(F)
    assert want_ln | want_q8 <= set(digests)
    assert {k for k in digests if k.startswith("layernorm_fwd")} == {
        "layernorm_fwd 24x768", "layernorm_fwd 12x1024", "layernorm_fwd 2048x1280"}
    # the calls are the plain versions on CPU tensors: the same bits twice
    rn = randn_fn(0)
    for key, fn in C.ln_bwd_cases(F, rn):
        assert torch.equal(fn(), fn()), key


def test_times_of_times_every_fp32_case(monkeypatch):
    """``--times-of`` times the fp32 GEMM's every mode (``FP32_GEMM``),
    attention_fwd_f32 and attention_bwd_f32 at every block of
    ``FP32_ATTN_BWD``, also queued, the fp32 s8 GEMM at every case of
    ``F32_Q8_GEMM`` (both models' rows, dynamic and static, h saved or
    not), and the fp32 LayerNorms at every row count of ``FP32_LN`` (D =
    768, 512, 1024, 1280), forward and dx with a residual and without, also
    queued, through the public wrappers: rehearsed on the CPU at small
    shapes with the card's timers stubbed, the bf16 and int8 cases left
    out."""
    C = _chip_smoke()
    cpu = torch.Generator().manual_seed(5)

    def randn_fn(seed):
        return lambda *shape, std=1.0, dtype=torch.bfloat16: (
            torch.randn(shape, generator=cpu) * std).to(dtype)

    timed = []

    def time_ms(fn, iters=10):
        timed.append(fn())
        return 1.0

    monkeypatch.setattr(C, "randn_fn", randn_fn)
    monkeypatch.setattr(C, "time_ms", time_ms)
    monkeypatch.setattr(C, "queued_ms", lambda fn, iters=10: (time_ms(fn), 2.0))
    monkeypatch.setattr(C, "q8_row_cases", lambda F, Q, rn: [])
    monkeypatch.setattr(C, "ln_bwd_cases", lambda F, rn: [])
    monkeypatch.setattr(C, "Q8_GEMM", ())
    monkeypatch.setattr(C, "SHAPES", {})
    monkeypatch.setattr(C, "FP32_GEMM", tuple((ep, 96, K // 12, N // 48, n)
                                              for ep, _, K, N, n in C.FP32_GEMM))
    monkeypatch.setattr(C, "FP32_ATTN_BWD", tuple(
        (label, 2, 2 * causal[0] if isinstance(causal, tuple) else min(S, 70), 2, causal)
        for label, B, S, H, causal in C.FP32_ATTN_BWD))
    monkeypatch.setattr(C, "F32_Q8_GEMM", tuple((ep, 96, K // 16, N // 16, *more)
                                                for ep, _, K, N, *more in C.F32_Q8_GEMM))
    assert [D for _, D in C.FP32_LN] == [768, 512, 1024, 1280]
    monkeypatch.setattr(C, "FP32_LN", tuple((rows // 796 + 1, D // 8) for rows, D in C.FP32_LN))
    times = C.kernel_times(F)
    gemm = {k for k in times if k.startswith("gemm_f32_epilogue")}
    attn = [k for k in times if k.startswith("attention_bwd_f32")]
    fwd = [k for k in times if k.startswith("attention_fwd_f32")]
    s8 = {k for k in times if k.startswith("gemm_s8_epilogue_f32")}
    assert gemm == {f"gemm_f32_epilogue {ep} 96x{K}->{N}" for ep, _, K, N, _ in C.FP32_GEMM}
    assert len(gemm) == 11
    assert {k.split()[1] for k in gemm} == set(F.EPILOGUES) - {"chunk_residual", "add_f32"}
    assert len(attn) == len(fwd) == 3 * len(C.FP32_ATTN_BWD) == 15
    assert {k.replace("_bwd_", "_fwd_") for k in attn} == set(fwd)
    assert s8 == {f"gemm_s8_epilogue_f32 {ep}{' save h' if save else ''} 96x{K}->{N}"
                  for ep, _, K, N, save, *_ in C.F32_Q8_GEMM}
    assert len(s8) == 20
    assert {k.split()[1] for k in s8} == {f"{kind}_{ep}" for kind in ("q8", "q8s")
                                          for ep in ("qkv", "residual", "fc_gelu")}
    ln = {k for k in times if k.startswith("layernorm_")}
    assert ln == {f"{name} {rows}x{D}{how}" for rows, D in C.FP32_LN
                  for name in ("layernorm_fwd_f32", "layernorm_bwd_f32 dx + r",
                               "layernorm_bwd_f32 dx")
                  for how in ("", " device", " host us")}
    assert len(ln) == 36
    assert len(times) == len(gemm) + len(attn) + len(fwd) + len(s8) + len(ln)
    # timed, and the attention and LayerNorm cases queued too
    assert len(timed) == len(gemm) + 4 * len(C.FP32_ATTN_BWD) + len(s8) + 2 * len(ln) // 3
    assert all(torch.isfinite(t).all() for r in timed for t in (r if isinstance(r, tuple) else (r,)))


# ---- the fp32 LayerNorms (csrc/layernorm_{fwd,bwd}.cu): each row's order
# of work, and the grid's order of rows


def _lane_sums(terms):
    """The fp32 kernels' row sums of ``terms`` (n, D): lane l adds the
    elements of its 16-byte vectors l, l + 32, ... in order, then the warp
    adds its 32 lane sums by the xor shuffle tree (16, 8, 4, 2, 1)."""
    n, D = terms.shape
    per = -(-(D // 4) // 32)
    padded = np.zeros((n, per * 128), np.float32)
    padded[:, :D] = terms
    padded = padded.reshape(n, per, 32, 4)
    acc = np.zeros((n, 32), np.float32)
    for i in range(per):
        for j in range(4):
            acc = acc + padded[:, i, :, j]
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ o]
    return acc[:, 0]


def _ln_rows(x, scale, bias=None, dxn=None, r=None, rows_a_warp=1, warps=4, fault=None,
             eps=1e-5):
    """layernorm_fwd's (``dxn`` None) or layernorm_bwd's fp32 rows in their
    kernels' order, in fp32: blocks of ``warps`` warps, ``rows_a_warp``
    consecutive rows a warp, every load of a warp's rows issued before its
    first reduction (a row past the end reads the last row's bytes and is
    not written); a row's statistics in ``_lane_sums``' order.  Faults:
    "rows crossed" (a row's statistics applied to its warp's other row's
    bytes), "tail skipped" (the grid rounds its blocks down), "tail without
    r" (the last block's rows lose their residual)."""
    f = np.float32
    rows, D = x.shape
    per_block = rows_a_warp * warps
    blocks = rows // per_block if fault == "tail skipped" else -(-rows // per_block)
    out = np.zeros_like(x)
    first = np.arange(blocks * warps) * rows_a_warp
    for q in range(rows_a_warp):
        row = first + q
        src = np.minimum(row, rows - 1)
        dst = np.minimum(first + (q + 1) % rows_a_warp, rows - 1) if fault == "rows crossed" \
            else src
        xs = x[src]
        mean = _lane_sums(xs) / f(D)
        dev = xs - mean[:, None]
        inv = (f(1) / np.sqrt(_lane_sums(dev * dev) / f(D) + f(eps))).astype(f)
        xhat = (x[dst] - mean[:, None]) * inv[:, None]
        if dxn is None:
            o = xhat * scale + bias
        else:
            g = dxn[src] * scale
            gm = _lane_sums(g) / f(D)
            gx = _lane_sums(g * (dev * inv[:, None])) / f(D)
            o = (dxn[dst] * scale - gm[:, None] - xhat * gx[:, None]) * inv[:, None]
            if r is not None:
                lost = (row >= (blocks - 1) * per_block) & (fault == "tail without r")
                o = np.where(lost[:, None], o, r[dst] + o)
        keep = row < rows
        out[row[keep]] = o[keep]
    return out


def _ln_fp64(x, scale, bias=None, dxn=None, r=None, eps=1e-5):
    """The same function in fp64, two-pass statistics."""
    x = x.astype(np.float64)
    mean = x.mean(-1, keepdims=True)
    inv = 1 / np.sqrt(((x - mean) ** 2).mean(-1, keepdims=True) + eps)
    xhat = (x - mean) * inv
    if dxn is None:
        return xhat * scale + bias
    g = dxn * scale.astype(np.float64)
    dx = (g - g.mean(-1, keepdims=True) - xhat * (g * xhat).mean(-1, keepdims=True)) * inv
    return dx if r is None else r + dx


def _ln_case(way, rows, D, seed=19):
    rng = np.random.default_rng(seed)
    f = np.float32
    args = dict(x=(rng.standard_normal((rows, D)) * 2).astype(f),
                scale=(rng.standard_normal(D) * 0.1 + 1).astype(f))
    if way == "forward":
        args["bias"] = (rng.standard_normal(D) * 0.1).astype(f)
    else:
        args["dxn"] = rng.standard_normal((rows, D)).astype(f)
        if way == "dx + r":
            args["r"] = rng.standard_normal((rows, D)).astype(f)
    return args


@pytest.mark.parametrize("way, D, rows_a_warp", [(way, D, 1) for way in ("forward", "dx + r", "dx")
                                                 for D in (512, 768, 1280)]
                         + [(way, 768, 2) for way in ("forward", "dx + r", "dx")])
def test_ln_fp32_order_meets_the_fp32_layernorm_limit(way, D, rows_a_warp):
    """The fp32 LayerNorms' order of work (lane sums, the shuffle tree,
    two-pass statistics, one or two rows a warp, blocks of four warps) at
    1,663 rows, a count that no block's rows divide, meets
    ``F32_LN_NORM_ERR`` (2^-16) against fp64 at ViT-B/16's widths and the
    chunked half's 1280."""
    C = _chip_smoke()
    args = _ln_case(way, 1663, D)
    got = torch.from_numpy(_ln_rows(**args, rows_a_warp=rows_a_warp))
    C.check_f32(f"fp32 LayerNorm {way} 1663x{D}", got, torch.from_numpy(_ln_fp64(**args)),
                norm_limit=C.F32_LN_NORM_ERR)


@pytest.mark.parametrize("fault, way", [("rows crossed", "dx + r"), ("rows crossed", "forward"),
                                        ("tail skipped", "forward"), ("tail skipped", "dx"),
                                        ("tail without r", "dx + r")])
def test_ln_fp32_check_catches_a_row_fault(fault, way):
    """The same check rejects a warp that applies one row's mean and
    inverse to its other row's bytes (two rows a warp), a grid that skips
    the 3 rows of 1,663 past its last whole block, and one where those rows
    lose their residual."""
    C = _chip_smoke()
    args = _ln_case(way, 1663, 768)
    got = torch.from_numpy(_ln_rows(**args, rows_a_warp=2 if fault == "rows crossed" else 1,
                                    fault=fault))
    with pytest.raises(AssertionError, match="relative norm|max abs err"):
        C.check_f32(f"fp32 LayerNorm {way}, {fault}", got, torch.from_numpy(_ln_fp64(**args)),
                    norm_limit=C.F32_LN_NORM_ERR)


def test_steps_of_times_both_fp32_trainers(monkeypatch, capsys):
    """``--steps-of ROOT`` builds [engine]'s MuDPT under PREC fp32 and under
    PREC fp32 with TRAIN.QUANT int8_ste on the tree at ROOT, times each
    one's step at 64 and on the 384 images as one batch and the fp32
    encode, and prints them on one JSON line: rehearsed on the CPU with the
    trainers, the kernel build and the card's timers stubbed."""
    import json
    from types import SimpleNamespace

    from mudpt_torch.ops import _build

    C = _chip_smoke()
    built = []

    class Trainer:
        trainable = frozen = aux = None

        def __init__(self):
            self.dm = SimpleNamespace(train_loader=[{"image": torch.zeros(64, 3)}] * 6)

        def _device_batch(self, batch):
            return batch

        def _text_features(self, *args):
            return None

        def _eval_step_cached(self, *args):
            return None

    monkeypatch.setattr(C, "_engine_trainer", lambda root, out, *more: (
        built.append((root, more)), Trainer())[1])
    monkeypatch.setattr(C, "fp32_timed", lambda tr, batch, n: (len(batch["image"]) + n / 100, 1.0))
    monkeypatch.setattr(C, "_synced_ms", lambda fn: (fn(), 7.0)[1])
    monkeypatch.setattr(C, "smi", lambda: "stub card")
    monkeypatch.setattr(_build, "load", lambda: {})
    assert C.steps_of(ROOT) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    steps = {"step 64": 64 + C.TIMED_STEPS / 100, "step 384": 384 + C.AB_STEPS / 100}
    assert line == {"steps_of": str(ROOT), "card": "stub card", "fp32 encode 384": 7.0,
                    **{f"{label} {k}": v for label in ("fp32", "fp32 int8_ste")
                       for k, v in steps.items()}}
    assert built == [(ROOT, ("OPTIM.MAX_EPOCH", "1", *C.FP32_OPTS)),
                     (ROOT, ("OPTIM.MAX_EPOCH", "1", "TRAIN.QUANT", "int8_ste", *C.FP32_OPTS))]


def _f32_attn_half(seed, D=128, H=2):
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s, std=1.0: torch.randn(*s, generator=g) * std  # noqa: E731
    p = (torch.ones(D), torch.zeros(D), rn(D, 3 * D, std=D ** -0.5), rn(3 * D, std=0.1),
         rn(D, D, std=D ** -0.5), rn(D, std=0.1))
    return rn(2, 33, D), p, H


def test_fp32_chain_limit_catches_one_bf16_rounding():
    """The attention half in fp32 with its qkv rounded once to bf16 (a cast
    to bf16 and back anywhere in the chain) reads 2^-10.4 in norm, 2^-10.0
    of the largest value, and fails the chain limits (2^-12, 2^-10); the
    same chain, exact, passes."""
    C = _chip_smoke()
    x, p, H = _f32_attn_half(4)
    ref = F.attn_halfblock_plain(x, *p, H)

    def gemm(a, w, bias, ep, extra=None, out=None):
        y = F.gemm_epilogue_plain(a, w, bias, ep, extra, out)
        return y.bfloat16().float() if ep == "qkv" else y

    fns = (F.layer_norm_plain, gemm, *F._PLAIN[2:])
    got = F._attn_chain(fns, x, *p, H, False)[0]
    with pytest.raises(AssertionError, match="relative norm|max abs err"):
        C.check_f32("attn_halfblock fp32, qkv rounded to bf16", got, ref,
                    norm_limit=C.F32_CHAIN_NORM_ERR, max_limit=C.F32_CHAIN_MAX_ERR)
    C.check_f32("attn_halfblock fp32", F._attn_chain(F._PLAIN, x, *p, H, False)[0], ref,
                norm_limit=C.F32_CHAIN_NORM_ERR, max_limit=C.F32_CHAIN_MAX_ERR)


def _fp32_step_counts(C):
    return C.in_fp32(F, C.expect(F.LAUNCHES, (24, "full_train"), (1, C.tower_lns(3, 3))))


def test_fp32_launch_check_passes_the_fp32_step():
    C = _chip_smoke()
    assert "fp32 kernels only" in C.check_fp32_launches(F, "fp32 step", _fp32_step_counts(C))


@pytest.mark.parametrize("fault", ["a bf16 GEMM", "no fp32 attention_bwd", "the XLA route",
                                   "an int8 kernel"])
def test_fp32_launch_check_catches_a_wrong_route(fault):
    """An fp32 run that launched a bf16 (or int8) kernel, one that launched
    no fp32 kernel of a kind it needs, and one routed to XLA (no launch at
    all) each fail."""
    C = _chip_smoke()
    got = _fp32_step_counts(C)
    if fault == "a bf16 GEMM":
        got["gemm_bf16_epilogue"] = 1
    elif fault == "no fp32 attention_bwd":
        got["attention_bwd_f32"] = 0
    elif fault == "the XLA route":
        got = dict.fromkeys(F.LAUNCHES, 0)
    else:
        got["quant_rows"] = 24
    with pytest.raises(AssertionError, match="launched"):
        C.check_fp32_launches(F, "fp32 step", got)
    with pytest.raises(AssertionError, match="launches differ"):
        C.check_launches("fp32 step", got, _fp32_step_counts(C))


# ---- [fp32 int8]: the int8 tiers on fp32 activations


def _f32_s8_case(ep):
    """The args of an fp32 s8 GEMM case and its plain output."""
    g = torch.Generator().manual_seed(8)
    x32 = torch.randn(96, 64, generator=g)
    wq, ws = Q.quantize_cols(torch.randn(64, 128, generator=g) * 0.125)
    a, xs = Q.quantize_rows_plain(x32)
    extra = torch.randn(96, 128, generator=g) if ep.endswith("residual") else None
    args = (a, xs, wq.t().contiguous(), ws, torch.randn(128, generator=g) * 0.1, ep, extra,
            None, False, torch.float32)
    return args, Q.gemm_s8_plain(*args)


@pytest.mark.parametrize("ep", ["q8_qkv", "q8_residual"])
def test_fp32_s8_check_catches_a_bf16_rounding(ep):
    """gemm_s8_epilogue_f32 is held bit-equal: its qkv (or R + v) rounded
    through bf16 -- the bf16 kernel's epilogue on fp32 tensors -- fails;
    the fp32 epilogue passes."""
    C = _chip_smoke()
    args, ref = _f32_s8_case(ep)
    v = Q._s8_matmul(args[0], args[2]) * args[1] * args[3] + args[4]
    faulty = v.bfloat16().float() if ep == "q8_qkv" else (args[6].bfloat16()
                                                          + v.bfloat16()).float()
    with pytest.raises(AssertionError, match="max abs err"):
        C.check_equal(f"gemm_s8_epilogue_f32 {ep}, bf16-rounded", faulty, ref)
    C.check_equal(f"gemm_s8_epilogue_f32 {ep}", Q.gemm_s8(*args), ref)


def test_fp32_codes_check_catches_codes_two_steps_off():
    """layernorm_q8_f32's codes are held within one step: every code two
    steps off fails, as does one code two steps off among otherwise equal
    codes."""
    C = _chip_smoke()
    g = torch.Generator().manual_seed(9)
    x = torch.randn(256, 128, generator=g) * 2
    s, b = torch.randn(128, generator=g) * 0.1 + 1, torch.randn(128, generator=g) * 0.1
    ref = Q.ln_quant_plain(x, s, b)[0]
    C.check_codes("layernorm_q8_f32", Q.ln_quant(x, s, b)[0], ref)
    off = (ref.int() + 2).clamp(-127, 127).to(torch.int8)
    with pytest.raises(AssertionError, match="max abs err"):
        C.check_codes("layernorm_q8_f32, two steps off", off, ref)
    one = ref.clone()
    one[3, 5] = ref[3, 5] - 2 if ref[3, 5] > 0 else ref[3, 5] + 2
    with pytest.raises(AssertionError, match="max abs err"):
        C.check_codes("layernorm_q8_f32, one code two steps off", one, ref)


def _fp32_q8_step_counts(C, route="q8_train"):
    """The launches of an fp32 step under a quantization-aware tier at
    ViT-B/16: every layer on the q8 chain, the fp32 backward."""
    from mudpt_torch.models.clip import VIT_B16

    return C.in_fp32(F, C.step_launches(F, VIT_B16, route, route))


def test_fp32_q8_launch_check_passes_the_fp32_qat_step():
    C = _chip_smoke()
    got = _fp32_q8_step_counts(C)
    assert got["layernorm_q8_f32"] == 48 and got["gemm_s8_epilogue_f32"] == 96
    assert got["quant_rows"] == 48 and got["gemm_f32_epilogue"] == 96
    assert all(got[k] == 0 for k in C.kernel_groups(F)[0] + ["layernorm_q8", "gemm_s8_epilogue"])
    assert "fp32 kernels only" in C.check_fp32_launches(F, "fp32 int8_ste step", got, quant=True)
    # and the unquantized fp32 check refuses it: an int8 kernel there is a wrong route
    with pytest.raises(AssertionError, match="launched"):
        C.check_fp32_launches(F, "fp32 step", got)


@pytest.mark.parametrize("fault", ["a bf16 layernorm_q8", "a bf16 gemm_s8_epilogue",
                                   "no fp32 backward", "the bf16 backward"])
def test_fp32_q8_launch_check_catches_a_wrong_route(fault):
    """An fp32 path under an int8 tier that launched the bf16 LayerNorm-quant
    or s8 GEMM, a quantization-aware step without the fp32 layer backward
    (none, or the bf16 one) each fail the launch checks."""
    C = _chip_smoke()
    want = _fp32_q8_step_counts(C)
    got = dict(want)
    if fault == "a bf16 layernorm_q8":
        got["layernorm_q8"], got["layernorm_q8_f32"] = 1, want["layernorm_q8_f32"] - 1
    elif fault == "a bf16 gemm_s8_epilogue":
        got["gemm_s8_epilogue"], got["gemm_s8_epilogue_f32"] = 1, want["gemm_s8_epilogue_f32"] - 1
    else:
        bwd = ("gemm_f32_epilogue", "layernorm_bwd_f32", "attention_bwd_f32")
        for k in bwd:
            got[k] = 0
        if fault == "the bf16 backward":
            got.update(gemm_bf16_epilogue=want["gemm_f32_epilogue"],
                       layernorm_bwd=want["layernorm_bwd_f32"],
                       attention_bwd=want["attention_bwd_f32"])
    with pytest.raises(AssertionError, match="launched"):
        C.check_fp32_launches(F, "fp32 int8_ste step", got, quant=True)
    with pytest.raises(AssertionError, match="launches differ"):
        C.check_launches("fp32 int8_ste step", got, want)


def _chunk_taps(tower, dfeat_off=0.0):
    """Taps of an unchunked encode of 8 rows and of two chunks of 4, as
    ``chip_smoke.TextTaps.by_site`` returns them: the features' gradients
    (``dfeat_off`` added to the second chunk's), ln_final a row-wise scale
    and the tower ``tower``, each with its input and output gradients."""
    g = torch.Generator().manual_seed(13)
    x, w = torch.randn(8, 6, generator=g), torch.randn(6, 6, generator=g)
    ln = {"s": torch.randn(6, generator=g)}
    dy = torch.randn(8, 6, generator=g)

    def rec(site, fn, p, xx, dyy):
        xx = xx.clone().requires_grad_(True)
        (dxx,) = torch.autograd.grad(fn(p, xx), xx, dyy)
        return {"site": site, "fn": fn, "p": p, "x": xx.detach(), "args": (), "kw": {},
                "dy": dyy, "dx": dxx}

    def recs(rows, off):
        d = dy[rows] + off
        return {"text_forward": [rec("text_forward", lambda p, v: v @ p["projection"],
                                     {"projection": w}, x[rows], d)],
                "layer_norm": [rec("layer_norm", lambda p, v: v * p["s"], ln, x[rows], d)],
                "transformer_forward": [rec("transformer_forward", tower, {}, x[rows], d)]}

    whole, first, second = recs(slice(0, 8), 0), recs(slice(0, 4), 0), recs(slice(4, 8), dfeat_off)
    return whole, {k: first[k] + second[k] for k in whole}


@pytest.mark.parametrize("fault", [None, "a tower whose rows depend on the batch",
                                   "the features' gradients one ulp apart"])
def test_chunk_cause_catches_a_batch_dependent_kernel(fault):
    """``[fp32 int8]``'s CoCoOp chunk probe passes row-wise sites and the
    same features' gradients, and fails a kernel site whose rows depend on
    the batch (replayed on a chunk's rows against all) and features'
    gradients that differ chunked."""
    C = _chip_smoke()
    tower = ((lambda p, v: v * v.shape[0]) if fault == "a tower whose rows depend on the batch"
             else (lambda p, v: torch.tanh(v)))
    whole, chunks = _chunk_taps(tower, 1e-6 if fault == "the features' gradients one ulp apart"
                                else 0.0)
    if fault is None:
        assert "replayed" in C.chunk_cause(whole, chunks, "none")
    else:
        with pytest.raises(AssertionError, match="bit-equal|differ chunked"):
            C.chunk_cause(whole, chunks, "none")


# ---------------------------------------------------------------------------
# [probes]: the probes of tools/ (ops/probe.py)
# ---------------------------------------------------------------------------

def test_probe_s8_check_catches_a_saturating_sum():
    """Positive codes wrap every output at G = 320: the bit-equal check
    passes the plain version's wrapped sums and rejects sums that saturate
    at the int32 range instead."""
    from mudpt_torch.ops import probe as P

    C = _chip_smoke()
    g = torch.Generator().manual_seed(21)
    lo, hi = C.PROBE_WRAP_CODES
    xs = torch.randint(lo, hi, (16, 8, 256), generator=g).to(torch.int8)
    wt = torch.randint(lo, hi, (16, 256), generator=g).to(torch.int8)
    ref = P.mma_probe_plain(xs, wt, 320)
    exact = torch.matmul(xs.long(), wt.long().t()).sum(0) * 320
    assert (exact.abs() >= 2 ** 31).all()
    C.check_equal("probe_mma s8", P.mma_probe(xs, wt, 320), ref)
    with pytest.raises(AssertionError, match="max abs err"):
        C.check_equal("probe_mma s8", exact.clamp(-2 ** 31, 2 ** 31 - 1).int(), ref)


def test_probe_recip_check_catches_a_division():
    """Rows whose absmax is 889: x / (889 / 127) = x / 7 lands on the ties
    k + 1/2 exactly, x * fp32(127 / 889) an ulp above them from k = 86 up, so
    a q8_recip quantizer that divides (the q8 codes) takes the even
    neighbour where the multiply rounds up, and the bit-equal check of
    quant_rows_recip rejects it."""
    from mudpt_torch.ops import probe as P

    C = _chip_smoke()
    row = torch.tensor([889.0] + [7.0 * k + 3.5 for k in range(86, 127)])
    x = torch.stack([row, -row])
    ref, s = P.quantize_rows_mode_plain(x, "q8_recip")
    divides = Q.quantize_rows_plain(x)[0]
    assert (ref != divides).any() and s[0].item() == 7.0
    C.check_equal("quant_rows q8_recip", ref, ref)
    with pytest.raises(AssertionError, match="max abs err"):
        C.check_equal("quant_rows q8_recip", divides, ref)


def test_probe_floor_gemm_check_catches_the_scales():
    """The floor's products carry no scale: an epilogue that applies the
    weight scales (the static one) fails the bit-equal check."""
    from mudpt_torch.ops import probe as P

    C = _chip_smoke()
    g = torch.Generator().manual_seed(22)
    a = P.sat_s8(torch.randn(64, 128, generator=g) * 2)
    wq, ws = Q.quantize_cols(torch.randn(128, 96, generator=g) * 128 ** -0.5)
    wq = wq.t().contiguous()
    bias = (torch.randn(96, generator=g) * 0.1).bfloat16()
    ref = Q.gemm_s8_plain(a, None, wq, ws, bias, "q8f_qkv")
    with pytest.raises(AssertionError, match="max abs err"):
        C.check_equal("gemm_s8_epilogue q8f_qkv", Q.gemm_s8_plain(a, None, wq, ws, bias,
                                                                 "q8s_qkv"), ref)


def test_probe_noclip_check_catches_a_code_off_q8():
    """q8_noclip's codes are held equal to q8's: one code a step off fails."""
    from mudpt_torch.ops import probe as P

    C = _chip_smoke()
    x = torch.randn(32, 256, generator=torch.Generator().manual_seed(23))
    q8 = Q.quantize_rows_plain(x)[0]
    noclip = P.quantize_rows_mode_plain(x, "q8_noclip")[0]
    C.check_equal("q8_noclip codes vs q8", noclip, q8)
    off = noclip.clone()
    off[3, 7] += 1 if off[3, 7] < 127 else -1
    with pytest.raises(AssertionError, match="max abs err"):
        C.check_equal("q8_noclip codes vs q8", off, q8)


def test_probe_floor_check_catches_a_wrapping_convert():
    """The floor converts as XLA does (saturating, NaN to 0): torch's own
    convert, which wraps 300 to 44, fails the bit-equal check, and gives
    other codes than [probes]' specials expect."""
    from mudpt_torch.ops import probe as P

    C = _chip_smoke()
    x = torch.randn(16, 256, generator=torch.Generator().manual_seed(24)) * 200
    with pytest.raises(AssertionError, match="max abs err"):
        C.check_equal("quant_rows q8_floor", x.to(torch.int8), P.sat_s8(x))
    finite = torch.tensor(C.PROBE_FLOOR_SPECIALS[:5])
    assert P.sat_s8(finite).tolist() == [127, -128, 127, -128, 127]
    assert finite[:4].to(torch.int8).tolist() != [127, -128, 127, -128]


# ---------------------------------------------------------------------------
# [text switches] and [tools]: the text tower's switches, 77-token attention,
# the tools' lines
# ---------------------------------------------------------------------------

def _tiny_text():
    from mudpt_torch.models.clip import TINY_TEST, init_clip_params

    return init_clip_params(TINY_TEST, torch.Generator().manual_seed(0))["text"]


@pytest.mark.parametrize("fault", [None, "pack", "trunc", "recompute"])
def test_text_switch_case_catches_an_ignored_switch(monkeypatch, fault):
    """``[text switches]``' case check passes each switch obeyed, and fails
    a switch that the text module ignores: the pack switch (the tower takes
    its rows unpacked), the truncation switch (the class rows stay cut) and
    the recompute switch (the layers keep the whole saving block)."""
    from mudpt_torch.models import text

    C = _chip_smoke()
    names = [f"object number {i}" for i in range(20)]
    case = {None: (4, "0", "1"), "pack": (4, "auto", "auto"), "trunc": (1, "0", "auto"),
            "recompute": (1, "auto", "1")}[fault]
    if fault is not None:
        monkeypatch.setattr(text, f"set_text_{'truncate' if fault == 'trunc' else fault}",
                            lambda v: None)
    run = lambda: C.text_switch_case(F, _tiny_text(), names, case, 1, device="cpu",  # noqa: E731
                                     hold_launches=False)
    if fault is None:
        r = run()
        assert (r["S"], r["G"], r["route"]) == (77, 4, "half_train_saves_off")
    else:
        with pytest.raises(AssertionError, match="the tower took|rows of|blocks"):
            run()


def test_attention_77_check_catches_pad_keys_let_in():
    """The 77-token attention checks hold the packed (80, 77) rows whole: an
    attention that reads the pad keys past each block's 77 valid rows fails
    both ways, while the packed rows' valid outputs pass against the
    unpacked causal 77-row blocks."""
    C = _chip_smoke()
    g = torch.Generator().manual_seed(31)
    qkv = torch.randn(2, 320, 3 * 128, generator=g).bfloat16()
    do = (torch.randn(2, 320, 128, generator=g) * 0.1).bfloat16()
    ref = F.attention_plain(qkv, 2, (80, 77))
    with pytest.raises(AssertionError, match="share of differing|max abs err|relative norm"):
        C.check_close("attention_fwd packed (80, 77)", F.attention_plain(qkv, 2, (80, 80)), ref)
    with pytest.raises(AssertionError, match="share of differing|max abs err|relative norm"):
        C.check_close("attention_bwd packed (80, 77)", F.attention_bwd_plain(qkv, do, 2, (80, 80)),
                      F.attention_bwd_plain(qkv, do, 2, (80, 77)))
    blocks = qkv.view(8, 80, 3 * 128)[:, :77]
    unpacked = F.attention_plain(blocks, 2, True)
    C.check_close("attention_fwd packed vs unpacked", ref.view(8, 80, 128)[:, :77], unpacked)


def test_tool_line_check_catches_a_missing_key():
    """``[tools]``' line check passes a line with its tool's keys, and fails
    one that lacks a key, carries an error, or holds a number that is not
    finite."""
    C = _chip_smoke()
    line = {"metric": "CoCoOp", "value": 120.5, "unit": "ms/step", "img_per_sec": 66.4,
            "text_trunc": "auto", "encode_chunk": 0, "final_loss": 6.9}
    assert C.check_tool_line("bench_cocoop", line, ("final_loss",)) is line
    for bad in ({k: v for k, v in line.items() if k != "img_per_sec"},
                {k: v for k, v in line.items() if k != "final_loss"},
                dict(line, error="RuntimeError: out of memory"),
                dict(line, final_loss=float("nan"))):
        with pytest.raises(AssertionError, match="lacks|not finite"):
            C.check_tool_line("bench_cocoop", bad, ("final_loss",))


def _profile_step_launches(F, steps: int) -> dict:
    """The launch counter after ``steps`` bf16 MuDPT train steps, each the
    route's 24 whole layers with the towers' LayerNorms."""
    C = _chip_smoke()
    per = C.expect(F.LAUNCHES, (24, "full_train"), (1, C.tower_lns(3, 3)))
    return {k: v * steps for k, v in per.items()}


def _traced(F, launches: dict, steps: int, of: int) -> dict:
    """A trace of ``steps`` of the ``of`` steps, every launch in it, the
    GEMMs spread over their template arguments."""
    C = _chip_smoke()
    out = {}
    for kernel, counts in C.TRACE_COUNTS.items():
        n = sum(launches.get(c, 0) for c in counts) * steps // of
        if n and kernel.startswith("gemm"):
            out[f"{kernel}<0, 1>"], out[f"{kernel}<6, 2>"] = n - n // 3, n // 3
        elif n:
            out[kernel] = n
    return out


def test_trace_check_catches_missing_launches():
    """``[tools]`` holds profile_step's trace to the counter: a trace with
    every launch of the 3 traced steps (of 5 counted) passes; one that lost
    the window's first launches of a kernel, or that names a kernel the
    counter did not count, fails.  ``TRACE_COUNTS`` names every kernel of
    ``utils/profiling.KERNELS`` and maps every count of ``F.KERNELS``."""
    from mudpt_torch.utils.profiling import KERNELS

    C = _chip_smoke()
    assert set(C.TRACE_COUNTS) == {*KERNELS, "gemm_bf16_kernel", "gemm_f32_kernel"}
    mapped = [c for counts in C.TRACE_COUNTS.values() for c in counts]
    assert sorted(set(mapped)) == sorted(F.KERNELS)
    launches = _profile_step_launches(F, 5)
    traced = _traced(F, launches, 3, 5)
    assert traced["layernorm_fwd_kernel"] == 3 * (24 * 2 + 3)
    assert "every launch" in C.check_trace_launches("profile_step", traced, launches, 3, 5)
    for bad in (dict(traced, attention_fwd_wgmma_kernel=traced["attention_fwd_wgmma_kernel"] - 6),
                dict(traced, attn_bwd_key_kernel=traced["attn_bwd_key_kernel"] - 1),
                {**traced, "gemm_bf16_kernel<0, 1>": traced["gemm_bf16_kernel<0, 1>"] - 7},
                dict(traced, quant_rows_kernel=12)):
        with pytest.raises(AssertionError, match="differ from the counter"):
            C.check_trace_launches("profile_step", bad, launches, 3, 5)
    with pytest.raises(AssertionError, match="split evenly"):
        C.check_trace_launches("profile_step", traced, launches, 3, 4)


def test_trace_launches_read_from_a_chrome_trace(tmp_path):
    """``utils/profiling.kernel_launches`` counts a Chrome trace's kernel
    events of the port's kernels by name, nothing else."""
    import json

    from mudpt_torch.utils.profiling import kernel_launches

    events = [{"ph": "X", "cat": "kernel", "name": "void gemm_bf16_kernel<3, 1>(CUtensorMap)"},
              {"ph": "X", "cat": "kernel", "name": "void gemm_bf16_kernel<3, 1>(CUtensorMap)"},
              {"ph": "X", "cat": "kernel", "name": "void attn_bwd_key_kernel<2>(CUtensorMap)"},
              {"ph": "X", "cat": "kernel", "name": "ampere_sgemm_128x64_nn"},
              {"ph": "X", "cat": "cpu_op", "name": "layernorm_fwd_kernel"}]
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": events}))
    assert kernel_launches(str(tmp_path / "t.json")) == {"gemm_bf16_kernel<3, 1>": 2,
                                                         "attn_bwd_key_kernel": 1}


def test_periphery_checks_catch_a_miskeyed_export(tmp_path):
    """``[periphery]`` holds the prompts an --eval_only loaded from the
    exported Dassl checkpoint to the trainer's: an export that swaps two
    same-shape leaves' keys loads without an error into a trainer's tree
    (``restore_into``), and the check rejects it; the right export passes."""
    from mudpt_torch.models import export_reference as TE
    from mudpt_torch.utils.checkpoint import load_checkpoint, restore_into

    C = _chip_smoke()
    g = torch.Generator().manual_seed(4)

    def lin(i, o):
        return {"w": torch.randn(i, o, generator=g), "b": torch.randn(o, generator=g)}

    tree = {"ctx": torch.randn(2, 16, generator=g), "deep_prompts": torch.randn(8, 2, 16, generator=g),
            "embed_projection": lin(16, 24), "deep_projections": lin(16, 24),
            "visual_ctx": torch.randn(2, 24, generator=g),
            "visual_ctx_deep_prompts": torch.randn(8, 2, 24, generator=g),
            "visual_ctx_deep_projections": lin(24, 16)}
    fresh = {k: ({kk: torch.zeros_like(vv) for kk, vv in v.items()} if isinstance(v, dict)
                 else torch.zeros_like(v)) for k, v in tree.items()}
    for swap in (False, True):
        sd, _ = TE.trainable_to_reference_state_dict(tree, "MuDPT")
        if swap:
            a, b = "mudpt_prompt_learner.embed_projection", "mudpt_prompt_learner.deep_projections"
            sd[f"{a}.weight"], sd[f"{b}.weight"] = sd[f"{b}.weight"], sd[f"{a}.weight"]
        d = tmp_path / str(swap) / "MultimodalDeepPromptTuning"
        d.mkdir(parents=True)
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}, "epoch": 1},
                   d / "model.pth.tar-1")
        loaded = restore_into(fresh, load_checkpoint(str(d.parent), d.name, 1)[0])
        if swap:
            with pytest.raises(AssertionError, match="leaves differ"):
                C.check_same_tree("eval prompts", tree, loaded)
        else:
            assert C.check_same_tree("eval prompts", tree, loaded) == "10 leaves bit-equal"


def test_periphery_feature_check_catches_a_bf16_rounding(tmp_path):
    """``[periphery]`` holds the fp32 extractor's features within the fp32
    chains' limits (2^-12) of the plain path: features rounded once to bf16
    fail, a change of fp32 sum order passes; the bf16 run's wider limits
    take that rounding; labels out of the split's order fail."""
    C = _chip_smoke()
    g = torch.Generator().manual_seed(5)
    x = torch.randn(64, 768, generator=g)
    w = torch.randn(768, 512, generator=g) * 768 ** -0.5
    ref = x @ w
    reordered = (x[:, :384] @ w[:384] + x[:, 384:] @ w[384:])
    labels = list(range(64))
    for feats, dtype, ok in ((reordered, "fp32", True), (ref.bfloat16().float(), "fp32", False),
                             (ref.bfloat16().float(), "bf16", True)):
        path = tmp_path / f"{dtype}_{ok}.npz"
        np.savez(path, feature_list=feats.numpy(), label_list=np.asarray(labels, np.int32))
        if ok:
            C.check_features("features", str(path), labels, ref, 512, dtype)
        else:
            with pytest.raises(AssertionError, match="relative norm error|max abs err"):
                C.check_features("features", str(path), labels, ref, 512, dtype)
    with pytest.raises(AssertionError, match="labels in order"):
        C.check_features("features", str(tmp_path / "fp32_True.npz"), labels[::-1], ref, 512,
                         "fp32")


def test_api_clip_forward_check_catches_a_launch_off_by_one():
    """``[api]`` (a) holds a ``clip_forward`` call to both towers' 12 + 12
    no-save layers and their three LayerNorms, on the dtype's kernels, and
    logits_per_text to the transpose: a count one off, or per-text logits
    that are not the transpose, fail."""
    from mudpt_torch.models.clip import VIT_B16

    C = _chip_smoke()
    want = C.clip_forward_launches(F, VIT_B16, False)
    assert want["layer_fullblock"] == 24 and want["layernorm_fwd"] == 24 * 2 + 3
    want32 = C.clip_forward_launches(F, VIT_B16, True)
    assert want32["layernorm_fwd_f32"] == want["layernorm_fwd"] and not want32["layernorm_fwd"]
    per_image = torch.randn(8, 5, generator=torch.Generator().manual_seed(7))
    assert "24 layer_fullblock" in C.check_clip_forward("bf16", dict(want), want, per_image,
                                                        per_image.T)
    for k in ("layer_fullblock", "attention_fwd", "gemm_bf16_epilogue"):
        with pytest.raises(AssertionError):
            C.check_clip_forward("bf16", dict(want, **{k: want[k] - 1}), want, per_image,
                                 per_image.T)
    with pytest.raises(AssertionError, match="transposed"):
        C.check_clip_forward("bf16", dict(want), want, per_image, per_image.T.flip(0))


def test_zeroshot_report_check_catches_another_accuracy():
    """``[api]`` (b) holds validate_zeroshot's report to exit 1 and the FAIL
    line of ``test()``'s accuracy on the same config: a line with another
    accuracy, or an exit 0, fails."""
    C = _chip_smoke()

    def report(acc):
        return (f"=> result on test: ...\ncaltech101: measured {acc:.2f} published 92.90 "
                f"delta {acc - 92.9:+.2f} [FAIL]\n\nFAILED: ['caltech101']\n")

    assert "measured 5.42" in C.check_zeroshot_report(report(5.4166), 1, "caltech101", 5.4166)
    for out, rc in ((report(5.83), 1), (report(5.4166), 0), ("", 1)):
        with pytest.raises(AssertionError, match="validate_zeroshot"):
            C.check_zeroshot_report(out, rc, "caltech101", 5.4166)


def _remat_bench_case():
    from mudpt_torch.models.clip import VIT_B16

    C = _chip_smoke()
    per_step = C.step_launches(F, VIT_B16, "full_train", "full_train")
    want = {"none": per_step, "full": C.expect(F.LAUNCHES, (1, per_step), (12, "full"),
                                               (12, "full"))}
    want = {m: {k: v * 7 for k, v in w.items()} for m, w in want.items()}
    recs = {"none": {"remat": "none", "value": 4391.57, "vs_baseline": 5.167,
                     "final_loss": 4.587772846221924, "model_tflops_per_sec": 338.18,
                     "exec_tflops_per_sec": 338.18},
            "full": {"remat": "full", "value": 2980.0, "vs_baseline": 3.506,
                     "final_loss": 4.587772846221924, "model_tflops_per_sec": 229.49,
                     "exec_tflops_per_sec": 340.42}}
    return C, recs, {m: dict(w) for m, w in want.items()}, want


def test_remat_bench_check_catches_a_loss_not_bit_equal():
    """``[api]`` (c) holds the bench under --remat full to none's final loss
    bit for bit, 48 layer_fullblock launches a step against 24 and
    vs_baseline the line's own: a loss one ulp off fails, and so do a full
    run counted without its recompute, a line whose remat is not the mode
    asked for and a vs_baseline that is not images/s over 850."""
    import math

    C, recs, launches, want = _remat_bench_case()
    assert launches["full"]["layer_fullblock"] == 48 * 7 == 2 * launches["none"][
        "layer_fullblock"]
    assert "bit-equal" in C.check_remat_bench(recs, launches, want)
    bad = dict(recs, full=dict(recs["full"], final_loss=math.nextafter(4.587772846221924, 5)))
    with pytest.raises(AssertionError, match="final loss"):
        C.check_remat_bench(bad, launches, want)
    with pytest.raises(AssertionError):
        C.check_remat_bench(recs, dict(launches, full=launches["none"]), want)
    with pytest.raises(AssertionError, match="remat 'none'"):
        C.check_remat_bench(dict(recs, full=dict(recs["full"], remat="none")), launches, want)
    with pytest.raises(AssertionError, match="vs_baseline"):
        C.check_remat_bench(dict(recs, none=dict(recs["none"], vs_baseline=4.392)),
                            launches, want)


def _trace_file(path, traced: dict, steps=("ProfilerStep#1",)):
    import json

    events = [{"ph": "X", "cat": "user_annotation", "name": s} for s in steps]
    for name, n in traced.items():
        events += [{"ph": "X", "cat": "kernel", "name": f"void {name}(CUtensorMap)"}] * n
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_trainer_trace_check_catches_a_missing_launch(tmp_path):
    """``[api]`` (d) holds the trainer's TRAIN.PROFILE_DIR trace to one
    recorded step (the profiler's step 1) holding every launch the counter
    counted for one of the epoch's six steps: a trace missing one launch,
    or recording two steps, fails."""
    C = _chip_smoke()
    launches = _profile_step_launches(F, 6)
    traced = _traced(F, launches, 1, 6)
    ok = _trace_file(tmp_path / "ok.json", traced)
    assert "every launch of the 1 traced steps" in C.check_trainer_trace("trace", ok, launches, 6)
    for name in ("layernorm_fwd_kernel", "attn_bwd_query_kernel", "gemm_bf16_kernel<6, 2>"):
        short = _trace_file(tmp_path / "short.json", dict(traced, **{name: traced[name] - 1}))
        with pytest.raises(AssertionError, match="differ from the counter"):
            C.check_trainer_trace("trace", short, launches, 6)
    two = _trace_file(tmp_path / "two.json", traced, ("ProfilerStep#1", "ProfilerStep#2"))
    with pytest.raises(AssertionError, match="records steps"):
        C.check_trainer_trace("trace", two, launches, 6)


def test_fresh_server_waits_for_the_word(tmp_path, monkeypatch):
    """``[export]``'s children start as soon as their artifact is written,
    load, and serve only after the parent's word: a stand-in child (the
    protocol of ``--serve-artifact ART IMAGES OUT GO``) has written nothing
    before it, and its line and logits come back after; a child that fails
    before loading raises with its error."""
    import textwrap
    import time

    C = _chip_smoke()
    (tmp_path / "chip_smoke.py").write_text(textwrap.dedent("""
        import json, os, sys, time
        import numpy as np
        art, images, out, go = sys.argv[2:6]
        if art.endswith("bad"):
            sys.exit("no such artifact")
        open(go + ".ready", "w").close()
        while not os.path.exists(go):
            time.sleep(0.01)
        np.save(out, np.load(images)[:, :3])
        print(json.dumps({"launches": {}, "load_s": 0.1, "model_modules": []}))
    """))
    np.save(tmp_path / "images.npy", np.arange(12, dtype=np.float32).reshape(2, 6))
    monkeypatch.setattr(torch.Tensor, "cuda", lambda self: self)
    server = C.FreshServer(tmp_path, str(tmp_path / "art"), str(tmp_path / "images.npy"), "art")
    assert server.wait_loaded() > 0
    time.sleep(0.2)
    assert not os.path.exists(server.out_npy) and server.proc.poll() is None
    logits, child, _ = server.finish()
    assert child == {"launches": {}, "load_s": 0.1, "model_modules": []}
    assert logits.tolist() == [[0, 1, 2], [6, 7, 8]]
    bad = C.FreshServer(tmp_path, str(tmp_path / "bad"), str(tmp_path / "images.npy"), "bad")
    with pytest.raises(AssertionError, match="no such artifact"):
        bad.wait_loaded()
