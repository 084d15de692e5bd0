"""``chip_smoke.check_close`` -- the limits each kernel is held to on the
card -- catches a systematic fault that stays inside the max-error limit:
emulated on the CPU with the plain GEMM, a GELU of the wrong form and a
missing bf16 rounding of the accumulator fail, while a change of fp32 sum
order passes."""

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
