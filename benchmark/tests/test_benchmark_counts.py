"""The operation and byte counts behind ``mfu.*`` and ``*_roofline.*``
against hand counts."""

import json

import pytest

from benchmark import inputs
from benchmark.metrics import work
from benchmark.spec import HERE

B16 = json.loads((HERE / "configs" / "mudpt-vitb16.json").read_text())
L14 = json.loads((HERE / "configs" / "mudpt-vitl14.json").read_text())


def _ops(ops, name):
    return sum(o.ops for o in ops if o.name == name)


def test_vit_b16_forward_per_image():
    ops = work.vision_ops(B16, 1, "bf16", backward=False)
    S, D = 199, 768
    layers = sum(o.ops for o in ops if o.name.startswith("vision.")
                 and o.name not in ("vision.patch_embed", "vision.proj"))
    # 12 layers of 24 D^2 a token (qkv, out, fc, proj) and attention once: 4 S^2 D
    assert layers == 12 * (24 * D * D * S + 4 * S * S * D)
    assert round(layers / 1e9, 1) == 35.3
    assert _ops(ops, "vision.patch_embed") == 2 * 196 * 768 * 768      # 0.231 GFLOP
    assert _ops(ops, "vision.proj") == 2 * 768 * 512


def test_dx_backward_counts_each_product_once_and_attention_twice():
    fwd = work.vision_ops(B16, 1, "bf16", backward=False)
    both = work.vision_ops(B16, 1, "bf16", backward=True)
    assert _ops(both, "vision.attention.dx") == 2 * _ops(fwd, "vision.attention")
    for name in ("attn_qkv", "attn_out", "mlp_fc", "mlp_proj"):
        assert _ops(both, f"vision.{name}.dx") == _ops(fwd, f"vision.{name}")
    assert "vision.patch_embed.dx" not in {o.name for o in both}


def test_causal_text_rows_count_their_earlier_keys_up_to_eot():
    eot = [4, 11]                      # prompts of 5 and 12 tokens
    ops = work.text_ops(B16, eot, "bf16", backward=False)
    D, L = 512, 12
    keys = sum(range(1, 6)) + sum(range(1, 13))
    assert _ops(ops, "text.attention") == L * 4 * keys * D
    assert _ops(ops, "text.attn_qkv") == L * 2 * 17 * D * 3 * D


def test_step_totals_and_precisions():
    ids, eot = inputs.class_tokens(100, 2, 77, 5)
    step = work.train_step_ops(B16, 384, eot, "bf16")
    assert sum(o.ops for o in step) / 384 / 1e9 == pytest.approx(72.59, abs=0.01)
    ids, eot = inputs.class_tokens(1000, 2, 77, 5)
    req = work.request_ops(L14, 224, 1000, "int8")
    s8 = [o for o in req if o.precision == "s8"]
    assert {o.name for o in s8} == {f"vision.{n}" for n in
                                    ("attn_qkv", "attn_out", "mlp_fc", "mlp_proj")}
    assert all(o.family == "attention" for o in req if "attention" in o.name)
    # the s8 products at 1,979 TOP/s, the rest (attention among it) at 989
    assert work.total(req, kind="ops") == pytest.approx(
        sum(o.ops for o in s8) / 1979e12 + sum(o.ops for o in req if o not in s8) / 989e12)


def test_roofline_least_time_is_the_larger_bound():
    big = work.gemm("g", 76416, 768, 2304)
    assert big.least_s() == big.ops / 989e12
    thin = work.gemm("t", 64, 768, 768)
    assert thin.least_s() == pytest.approx(thin.bytes / 3.35e12)
    att = work.attention("a", 384 * 199 * 199, 384 * 199, 768, 1, backward=False)[0]
    assert att.least_s() == att.bytes / 3.35e12          # attention at these rows: bytes
