"""The fp32 kernel chains' dispatch, on the CPU: the wrappers' table from
activation dtype to kernel (``fused_block.kernel_for``), bf16 and fp32 each
to its own entry point, fp16 and a mix of dtypes refused; the int8 tiers
routing fp32 activations to their q8 chains and refusing a mix of dtypes;
every CUDA source bound by ``_build.SIGNATURES`` and every entry there
backed by a source; every launch count either a kernel of
``chip_smoke.py``'s kernel object or a chain; and the routing gates of
``layers.residual_block`` choosing the same route for fp32 activations as
for bf16, as the JAX package's gates ignore the dtype."""

import importlib.util
from pathlib import Path

import pytest
import torch

from mudpt_torch.models import layers as TL
from mudpt_torch.ops import _build
from mudpt_torch.ops import fused_block as F

ROOT = Path(__file__).resolve().parent.parent
OPS = sorted(F.DTYPE_KERNELS)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_each_dtype_maps_to_its_entry_point(op, dtype):
    key = F.kernel_for(op, dtype, dtype)
    assert key == F.DTYPE_KERNELS[op][dtype]
    assert ("f32" in key) == (dtype == torch.float32)
    source, entry = F.KERNELS[key]
    assert entry in _build.SIGNATURES[source]
    assert (_build.CSRC / f"{source}.cu").is_file()


@pytest.mark.parametrize("op", OPS)
def test_bf16_and_fp32_kernels_differ(op):
    """Each dtype its own launch count; its own entry point but for the
    LayerNorms, whose entry point takes the type as a flag."""
    bf16, fp32 = (F.DTYPE_KERNELS[op][dt] for dt in (torch.bfloat16, torch.float32))
    assert bf16 != fp32
    assert (F.KERNELS[bf16] == F.KERNELS[fp32]) == op.startswith("layernorm")


@pytest.mark.parametrize("op", OPS)
def test_fp16_and_mixed_dtypes_raise(op):
    with pytest.raises(TypeError, match="no kernel for torch.float16"):
        F.kernel_for(op, torch.float16)
    with pytest.raises(TypeError, match="one activation dtype"):
        F.kernel_for(op, torch.float32, torch.bfloat16)
    with pytest.raises(TypeError, match="one activation dtype"):
        F.kernel_for(op)


QUANT_CHAINS = {"int8": "_InferenceOnlyFn", "int8_static": "_InferenceOnlyFn",
                "int8_ste": "LayerFullblockQ8SteFn",
                "int8_ste_static": "LayerFullblockQ8SteStaticFn"}


@pytest.mark.parametrize("quant", sorted(QUANT_CHAINS))
def test_quant_route_takes_fp32_and_refuses_a_mix(quant):
    """Under each int8 tier an fp32 x takes the q8 chain (on the CPU its
    plain versions), which returns fp32; an fp32 x with a bf16 block (a
    mix) raises, as the kernels' dispatch does on the card."""
    blk = _block(64, 1, torch.float32)
    if quant.endswith("static"):
        blk["q8_scales"] = torch.tensor([2.0, 1.5, 2.5, 1.0])
    x = torch.randn(2, 5, 64, requires_grad=True)
    with TL.quantized(quant):
        y = TL.residual_block(blk, x, 1)
        assert y.dtype == torch.float32 and y.shape == x.shape
        assert type(y.grad_fn).__name__ == QUANT_CHAINS[quant] + "Backward"
        if quant.startswith("int8_ste"):
            (dx,) = torch.autograd.grad(y.sum(), x)
            assert dx.dtype == torch.float32 and torch.isfinite(dx).all()
        mixed = _block(64, 1, torch.bfloat16)
        mixed.update({k: v for k, v in blk.items() if k == "q8_scales"})
        with pytest.raises(TypeError, match="one activation dtype"):
            TL.residual_block(mixed, x, 1)


def test_every_source_has_signatures_and_every_entry_a_source():
    sources = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert sources == set(_build.SIGNATURES)
    for source, entries in _build.SIGNATURES.items():
        assert entries, source
        text = (_build.CSRC / f"{source}.cu").read_text()
        for entry in entries:
            assert f'extern "C" int {entry}(' in text, (source, entry)


def test_every_launch_count_is_in_the_kernel_record_or_a_chain():
    C = _chip_smoke()
    groups = C.kernel_groups(F)
    names = [n for g in groups for n in g]
    assert sorted(names) == sorted(F.KERNELS)  # each kernel once
    assert set(F.LAUNCHES) == set(F.KERNELS) | set(F.CHAINS)
    assert not set(F.KERNELS) & set(F.CHAINS)
    for name in names:
        assert name in C.REPLACES
        assert (_build.CSRC / f"{F.KERNELS[name][0]}.cu").is_file()
    # the fp32 paths' expected launches map every bf16 kernel to its fp32 one
    want = C.expect(F.LAUNCHES, (12, "full_train"), (1, C.tower_lns(3, 3)))
    got = C.in_fp32(F, want)
    assert sum(got.values()) == sum(want.values())
    assert all(got[k] == 0 for k in groups[0])
    assert got["gemm_f32_epilogue"] == want["gemm_bf16_epilogue"] == 96


def _block(D, H, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s, std=0.1: (torch.randn(*s, generator=g) * std).to(dtype)  # noqa: E731
    ln = lambda: {"scale": torch.ones(D), "bias": torch.zeros(D)}  # noqa: E731
    return {"ln_1": ln(), "ln_2": ln(),
            "attn": {"qkv_w": rn(D, 3 * D), "qkv_b": rn(3 * D), "out_w": rn(D, D),
                     "out_b": rn(D)},
            "mlp": {"fc_w": rn(D, 4 * D), "fc_b": rn(4 * D), "proj_w": rn(4 * D, D),
                    "proj_b": rn(D)}}


@pytest.mark.parametrize("D,saves,route", [(64, True, "Fullblock"), (64, False, "Halfblock"),
                                           (1280, True, None)])
def test_routing_gates_ignore_the_dtype(D, saves, route):
    """The same route for fp32 as for bf16: the whole layer while saves are
    on and D <= 768, the halves with saves off, the XLA route past 1024."""
    names = []
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(2, 5, D, dtype=dtype, requires_grad=True)
        with F.saved_acts(saves):
            y = TL.residual_block(_block(D, D // 64, dtype), x, D // 64)
        assert y.dtype == dtype
        names.append(type(y.grad_fn).__name__)
    assert names[0] == names[1]
    if route is None:
        assert "Fullblock" not in names[0] and "Halfblock" not in names[0]
    else:
        assert route in names[0]
