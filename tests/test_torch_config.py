"""The port's copy of the config tree against the JAX package's: every
YAML under ``configs/`` (one case per file) merges onto the defaults to the
same tree, ``trainer_params()`` of every namespace included; so do the
dataset-then-trainer cascade with trailing ``KEY VALUE`` opts and the
typed-merge errors."""

import dataclasses
import warnings
from pathlib import Path

import pytest

from mudpt_tpu import config as J

from mudpt_torch import config as T

ROOT = Path(__file__).resolve().parent.parent
YAMLS = sorted((ROOT / "configs").rglob("*.yaml"))
NAMESPACES = ("CoOp", "CoCoOp", "VPT", "MPT", "MuDPT", "UMuDPT", "UUMuDPT",
              "ZeroshotCLIP", "ZeroshotCLIP2")


def _same(jcfg, tcfg):
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    for name in NAMESPACES:
        jp, tp = jcfg.trainer_params(name), tcfg.trainer_params(name)
        assert (tp is None) == (jp is None)
        if jp is not None:
            assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert str(tcfg) == str(jcfg)


@pytest.mark.parametrize("path", YAMLS, ids=lambda p: str(p.relative_to(ROOT / "configs")))
def test_yaml_merges_to_the_same_tree(path):
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jcfg = J.merge_from_file(J.default_config(), str(path))
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        tcfg = T.merge_from_file(T.default_config(), str(path))
    _same(jcfg, tcfg)
    # unknown keys (the reference's stale TRAINER.MAPLE) warn alike
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]


def test_cascade_with_opts_is_the_same():
    files = ("configs/datasets/synthetic.yaml",
             "configs/trainers/MuDPT/vit_b16_bz4_ep5_nctx2_depth9.yaml")
    opts = ["TRAINER.NAME", "MuDPT", "INPUT.SIZE", "(32, 32)", "OPTIM.WARMUP_CONS_LR", "1e-5",
            "PERF.TEXT_RECOMPUTE", "1", "DATALOADER.HOST_SHARD", "True",
            "TRAINER.MUDPT.PREC", "fp32", "MODEL.BACKBONE.PATH", "random"]
    jcfg = J.load_config(*(str(ROOT / f) for f in files), opts=opts, SEED=3)
    tcfg = T.load_config(*(str(ROOT / f) for f in files), opts=opts, SEED=3)
    _same(jcfg, tcfg)
    assert tcfg.trainer_params().N_CTX == 2 and tcfg.INPUT.SIZE == (32, 32)
    assert tcfg.PERF._touched == jcfg.PERF._touched == {"TEXT_RECOMPUTE"}


@pytest.mark.parametrize("opts", [["TRAINER.MUDPT.N_CTX", "notanumber"],
                                  ["DATALOADER.PIPELINE", "True"], ["SEED"]])
def test_bad_opts_raise_alike(opts):
    with pytest.raises((TypeError, ValueError)) as je:
        J.merge_from_list(J.default_config(), opts)
    with pytest.raises(type(je.value)) as te:
        T.merge_from_list(T.default_config(), opts)
    assert str(te.value) == str(je.value)


def test_perf_knobs_apply_and_the_rest_raise():
    """A PERF knob reaches its module (BLOCK, LN, SCAN_UNROLL, REMAT and the
    text tower's three switches too) and the snapshot reports its live
    value; a value the module refuses raises; an unset knob leaves the
    module alone."""
    from mudpt_torch.ops import fused_block

    cfg = T.load_config(opts=["PERF.TEXT_PACK", "0", "PERF.TEXT_TRUNC", "auto",
                              "PERF.TEXT_RECOMPUTE", "auto", "PERF.SAVE_MLP_WIDE", "0",
                              "PERF.SAVE_ACTS", "True"])
    try:
        fused_block.set_save_acts(False)  # set to its default by the config
        snap = T.apply_perf_config(cfg.PERF)
        assert snap["SAVE_MLP_WIDE"] == "0" and snap["SAVE_ACTS"] is True
        fused_block.set_save_mlp_wide("1")
        assert T.apply_perf_config(T.default_config().PERF)["SAVE_MLP_WIDE"] == "1"
    finally:
        fused_block.set_save_mlp_wide("auto")
        fused_block.set_save_acts(True)
    from mudpt_torch.models import layers, transformer

    try:
        snap = T.apply_perf_config(T.load_config(opts=[
            "PERF.REMAT", "full", "PERF.BLOCK", "xla", "PERF.LN", "bf16",
            "PERF.SCAN_UNROLL", "2"]).PERF)
        assert (snap["REMAT"], snap["BLOCK"], snap["BLOCK_RESOLVED"], snap["LN"],
                snap["SCAN_UNROLL"]) == ("full", "xla", "xla", "bf16", "2")
        assert (transformer.remat_mode(), layers.block_impl(), layers.ln_dtype(),
                transformer.resolve_unroll()) == ("full", "xla", "bf16", 2)
    finally:
        T.apply_perf_config(T.load_config(opts=[
            "PERF.REMAT", "none", "PERF.BLOCK", "auto", "PERF.LN", "fp32",
            "PERF.SCAN_UNROLL", "auto"]).PERF)
    assert T.perf_snapshot()["BLOCK"] == "auto" and transformer.remat_mode() == "none"
    from mudpt_torch.models import text

    try:
        snap = T.apply_perf_config(T.load_config(opts=[
            "PERF.TEXT_PACK", "1", "PERF.TEXT_TRUNC", "0", "PERF.TEXT_RECOMPUTE", "1"]).PERF)
        assert (snap["TEXT_PACK"], snap["TEXT_TRUNC"], snap["TEXT_RECOMPUTE"]) == (1, "0", "1")
        assert (text.text_pack(), text.text_truncate_enabled(), text.text_recompute()) == (
            1, False, "1")
        with pytest.raises(ValueError, match="TEXT_RECOMPUTE"):
            T.apply_perf_config(T.load_config(opts=["PERF.TEXT_RECOMPUTE", "2"]).PERF)
    finally:
        T.apply_perf_config(T.load_config(opts=[
            "PERF.TEXT_PACK", "0", "PERF.TEXT_TRUNC", "auto", "PERF.TEXT_RECOMPUTE",
            "auto"]).PERF)
    assert (T.perf_snapshot()["TEXT_PACK"], text.text_truncate()) == (0, "auto")
