"""The text tower's three switches (``PERF.TEXT_PACK``, ``TEXT_TRUNC``,
``TEXT_RECOMPUTE``) in the port against the JAX package's, in fp32 at a
tiny size (2 layers, width 64, 2 heads): ``text_forward``'s features and
their gradients with respect to the prompt embeddings and the deep prompts
over the whole switch grid, the truncated length, the pack and saves-off
decisions over a grid of rows and lengths, the switches through a Config
(YAML and opts) with the snapshots of both packages, and a CoOp trainer
built under ``TEXT_TRUNC 0`` against the JAX trainer.  Each package is set
through its own setters and restored after each test; inputs are
numpy-seeded."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudpt_tpu.config import load_config as jload_config
from mudpt_tpu.config.perf import apply_perf_config as japply
from mudpt_tpu.config.perf import perf_snapshot as jsnapshot
from mudpt_tpu.models import layers as JL
from mudpt_tpu.models import text as JT
from mudpt_tpu.models import transformer as JTR
from mudpt_tpu.models.clip import CLIPConfig as JCLIPConfig
from mudpt_tpu.models.clip import init_clip_params as jinit
from mudpt_tpu.trainers import build_trainer as jbuild_trainer
from mudpt_tpu.utils.rng import new_rng

from mudpt_torch.config import apply_perf_config, load_config, perf_snapshot
from mudpt_torch.models import layers as TL
from mudpt_torch.models import text as TT
from mudpt_torch.models import transformer as TTR
from mudpt_torch.models.convert import params_from_numpy
from mudpt_torch.ops import fused_block
from mudpt_torch.trainers import build_trainer

CFG = JCLIPConfig(
    embed_dim=64, image_resolution=32, vision_layers=2, vision_width=64,
    vision_patch_size=16, transformer_width=64, transformer_heads=2,
    transformer_layers=2,
)
H, N_CTX, N_ROWS, FULL = 2, 2, 16, 77
TOL = dict(rtol=1e-4, atol=1e-4)
PACKS, TRUNCS, RECOMPUTES = (0, 1, 2, 4), ("auto", "0"), ("auto", "0", "1")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def switches(pack=0, trunc="auto", recompute="auto", block=None, unroll=None):
    """Both packages' switches set alike inside the context, each restored
    after it (and the block impl and scan unroll when given)."""
    saved_j = (JT._TEXT_PACK, JT._TEXT_TRUNC, JT._TEXT_RECOMPUTE, JL._BLOCK_IMPL,
               JTR._SCAN_UNROLL)
    saved_t = (TT.text_pack(), TT.text_truncate(), TT.text_recompute(), TL.block_impl(),
               TTR._SCAN_UNROLL)
    try:
        for mod in (JT, TT):
            mod.set_text_pack(pack)
            mod.set_text_truncate(trunc != "0")
            mod.set_text_recompute(recompute)
        if block is not None:
            JL.set_block_impl(block)
            TL.set_block_impl(block)
        if unroll is not None:
            JTR.set_scan_unroll(unroll)
            TTR.set_scan_unroll(unroll)
        yield
    finally:
        JT._TEXT_PACK, JT._TEXT_TRUNC, JT._TEXT_RECOMPUTE, JL._BLOCK_IMPL = saved_j[:4]
        JTR._SCAN_UNROLL = saved_j[4]
        TT.set_text_pack(saved_t[0])
        TT.set_text_truncate(saved_t[1] != "0")
        TT.set_text_recompute(saved_t[2])
        TL.set_block_impl(saved_t[3])
        TTR.set_scan_unroll(saved_t[4])


@pytest.fixture(scope="module")
def params():
    jp = jinit(new_rng(0), CFG)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _inputs(seed):
    """16 class rows of the full 77 tokens, their EOT positions below 14,
    one deep prompt layer, and the features' cotangent."""
    rng = np.random.RandomState(seed)
    emb = (rng.randn(N_ROWS, FULL, 64) * 0.1).astype(np.float32)
    eot = rng.randint(1 + N_CTX, 14, N_ROWS).astype(np.int32)
    deep = (rng.randn(1, N_CTX, 64) * 0.1).astype(np.float32)
    cot = rng.randn(N_ROWS, 64).astype(np.float32)
    return emb, eot, deep, cot


_JAX_RUNS = {}


def _jax_run(jp, x, eot, deep, cot):
    """The JAX features and their input gradients, traced once for each
    packing the JAX switches resolve to at this row length (the recompute
    switch changes nothing on its XLA blocks)."""
    key = (JT._resolve_pack(N_ROWS, CFG.transformer_layers, -(-x.shape[1] // 8) * 8),
           x.shape[1])
    if key not in _JAX_RUNS:
        @jax.jit
        def run(e, d, c):
            out, vjp = jax.vjp(lambda e, d: JT.text_forward(
                jp["text"], e, jnp.asarray(eot), n_head=H, deep_prompts=d), e, d)
            return (out, *vjp(c))

        _JAX_RUNS[key] = tuple(map(np.asarray, run(jnp.asarray(x), jnp.asarray(deep),
                                                    jnp.asarray(cot))))
    return _JAX_RUNS[key]


class Calls:
    """Counts the port's residual blocks by route (plain versions on the
    CPU): the full block that saves, or the two halves."""

    def __init__(self, monkeypatch):
        self.n = {"layer_fullblock": 0, "attn_halfblock": 0}
        for name in self.n:
            real = getattr(fused_block, name)
            monkeypatch.setattr(fused_block, name, self._count(name, real))

    def _count(self, name, real):
        def counted(*args, **kwargs):
            self.n[name] += 1
            return real(*args, **kwargs)
        return counted


@pytest.mark.parametrize("recompute", RECOMPUTES)
@pytest.mark.parametrize("trunc", TRUNCS)
@pytest.mark.parametrize("pack", PACKS)
def test_text_forward_under_switches_matches_jax(params, monkeypatch, pack, trunc, recompute):
    """Features and the gradients of the prompt embeddings and the deep
    prompts: the port under (pack, trunc, recompute) against the JAX package
    under the same switches, the rows cut to ``effective_text_length`` as a
    trainer's class bank cuts them; the layers take the route the recompute
    switch asks for."""
    jp, tp = params
    emb, eot, deep, cot = _inputs(1)
    calls = Calls(monkeypatch)
    with switches(pack, trunc, recompute):
        S = TT.effective_text_length(int(eot.max()), FULL)
        assert S == JT.effective_text_length(int(eot.max()), FULL) == (16 if trunc == "auto"
                                                                      else FULL)
        x = emb[:, :S]

        jout, jde, jdd = _jax_run(jp, x, eot, deep, cot)
        te = torch.from_numpy(x).requires_grad_(True)
        td = torch.from_numpy(deep).requires_grad_(True)
        tout = TT.text_forward(tp["text"], te, torch.from_numpy(eot), n_head=H, deep_prompts=td)
        tde, tdd = torch.autograd.grad(tout, (te, td), torch.from_numpy(cot))
        P = -(-S // 8) * 8
        saves_off = TT._text_saves_off(N_ROWS, P)
        assert saves_off == JT._text_saves_off(N_ROWS, P) == (
            recompute == "1" or (recompute == "auto" and N_ROWS * P >= 512 * 80))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tde.numpy(), np.asarray(jde), **TOL)
    np.testing.assert_allclose(tdd.numpy(), np.asarray(jdd), **TOL)
    layers = CFG.transformer_layers
    assert calls.n == ({"layer_fullblock": 0, "attn_halfblock": layers} if saves_off
                       else {"layer_fullblock": layers, "attn_halfblock": 0})


@pytest.mark.parametrize("pack", [2, 4])
def test_forced_pack_on_the_xla_route_matches_jax(params, pack):
    """A forced G packs on the XLA block route too (the JAX package's
    packed mask), with the same features as the unpacked rows; 4-D rows
    (instances x classes) pack over all of them."""
    jp, tp = params
    emb, eot, deep, _ = _inputs(2)
    x = emb[:, :16]
    with switches(pack, block="xla"):
        assert TT._resolve_pack(N_ROWS, 2, 16) == JT._resolve_pack(N_ROWS, 2, 16) == pack
        j = jax.jit(lambda x, d: JT.text_forward(jp["text"], x, jnp.asarray(eot), n_head=H,
                                                 deep_prompts=d))(jnp.asarray(x), jnp.asarray(deep))
        with torch.no_grad():
            t = TT.text_forward(tp["text"], torch.from_numpy(x), torch.from_numpy(eot),
                                n_head=H, deep_prompts=torch.from_numpy(deep))
            x4 = torch.from_numpy(np.stack([x[:8], x[8:]]))
            t4 = TT.text_forward(tp["text"], x4, torch.from_numpy(eot[:8]), n_head=H,
                                 deep_prompts=torch.from_numpy(deep))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    assert t4.shape == (2, 8, 64)
    np.testing.assert_allclose(t4[0].numpy(), np.asarray(j)[:8], **TOL)


def test_explicit_pack_argument_wins_over_the_switch(params, monkeypatch):
    """``pack=`` given to ``text_forward`` ranks above the module switch:
    the switch forces 4, the argument 1 runs the rows unpacked."""
    _, tp = params
    emb, eot, _, _ = _inputs(3)
    seen = []
    real = TT.transformer_forward

    def spy(blocks, x, **kw):
        seen.append(tuple(x.shape))
        return real(blocks, x, **kw)

    monkeypatch.setattr(TT, "transformer_forward", spy)
    with switches(4), torch.no_grad():
        TT.text_forward(tp["text"], torch.from_numpy(emb[:, :16]), torch.from_numpy(eot),
                        n_head=H, pack=1)
        TT.text_forward(tp["text"], torch.from_numpy(emb[:, :16]), torch.from_numpy(eot),
                        n_head=H)
    assert seen == [(N_ROWS, 16, 64), (N_ROWS // 4, 64, 64)]


@pytest.mark.parametrize("block,unroll", [("pallas", None), ("xla", None), ("pallas", "1")])
@pytest.mark.parametrize("pack", PACKS)
def test_pack_rule_matches_jax(pack, block, unroll):
    """``_resolve_pack`` over rows and lengths, on either block route and
    under a rolled scan, for each switch value."""
    with switches(pack, block=block, unroll=unroll):
        for n_rows in (1, 7, 16, 64, 100, 1000, 8000):
            for seq in (16, 24, 80):
                got = TT._resolve_pack(n_rows, 12, seq)
                assert got == JT._resolve_pack(n_rows, 12, seq), (n_rows, seq)
                if pack:
                    assert got == pack


@pytest.mark.parametrize("recompute", RECOMPUTES)
def test_saves_off_rule_matches_jax(recompute):
    with switches(recompute=recompute):
        for n_rows in (1, 100, 511, 512, 513, 2560, 8000):
            for seq in (16, 24, 80, 128):
                assert TT._text_saves_off(n_rows, seq) == JT._text_saves_off(n_rows, seq)


@pytest.mark.parametrize("trunc", TRUNCS)
def test_effective_length_matches_jax(trunc):
    with switches(trunc=trunc):
        assert TT.text_truncate_enabled() == JT.text_truncate_enabled() == (trunc == "auto")
        for full in (16, 24, 77):
            for max_eot in (0, 3, 10, 15, 16, 40, 76):
                assert (TT.effective_text_length(max_eot, full)
                        == JT.effective_text_length(max_eot, full))


def test_bad_recompute_value_raises():
    with switches(), pytest.raises(ValueError, match="TEXT_RECOMPUTE"):
        TT.set_text_recompute("2")


PERF_YAML = "PERF:\n  TEXT_PACK: 4\n  TEXT_TRUNC: 0\n  TEXT_RECOMPUTE: 1\n  BLOCK: pallas\n"


@pytest.mark.parametrize("how", ["yaml", "opts"])
def test_switches_through_a_config_match_jax_snapshot(tmp_path, how):
    """``apply_perf_config`` with the three switches from a YAML file or from
    opts reaches the text module, and the snapshot equals the JAX package's
    for the same PERF."""
    if how == "yaml":
        (tmp_path / "perf.yaml").write_text(PERF_YAML)
        files, opts = (str(tmp_path / "perf.yaml"),), []
    else:
        files, opts = (), ["PERF.TEXT_PACK", "4", "PERF.TEXT_TRUNC", "0",
                           "PERF.TEXT_RECOMPUTE", "1", "PERF.BLOCK", "pallas"]
    with switches():
        snap = apply_perf_config(load_config(*files, opts=opts).PERF)
        jsnap = japply(jload_config(*files, opts=opts).PERF)
        assert snap == jsnap == perf_snapshot() == jsnapshot()
        assert (snap["TEXT_PACK"], snap["TEXT_TRUNC"], snap["TEXT_RECOMPUTE"]) == (4, "0", "1")
        assert (TT.text_pack(), TT.text_truncate_enabled(), TT._text_saves_off(1, 16)) == (
            4, False, True)
        # an unset knob leaves the module state alone
        apply_perf_config(load_config().PERF)
        assert TT.text_pack() == 4


FILES = ("configs/datasets/synthetic.yaml", "configs/trainers/test/tiny.yaml")


def test_coop_built_under_full_rows_matches_jax_trainer(tmp_path):
    """CoOp built with ``PERF.TEXT_TRUNC 0`` in both packages: the class bank
    keeps the full 77 tokens (the config applies before the bank is built),
    and the port's logits from the JAX trainer's trees match the JAX
    trainer's."""
    def opts(out):
        return ["TRAINER.NAME", "CoOp", "OUTPUT_DIR", str(out), "TRAINER.COOP.PREC", "fp32",
                "TRAINER.COOP.N_CTX", "4", "PERF.TEXT_TRUNC", "0"]

    def np_tree(tree):
        return jax.tree_util.tree_map(np.asarray, tree)

    with switches():
        jtr = jbuild_trainer(jload_config(*FILES, opts=opts(tmp_path / "jax")))
        ttr = build_trainer(load_config(*FILES, opts=opts(tmp_path / "torch")), devices="cpu")
        assert ttr.perf_resolved["TEXT_TRUNC"] == jtr.perf_resolved["TEXT_TRUNC"] == "0"
        suffix = ttr.aux["token_suffix"].shape[1]
        assert suffix == np.shape(jtr.aux["token_suffix"])[1] == FULL - 1 - 4
        images = np.random.RandomState(4).randn(3, 32, 32, 3).astype(np.float32)
        want = np.asarray(jax.jit(jtr.forward)(jtr.trainable, jtr.frozen, jtr.aux,
                                               jnp.asarray(images)))
        frozen = params_from_numpy(np_tree(jtr.frozen), "cpu")
        aux = params_from_numpy(np_tree(jtr.aux), "cpu")
        trainable = params_from_numpy(np_tree(jtr.trainable), "cpu")
        with torch.no_grad():
            got = ttr.forward(trainable, frozen, aux, torch.from_numpy(images)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("pack", [0, 4])
def test_calibration_capture_under_pack_matches_jax(params, pack):
    """Static calibration's capture of the text tower: the auto rule runs it
    unpacked in both packages, a forced G packs it in both (its pad rows
    enter the absmax as the JAX package's do): the scales agree."""
    from mudpt_tpu.ops import quant_block as JQ

    from mudpt_torch.ops import quant_block as TQ

    jp, tp = params
    emb, eot, deep, _ = _inputs(5)
    x, eot = emb[:14, :16], eot[:14]  # 14 rows: G = 4 leaves two pad rows
    with switches(pack):
        j = JQ.calibrate(lambda e: JT.text_forward(jp["text"], e, jnp.asarray(eot), n_head=H,
                                                   deep_prompts=jnp.asarray(deep)),
                         jnp.asarray(x))
        t = TQ.calibrate(lambda e: TT.text_forward(tp["text"], e, torch.from_numpy(eot),
                                                   n_head=H, deep_prompts=torch.from_numpy(deep)),
                         torch.from_numpy(x))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_switches_through_the_cli(tmp_path):
    """``python -m mudpt_torch.train``'s trailing opts set the switches before
    the trainer builds its class bank, and its metrics.jsonl records them."""
    import json

    from mudpt_torch import train as cli

    argv = ["--device", "cpu", "--trainer", "CoOp", "--dataset_config", FILES[0],
            "--trainer_config", FILES[1], "--output_dir", str(tmp_path), "--no_train",
            "TRAINER.COOP.N_CTX", "4", "PERF.TEXT_PACK", "2", "PERF.TEXT_TRUNC", "0",
            "PERF.TEXT_RECOMPUTE", "0"]
    with switches():
        tr = cli.main(cli.parse_args(argv))
        assert (TT.text_pack(), TT.text_truncate(), TT.text_recompute()) == (2, "0", "0")
    assert tr.aux["token_suffix"].shape[1] == FULL - 1 - 4
    with open(tmp_path / "metrics.jsonl") as f:
        perf = next(r for r in map(json.loads, f) if r["kind"] == "perf_config")
    assert (perf["TEXT_PACK"], perf["TEXT_TRUNC"], perf["TEXT_RECOMPUTE"]) == (2, "0", "0")
