"""The port's mesh layout (``mudpt_torch/parallel``) against the JAX
package's on its 8 CPU devices: ``build_mesh``'s errors and warnings for the
same (devices, PARALLEL.DATA, PARALLEL.MODEL), ``shard_batch``'s padding and
``valid`` (the ranks' rows concatenated against the global array),
``host_rows_slice``, ``shard_class_tree``'s padding, and ``DataManager``'s
train and eval item split with the JAX side's process count and index set
to the data axis and the rank's data index (each rank's view a
``MeshContext`` of its own, no process group).  Then the (2,2) mesh on four
gloo ranks (``tests/torch_multirank_worker.py``): MuDPT's and CoCoOp's first
two steps against one process, and MuDPT's against the JAX package's 2x2
mesh on the JAX trainer's trees, to 1e-5."""

import os
import warnings
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from mudpt_tpu.config import default_config as jdefault_config
from mudpt_tpu.data.manager import DataManager as JDataManager
from mudpt_tpu.parallel import mesh as jmesh

from mudpt_torch.config import default_config
from mudpt_torch.data.manager import DataManager
from mudpt_torch.parallel import mesh
from mudpt_torch.parallel.mesh import MeshContext


def _cfgs(data, model):
    out = []
    for make in (jdefault_config, default_config):
        cfg = make()
        cfg.PARALLEL.DATA, cfg.PARALLEL.MODEL = data, model
        out.append(cfg)
    return out


def _outcome(fn):
    """('ok', shape) or ('raise', type, message), and the warnings' texts."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            res = fn()
            out = ("ok", res.n_data, res.n_model)
        except ValueError as e:
            out = ("raise", type(e).__name__, str(e))
    return out, [str(w.message) for w in caught if "mesh uses" in str(w.message)]


@pytest.mark.parametrize("n,data,model", [
    (1, 0, 1), (8, 0, 1), (8, 0, 2), (8, 4, 2), (8, 2, 2), (8, 3, 1), (8, 0, 3),
    (8, 0, 16), (8, 4, 4), (4, 5, 1), (2, 1, 2),
])
def test_build_mesh_checks_match_jax(n, data, model):
    jcfg, cfg = _cfgs(data, model)
    got = _outcome(lambda: mesh.build_mesh(cfg, n))
    want = _outcome(lambda: jmesh.build_mesh(jcfg, jax.devices()[:n]))
    if want[0][0] == "ok":
        want = (("ok", want[0][1], want[0][2]), want[1])
    assert got == want


def test_mesh_context_places_ranks_row_major():
    """Rank r at (d, m) = divmod(r, n_model): the reshape of build_mesh."""
    jm = jmesh.build_mesh(_cfgs(4, 2)[0], jax.devices()[:8]).mesh.devices
    for r in range(8):
        ctx = MeshContext(4, 2, rank=r)
        assert jm[ctx.data_index, ctx.model_index].id == jax.devices()[r].id
        assert ctx.shape == {"data": 4, "model": 2} and ctx.in_mesh
    assert not MeshContext(2, 2, rank=5).in_mesh


def _batch(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"image": rng.randn(n, 4, 4, 3).astype(np.float32),
            "label": rng.randint(0, 5, n).astype(np.int32),
            "valid": np.ones(n, bool)}


@pytest.mark.parametrize("n_data,n_model,rows", [(4, 2, 10), (2, 2, 8), (2, 1, 7), (8, 1, 3)])
def test_shard_batch_matches_jax(n_data, n_model, rows):
    batch = _batch(rows)
    jctx = jmesh.build_mesh(_cfgs(n_data, n_model)[0], jax.devices()[:n_data * n_model])
    want = {k: np.asarray(v) for k, v in jmesh.shard_batch(jctx, batch).items()}
    for m in range(n_model):
        parts = [mesh.shard_batch(MeshContext(n_data, n_model, rank=d * n_model + m), batch)
                 for d in range(n_data)]
        for k in batch:
            got = np.concatenate([p[k] for p in parts])
            np.testing.assert_array_equal(got, want[k])
    assert want["valid"].sum() == rows  # pad rows marked invalid
    host = mesh.shard_batch(MeshContext(n_data, n_model), batch, host_local=True)
    assert all(np.array_equal(host[k], batch[k]) for k in batch)


@pytest.mark.parametrize("n_data,n_local", [(2, 5), (4, 3)])
def test_host_rows_slice_matches_jax(monkeypatch, n_data, n_local):
    """With one rank a process, the JAX package's process count is the data
    axis and its process index the rank's data index."""
    jctx = jmesh.build_mesh(_cfgs(n_data, 2)[0], jax.devices()[:2 * n_data])
    monkeypatch.setattr(jax, "process_count", lambda: n_data)
    for d in range(n_data):
        monkeypatch.setattr(jax, "process_index", lambda d=d: d)
        assert mesh.host_rows_slice(MeshContext(n_data, 2, rank=2 * d), n_local) \
            == jmesh.host_rows_slice(jctx, n_local)


@pytest.mark.parametrize("n_model,pad_to", [(2, None), (4, None), (2, 8), (1, None)])
def test_shard_class_tree_pads_as_jax(n_model, pad_to):
    rng = np.random.RandomState(1)
    tree = {"token_prefix": rng.randn(5, 1, 8).astype(np.float32),
            "eot_idx": np.arange(5, dtype=np.int32),
            "inner": {"text_features": rng.randn(5, 4).astype(np.float32)}}
    jctx = jmesh.build_mesh(_cfgs(8 // n_model, n_model)[0], jax.devices()[:8])
    want = jax.tree_util.tree_map(np.asarray, jmesh.shard_class_tree(jctx, tree, pad_to))
    ctx = MeshContext(8 // n_model, n_model, rank=1)
    torch_tree = jax.tree_util.tree_map(torch.from_numpy, tree)
    got = mesh.shard_class_tree(ctx, torch_tree, pad_to)
    got_np = mesh.shard_class_tree(ctx, tree, pad_to)
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        keys = [p.key for p in path]
        g, gn = got, got_np
        for k in keys:
            g, gn = g[k], gn[k]
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(gn, w)
    assert mesh.replicate(ctx, torch_tree)["eot_idx"].device == torch.device("cpu")


def _dataset(n_train=37, n_test=29):
    return SimpleNamespace(train_x=list(range(n_train)), val=None, test=list(range(100, 100 + n_test)),
                           num_classes=4, classnames=list("abcd"))


def _split(dm):
    t, e = dm.train_loader, dm.test_loader
    return (list(t.items), t.batch_size, list(e.items), e.batch_size, e.pad_to_batches,
            dm.host_sharded, dm.eval_host_sharded)


@pytest.mark.parametrize("mode,n_data,train_bs,test_bs", [
    ("auto", 2, 8, 8), ("auto", 4, 8, 6), ("on", 2, 8, 8), ("off", 2, 8, 8), ("auto", 1, 8, 8),
    ("auto", 3, 9, 6),
])
def test_data_manager_split_matches_jax(monkeypatch, mode, n_data, train_bs, test_bs):
    """The train items and every eval block of a data index, against the
    JAX package's host split with its process count and index set."""
    jcfg, cfg = jdefault_config(), default_config()
    for c in (jcfg, cfg):
        c.DATALOADER.HOST_SHARD = mode
        c.DATALOADER.TRAIN_X.BATCH_SIZE, c.DATALOADER.TEST.BATCH_SIZE = train_bs, test_bs
        c.DATALOADER.NUM_WORKERS = 1
    monkeypatch.setattr(jax, "process_count", lambda: n_data)
    covered = []
    for d in range(n_data):
        monkeypatch.setattr(jax, "process_index", lambda d=d: d)
        want = _split(JDataManager(jcfg, _dataset(), n_data=n_data))
        got = _split(DataManager(cfg, _dataset(), n_data=n_data, data_index=d))
        assert got == want
        covered += got[2]
    if got[6]:  # the blocks of the data axis cover the test split once
        assert sorted(covered) == list(range(100, 129))


def test_data_manager_on_refuses_an_indivisible_batch(monkeypatch):
    jcfg, cfg = jdefault_config(), default_config()
    for c in (jcfg, cfg):
        c.DATALOADER.HOST_SHARD = "on"
        c.DATALOADER.TRAIN_X.BATCH_SIZE = 9
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    with pytest.raises(ValueError) as want:
        JDataManager(jcfg, _dataset(), n_data=2)
    with pytest.raises(ValueError) as got:
        DataManager(cfg, _dataset(), n_data=2, data_index=0)
    assert str(got.value) == str(want.value)


def test_shard_rows_without_a_group_falls_back_or_refuses():
    """No mesh or a one-rank model axis: a plain call.  A model axis of two
    ranks without a process group cannot gather, and says so."""
    fn = lambda x: x * 2  # noqa: E731
    x = torch.arange(6.0).reshape(6, 1)
    assert torch.equal(mesh.shard_rows(None, "model", fn, x), 2 * x)
    assert torch.equal(mesh.shard_rows(MeshContext(2, 1), "model", fn, x), 2 * x)
    assert torch.equal(mesh.shard_rows(MeshContext(1, 2), "data", fn, x), 2 * x)
    # an indivisible block runs plain, as the JAX wrapper does
    assert torch.equal(mesh.shard_rows(MeshContext(1, 4), "model", fn, x), 2 * x)
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.shard_rows(MeshContext(1, 2), "model", fn, x)


# ---- the (2,2) mesh on four gloo ranks: MuDPT against one process and
# against the JAX package's MuDPT on a 2x2 mesh of its CPU devices (the JAX
# trainer's trees crossed into the port), and CoCoOp against one process


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    from mudpt_tpu.config import load_config as jload_config
    from mudpt_tpu.trainers import build_trainer as jbuild_trainer

    from tests import torch_multirank_worker as W
    from tests.test_torch_multirank import STEPS, run_ranks, save_batches

    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        tmp = tmp_path_factory.mktemp("world4")
        batches = save_batches(W.build("MuDPT", str(tmp / "b")), str(tmp / "b.npz"))
        mesh22 = ["PARALLEL.DATA", "2", "PARALLEL.MODEL", "2", "DATALOADER.HOST_SHARD", "off"]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the mesh uses 4 of the 8 devices
            jtr = jbuild_trainer(jload_config(
                *(os.path.join(W.ROOT, f) for f in W.FILES),
                opts=["TRAINER.NAME", "MuDPT", "OUTPUT_DIR", str(tmp / "jax"), *mesh22]))
        assert dict(jtr.mesh.mesh.shape) == {"data": 2, "model": 2}
        trees = {"frozen": jtr.frozen, "aux": jtr.aux, "trainable": jtr.trainable}
        weights = str(tmp / "jax_trees.npz")
        np.savez(weights, **_flat(jax.tree_util.tree_map(np.asarray, trees)))
        cases = [dict(name="mudpt22", trainer="MuDPT", batches=batches, weights=weights,
                      opts=mesh22),
                 dict(name="cocoop22", trainer="CoCoOp", batches=batches, opts=mesh22)]
        ranks = run_ranks(4, tmp, cases)
        refs = {c["name"]: W.run_case(dict(c, opts=[]), str(tmp / f"ref_{c['name']}"))
                for c in cases}
        # the JAX package's steps on the same global batches
        jlosses = []
        with np.load(batches) as f:
            for i in range(STEPS):
                sb = jmesh.shard_batch(jtr.mesh, {k: f[f"{i}/{k}"]
                                                  for k in ("image", "label", "valid")})
                jtr.trainable, jtr.opt_state, loss, _ = jtr._train_step(
                    jtr.trainable, jtr.opt_state, jtr.frozen, jtr.aux, sb)
                jlosses.append(float(loss))
        jprompts = _flat(jax.tree_util.tree_map(np.asarray, jtr.trainable))
        return ranks, refs, jlosses, jprompts
    finally:
        torch.set_num_threads(prev)


@pytest.mark.parametrize("name", ["mudpt22", "cocoop22"])
def test_2x2_mesh_steps_match_one_process(world4, name):
    from tests.test_torch_multirank import hold_confusion, hold_steps

    ranks, refs, _, _ = world4
    recs = [r[name] for r in ranks]
    hold_steps(recs, refs[name])
    hold_confusion(recs, refs[name], 16, same_prompts=True)
    sums = {float(r["ckpt_sum"]) for r in recs}
    assert len(sums) == 1


def test_2x2_mesh_steps_match_jax_2x2_mesh(world4):
    """The port's four ranks and the JAX package's 2x2 mesh, from the same
    trees on the same batches: the losses and the prompts after two steps
    (fp32 on both sides: the order of fp32 sums differs)."""
    ranks, _, jlosses, jprompts = world4
    for rec in (r["mudpt22"] for r in ranks):
        np.testing.assert_allclose(rec["losses"], jlosses, rtol=0, atol=1e-5)
        for k, want in jprompts.items():
            got = rec[f"prompt/{k}"]
            assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(), 1.0), k


@pytest.mark.parametrize("lead,n_data", [((16,), 1), ((4, 8), 2)])
def test_text_forward_packs_by_the_global_row_count(monkeypatch, lead, n_data):
    """Under a model axis of 2 each rank encodes half the class rows, yet
    the packing G comes from the global row count, as the JAX package
    resolves it before its tower runs per shard (``text.py:222-243``): 16
    class rows pack two to a kernel row (8 alone would not pack), and a 4-D
    block of 4 local instances x 8 classes on a data axis of 2 counts 64
    rows (G = 8; the rank's 16 would give 2).  The split is emulated: both
    halves of the class axis encoded here, the tower's inputs recorded."""
    from mudpt_torch.models import text as T
    from mudpt_torch.models.clip import TINY_TEST, init_clip_params

    p = init_clip_params(TINY_TEST, torch.Generator().manual_seed(0))["text"]
    S, D = 16, TINY_TEST.transformer_width
    x = torch.randn(*lead, S, D, generator=torch.Generator().manual_seed(1))
    widths, tower = [], T.transformer_forward

    def recording(blocks, xx, **kw):
        widths.append(xx.shape[1])
        return tower(blocks, xx, **kw)

    def split(ctx, axis, fn, xx):
        dim = 0 if xx.dim() == 3 else 1
        return torch.cat([fn(h) for h in xx.chunk(2, dim)], dim)

    monkeypatch.setattr(T, "transformer_forward", recording)
    monkeypatch.setattr(T, "shard_rows", split)
    monkeypatch.setattr(T, "shard_rows_2d", split)
    eot = torch.full((lead[-1],), S - 1)
    out = T.text_forward(p, x, eot, n_head=TINY_TEST.transformer_heads,
                         mesh_ctx=MeshContext(n_data, 2))
    g = T._auto_pack_g(S, int(np.prod(lead)) * n_data)
    assert g > T._auto_pack_g(S, int(np.prod(lead)) // 2)
    assert widths == [g * S, g * S] and out.shape == (*lead, TINY_TEST.embed_dim)
