"""Reference (Dassl ``torch.save``) checkpoints in and out of the port,
against the JAX package on the same numpy-seeded trees:
``mudpt_torch/models/{import,export}_reference.py``, ``utils/checkpoint``'s
torch-pickle branch, ``--eval_only --model_dir <Dassl dir>`` through both
CLIs, and the two conversion tools of ``mudpt_torch/tools``."""

import importlib.util
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

from mudpt_tpu.models import export_reference as JE
from mudpt_tpu.models import import_reference as JI
from mudpt_tpu.utils import checkpoint as JK

from mudpt_torch.models import export_reference as TE
from mudpt_torch.models import import_reference as TI
from mudpt_torch.utils import checkpoint as TK

from tests.test_torch_feat_extractor import write_clip_pt

D = 16  # prompt width of the trees below


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _draw(rs, *shape):
    return rs.standard_normal(shape).astype(np.float32)


def _lin(rs, i, o):
    return {"w": _draw(rs, i, o), "b": _draw(rs, o)}


def _ln(rs, d):
    return {"scale": _draw(rs, d), "bias": _draw(rs, d)}


def _head(rs, d, out):
    block = {"ln_1": _ln(rs, d),
             "attn": {"qkv_w": _draw(rs, d, 3 * d), "qkv_b": _draw(rs, 3 * d),
                      "out_w": _draw(rs, d, d), "out_b": _draw(rs, d)},
             "ln_2": _ln(rs, d),
             "mlp": {"fc_w": _draw(rs, d, 4 * d), "fc_b": _draw(rs, 4 * d),
                     "proj_w": _draw(rs, 4 * d, d), "proj_b": _draw(rs, d)}}
    return {"ln_pre": _ln(rs, d), "block": block, "ln_post": _ln(rs, d), "proj": _lin(rs, d, out)}


def family_tree(trainer: str, seed: int = 0) -> dict:
    """A trainable tree of ``trainer``'s layout (names and nesting as the
    trainers build them), leaves drawn from ``seed``."""
    rs = np.random.RandomState(seed)
    if trainer == "MuDPT":
        return {"ctx": _draw(rs, 2, D), "deep_prompts": _draw(rs, 2, 2, D),
                "embed_projection": _lin(rs, D, 24), "deep_projections": _lin(rs, D, 24),
                "visual_ctx": _draw(rs, 2, 24), "visual_ctx_deep_prompts": _draw(rs, 2, 2, 24),
                "visual_ctx_deep_projections": _lin(rs, 24, D)}
    if trainer in ("UMuDPT", "UUMuDPT"):
        tree = {"ctx": _draw(rs, 2, D), "deep_prompts": _draw(rs, 2, 2, D),
                "t2v": _head(rs, D, 24)}
        if trainer == "UUMuDPT":
            tree.update(visual_ctx=_draw(rs, 2, 24), visual_ctx_deep_prompts=_draw(rs, 2, 2, 24),
                        v2t=_head(rs, 24, D))
        return tree
    if trainer == "CoCoOp":
        return {"ctx": _draw(rs, 4, D),
                "meta_net": {"linear1": _lin(rs, 24, 2), "linear2": _lin(rs, 2, D)}}
    if trainer == "CoOp":
        return {"ctx": _draw(rs, 4, D)}
    if trainer == "VPT":
        return {"visual_ctx": _draw(rs, 3, 24), "visual_deep_prompts": _draw(rs, 2, 3, 24)}
    if trainer == "MPT":
        return {"ctx": _draw(rs, 2, D), "visual_ctx": _draw(rs, 3, 24),
                "visual_deep_prompts": _draw(rs, 2, 3, 24), "text_deep_prompts": _draw(rs, 1, 2, D)}
    raise KeyError(trainer)


FAMILIES = ("MuDPT", "UMuDPT", "UUMuDPT", "CoCoOp", "CoOp", "VPT", "MPT")
# the class buffers and frozen weights a reference checkpoint also holds
EXTRA_KEYS = {"MuDPT": ("mudpt_prompt_learner.token_prefix", "image_encoder.conv1.weight"),
              "UMuDPT": ("umudpt_prompt_learner.token_suffix", "logit_scale"),
              "UUMuDPT": ("uumudpt_prompt_learner.token_prefix", "logit_scale"),
              "CoCoOp": ("token_prefix", "token_suffix"), "CoOp": ("token_prefix", "token_suffix"),
              "VPT": ("image_encoder.conv1.weight", "text_encoder.positional_embedding"),
              "MPT": ("text_prompt_learner.token_prefix", "image_encoder.ln_post.weight")}
VARIANTS = ("envelope", "bare", "module", "fp16")


def reference_file(path, trainer: str, variant: str, epoch: int = 7) -> str:
    """``trainer``'s tree as a reference checkpoint would hold it (the JAX
    exporter's keys, plus class buffers and frozen weights) in one of the
    forms Dassl runs write: its envelope, a bare state dict, an
    nn.DataParallel ``module.`` prefix, or fp16 leaves."""
    sd, _ = JE.trainable_to_reference_state_dict(family_tree(trainer))
    rs = np.random.RandomState(1)
    sd = {k: torch.from_numpy(v.copy()) for k, v in sd.items()}
    sd.update({k: torch.from_numpy(_draw(rs, 3, 4)) for k in EXTRA_KEYS[trainer]})
    if variant == "fp16":
        sd = {k: v.half() for k, v in sd.items()}
    if variant == "module":
        sd = {f"module.{k}": v for k, v in sd.items()}
    torch.save(sd if variant == "bare" else {"state_dict": sd, "epoch": epoch}, path)
    return path


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def assert_trees_bit_equal(got: dict, want: dict) -> None:
    got, want = _flat(got), _flat(want)
    assert list(got) == list(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert isinstance(got[k], np.ndarray) and g.dtype == w.dtype == np.float32, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("trainer", FAMILIES)
def test_import_matches_jax(tmp_path, trainer, variant):
    path = reference_file(str(tmp_path / "model.pth.tar-7"), trainer, variant)
    want, wmeta = JI.load_reference_checkpoint(path)
    got, meta = TI.load_reference_checkpoint(path)
    assert_trees_bit_equal(got, want)
    assert meta == wmeta
    assert meta["trainer"] == ("VPT/MPT" if trainer in ("VPT", "MPT") else trainer)
    assert meta.get("epoch") == (None if variant == "bare" else 7)
    if variant != "fp16":
        assert_trees_bit_equal(got, family_tree(trainer))


def test_import_bf16_leaves(tmp_path):
    """A bf16 state dict converts through ``to_numpy`` (as fp32 values)."""
    sd, _ = TE.trainable_to_reference_state_dict(family_tree("CoCoOp"))
    torch.save({"state_dict": {k: torch.from_numpy(v).bfloat16() for k, v in sd.items()}},
               tmp_path / "m")
    got, _ = TI.load_reference_checkpoint(str(tmp_path / "m"))
    want = {k: torch.from_numpy(v).bfloat16().float().numpy() for k, v in sd.items()}
    np.testing.assert_array_equal(got["meta_net"]["linear1"]["w"],
                                  want["meta_net.linear1.weight"].T)


@pytest.mark.parametrize("trainer", FAMILIES)
def test_export_matches_jax(trainer):
    tree = family_tree(trainer)
    want, wfam = JE.trainable_to_reference_state_dict(tree)
    for name in (None, trainer):
        got, fam = TE.trainable_to_reference_state_dict(tree, name)
        assert fam == wfam
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # torch tensors (a live trainer's leaves) export as their arrays do
    as_tensors = jax.tree_util.tree_map(torch.from_numpy, tree)
    got, _ = TE.trainable_to_reference_state_dict(as_tensors, trainer)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_ctx_only_mpt_exports_by_trainer():
    """The documented difference: MPT with VISUAL_PROMPT_DEPTH 0 and
    TEXT_PROMPT_DEPTH <= 1 trains ``ctx`` alone.  The JAX exporter reads the
    tree's keys and writes CoOp's bare ``ctx``; the port given trainer MPT
    writes the key the reference MPT loads, and without a trainer infers as
    the JAX exporter does."""
    tree = {"ctx": family_tree("MPT")["ctx"]}
    jsd, jfam = JE.trainable_to_reference_state_dict(tree)
    assert (list(jsd), jfam) == (["ctx"], "CoOp")
    tsd, tfam = TE.trainable_to_reference_state_dict(tree, "MPT")
    assert (list(tsd), tfam) == (["text_prompt_learner.visual_ctx"], "VPT/MPT")
    np.testing.assert_array_equal(tsd["text_prompt_learner.visual_ctx"], tree["ctx"])
    tsd, tfam = TE.trainable_to_reference_state_dict(tree)
    assert (list(tsd), tfam) == (["ctx"], "CoOp")
    back, fam = TI.reference_state_dict_to_trainable(
        TE.trainable_to_reference_state_dict(tree, "MPT")[0])
    assert fam == "VPT/MPT"
    assert_trees_bit_equal(back, tree)


@pytest.mark.parametrize("trainer", FAMILIES)
def test_export_then_import_is_identity(tmp_path, trainer):
    tree = family_tree(trainer, seed=5)
    path = TE.save_reference_checkpoint(str(tmp_path / "model.pth.tar-3"), tree, epoch=3,
                                        trainer=trainer)
    assert TI.is_torch_checkpoint(path)
    back, meta = TI.load_reference_checkpoint(path)
    assert_trees_bit_equal(back, tree)
    assert meta["epoch"] == 3
    with pytest.raises(ValueError, match="no reference checkpoint layout"):
        TE.trainable_to_reference_state_dict(tree, "ZeroshotCLIP")


def test_is_torch_checkpoint_matches_jax(tmp_path):
    sd = {"ctx": torch.zeros(2, 3)}
    torch.save(sd, tmp_path / "zip.pt")
    torch.save(sd, tmp_path / "legacy.pt", _use_new_zipfile_serialization=False)
    np.savez(tmp_path / "arrays.npz", ctx=np.zeros(3))
    with open(tmp_path / "plain.pkl", "wb") as f:
        pickle.dump({"a": 1}, f, protocol=2)
    (tmp_path / "text.txt").write_text("PK not a zip")
    TK.save_checkpoint(str(tmp_path), "native", 1, {"ctx": np.zeros(3, np.float32)})
    cases = {"zip.pt": True, "legacy.pt": True, "arrays.npz": False, "plain.pkl": True,
             "text.txt": False, "missing.pt": False, "native/model.pth.tar-1": False}
    for name, want in cases.items():
        path = str(tmp_path / name)
        assert JI.is_torch_checkpoint(path) == TI.is_torch_checkpoint(path) == want, name


def test_unrecognised_state_dict_raises(tmp_path):
    sd = {"image_encoder.conv1.weight": torch.zeros(2), "logit_scale": torch.zeros(())}
    for fn in (JI.reference_state_dict_to_trainable, TI.reference_state_dict_to_trainable):
        with pytest.raises(ValueError, match="Unrecognized reference checkpoint"):
            fn(sd)
    with pytest.raises(ValueError, match="Unrecognized trainable tree"):
        TE.trainable_to_reference_state_dict({"meta": np.zeros(2)})


def test_load_checkpoint_reads_dassl_and_native(tmp_path):
    """``utils/checkpoint.load_checkpoint`` routes a torch pickle through the
    importer, (tree, None, meta) as the JAX package returns, and still reads
    the native .npz."""
    d = tmp_path / "MultimodalDeepPromptTuning"
    d.mkdir()
    reference_file(str(d / "model.pth.tar-4"), "MuDPT", "envelope", epoch=4)
    reference_file(str(d / "model-best.pth.tar"), "MuDPT", "module", epoch=4)
    for kw in ({"epoch": 4}, {}):
        tree, opt, meta = TK.load_checkpoint(str(tmp_path), d.name, **kw)
        jtree, jopt, jmeta = JK.load_checkpoint(str(tmp_path), d.name, **kw)
        assert opt is None and jopt is None and meta == jmeta
        assert meta["trainer"] == "MuDPT" and meta["epoch"] == 4
        assert_trees_bit_equal(tree, jtree)
    TK.save_checkpoint(str(tmp_path), "native", 2, family_tree("CoOp"), meta={"trainer": "CoOp"})
    tree, _, meta = TK.load_checkpoint(str(tmp_path), "native", 2)
    assert meta["trainer"] == "CoOp"
    assert_trees_bit_equal(tree, family_tree("CoOp"))


# ---------------------------------------------------------------------------
# --eval_only --model_dir <a Dassl dir> through both CLIs
# ---------------------------------------------------------------------------

REL = 1e-4  # fp32 on both sides: the packages differ in the order of fp32 sums


def _cli(main, argv):
    streams = sys.stdout, sys.stderr
    try:
        return main(argv)
    finally:
        sys.stdout, sys.stderr = streams


def test_eval_only_on_a_dassl_dir_matches_jax_cli(tmp_path, monkeypatch):
    import train as jax_cli

    from mudpt_torch import train as port_cli
    from mudpt_tpu.trainers import base as jbase

    pt = write_clip_pt(str(tmp_path / "clip.pt"))
    common = ["--trainer", "MuDPT", "--dataset_config", "configs/datasets/synthetic.yaml",
              "--trainer_config", "configs/trainers/test/tiny.yaml", "--backbone_path", pt]
    # the prompts: a JAX trainer's trees on the same backbone, moved off
    # their init by seeded noise, exported as the reference writes them
    jtr = jbase.build_trainer(jax_cli.setup_config(jax_cli.parse_args(
        [*common, "--output_dir", str(tmp_path / "build")])))
    rs = np.random.RandomState(3)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.5 * rs.standard_normal(a.shape).astype(np.float32),
        jtr.trainable)
    ref_dir = tmp_path / "reference_out"
    (ref_dir / jtr.model_name).mkdir(parents=True)
    JE.save_reference_checkpoint(str(ref_dir / jtr.model_name / "model.pth.tar-2"), tree, 2)

    built = []
    monkeypatch.setattr("mudpt_tpu.trainers.build_trainer",
                        lambda cfg: built.append(jbase.build_trainer(cfg)) or built[-1])
    evals = ["--eval_only", "--model_dir", str(ref_dir), "--load_epoch", "2"]
    _cli(lambda a: jax_cli.main(jax_cli.parse_args(a)),
         [*common, "--output_dir", str(tmp_path / "jax"), *evals])
    ttr = _cli(lambda a: port_cli.main(port_cli.parse_args(a)),
               [*common, "--output_dir", str(tmp_path / "port"), "--device", "cpu", *evals])
    (jtr,) = built
    want = TK._flatten(tree)
    for got in (TK._flatten(ttr.trainable), TK._flatten(jtr.trainable)):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    def last_eval(out):
        import json

        with open(out / "metrics.jsonl") as f:
            return [r for r in map(json.loads, f) if r["kind"] == "eval"][-1]

    jres, tres = last_eval(tmp_path / "jax"), last_eval(tmp_path / "port")
    assert tres["accuracy"] == jres["accuracy"]
    jtxt = jtr._text_features(jtr.trainable, jtr.frozen, jtr.aux)
    ttxt = ttr._text_features(ttr.trainable, ttr.frozen, ttr.aux)
    worst = 0.0
    for batch in ttr.dm.test_loader:
        jl = np.asarray(jtr.forward_image(jtr.trainable, jtr.frozen, jtr.aux, batch["image"], jtxt))
        with torch.no_grad():
            tl = ttr.forward_image(ttr.trainable, ttr.frozen, ttr.aux,
                                   torch.from_numpy(batch["image"]), ttxt).numpy()
        worst = max(worst, float(np.abs(tl - jl).max() / np.abs(jl).max()))
    assert worst <= REL, worst


# ---------------------------------------------------------------------------
# the conversion tools
# ---------------------------------------------------------------------------

def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", f"tools/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(root) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_import_tool_matches_jax_tool(tmp_path):
    from mudpt_torch.tools import import_reference_checkpoint as tool

    for src in ("a", "b"):
        for trainer, name in (("MuDPT", "MultimodalDeepPromptTuning"),
                              ("CoOp", "prompt_learner")):
            d = tmp_path / src / name
            d.mkdir(parents=True)
            reference_file(str(d / "model.pth.tar-5"), trainer, "envelope", epoch=5)
            reference_file(str(d / "model-best.pth.tar"), trainer, "bare")
    assert _jax_tool("import_reference_checkpoint").main(["--src", str(tmp_path / "a")]) == 0
    assert tool.main(["--src", str(tmp_path / "b"), "--device", "cpu"]) == 0
    ja, tb = tmp_path / "a" / "converted", tmp_path / "b" / "converted"
    assert _files(tb) == _files(ja) and len(_files(tb)) == 8
    for rel in _files(tb):
        if rel.endswith(".json"):
            continue
        name, fname = os.path.split(rel)
        epoch = int(fname.rsplit("-", 1)[1]) if "tar-" in fname else None
        got, _, gmeta = TK.load_checkpoint(str(tb), name, epoch)
        want, _, wmeta = JK.load_checkpoint(str(ja), name, epoch)
        assert_trees_bit_equal(got, want)
        assert gmeta == wmeta
    # a single file, into a named --dst
    one = tmp_path / "b" / "prompt_learner" / "model.pth.tar-5"
    assert tool.main(["--src", str(one), "--dst", str(tmp_path / "one"), "--device", "cpu"]) == 0
    assert _files(tmp_path / "one") == ["prompt_learner/model.pth.tar-5",
                                        "prompt_learner/model.pth.tar-5.json"]


def test_export_tool_matches_jax_tool(tmp_path):
    from mudpt_torch.tools import export_reference_checkpoint as tool

    for src in ("a", "b"):
        TK.save_checkpoint(str(tmp_path / src), "MultimodalDeepPromptTuning", 3,
                           family_tree("MuDPT"), is_best=True, meta={"trainer": "MuDPT"})
        TK.save_checkpoint(str(tmp_path / src), "prompt_learner", 2, family_tree("CoCoOp"),
                           meta={"trainer": "CoCoOp"})
    assert _jax_tool("export_reference_checkpoint").main(["--src", str(tmp_path / "a")]) == 0
    assert tool.main(["--src", str(tmp_path / "b"), "--device", "cpu"]) == 0
    ja, tb = tmp_path / "a" / "exported", tmp_path / "b" / "exported"
    assert _files(tb) == _files(ja) == ["MultimodalDeepPromptTuning/model-best.pth.tar",
                                        "MultimodalDeepPromptTuning/model.pth.tar-3",
                                        "prompt_learner/model.pth.tar-2"]
    for rel in _files(tb):
        got = torch.load(tb / rel, map_location="cpu", weights_only=True)
        want = torch.load(ja / rel, map_location="cpu", weights_only=True)
        assert got["epoch"] == want["epoch"]
        assert list(got["state_dict"]) == list(want["state_dict"])
        for k, v in want["state_dict"].items():
            assert torch.equal(got["state_dict"][k], v), k


def test_export_tool_dispatches_on_the_checkpoints_trainer(tmp_path):
    """A ctx-only MPT checkpoint (its meta names trainer MPT) exports as
    ``text_prompt_learner.visual_ctx``, and the port reads it back as the
    same tree."""
    from mudpt_torch.tools import export_reference_checkpoint as tool

    tree = {"ctx": family_tree("MPT")["ctx"]}
    TK.save_checkpoint(str(tmp_path / "run"), "MaPLe", 1, tree, meta={"trainer": "MPT"})
    assert tool.main(["--src", str(tmp_path / "run"), "--dst", str(tmp_path / "out"),
                      "--device", "cpu"]) == 0
    ckpt = torch.load(tmp_path / "out" / "MaPLe" / "model.pth.tar-1", weights_only=True)
    assert list(ckpt["state_dict"]) == ["text_prompt_learner.visual_ctx"]
    back, _, meta = TK.load_checkpoint(str(tmp_path / "out"), "MaPLe", 1)
    assert meta["trainer"] == "VPT/MPT"
    assert_trees_bit_equal(back, tree)


def test_tools_without_cuda_raise(tmp_path, monkeypatch):
    from mudpt_torch.tools import export_reference_checkpoint, import_reference_checkpoint

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (import_reference_checkpoint, export_reference_checkpoint):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main(["--src", str(tmp_path)])
