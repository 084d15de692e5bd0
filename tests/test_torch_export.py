"""Serving artifacts of the port (``mudpt_torch/serving.py``), the
counterparts of ``tests/test_serving.py``'s cases on the CPU: the ``xla``
tier's round trip with a symbolic batch, CoCoOp's pinned batch, trained
weights live, the kernel tiers validated and exported (their custom ops run
the plain versions on the CPU), ``pallas_int8_static`` calibrating, reusing
a trainer's scales and refusing instance-conditional trainers, the text
tower pruned, an ambient quant mode cleared, ``export_zero_shot`` against
``api.zero_shot_classifier``, and a CPU-exported program moved to another
device.  The port's ``xla`` artifact against the JAX package's is in
``test_torch_export_jax.py``, the tools in ``test_torch_export_cli.py``."""

import json
import os

import numpy as np
import pytest
import torch

from mudpt_torch import api, serving
from mudpt_torch.config import load_config
from mudpt_torch.models import layers as TL
from mudpt_torch.models.clip import TINY_TEST, init_clip_params, leaves
from mudpt_torch.trainers import build_trainer

FILES = ("configs/datasets/synthetic.yaml", "configs/trainers/test/tiny.yaml")
HPARAMS = {"VPT": ("VISUAL_PROMPT_DEPTH", "2", "DEEP_VISUAL_N_CTX", "2"), "CoCoOp": ("N_CTX", "4")}
FP32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _opts(trainer, out, *more):
    key = f"TRAINER.{trainer.upper()}"
    opts = ["TRAINER.NAME", trainer, "OUTPUT_DIR", str(out)]
    if not trainer.startswith("Zeroshot"):
        opts += [f"{key}.PREC", "fp32"]
    hp = HPARAMS.get(trainer, ())
    for k, v in zip(hp[::2], hp[1::2]):
        opts += [f"{key}.{k}", v]
    return opts + list(more)


def _trainer(trainer, tmp_path, *more):
    return build_trainer(load_config(*FILES, opts=_opts(trainer, tmp_path / trainer, *more)),
                         devices="cpu")


def _images(n, res=32, seed=0):
    return np.random.RandomState(seed).randn(n, res, res, 3).astype(np.float32)


def _forward(tr, imgs):
    with torch.no_grad():
        out = tr.forward(tr.trainable, tr.frozen, tr.aux, torch.from_numpy(imgs))
    return out[:, :tr.num_classes].float().numpy()


def _in_process(tr, tier, imgs, **kw):
    score, ops, _ = serving.trainer_program(tr, block_impl=tier, **kw)
    with torch.no_grad(), serving._block_impl(tier):
        return score(ops, torch.from_numpy(imgs)).numpy()


def _ops_in(art):
    """The custom ops a program calls, by name."""
    program = torch.export.load(os.path.join(art, "program.pt2"))
    return {str(n.target) for n in program.graph.nodes
            if n.op == "call_function" and str(n.target).startswith("mudpt.")}


@pytest.mark.parametrize("name", ["MuDPT", "UUMuDPT", "VPT"])
def test_export_trainer_round_trip_symbolic_batch(tmp_path, name):
    """The cached-text image path of three distinct forwards: the artifact
    equals the trainer's forward, one program at batches 1, 2 and 3."""
    tr = _trainer(name, tmp_path)
    art = str(tmp_path / "artifact")
    serving.export_trainer(art, tr, platforms=("cpu",))
    assert sorted(os.listdir(art)) == ["meta.json", "params.npz", "program.pt2"]
    clf = serving.load(art, device="cpu")
    assert clf.classnames == list(tr.classnames)
    assert clf.meta["trainer"] == name and clf.meta["block_impl"] == "xla"
    assert clf.meta["preprocess"]["resize_then_center_crop"] == 32
    assert clf.meta["torch_version"] == torch.__version__ and clf.meta["batch"] is None
    assert clf.meta["perf"]["BLOCK"] == "auto" and not _ops_in(art)
    for b in (2, 3, 1):
        imgs = _images(b, seed=b)
        got = clf.predict(imgs)
        assert got.shape == (b, tr.num_classes)
        np.testing.assert_allclose(got, _forward(tr, imgs), **FP32)


def test_export_zsclip_model_inference_path(tmp_path):
    tr = _trainer("ZeroshotCLIP", tmp_path, "MODEL.BACKBONE.PATH", "random")
    art = str(tmp_path / "artifact")
    serving.export_trainer(art, tr)
    clf = serving.load(art, device="cpu")
    imgs = _images(2)
    got = clf.predict(imgs)
    # the zero-shot backbone is bf16: the artifact's XLA blocks equal the
    # tier in process bit for bit, and the trainer's own route (the kernels'
    # plain versions, which round elsewhere) to bf16 resolution, as in
    # tests/test_serving.py
    np.testing.assert_array_equal(got, _in_process(tr, "xla", imgs))
    with torch.no_grad():
        want = tr.model_inference(tr.trainable, tr.frozen, tr.aux, torch.from_numpy(imgs))
    want = want[:, :tr.num_classes].float().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert clf.meta["n_leaves"] < len(leaves(tr.frozen))


def test_export_cocoop_requires_pinned_batch(tmp_path):
    tr = _trainer("CoCoOp", tmp_path)
    art = str(tmp_path / "artifact")
    with pytest.raises(ValueError, match="batch"):
        serving.export_trainer(art, tr, platforms=("cpu",))
    serving.export_trainer(art, tr, batch=2, platforms=("cpu",))
    clf = serving.load(art, device="cpu")
    imgs = _images(2)
    np.testing.assert_allclose(clf.predict(imgs), _forward(tr, imgs), **FP32)
    with pytest.raises(ValueError, match="pinned to batch 2"):
        clf.predict(_images(3))
    # the int8 tier exports the full forward too, its per-instance text
    # encode on the dynamic chain (the JAX package's serving.py:273-281);
    # the static tier refuses, naming the dynamic one
    q8 = str(tmp_path / "artifact_q8")
    serving.export_trainer(q8, tr, batch=2, block_impl="pallas_int8")
    assert _ops_in(q8) == {"mudpt.layer_fullblock_q8.default", "mudpt.layernorm_fwd.default"}
    np.testing.assert_array_equal(serving.load(q8, device="cpu").predict(imgs),
                                  _in_process(tr, "pallas_int8", imgs))
    with pytest.raises(ValueError, match="block_impl='pallas_int8'"):
        serving.export_trainer(art, tr, batch=2, block_impl="pallas_int8_static")


def test_export_trained_weights_are_live(tmp_path):
    tr = _trainer("CoOp", tmp_path)
    a0, a1 = str(tmp_path / "a0"), str(tmp_path / "a1")
    serving.export_trainer(a0, tr)
    tr.train()
    serving.export_trainer(a1, tr)
    imgs = _images(2)
    l0 = serving.load(a0, device="cpu").predict(imgs)
    l1 = serving.load(a1, device="cpu").predict(imgs)
    assert np.abs(l0 - l1).max() > 1e-6
    np.testing.assert_allclose(l1, _forward(tr, imgs), **FP32)


@pytest.fixture(scope="module")
def mudpt(tmp_path_factory):
    return _trainer("MuDPT", tmp_path_factory.mktemp("mudpt"))


@pytest.mark.parametrize("tier,ops", [("pallas", {"mudpt.layer_fullblock.default",
                                                  "mudpt.layernorm_fwd.default"}),
                                      ("pallas_int8", {"mudpt.layer_fullblock_q8.default",
                                                       "mudpt.layernorm_fwd.default"})])
def test_export_kernel_tiers_validated_and_exported(tmp_path, mudpt, tier, ops):
    """The kernel tiers are CUDA-only and need a pinned batch; the program
    calls the chains as ``mudpt::`` custom ops, which on the CPU run the
    plain versions: the same logits as the tier in process.  The export
    leaves the block impl and quant mode as they were."""
    art = str(tmp_path / tier)
    with pytest.raises(ValueError, match="CUDA-only"):
        serving.export_trainer(art, mudpt, batch=4, block_impl=tier, platforms=("cpu",))
    with pytest.raises(ValueError, match="pinned batch"):
        serving.export_trainer(art, mudpt, block_impl=tier)
    serving.export_trainer(art, mudpt, batch=4, block_impl=tier)
    meta = json.load(open(os.path.join(art, "meta.json")))
    assert meta["block_impl"] == tier and meta["platforms"] == ["cuda"] and meta["batch"] == 4
    assert _ops_in(art) == ops
    assert TL.block_impl() == "auto" and TL.quant_mode() == "none"
    imgs = _images(4)
    got = serving.load(art, device="cpu").predict(imgs)
    np.testing.assert_array_equal(got, _in_process(mudpt, tier, imgs))
    if tier == "pallas":
        np.testing.assert_allclose(got, _forward(mudpt, imgs), **FP32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.load(art)


def test_export_pallas_int8_static_artifact(tmp_path, mudpt):
    art = str(tmp_path / "q8s")
    with pytest.raises(ValueError, match="calib_images"):
        serving.export_trainer(art, mudpt, batch=4, block_impl="pallas_int8_static")
    with pytest.raises(ValueError, match="only used by"):
        serving.export_trainer(art, mudpt, batch=4, block_impl="pallas",
                               calib_images=_images(4))
    calib = _images(8, seed=5)
    serving.export_trainer(art, mudpt, batch=4, block_impl="pallas_int8_static",
                           calib_images=calib)
    meta = json.load(open(os.path.join(art, "meta.json")))
    assert meta["calibration"] == {"n_images": 8}
    assert _ops_in(art) == {"mudpt.layer_fullblock_q8_static.default",
                            "mudpt.layernorm_fwd.default"}
    npz = np.load(os.path.join(art, "params.npz"))
    n_layers = mudpt.clip_cfg.vision_layers
    assert any(npz[k].shape == (n_layers, 4) and npz[k].dtype == np.float32 for k in npz.files)
    imgs = _images(4)
    got = serving.load(art, device="cpu").predict(imgs)
    np.testing.assert_array_equal(got, _in_process(mudpt, "pallas_int8_static", imgs,
                                                   calib_images=calib))
    assert TL.quant_mode() == "none" and TL.block_impl() == "auto"


def test_export_static_rejects_instance_conditional(tmp_path):
    tr = _trainer("CoCoOp", tmp_path)
    with pytest.raises(ValueError, match="pallas_int8"):
        serving.export_trainer(str(tmp_path / "a"), tr, batch=4,
                               block_impl="pallas_int8_static", calib_images=_images(4))


def test_export_static_reuses_trainer_scales(tmp_path):
    """A trainer built under a static quant mode carries calibrated scales:
    the static export without calib_images ships them; the other tiers
    ship neither them nor the int8 weight codes."""
    tr = _trainer("MuDPT", tmp_path, "TRAIN.QUANT", "int8_ste_static")
    TL.set_quant_mode("none")
    want = tr.frozen["visual"]["blocks"]["q8_scales"].numpy()
    art = str(tmp_path / "reuse")
    serving.export_trainer(art, tr, batch=4, block_impl="pallas_int8_static")
    meta = json.load(open(os.path.join(art, "meta.json")))
    assert meta["calibration"] == {"reused_trainer_scales": True}
    npz = np.load(os.path.join(art, "params.npz"))
    shipped = [npz[k] for k in npz.files if npz[k].shape == want.shape
               and npz[k].dtype == np.float32]
    assert any(np.array_equal(s, want) for s in shipped)
    plain = str(tmp_path / "plain")
    serving.export_trainer(plain, tr)
    npz = np.load(os.path.join(plain, "params.npz"))
    assert not any(npz[k].dtype == np.int8 or npz[k].shape == want.shape for k in npz.files)


def test_export_prunes_dead_text_tower(tmp_path, mudpt):
    art = str(tmp_path / "pruned")
    serving.export_trainer(art, mudpt)
    clf = serving.load(art, device="cpu")
    n_text = len(leaves(mudpt.frozen["text"]))
    n_full = len(leaves({"t": mudpt.trainable, "f": mudpt.frozen, "a": mudpt.aux}))
    assert clf.meta["n_leaves"] <= n_full + 1 - n_text  # +1: the cached text
    vocab = mudpt.clip_cfg.vocab_size
    assert all(t.shape[:1] != (vocab,) for t in clf._leaves)
    imgs = _images(3)
    np.testing.assert_allclose(clf.predict(imgs), _forward(mudpt, imgs), **FP32)


def test_export_xla_clears_ambient_quant_mode(tmp_path, mudpt):
    want = _forward(mudpt, _images(2))
    TL.set_quant_mode("int8_ste")
    try:
        art = str(tmp_path / "xla_quant_ambient")
        serving.export_trainer(art, mudpt)
        assert TL.quant_mode() == "int8_ste"
    finally:
        TL.set_quant_mode("none")
    got = serving.load(art, device="cpu").predict(_images(2))
    np.testing.assert_allclose(got, want, **FP32)


def test_export_zero_shot_matches_api(tmp_path):
    params = init_clip_params(TINY_TEST, torch.Generator().manual_seed(0))
    classnames = ["tabby_cat", "dog", "bird"]
    templates = ["a photo of a {}.", "a drawing of a {}."]
    art = str(tmp_path / "zs")
    serving.export_zero_shot(art, TINY_TEST, params, classnames, templates)
    clf = serving.load(art, device="cpu")
    assert clf.meta["trainer"] == "zero-shot" and clf.meta["platforms"] == ["cpu", "cuda"]
    imgs = _images(4)
    classify = api.zero_shot_classifier(TINY_TEST, params, classnames, templates)
    np.testing.assert_allclose(clf.predict(imgs), classify(imgs).numpy(), **FP32)


def test_cpu_program_moves_to_another_device(tmp_path, mudpt):
    """A program runs on the device it was exported on; the loader moves it
    (``move_to_device_pass``) when the device differs: here to 'meta',
    where the masks and index vectors the towers build move with it."""
    art = str(tmp_path / "moved")
    serving.export_trainer(art, mudpt)
    clf = serving.load(art, device="meta")
    nodes = [n for n in clf._module.graph.nodes if "device" in n.kwargs]
    assert nodes and all(str(n.kwargs["device"]) == "meta" for n in nodes)
    out = clf.forward(torch.empty(3, 32, 32, 3, device="meta"))
    assert out.device.type == "meta" and tuple(out.shape) == (3, mudpt.num_classes)
