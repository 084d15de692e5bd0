"""The port's feature extractor (``mudpt_torch/tools/feat_extractor.py``)
against ``lpclip/feat_extractor.py``: one tiny CLIP ``.pt`` written once from
a numpy seed (an OpenAI-layout state dict, width 64, 2 + 2 layers, 32 px),
loaded by both tools through ``--backbone_path`` on the synthetic dataset,
over the splits train, val and test; then ``lpclip/linear_probe.py``, the
file as it is, on both packages' files."""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

from mudpt_torch.tools import feat_extractor

SPLITS = ("train", "val", "test")
OPTS = ("INPUT.SIZE", "(32, 32)", "DATALOADER.TRAIN_X.BATCH_SIZE", "8")
# fp32 on both sides: the packages differ only in the order of fp32 sums
FP32_REL = 1e-4
# bf16 on both sides: each rounds its bf16 products and activations in its
# own order; the features part by about two bf16 roundings (measured
# 6.6e-3-7.2e-3 relative norm over the three splits; one rounding is 2^-8)
BF16_REL = 2.0 ** -5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def clip_state_dict(seed: int, width: int = 64, layers: int = 2, patch: int = 16,
                    grid: int = 2, embed: int = 64, vocab: int = 49408) -> dict:
    """An OpenAI-layout CLIP state dict drawn from ``seed`` (numpy): ViT
    vision and text towers of ``width`` (one 64-wide head a layer), weights
    scaled as CLIP initialises them, so the towers' activations stay O(1)."""
    rs = np.random.RandomState(seed)

    def f(*shape, std=0.02):
        return torch.from_numpy((rs.standard_normal(shape) * std).astype(np.float32))

    def ones(n):
        return torch.from_numpy((1.0 + 0.1 * rs.standard_normal(n)).astype(np.float32))

    sd = {"visual.conv1.weight": f(width, 3, patch, patch),
          "visual.class_embedding": f(width, std=width ** -0.5),
          "visual.positional_embedding": f(grid * grid + 1, width, std=width ** -0.5),
          "visual.ln_pre.weight": ones(width), "visual.ln_pre.bias": f(width),
          "visual.ln_post.weight": ones(width), "visual.ln_post.bias": f(width),
          "visual.proj": f(width, embed, std=width ** -0.5),
          "token_embedding.weight": f(vocab, width), "positional_embedding": f(77, width, std=0.01),
          "ln_final.weight": ones(width), "ln_final.bias": f(width),
          "text_projection": f(width, embed, std=width ** -0.5),
          "logit_scale": torch.tensor(float(np.log(1 / 0.07)))}
    for prefix in ("visual.transformer.resblocks", "transformer.resblocks"):
        for i in range(layers):
            p = f"{prefix}.{i}."
            sd.update({p + "ln_1.weight": ones(width), p + "ln_1.bias": f(width),
                       p + "attn.in_proj_weight": f(3 * width, width, std=width ** -0.5),
                       p + "attn.in_proj_bias": f(3 * width),
                       p + "attn.out_proj.weight": f(width, width, std=width ** -0.5),
                       p + "attn.out_proj.bias": f(width),
                       p + "ln_2.weight": ones(width), p + "ln_2.bias": f(width),
                       p + "mlp.c_fc.weight": f(4 * width, width, std=width ** -0.5),
                       p + "mlp.c_fc.bias": f(4 * width),
                       p + "mlp.c_proj.weight": f(width, 4 * width, std=(4 * width) ** -0.5),
                       p + "mlp.c_proj.bias": f(width)})
    return sd


def write_clip_pt(path: str, seed: int = 0) -> str:
    torch.save(clip_state_dict(seed), path)
    return path


@pytest.fixture(scope="module")
def features(tmp_path_factory):
    """Both tools' files for every split and dtype: {(package, dtype): dir}.
    Each package reads its own copy of the .pt (a .pt's conversion is cached
    beside it)."""
    sys.path.insert(0, "lpclip")
    jax_tool = importlib.import_module("feat_extractor")
    root = tmp_path_factory.mktemp("feat")
    pts = {pkg: write_clip_pt(str(root / f"clip_{pkg}.pt")) for pkg in ("jax", "port")}
    dirs = {}
    for dtype in ("fp32", "bf16"):
        for pkg in ("jax", "port"):
            out = str(root / f"{pkg}_{dtype}")
            for split in SPLITS:
                argv = ["--output_dir", out, "--dataset_config_file",
                        "configs/datasets/synthetic.yaml", "--split", split,
                        "--backbone_path", pts[pkg], "--dtype", dtype]
                if pkg == "jax":
                    jax_tool.main(jax_tool.parse_args([*argv, *OPTS]))
                else:
                    rec = feat_extractor.main([*argv, "--device", "cpu", *OPTS])
                    assert rec["path"] == os.path.join(out, "Synthetic", f"{split}.npz")
                    assert rec["dtype"] == dtype and rec["device"] == "cpu"
            dirs[pkg, dtype] = out
    return dirs


def _load(out, split):
    with np.load(os.path.join(out, "Synthetic", f"{split}.npz")) as f:
        assert sorted(f.files) == ["feature_list", "label_list"]
        return f["feature_list"], f["label_list"]


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype,limit", [("fp32", FP32_REL), ("bf16", BF16_REL)])
def test_features_match_jax_extractor(features, split, dtype, limit):
    want_f, want_l = _load(features["jax", dtype], split)
    got_f, got_l = _load(features["port", dtype], split)
    assert got_f.dtype == np.float32 and got_f.shape == want_f.shape
    assert got_f.shape[1] == 64 and len(got_f) == {"train": 32, "val": 8, "test": 16}[split]
    np.testing.assert_array_equal(got_l, want_l)
    rel = _rel(got_f, want_f)
    print(f"{dtype} {split}: relative norm {rel:.3e} (limit {limit:.3e})")
    assert rel <= limit, rel


def test_bf16_features_near_fp32(features):
    """The bf16 run is the bf16 tower, not a copy of the fp32 one: its
    features differ from the fp32 run's, by bf16 roundings alone."""
    f32, _ = _load(features["port", "fp32"], "test")
    b16, _ = _load(features["port", "bf16"], "test")
    rel = _rel(b16, f32)
    assert 0 < rel <= BF16_REL, rel


def test_linear_probe_same_accuracy(features, tmp_path, monkeypatch):
    """``lpclip/linear_probe.py`` (unchanged) on the port's fp32 files gives
    the JAX files' test accuracy at every shot count."""
    sys.path.insert(0, "lpclip")
    linear_probe = importlib.import_module("linear_probe")
    monkeypatch.chdir(tmp_path)
    reports = {}
    for pkg in ("jax", "port"):
        args = linear_probe.parse_args([
            "--trainval_dataset", "Synthetic", "--test_dataset", "Synthetic",
            "--feature_dir", features[pkg, "fp32"], "--num_step", "2", "--num_run", "2",
            "--report_dir", str(tmp_path / f"report_{pkg}")])
        linear_probe.main(args)
        (summary,) = [p for p in (tmp_path / f"report_{pkg}" / "Synthetic").glob("*.txt")
                      if "details" not in p.name]
        reports[pkg] = summary.read_text().splitlines()
    assert len(reports["port"]) == 5 and reports["port"] == reports["jax"], reports


def test_throughput_counts_collected_images(tmp_path):
    """The timed images are those collected after the first batch: all the
    others, the padded rows of the last batch left out."""
    rec = feat_extractor.main(["--output_dir", str(tmp_path), "--dataset_config_file",
                               "configs/datasets/synthetic.yaml", "--split", "train",
                               "--backbone_name", "test-tiny", "--backbone_path", "random",
                               "--device", "cpu", "INPUT.SIZE", "(32, 32)",
                               "DATALOADER.TRAIN_X.BATCH_SIZE", "12"])
    # 32 train images in batches of 12: 12 in the first, 20 timed
    assert rec["n_images"] == 32 and rec["timed_images"] == 20
    assert rec["seconds"] > 0 and rec["img_per_sec"] > 0


def test_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        feat_extractor.main(["--split", "test", "--dataset_config_file",
                             "configs/datasets/synthetic.yaml"])
