"""The CLIP checkpoint registry and its verified download in both packages
(``models/download.py``), ``api.load`` by registry name, and the engine's
``load_backbone`` on a cache miss.  No socket is opened: the registry is
replaced by one ``file://`` entry whose path carries the real SHA256 of a
tiny CLIP state dict written here with ``torch.save``, and every other
cache miss meets a ``download_model`` that raises."""

import dataclasses
import hashlib
import os
import urllib.request

import numpy as np
import pytest
import torch

import mudpt_tpu.api as japi
from mudpt_tpu.models import download as JD

import mudpt_torch.api as tapi
from mudpt_torch.config import default_config
from mudpt_torch.models import download as TD
from mudpt_torch.trainers.base import load_backbone
from tests.test_torch_checkpoint import _same_clip, _state_dict

NAME = "tiny-clip"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on few cores: keep torch's intra-op
    pool small so these files do not crowd out timing-sensitive tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def registry(tmp_path, monkeypatch):
    """Both packages' registries hold one ``file://`` entry for a tiny
    ``.pt``; returns (its bytes, its sha256)."""
    src = tmp_path / "src.pt"
    torch.save(_state_dict(np.random.RandomState(4)), src)
    data = src.read_bytes()
    digest = hashlib.sha256(data).hexdigest()
    served = tmp_path / "served" / digest / "tiny.pt"
    served.parent.mkdir(parents=True)
    served.write_bytes(data)
    for mod in (JD, TD):
        monkeypatch.setattr(mod, "_MODELS", {NAME: served.as_uri()})
    return data, digest


def _no_urlopen(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("urlopen reached on a verified cache hit")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)


def test_available_models_match():
    assert TD.available_models() == JD.available_models() == list(JD._MODELS)
    assert TD._MODELS == JD._MODELS and len(TD._MODELS) == 9
    assert tapi.available_models() == japi.available_models()


def test_miss_downloads_and_verifies(tmp_path, registry):
    data, digest = registry
    paths = [mod.download_model(NAME, str(tmp_path / root))
             for mod, root in ((JD, "jax"), (TD, "port"))]
    assert [os.path.basename(p) for p in paths] == ["tiny.pt", "tiny.pt"]
    for p in paths:
        with open(p, "rb") as f:
            assert f.read() == data
        assert TD._sha256(p) == JD._sha256(p) == digest


def test_hit_never_opens_a_url(tmp_path, registry, monkeypatch):
    root = str(tmp_path / "cache")
    first = TD.download_model(NAME, root)
    _no_urlopen(monkeypatch)
    assert TD.download_model(NAME, root) == first == JD.download_model(NAME, root)


def test_corrupted_cache_downloads_again(tmp_path, registry):
    data, _ = registry
    root = tmp_path / "cache"
    root.mkdir()
    (root / "tiny.pt").write_bytes(b"truncated")
    with pytest.warns(UserWarning, match="SHA256 mismatches; re-downloading"):
        path = TD.download_model(NAME, str(root))
    assert open(path, "rb").read() == data


def test_bad_digest_after_download_raises(tmp_path, registry, monkeypatch):
    _, digest = registry
    url = TD._MODELS[NAME].replace(digest, "0" * 64)
    os.makedirs(url[len("file://"):].rsplit("/", 1)[0])
    with open(url[len("file://"):], "wb") as f:
        f.write(b"not the file the digest names")
    monkeypatch.setattr(TD, "_MODELS", {NAME: url})
    with pytest.raises(RuntimeError, match="SHA256 checksum mismatches"):
        TD.download_model(NAME, str(tmp_path / "cache"))


def test_unknown_name_raises():
    with pytest.raises(KeyError, match="available"):
        TD.download_model("ViT-H/14", "/nonexistent")


def test_api_load_by_name(tmp_path, registry):
    """``api.load(name, download_root)``: the same config and parameters as
    ``mudpt_tpu.api.load`` (the port's on the CPU, as asked)."""
    jcfg, jparams, jpre = japi.load(NAME, str(tmp_path / "jax"))
    tcfg, tparams, tpre = tapi.load(NAME, str(tmp_path / "port"), device="cpu")
    _same_clip((jcfg, jparams), (tcfg, tparams))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tpre.size == jpre.size == jcfg.image_resolution
    # a local path still loads as before
    local = tapi.load(str(tmp_path / "port" / "tiny.pt"), device="cpu")
    _same_clip((jcfg, jparams), local[:2])


def _cfg(name, path=""):
    cfg = default_config()
    cfg.MODEL.BACKBONE.NAME, cfg.MODEL.BACKBONE.PATH = name, path
    return cfg


def _failing_download(monkeypatch):
    calls = []

    def fail(name, root="~/.cache/clip"):
        calls.append(name)
        raise OSError("no network in this environment")

    monkeypatch.setattr(TD, "download_model", fail)
    return calls


def test_load_backbone_attempts_the_download(tmp_path, monkeypatch):
    """``tests/test_trainers.py:371-410`` for the port: a cache miss on a
    registry name attempts the download once and raises naming the cache
    and the 'random' opt-in; a name outside the registry raises the second
    error; 'random' still inits."""
    monkeypatch.setenv("HOME", str(tmp_path))  # an empty ~/.cache/clip
    calls = _failing_download(monkeypatch)
    with pytest.raises(RuntimeError) as exc:
        load_backbone(_cfg("ViT-B/16"), "cpu")
    msg = str(exc.value)
    assert calls == ["ViT-B/16"], "the download must be attempted on a cache miss"
    assert ".cache/clip" in msg and "random" in msg and "download failed (OSError" in msg
    with pytest.raises(RuntimeError, match="not a known download") as exc:
        load_backbone(_cfg("test-tiny"), "cpu")
    assert "random" in str(exc.value) and calls == ["ViT-B/16"]
    clip_cfg, _ = load_backbone(_cfg("test-tiny", "random"), "cpu")
    assert clip_cfg.vision_layers == 2


def test_load_backbone_cache_names(tmp_path, monkeypatch):
    """The cache file is the registry URL's basename: 'ViT-L/14@336px' reads
    ``ViT-L-14-336px.pt``, without a download."""
    monkeypatch.setenv("HOME", str(tmp_path))
    calls = _failing_download(monkeypatch)
    cache = tmp_path / ".cache" / "clip"
    cache.mkdir(parents=True)
    torch.save(_state_dict(np.random.RandomState(5)), cache / "ViT-L-14-336px.pt")
    got = load_backbone(_cfg("ViT-L/14@336px"), "cpu")
    _same_clip(tapi.load(str(cache / "ViT-L-14-336px.pt"), device="cpu")[:2], got)
    assert calls == []
    assert os.path.basename(TD._MODELS["ViT-L/14@336px"]) == "ViT-L-14-336px.pt"


def test_load_backbone_downloads_on_a_miss(tmp_path, registry, monkeypatch):
    """A registry name missing from the cache loads what ``download_model``
    fetched, as the JAX package's ``load_backbone`` does."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    from mudpt_tpu.trainers.base import load_backbone as jax_load_backbone

    got = load_backbone(_cfg(NAME), "cpu")
    assert (tmp_path / "home" / ".cache" / "clip" / "tiny.pt").is_file()
    _same_clip(jax_load_backbone(_cfg(NAME)), got)
