"""The port's 15 dataset readers against the JAX package's on generated
trees in each dataset's layout (those of ``tests/test_dataset_formats.py``
and ``tests/test_data.py``, four classes): the same items (impath, label,
classname), classnames and split sizes under the global seed, for
``NUM_SHOTS`` -1 and 2 and ``SUBSAMPLE_CLASSES`` all, base and new; the
caches each package writes (``preprocessed.pkl``, ``split_fewshot/``) read
equal by the other; all 16 plugins registered; a ``mudpt_tpu``-written
cache read by the port without importing ``mudpt_tpu``; and the readers,
``common.py`` and ``datum.py`` (but for its unpickler) copies of the JAX
package's modules."""

import json
import os
import random
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import mudpt_tpu.data.datasets  # noqa: F401  (registration)
from mudpt_tpu.config import default_config as jdefault_config
from mudpt_tpu.data import datum as jdatum
from mudpt_tpu.utils.registry import DATASET_REGISTRY as JREG

import mudpt_torch.data.datasets  # noqa: F401  (registration)
from mudpt_torch.config import default_config
from mudpt_torch.data import datum as tdatum
from mudpt_torch.utils.registry import DATASET_REGISTRY as TREG

ROOT = Path(__file__).resolve().parent.parent
CLASSES = ("alpha", "beta", "gamma", "delta")


def _img(path: Path, shade: int = 0) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.new("RGB", (24, 24), color=(120, 80 + shade, 60)).save(path)


def _folders(img_root: Path, names, per_class: int = 10) -> None:
    for c, name in enumerate(names):
        for i in range(per_class):
            _img(img_root / name / f"{name}_{i:03d}.jpg", c)


def _pets(root: Path) -> None:
    d = root / "oxford_pets"
    rows = {"trainval.txt": [], "test.txt": []}
    for b, breed in enumerate(["Abyssinian", "beagle", "Bengal", "boxer"]):
        for i in range(7):
            name = f"{breed}_{i + 1}"
            _img(d / "images" / f"{name}.jpg", b)
            rows["trainval.txt" if i < 5 else "test.txt"].append(f"{name} {b + 1} 1 1")
    (d / "annotations").mkdir(parents=True)
    for f, lines in rows.items():
        (d / "annotations" / f).write_text("\n".join(lines) + "\n")


def _aircraft(root: Path) -> None:
    d = root / "fgvc_aircraft"
    d.mkdir(parents=True)
    variants = ["707-320", "A300B4", "Boeing 717", "Cessna 172"]
    (d / "variants.txt").write_text("\n".join(variants) + "\n")
    k = 0
    for split, n in (("train", 3), ("val", 2), ("test", 2)):
        rows = []
        for v in variants:
            for _ in range(n):
                k += 1
                rows.append(f"{k:07d} {v}")
                _img(d / "images" / f"{k:07d}.jpg")
        (d / f"images_variant_{split}.txt").write_text("\n".join(rows) + "\n")


def _flowers(root: Path) -> None:
    from scipy.io import savemat

    d = root / "oxford_flowers"
    labels = [c for c in (1, 2, 3, 4) for _ in range(10)]
    random.Random(1).shuffle(labels)
    for i in range(len(labels)):
        _img(d / "jpg" / f"image_{i + 1:05d}.jpg")
    savemat(d / "imagelabels.mat", {"labels": np.array([labels])})
    (d / "cat_to_name.json").write_text(json.dumps(
        {str(c): n for c, n in zip((1, 2, 3, 4), ("rose", "tulip", "lily", "iris"))}))


def _cars(root: Path) -> None:
    from scipy.io import savemat

    d = root / "stanford_cars"
    (d / "devkit").mkdir(parents=True)
    names = np.array([["Audi A4 Sedan 2012", "BMW M3 Coupe 2015", "Fiat 500 Abarth 2012",
                       "Kia Soul 2011"]], dtype=object)
    savemat(d / "devkit" / "cars_meta.mat", {"class_names": names})

    def annos(image_dir, n_per_cls):
        rec = np.zeros((1, 4 * n_per_cls), dtype=[("bbox_x1", "O"), ("class", "O"),
                                                   ("fname", "O")])
        k = 0
        for cls in (1, 2, 3, 4):
            for i in range(n_per_cls):
                fname = f"{cls}_{i}.jpg"
                _img(d / image_dir / fname, cls)
                rec[0, k]["bbox_x1"] = np.array([[1]])
                rec[0, k]["class"] = np.array([[cls]])
                rec[0, k]["fname"] = fname
                k += 1
        return {"annotations": rec}

    savemat(d / "devkit" / "cars_train_annos.mat", annos("cars_train", 5))
    savemat(d / "cars_test_annos_withlabels.mat", annos("cars_test", 2))


def _sun(root: Path) -> None:
    d = root / "sun397"
    classes = ["/a/abbey", "/c/church/indoor", "/c/church/outdoor", "/d/dock"]
    (d / "SUN397").mkdir(parents=True)
    (d / "SUN397" / "ClassName.txt").write_text("\n".join(classes) + "\n")
    train, test = [], []
    for cname in classes:
        for i in range(7):
            rel = f"{cname}/sun_{i:03d}.jpg"
            _img(d / "SUN397" / rel[1:])
            (train if i < 5 else test).append(rel)
    (d / "Training_01.txt").write_text("\n".join(train) + "\n")
    (d / "Testing_01.txt").write_text("\n".join(test) + "\n")


def _ucf(root: Path) -> None:
    d = root / "ucf101"
    (d / "ucfTrainTestlist").mkdir(parents=True)
    actions = ("ApplyEyeMakeup", "Archery", "BabyCrawling", "Biking")
    (d / "ucfTrainTestlist" / "classInd.txt").write_text(
        "".join(f"{i + 1} {a}\n" for i, a in enumerate(actions)))
    train, test = [], []
    for a in actions:
        renamed = "_".join(re.findall("[A-Z][^A-Z]*", a))
        for i in range(7):
            fname = f"v_{a}_g{i:02d}.avi"
            _img(d / "UCF-101-midframes" / renamed / fname.replace(".avi", ".jpg"))
            (train if i < 5 else test).append(f"{a}/{fname} 1")
    (d / "ucfTrainTestlist" / "trainlist01.txt").write_text("\n".join(train) + "\n")
    (d / "ucfTrainTestlist" / "testlist01.txt").write_text("\n".join(test) + "\n")


WNIDS = [f"n{i:08d}" for i in range(1000)]


def _classnames(d: Path) -> None:
    d.mkdir(parents=True, exist_ok=True)
    (d / "classnames.txt").write_text("".join(f"{w} synset {i}\n" for i, w in enumerate(WNIDS)))


def _imagenet(root: Path) -> None:
    d = root / "imagenet"
    _classnames(d)
    for split, n in (("train", 4), ("val", 2)):
        for w in WNIDS[:4]:
            for i in range(n):
                _img(d / "images" / split / w / f"{w}_{i}.JPEG")


def _imagenet_v2(root: Path) -> None:
    d = root / "imagenetv2"
    _classnames(d)
    img_root = d / "imagenetv2-matched-frequency-format-val"
    for label in range(1000):
        (img_root / str(label)).mkdir(parents=True)
    for label in range(4):
        for i in range(2):
            _img(img_root / str(label) / f"{i}.jpg")


def _variant(ddir: str, sub: str):
    def make(root: Path) -> None:
        d = root / ddir
        _classnames(d)
        for w in (WNIDS[7], WNIDS[3], WNIDS[11], WNIDS[5]):
            for i in range(2):
                _img(d / sub / w / f"{i}.jpg")
        (d / sub / "README.txt").write_text("ignore me\n")
    return make


TREES = {
    "OxfordPets": _pets,
    "Caltech101": lambda r: _folders(
        r / "caltech101" / "caltech-101" / "101_ObjectCategories",
        ("Faces", "airplanes", "BACKGROUND_Google", "Faces_easy", "Leopards", "ant")),
    "DescribableTextures": lambda r: _folders(r / "dtd" / "images", CLASSES),
    "EuroSAT": lambda r: _folders(r / "eurosat" / "2750",
                                  ("AnnualCrop", "Forest", "River", "SeaLake")),
    "FGVCAircraft": _aircraft,
    "Food101": lambda r: _folders(r / "food-101" / "images", CLASSES),
    "OxfordFlowers": _flowers,
    "StanfordCars": _cars,
    "SUN397": _sun,
    "UCF101": _ucf,
    "ImageNet": _imagenet,
    "ImageNetV2": _imagenet_v2,
    "ImageNetSketch": _variant("imagenet-sketch", "images"),
    "ImageNetA": _variant("imagenet-adversarial", "imagenet-a"),
    "ImageNetR": _variant("imagenet-rendition", "imagenet-r"),
}
# (NUM_SHOTS, SUBSAMPLE_CLASSES)
VARIANTS = {"all": (-1, "all"), "base2": (2, "base"), "new2": (2, "new")}


def _cfg(make, root: Path, name: str, shots: int, subsample: str):
    cfg = make()
    cfg.DATASET.NAME = name
    cfg.DATASET.ROOT = str(root)
    cfg.DATASET.NUM_SHOTS = shots
    cfg.DATASET.SUBSAMPLE_CLASSES = subsample
    return cfg


def _read(reg, make, root, name, variant, seed):
    random.seed(seed)
    return reg.get(name).build(_cfg(make, root, name, *VARIANTS[variant]))


def _items(split) -> list:
    return [(it.impath, it.label, it.classname) for it in split]


def _same(a, b) -> None:
    assert a.classnames == b.classnames and a.num_classes == b.num_classes
    for split in ("train_x", "val", "test"):
        assert _items(getattr(a, split)) == _items(getattr(b, split)), split
    assert all(type(it) is tdatum.Datum for s in (b.train_x, b.val, b.test) for it in s)


def _drop_caches(root: Path) -> None:
    for p in root.rglob("preprocessed.pkl"):
        p.unlink()
    for p in root.rglob("split_fewshot"):
        shutil.rmtree(p)


def _cache_modules(root: Path) -> set:
    """The Datum modules the tree's caches pickle."""
    mods = set()
    for p in list(root.rglob("preprocessed.pkl")) + list(root.rglob("shot_*.pkl")):
        raw = p.read_bytes()
        mods |= {m for m in ("mudpt_tpu.data.datum", "mudpt_torch.data.datum")
                 if m.encode() in raw}
    return mods


def test_all_plugins_registered():
    assert sorted(TREG.keys()) == sorted(JREG.keys())
    assert len(list(TREG.keys())) == 16 and set(TREES) | {"Synthetic"} == set(TREG.keys())


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("name", sorted(TREES))
def test_reader_matches_jax_and_caches_cross(tmp_path, name, variant):
    TREES[name](tmp_path)
    # fresh reads under the same global seed: the same items
    jset = _read(JREG, jdefault_config, tmp_path, name, variant, seed=0)
    _drop_caches(tmp_path)
    tset = _read(TREG, default_config, tmp_path, name, variant, seed=0)
    _same(jset, tset)
    assert len(tset.test) > 0 and tset.num_classes >= 2
    if variant != "all" and name not in ("ImageNetV2", "ImageNetSketch", "ImageNetA",
                                         "ImageNetR"):
        # the few-shot split: two a class; base and new take two classes each
        assert tset.num_classes == 2 and len(tset.train_x) == 4
    # each package reads the other's caches (under another global seed, so
    # a recomputed split would differ where the split is drawn)
    written = _cache_modules(tmp_path)
    assert written <= {"mudpt_torch.data.datum"}
    _same(_read(JREG, jdefault_config, tmp_path, name, variant, seed=123), tset)
    _drop_caches(tmp_path)
    jset = _read(JREG, jdefault_config, tmp_path, name, variant, seed=0)
    assert _cache_modules(tmp_path) == ({"mudpt_tpu.data.datum"} if written else set())
    _same(jset, _read(TREG, default_config, tmp_path, name, variant, seed=123))


def test_jax_cache_read_without_importing_jax_package(tmp_path):
    """A split cache that mudpt_tpu's write_split_cache wrote, read by the
    port in a process where mudpt_tpu is importable: the items equal the
    JAX package's, as the port's Datum, and mudpt_tpu is never imported
    (the unpickler used to resolve mudpt_tpu.data.datum.Datum by import)."""
    items = [jdatum.Datum(impath=f"/data/x/{i}.jpg", label=i % 3, classname=f"c{i % 3}")
             for i in range(7)]
    path = tmp_path / "split_fewshot" / "shot_2-seed_1.pkl"
    jdatum.write_split_cache(str(path), {"train": items, "val": items[:2]})
    code = (
        "import json, sys\n"
        "from mudpt_torch.data import datum\n"
        f"cached = datum.read_split_cache({str(path)!r})\n"
        "train = datum._revive(cached['train'])\n"
        "print(json.dumps({'items': [[d.impath, d.label, d.classname] for d in train],\n"
        "                  'types': sorted({type(d).__module__ for d in train}),\n"
        "                  'raw': sorted({type(d).__name__ for d in cached['val']}),\n"
        "                  'jax_package': 'mudpt_tpu' in sys.modules}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["items"] == [[d.impath, d.label, d.classname] for d in items]
    assert got["types"] == ["mudpt_torch.data.datum"] and got["raw"] == ["_ForeignDatum"]
    assert got["jax_package"] is False


def test_dassl_cache_still_read(tmp_path):
    """A Dassl-classed cache (``_impath``-style attributes, a module that is
    not importable) still reads through the stand-in."""
    import pickle
    import types

    mod = types.ModuleType("dassl_probe_base_dataset")

    class Datum:
        def __init__(self, impath, label, classname):
            self._impath, self._label, self._classname = impath, label, classname

    Datum.__module__, Datum.__qualname__ = mod.__name__, "Datum"
    mod.Datum = Datum
    sys.modules[mod.__name__] = mod
    try:
        path = tmp_path / "preprocessed.pkl"
        path.write_bytes(pickle.dumps({"train": [Datum("/a.jpg", 2, "cat")]}))
    finally:
        del sys.modules[mod.__name__]
    train = tdatum._revive(tdatum.read_split_cache(str(path))["train"])
    assert [(d.impath, d.label, d.classname) for d in train] == [("/a.jpg", 2, "cat")]


COPIES = ("caltech101", "dtd", "eurosat", "fgvc_aircraft", "food101", "imagenet_variants",
          "oxford_flowers", "oxford_pets", "stanford_cars", "sun397", "ucf101", "common")


def _body(path: Path, skip=()) -> list:
    """The module's top-level statements but its docstring and ``skip``,
    as ASTs with the package name made the port's."""
    import ast

    tree = ast.parse(path.read_text().replace("mudpt_tpu", "mudpt_torch"))
    nodes = tree.body[1:] if ast.get_docstring(tree) else tree.body
    return [ast.dump(n) for n in nodes if getattr(n, "name", None) not in skip]


@pytest.mark.parametrize("name", COPIES)
def test_reader_modules_are_copies(name):
    """Each reader and ``common.py`` equal the JAX package's but for the
    package name (the port's ``imagenet.py`` differs by its ``_revive`` of
    cached items, held above)."""
    rel = Path("data") / "datasets" / f"{name}.py"
    assert _body(ROOT / "mudpt_torch" / rel) == _body(ROOT / "mudpt_tpu" / rel)


def test_datum_is_a_copy_but_for_the_unpickler():
    rel = Path("data") / "datum.py"
    skip = ("_CacheUnpickler",)
    assert _body(ROOT / "mudpt_torch" / rel, skip) == _body(ROOT / "mudpt_tpu" / rel, skip)
