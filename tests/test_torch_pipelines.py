"""The port's grain and tf.data pipelines against the JAX package's, on
24 x 24 (and larger) JPEGs:

* ``grain``: batches bit-equal to ``mudpt_tpu``'s ``GrainLoader`` (grain's
  own shuffle, the per-item draws), training and eval, at 0 and 2 worker
  processes, across epochs, after ``set_epoch`` and with a padded last
  batch; the order is grain's ``index_shuffle``, held to its C++ module;
* ``tfdata`` eval: the resize bit-equal to ``tf.image.resize(bicubic)``;
  each batch bit-equal to TensorFlow's eval graph on an accurately decoded
  JPEG, and within 0.08 (max) and 0.02 (mean) of ``mudpt_tpu``'s
  ``TFDataLoader``, whose decoder runs libjpeg's fast integer IDCT (the
  same function as ``tests/test_aux.py``'s PIL-vs-TF check, which allows a
  mean of 0.12, up to the decode);
* ``tfdata`` train: deterministic, replayed by ``set_epoch``, equal at 0
  and 2 workers, its crops and flip rate in the stated ranges;
* ``DataManager``: the three pipelines dispatched as the JAX package's,
  ``HOST_SHARD`` parsed and refused alike;
* no worker process, forkserver or resource tracker outlives a program
  that decoded with workers and exited with a pass still open.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import tensorflow as tf
from PIL import Image

from mudpt_tpu.config import default_config as jdefault_config
from mudpt_tpu.data import DataManager as JDataManager
from mudpt_tpu.data import manager as jmanager
from mudpt_tpu.data.datum import Datum as JDatum
from mudpt_tpu.data.grain_pipeline import GrainLoader as JGrainLoader
from mudpt_tpu.data.tfdata import TFDataLoader as JTFDataLoader
from mudpt_tpu.data.transforms import EvalTransform as JEval
from mudpt_tpu.data.transforms import TrainTransform as JTrain

from mudpt_torch.config import default_config
from mudpt_torch.data import DataManager, manager
from mudpt_torch.data import tfdata as T
from mudpt_torch.data.datum import Datum
from mudpt_torch.data.grain_pipeline import GrainLoader, epoch_order, index_shuffle
from mudpt_torch.data.loader import DataLoader
from mudpt_torch.data.transforms import CLIP_MEAN, CLIP_STD, EvalTransform, TrainTransform

# the port's tfdata eval against the JAX TFDataLoader, normalized units:
# the decoders differ by up to 4 of 255 levels (0.06 here), the bicubic's
# overshoot can add a little; readings on these images: max 0.058-0.060,
# mean 0.012
TFDATA_MAX, TFDATA_MEAN = 0.08, 0.02


def _jpeg(path, h, w, seed, noise=20.0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([yy * 255 // h, xx * 255 // w, (yy + xx) * 127 // (h + w)], -1)
    img = img + rng.randn(h, w, 3) * noise
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path, quality=85)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """11 JPEGs of 24 x 24 or 24 x 30 and 4 larger ones, 3 classes."""
    d = tmp_path_factory.mktemp("jpegs")
    sizes = [(24, 24), (24, 30), (30, 24)] * 3 + [(24, 24), (24, 30)]
    sizes += [(240, 300), (300, 240), (57, 83), (128, 96)]
    paths = []
    for i, (h, w) in enumerate(sizes):
        p = str(d / f"{i}.jpg")
        _jpeg(p, h, w, i)
        paths.append(p)
    return paths


def _both(paths):
    jitems = [JDatum(impath=p, label=i % 3, classname=f"c{i % 3}") for i, p in enumerate(paths)]
    titems = [Datum(impath=p, label=i % 3, classname=f"c{i % 3}") for i, p in enumerate(paths)]
    return jitems, titems


def _equal_epochs(jl, tl, n_epochs=1):
    """Each epoch's batches of the two loaders bit-equal; the port's."""
    epochs = []
    for _ in range(n_epochs):
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) == len(tl) == len(jl) > 0
        for a, b in zip(jb, tb):
            assert set(b) == {"image", "label", "valid"}
            for k in ("image", "label", "valid"):
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        epochs.append(tb)
    return epochs if n_epochs > 1 else epochs[0]


def test_index_shuffle_is_grains():
    from grain._src.python.experimental.index_shuffle.python import (
        index_shuffle_module as G)

    rng = np.random.RandomState(0)
    for max_index in (0, 1, 2, 10, 799, 2047, 65535, 65536, 70001, 2 ** 21 + 5):
        seed = int(rng.randint(0, 2 ** 32))
        idx = rng.randint(0, max_index + 1, 64)
        want = [G.index_shuffle(int(i), max_index=max_index, seed=seed, rounds=4) for i in idx]
        assert index_shuffle(idx, max_index, seed).tolist() == want
    order = epoch_order(37, True, 9)
    assert sorted(order.tolist()) == list(range(37)) and order.tolist() != list(range(37))
    with pytest.raises(ValueError, match="32-bit"):
        epoch_order(4, True, 2 ** 32)


@pytest.mark.parametrize("workers", [0, 2])
def test_grain_train_bit_equal(jpegs, workers):
    jitems, titems = _both(jpegs[:11])
    def mk_j():
        return JGrainLoader(jitems, JTrain(size=16), 4, shuffle=True, drop_last=True, seed=3)

    def mk_t():
        return GrainLoader(titems, TrainTransform(size=16), 4, shuffle=True, drop_last=True,
                           seed=3, num_workers=workers)

    jl, tl = mk_j(), mk_t()
    first, second = _equal_epochs(jl, tl, n_epochs=2)
    assert jl._epoch == tl._epoch == 2
    assert not np.array_equal(first[0]["label"], second[0]["label"])
    # a resumed loader replays epoch 2 (set_epoch(1))
    jr, tr = mk_j(), mk_t()
    jr.set_epoch(1)
    tr.set_epoch(1)
    for a, b in zip(second, _equal_epochs(jr, tr)):
        np.testing.assert_array_equal(a["image"], b["image"])


@pytest.mark.parametrize("workers", [0, 2])
def test_grain_eval_bit_equal_with_padded_batch(jpegs, workers):
    jitems, titems = _both(jpegs[:11])
    jl = JGrainLoader(jitems, JEval(size=16), 4, pad_to_batches=5)
    tl = GrainLoader(titems, EvalTransform(size=16), 4, pad_to_batches=5, num_workers=workers)
    tb = _equal_epochs(jl, tl)
    assert len(tb) == 5 and tb[2]["valid"].sum() == 3 and not tb[4]["valid"].any()
    assert not tb[2]["image"][3:].any() and tb[4]["image"].shape == (4, 16, 16, 3)
    # the threads loader runs the same EvalTransform: the same batches
    for a, b in zip(tb, DataLoader(titems, EvalTransform(size=16), 4, pad_to_batches=5)):
        for k in ("image", "label", "valid"):
            np.testing.assert_array_equal(a[k], b[k])


def test_resize_is_tf_bicubic():
    rng = np.random.RandomState(1)
    for h, w, oh, ow in [(24, 30, 16, 20), (240, 300, 224, 280), (57, 83, 32, 32),
                         (10, 13, 32, 32), (1, 5, 3, 7), (33, 17, 224, 224)]:
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        want = tf.image.resize(img, (oh, ow), method="bicubic").numpy()
        np.testing.assert_array_equal(T.resize_bicubic(img, oh, ow), want)


def _tf_eval_accurate(path, size):
    """``TFDataLoader._decode_eval`` (tfdata.py:98-120) on the JPEG decoded
    with INTEGER_ACCURATE, libjpeg's accurate IDCT, which PIL runs."""
    img = tf.io.decode_jpeg(tf.io.read_file(path), channels=3, dct_method="INTEGER_ACCURATE")
    shape = tf.shape(img)
    short, long_ = tf.minimum(shape[0], shape[1]), tf.maximum(shape[0], shape[1])
    new_long = tf.cast(tf.cast(size, tf.float64) * tf.cast(long_, tf.float64)
                       / tf.cast(short, tf.float64), tf.int32)
    nh = tf.where(shape[0] >= shape[1], new_long, size)
    nw = tf.where(shape[0] >= shape[1], size, new_long)
    img = tf.image.resize(img, (nh, nw), method="bicubic")
    top = tf.cast(tf.round(tf.cast(nh - size, tf.float32) / 2.0), tf.int32)
    left = tf.cast(tf.round(tf.cast(nw - size, tf.float32) / 2.0), tf.int32)
    img = img[top:top + size, left:left + size] / 255.0
    return ((img - tf.constant(CLIP_MEAN, tf.float32)) / tf.constant(CLIP_STD, tf.float32)).numpy()


@pytest.mark.parametrize("size", [16, 224])
def test_tfdata_eval_matches_tf(jpegs, size):
    jitems, titems = _both(jpegs)
    tb = list(T.TFDataLoader(titems, 4, size=size, pad_to_batches=5))
    got = np.concatenate([b["image"] for b in tb])[:len(jpegs)]
    want = np.stack([_tf_eval_accurate(p, size) for p in jpegs])
    np.testing.assert_array_equal(got, want)
    jb = list(JTFDataLoader(jitems, 4, size=size, pad_to_batches=5))
    assert len(jb) == len(tb) == 5
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(a["label"], b["label"])
        np.testing.assert_array_equal(a["valid"], b["valid"])
        d = np.abs(a["image"] - b["image"])
        assert d.max() <= TFDATA_MAX and d.mean() <= TFDATA_MEAN, (d.max(), d.mean())
    assert not tb[-1]["valid"].any() and tb[-1]["image"].shape == (4, size, size, 3)


def test_tfdata_train_deterministic_and_replayed(jpegs):
    _, titems = _both(jpegs)
    mk = lambda w: T.TFDataLoader(titems, 4, size=16, is_train=True, shuffle=True,  # noqa: E731
                                  drop_last=True, seed=2, num_workers=w)
    a, b = mk(0), mk(2)
    e1 = [list(a), list(a)]
    assert len(e1[0]) == len(a) == len(titems) // 4
    for ea, eb in zip(e1, [list(b), list(b)]):
        for x, y in zip(ea, eb):
            for k in ("image", "label", "valid"):
                np.testing.assert_array_equal(x[k], y[k])
    assert not np.array_equal(e1[0][0]["image"], e1[1][0]["image"])
    r = mk(0)
    r.set_epoch(1)
    for x, y in zip(e1[1], list(r)):
        np.testing.assert_array_equal(x["image"], y["image"])
        np.testing.assert_array_equal(x["label"], y["label"])
    assert all(b["valid"].all() and np.isfinite(b["image"]).all() for b in e1[0])


def test_tfdata_crop_and_flip_ranges():
    """Over 4,000 draws a shape: every box inside the image, its area at
    least 8% of the image's, its aspect ratio within [3/4, 4/3] up to the
    rounding of a side to whole pixels; the flip rate within 0.5 +- 0.04
    (five standard deviations)."""
    for h, w in ((240, 300), (300, 240), (24, 24), (57, 83)):
        areas, flips = [], []
        for pos in range(4000):
            top, left, ch, cw = T.sample_crop(h, w, np.random.default_rng([7, 2 * pos]))
            assert 0 <= top and top + ch <= h and 0 <= left and left + cw <= w
            assert cw * ch >= 0.08 * h * w
            if (ch, cw) != (h, w):
                assert 0.75 * (ch - 1) <= cw + 0.5 and cw - 0.5 <= 1.3333 * (ch + 1)
            areas.append(cw * ch / (h * w))
            flips.append(T.flips(np.random.default_rng([7, 2 * pos + 1])))
        assert abs(np.mean(flips) - 0.5) <= 0.04
        assert min(areas) < 0.2 and max(areas) > 0.9  # the range is covered


# decodes with 2 workers under grain and under tfdata and exits with a pass
# of each open; prints the pids of the workers, the forkserver and the
# resource tracker
_OPEN_PASSES = """
import json, multiprocessing.forkserver as fs, multiprocessing.resource_tracker as rt, sys
from mudpt_torch.data import grain_pipeline as G
from mudpt_torch.data import tfdata as T
from mudpt_torch.data.datum import Datum
from mudpt_torch.data.transforms import TrainTransform
items = [Datum(impath=p, label=i % 3, classname=f"c{i % 3}")
         for i, p in enumerate(sys.argv[1:])]
OPEN = []
for loader in (G.GrainLoader(items, TrainTransform(size=16), 4, shuffle=True, num_workers=2),
               T.TFDataLoader(items, 4, size=16, is_train=True, num_workers=2)):
    list(loader)
    OPEN.append(iter(loader))
    next(OPEN[-1])
pids = [w.pid for pool in G._POOLS for w in pool._workers]
print(json.dumps(pids + [fs._forkserver._forkserver_pid, rt._resource_tracker._pid]))
"""


def _running(pid: int) -> bool:
    """Whether ``pid`` is a live process (an exited one not yet reaped is
    not)."""
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except FileNotFoundError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


def test_no_process_outlives_the_program(jpegs, tmp_path):
    """Once a program that decoded with worker processes has exited, none
    of them, nor the forkserver or resource tracker it started, is still
    running, though it left a grain and a tfdata pass open; and its exit
    printed no error.  Its output goes to files: a pipe would make the
    wait last until every process holding it had exited too."""
    with open(tmp_path / "out", "w+") as out, open(tmp_path / "err", "w+") as err:
        rc = subprocess.run([sys.executable, "-c", _OPEN_PASSES, *jpegs[:8]],
                            stdout=out, stderr=err, timeout=120,
                            cwd=Path(__file__).resolve().parents[1]).returncode
        pids = running = None
        if rc == 0:
            pids = json.loads((tmp_path / "out").read_text().splitlines()[-1])
            running = [p for p in pids if _running(p)]
    stderr = (tmp_path / "err").read_text()
    assert rc == 0, stderr
    assert len(pids) == 6 and all(pids), pids  # 2 + 2 workers, server, tracker
    assert running == [], running
    assert "Traceback" not in stderr and "leaked" not in stderr, stderr


def test_tfdata_refuses_array_items():
    items = [Datum(label=0, classname="c", array=np.zeros((8, 8, 3), np.float32))]
    with pytest.raises(ValueError, match="threads or grain"):
        T.TFDataLoader(items, 1, size=8)


def _folder_tree(root, per_class=5):
    img_root = root / "caltech101" / "caltech-101" / "101_ObjectCategories"
    for c, name in enumerate(("Faces", "airplanes", "ant", "bee")):
        (img_root / name).mkdir(parents=True)
        for i in range(per_class):
            _jpeg(str(img_root / name / f"{i}.jpg"), 24, 30, 10 * c + i)


def _cfgs(root, pipeline, *more):
    out = []
    for make in (jdefault_config, default_config):
        cfg = make()
        cfg.DATASET.NAME = "Caltech101"
        cfg.DATASET.ROOT = str(root)
        cfg.INPUT.SIZE = (16, 16)
        cfg.DATALOADER.PIPELINE = pipeline
        cfg.DATALOADER.NUM_WORKERS = 2
        cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 3
        cfg.DATALOADER.TEST.BATCH_SIZE = 4
        for k, v in zip(more[::2], more[1::2]):
            node = cfg
            *path, leaf = k.split(".")
            for p in path:
                node = getattr(node, p)
            setattr(node, leaf, v)
        out.append(cfg)
    return out


@pytest.mark.parametrize("pipeline,loader", [("threads", DataLoader), ("grain", GrainLoader),
                                             ("tfdata", T.TFDataLoader),
                                             ("no-such-pipeline", DataLoader)])
def test_datamanager_dispatch(tmp_path, pipeline, loader):
    _folder_tree(tmp_path)
    jcfg, tcfg = _cfgs(tmp_path, pipeline)
    jdm, tdm = JDataManager(jcfg), DataManager(tcfg)
    assert tdm.classnames == jdm.classnames and tdm.num_classes == 4
    assert not tdm.host_sharded and not tdm.eval_host_sharded
    for split in ("train", "val", "test"):
        jl, tl = getattr(jdm, f"{split}_loader"), getattr(tdm, f"{split}_loader")
        assert type(tl) is loader and type(jl).__name__ == loader.__name__
        assert len(tl) == len(jl) > 0
    if pipeline != "tfdata":  # the same transforms: the same batches
        _equal_epochs(jdm.train_loader, tdm.train_loader)
        _equal_epochs(jdm.test_loader, tdm.test_loader)
    else:
        assert tdm.train_loader._is_train and not tdm.test_loader._is_train
        assert tdm.train_loader.num_workers == 2


@pytest.mark.parametrize("value", [True, False, "auto", "on", "off", "Yes", "0", ""])
def test_host_shard_values(value):
    assert manager._host_shard_mode(value) == jmanager._host_shard_mode(value)


def test_host_shard_refused_alike(tmp_path):
    _folder_tree(tmp_path)
    jcfg, tcfg = _cfgs(tmp_path, "threads", "DATALOADER.HOST_SHARD", "sometimes")
    with pytest.raises(ValueError) as jerr:
        JDataManager(jcfg)
    with pytest.raises(ValueError) as terr:
        DataManager(tcfg)
    assert str(terr.value) == str(jerr.value) == (
        "DATALOADER.HOST_SHARD='sometimes': expected auto|on|off")
