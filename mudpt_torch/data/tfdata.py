"""The tf.data pipeline (``DATALOADER.PIPELINE tfdata``) without TensorFlow:
the counterpart of ``mudpt_tpu/data/tfdata.py``'s ``TFDataLoader``, decoding
with PIL in a ``torch.utils.data`` loader.

Eval follows ``tfdata.py:98-120`` to the pixel: the short side resized to
``size``, the long side int-truncated, then a center crop whose origin is
rounded half to even, by ``tf.image.resize(method="bicubic")``'s resampler
(:func:`resize_bicubic`: Keys' cubic with a = -0.5 read from its 1,024-entry
table, half-pixel centres, no antialias, taps outside the image dropped and
the weights renormalized, fp32 sums in its order).  Neither
``F.interpolate(mode="bicubic")`` (a = -0.75) nor PIL's bicubic
(antialiased) computes that resize.  What differs from the JAX loader is
the JPEG decode: TensorFlow decodes with libjpeg's fast integer IDCT by
default, PIL with the accurate one (TensorFlow's ``INTEGER_ACCURATE``,
pixel for pixel), which moves a pixel by up to 4 of 255 levels.

Train keeps the distributions of ``tfdata.py:122-209`` but not its draws:
TensorFlow's ``stateless_sample_distorted_bounding_box`` cannot be
reproduced without TensorFlow, so the port's draws are its own.
:func:`sample_crop` follows that sampler's structure (the aspect ratio
uniform in [0.75, 1.3333], a least area uniform in [0.08, 1] of the image,
the height uniform between that area's and the largest that fits, up to
100 attempts, else the whole image) and :func:`flips` draws the flip with
probability 0.5, each from numpy's generator keyed by (seed + epoch,
2 x position) and (seed + epoch, 2 x position + 1): separate streams, a
pure function of the run's seed, the epoch and the item's position in the
epoch, whatever the worker count.  The epoch's order is a shuffle keyed by
(seed, epoch), as the threads loader's, so ``set_epoch`` replays a run's
batches.  The whole image is decoded and then cropped; the JAX loader's
fused ``decode_and_crop_jpeg`` is an optimization that computes the same
crop up to the chroma upsampling at its top edge.

Batches keep the contract of the other loaders ({image f32 NHWC, label i32,
valid bool}); ``num_workers`` processes decode, as ``grain_pipeline``'s.
"""

from __future__ import annotations

import math
import random
from typing import List

import numpy as np
import torch.utils.data

from mudpt_torch.data.datum import Datum
from mudpt_torch.data.grain_pipeline import decode_batches
from mudpt_torch.data.transforms import CLIP_MEAN, CLIP_STD, load_image

_TABLE = 1024  # entries of the resampler's coefficient table (resize_bicubic_op.cc)
_FLT_MIN = np.float32(np.finfo(np.float32).tiny)


def _keys_cubic_table() -> tuple:
    """Keys' cubic (a = -0.5) at x = i / 1024 for the near taps and at
    x + 1 for the far ones, each computed in double and stored as float."""
    a = -0.5
    x = (np.arange(_TABLE + 1) / _TABLE).astype(np.float32).astype(np.float64)
    near = ((a + 2) * x - (a + 3)) * x * x + 1
    x = (x + 1.0).astype(np.float32).astype(np.float64)
    far = ((a * x - 5 * a) * x + 8 * a) * x - 4 * a
    return near.astype(np.float32), far.astype(np.float32)


_NEAR, _FAR = _keys_cubic_table()


def _taps(in_size: int, out_size: int) -> tuple:
    """(indices (out, 4), fp32 weights (out, 4)) of one axis, as
    ``GetWeightsAndIndices`` with half-pixel centres computes them."""
    scale = np.float32(in_size) / np.float32(out_size)
    loc_f = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * scale - np.float32(0.5)
    loc = np.floor(loc_f).astype(np.int64)
    delta = loc_f - loc.astype(np.float32)
    off = np.rint(delta * np.float32(_TABLE)).astype(np.int64)
    idx = np.stack([loc - 1, loc, loc + 1, loc + 2], axis=1)
    w = np.stack([_FAR[off], _NEAR[off], _NEAR[_TABLE - off], _FAR[_TABLE - off]], axis=1)
    inside = (idx >= 0) & (idx < in_size)
    w = np.where(inside, w, np.float32(0))
    total = ((w[:, 0] + w[:, 1]) + w[:, 2]) + w[:, 3]
    norm = np.abs(total) >= np.float32(1000) * _FLT_MIN
    inv = np.float32(1) / np.where(norm, total, np.float32(1))
    w = np.where(norm[:, None], w * inv[:, None], w)
    return np.clip(idx, 0, in_size - 1), w.astype(np.float32)


def resize_bicubic(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``tf.image.resize(img, (out_h, out_w), method="bicubic")`` of an
    (H, W, C) uint8 image, fp32: each output row from four input rows, then
    each output pixel from four of those columns, each sum
    ((v0 w0 + v1 w1) + v2 w2) + v3 w3 in fp32 (``Interpolate1D``'s order)."""
    src = img.astype(np.float32)
    yi, yw = _taps(src.shape[0], out_h)
    xi, xw = _taps(src.shape[1], out_w)
    rows = np.take(src, yi[:, 0], axis=0) * yw[:, 0, None, None]
    for k in range(1, 4):
        rows += np.take(src, yi[:, k], axis=0) * yw[:, k, None, None]
    out = np.take(rows, xi[:, 0], axis=1) * xw[None, :, 0, None]
    for k in range(1, 4):
        out += np.take(rows, xi[:, k], axis=1) * xw[None, :, k, None]
    return out


def sample_crop(h: int, w: int, rng: np.random.Generator, area=(0.08, 1.0),
                ratio=(0.75, 1.3333), attempts: int = 100) -> tuple:
    """(top, left, height, width) of a random-resized crop of an h x w image
    (see the module docstring; ``GenerateRandomCrop``'s arithmetic)."""
    for _ in range(attempts):
        aspect = rng.uniform(ratio[0], ratio[1])
        min_area = rng.uniform(area[0], area[1]) * w * h
        max_area = area[1] * w * h
        ch = int(np.rint(math.sqrt(min_area / aspect)))
        max_h = int(np.rint(math.sqrt(max_area / aspect)))
        if int(np.rint(max_h * aspect)) > w:
            max_h = int((w + 0.5 - 1e-7) / aspect)
            if int(np.rint(max_h * aspect)) > w:
                max_h -= 1
        max_h = min(max_h, h)
        ch = min(ch, max_h)
        if ch < max_h:
            ch += int(rng.integers(0, max_h - ch + 1))
        cw = int(np.rint(ch * aspect))
        if cw * ch < min_area:
            ch += 1
            cw = int(np.rint(ch * aspect))
        if not (min_area <= cw * ch <= max_area and 0 < cw <= w and 0 < ch <= h):
            continue
        top = int(rng.integers(0, h - ch)) if ch < h else 0
        left = int(rng.integers(0, w - cw)) if cw < w else 0
        return top, left, ch, cw
    return 0, 0, h, w


def flips(rng: np.random.Generator) -> bool:
    """A horizontal flip with probability 0.5."""
    return bool(rng.random() < 0.5)


def eval_geometry(h: int, w: int, size: int) -> tuple:
    """(resized h, resized w, crop top, crop left): the short side to
    ``size``, the long side int-truncated, the origin rounded half to even
    (``tfdata.py:107-119``)."""
    long_ = int(size * max(h, w) / min(h, w))
    nh, nw = (long_, size) if h >= w else (size, long_)
    top = int(np.rint(np.float32(nh - size) / np.float32(2)))
    left = int(np.rint(np.float32(nw - size) / np.float32(2)))
    return nh, nw, top, left


class _Decode(torch.utils.data.Dataset):
    """Keys (item index, epoch, position in the epoch) -> (normalized f32
    (size, size, 3) image, label)."""

    def __init__(self, items: List[Datum], size: int, is_train: bool, seed: int, mean, std):
        self.items = items
        self.size = size
        self.is_train = is_train
        self.seed = seed
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, key) -> tuple:
        i, epoch, pos = key
        item, size = self.items[i], self.size
        img = np.asarray(load_image(item.impath))
        if self.is_train:
            base = self.seed + epoch
            top, left, ch, cw = sample_crop(*img.shape[:2], np.random.default_rng([base, 2 * pos]))
            out = resize_bicubic(img[top:top + ch, left:left + cw], size, size)
            if flips(np.random.default_rng([base, 2 * pos + 1])):
                out = out[:, ::-1]
        else:
            nh, nw, top, left = eval_geometry(*img.shape[:2], size)
            out = resize_bicubic(img, nh, nw)[top:top + size, left:left + size]
        return (out / np.float32(255) - self.mean) / self.std, int(item.label)


class TFDataLoader:
    def __init__(
        self,
        items: List[Datum],
        batch_size: int,
        *,
        size: int = 224,
        is_train: bool = False,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        mean=CLIP_MEAN,
        std=CLIP_STD,
        pad_to_batches: int = 0,
        num_workers: int = 0,
    ):
        missing = sum(1 for it in items if not it.impath)
        if missing:
            raise ValueError(
                f"DATALOADER.PIPELINE=tfdata reads images from disk, but "
                f"{missing}/{len(items)} items have no file path (array-backed "
                f"dataset, e.g. Synthetic) — use the threads or grain pipeline"
            )
        self.batch_size = batch_size
        self.items = items
        self._size = size
        self._is_train = is_train
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self._drop_last = drop_last
        self.num_workers = num_workers
        self._dataset = _Decode(items, size, is_train, seed, mean, std)
        # pod eval: hosts iterate in lockstep, so a host whose item shard is
        # short must still emit the same number of batches — trailing
        # batches are all-invalid zeros (same as DataLoader)
        self.pad_to_batches = pad_to_batches

    def __len__(self) -> int:
        n = len(self.items)
        if self._drop_last:
            return n // self.batch_size
        return max(
            (n + self.batch_size - 1) // self.batch_size, self.pad_to_batches
        )

    def set_epoch(self, epoch: int):
        """Fast-forward the epoch counter so a resumed run replays the exact
        shuffle order AND augmentation draws an uninterrupted run would see
        (the next __iter__ builds ``epoch``)."""
        self._epoch = int(epoch)

    def _batches(self, epoch: int) -> list:
        order = list(range(len(self.items)))
        if self._shuffle:
            random.Random(hash((self._seed, epoch, -1)) & 0xFFFFFFFF).shuffle(order)
        keys = [(i, epoch, pos) for pos, i in enumerate(order)]
        out = [keys[i:i + self.batch_size] for i in range(0, len(keys), self.batch_size)]
        if self._drop_last and out and len(out[-1]) < self.batch_size:
            out.pop()
        return out

    def __iter__(self):
        emitted = 0
        if self.items:
            epoch = self._epoch
            self._epoch += 1
            for images, labels in decode_batches(self._dataset, self._batches(epoch),
                                                 self.num_workers, 2 * self.batch_size):
                n = len(labels)
                pad = self.batch_size - n
                if pad:
                    images = np.pad(images, [(0, pad), (0, 0), (0, 0), (0, 0)])
                    labels = np.pad(labels, (0, pad))
                yield {
                    "image": images.astype(np.float32),
                    "label": labels.astype(np.int32),
                    "valid": np.arange(self.batch_size) < n,
                }
                emitted += 1
        if emitted < self.pad_to_batches:
            eb = {  # consumers treat batches as read-only
                "image": np.zeros(
                    (self.batch_size, self._size, self._size, 3), np.float32
                ),
                "label": np.zeros(self.batch_size, np.int32),
                "valid": np.zeros(self.batch_size, bool),
            }
            for _ in range(self.pad_to_batches - emitted):
                yield eb
