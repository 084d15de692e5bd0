"""The grain pipeline (``DATALOADER.PIPELINE grain``) on ``torch.utils.data``:
the counterpart of ``mudpt_tpu/data/grain_pipeline.py``'s ``GrainLoader``,
without ``grain``.

Order: grain's ``IndexSampler`` shuffles an epoch with its C++
``index_shuffle`` (a Simon block cipher whose round keys come from
``std::seed_seq``, cycle-walked into [0, n)), keyed by seed + epoch.
:func:`index_shuffle` computes the same permutation with numpy, so an epoch
visits the items in the JAX loader's order.  Each item's augmentation draws
from ``random.Random(hash((seed, epoch, idx)) & 0xFFFFFFFF)``, ``idx`` the
item's index (``grain_pipeline.py:37-39``), through the same PIL transforms:
the batches are bit-equal to the JAX ``GrainLoader``'s, for any number of
workers.

Workers: ``num_workers`` processes decode (0 by default, as the JAX
loader's ``worker_count``: the main process decodes).  They come from a
``forkserver``: the server starts from a fresh interpreter, so the workers
never inherit the parent's CUDA context or threads (``fork`` after CUDA is
initialized is unsafe), and each is forked from the server, which has this
package imported already, instead of importing torch anew as ``spawn``'s
workers do.  The keys a worker receives carry the epoch, so its draws
depend on nothing the worker holds (:func:`decode_batches`).  A pass
stops its workers when it ends or is closed; the server and its resource
tracker are stopped, and waited for, when this process exits
(:func:`stop_workers`), so that no process outlives it.
"""

from __future__ import annotations

import math
import multiprocessing
import multiprocessing.forkserver
import multiprocessing.resource_tracker
import multiprocessing.util
import random
import weakref
from typing import List

import numpy as np
import torch
import torch.utils.data

from mudpt_torch.data.datum import Datum
from mudpt_torch.data.transforms import load_image

_M32 = 0xFFFFFFFF
# the worker pools of passes not yet stopped (see stop_workers)
_POOLS: "weakref.WeakSet" = weakref.WeakSet()


def _seed_seq(seed: int, n: int) -> List[int]:
    """``std::seed_seq{seed}.generate`` of ``n`` 32-bit words (the C++
    standard's algorithm, [rand.util.seedseq])."""
    out = [0x8B8B8B8B] * n
    s, v = 1, (seed & _M32,)
    t = 11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else 3 if n >= 7 else (n - 1) // 2
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)

    def mix(x: int) -> int:
        return x ^ (x >> 27)

    for k in range(m):
        r1 = 1664525 * mix(out[k % n] ^ out[(k + p) % n] ^ out[(k - 1) % n]) & _M32
        r2 = (r1 + (s if k == 0 else k % n + v[k - 1] if k <= s else k % n)) & _M32
        out[(k + p) % n] = (out[(k + p) % n] + r1) & _M32
        out[(k + q) % n] = (out[(k + q) % n] + r2) & _M32
        out[k % n] = r2
    for k in range(m, m + n):
        r3 = 1566083941 * mix((out[k % n] + out[(k + p) % n] + out[(k - 1) % n]) & _M32) & _M32
        r4 = (r3 - k % n) & _M32
        out[(k + p) % n] ^= r3
        out[(k + q) % n] ^= r4
        out[k % n] = r4
    return out


def index_shuffle(index, max_index: int, seed: int, rounds: int = 4) -> np.ndarray:
    """Positions of ``index`` (an int or an array) in grain's pseudorandom
    permutation of [0, max_index] (``grain.random.index_shuffle``): a Simon
    cipher on blocks of 2w bits, w = max(8, ceil(log2(max_index) / 2)),
    ``rounds`` round keys from ``std::seed_seq{seed}``, applied again while
    the result exceeds ``max_index``.  The cipher runs once over the whole
    block, and the walks read that table: they visit each block value at
    most once between them, where walking each index alone takes as many
    steps again for every index."""
    idx = np.atleast_1d(np.asarray(index, np.int64))
    if max_index == 0:
        return np.zeros(idx.shape, np.int64)
    block = math.ceil(math.log2(max_index))
    block = max(block + block % 2, 16)
    w = block // 2
    mask = np.uint64((1 << w) - 1)
    keys = [np.uint64(k) & mask for k in _seed_seq(seed, rounds)]

    def rotl(v, r: int):
        r %= w
        return v if r == 0 else ((v << np.uint64(r)) | (v >> np.uint64(w - r))) & mask

    def f(v):
        return (rotl(v, 1) & rotl(v, 8)) ^ rotl(v, 2)

    x = np.arange(1 << block, dtype=np.uint64)
    hi, lo = x >> np.uint64(w), x & mask
    for i in range(0, rounds, 2):
        hi = hi ^ f(lo) ^ keys[i]
        lo = lo ^ f(hi) ^ keys[i + 1]
    table = ((hi << np.uint64(w)) | lo).tolist()
    out = []
    for x in idx.tolist():
        x = table[x]
        while x > max_index:
            x = table[x]
        out.append(x)
    return np.asarray(out, np.int64)


def epoch_order(n: int, shuffle: bool, seed: int) -> np.ndarray:
    """The item indices of an epoch in ``IndexSampler``'s order: the
    identity, or grain's shuffle keyed by ``seed`` (the loader's seed plus
    the epoch, a 32-bit value as grain requires)."""
    if not shuffle:
        return np.arange(n)
    if not 0 <= seed <= _M32:
        raise ValueError("Seed should be positive 32-bit integer.")
    return index_shuffle(np.arange(n), n - 1, seed)


def worker_context():
    """The multiprocessing context of the pipelines' worker processes (see
    the module docstring)."""
    ctx = multiprocessing.get_context("forkserver")
    # read when the server starts, once a process; later calls change nothing
    ctx.set_forkserver_preload(["mudpt_torch.data.grain_pipeline",
                                "mudpt_torch.data.tfdata"])
    return ctx


def stop_workers() -> None:
    """Stop every worker of a pass still open, then the forkserver and the
    resource tracker behind them, waiting for each process to exit.  Runs
    when this process exits too: left alone, the server and the tracker
    exit only once they see this process gone, and a worker whose server
    has gone only at its next liveness poll, seconds later.  Each step does
    nothing where nothing runs; a later pass starts them anew."""
    for pool in list(_POOLS):
        pool._shutdown_workers()
    multiprocessing.forkserver._forkserver._stop()
    multiprocessing.resource_tracker._resource_tracker._stop()


# at exit, after multiprocessing has stopped the workers and released their
# semaphores (exit priority 0), so that the tracker stops with none left
multiprocessing.util.Finalize(None, stop_workers, exitpriority=-1)


def _sample(sample) -> tuple:
    """A decoded item as it leaves a worker: a contiguous fp32 image and
    its label."""
    image, label = sample
    return np.ascontiguousarray(image, np.float32), label


def decode_batches(dataset, batches: list, num_workers: int, in_flight: int):
    """(images, labels) numpy pairs of ``dataset`` over the key lists
    ``batches``.  ``num_workers`` worker processes (none: this process)
    decode one item at a time, as tf.data's parallel map and grain's record
    workers take them, so a batch's items decode side by side, with up to
    ``in_flight`` items queued ahead; the items are batched here in key
    order.  The workers live for one pass: they stop when it ends or is
    closed (a worker pool left to the garbage collector waits out its
    join timeouts, seconds a worker)."""
    kw = {}
    if num_workers:
        kw = dict(multiprocessing_context=worker_context(),
                  prefetch_factor=max(2, -(-in_flight // num_workers)))
    items = iter(torch.utils.data.DataLoader(
        dataset, sampler=[key for batch in batches for key in batch], batch_size=None,
        num_workers=num_workers, collate_fn=_sample, **kw))
    if num_workers:
        _POOLS.add(items)
    try:
        for batch in batches:
            samples = [next(items) for _ in batch]
            yield (np.stack([image for image, _ in samples]),
                   np.asarray([label for _, label in samples], np.int32))
    finally:
        if num_workers:
            items._shutdown_workers()


class _DecodeItems(torch.utils.data.Dataset):
    """Item ``idx`` of ``items`` decoded and augmented at ``epoch``
    (``_DecodeTransform.map``); keys are (idx, epoch)."""

    def __init__(self, items: List[Datum], transform, seed: int):
        self.items = items
        self.transform = transform
        self.seed = seed

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, key) -> tuple:
        idx, epoch = key
        item = self.items[idx]
        rng = random.Random(hash((self.seed, epoch, int(idx))) & 0xFFFFFFFF)
        if item.array is not None:
            arr = np.asarray(item.array, np.float32)
            if hasattr(self.transform, "apply_array"):
                arr = self.transform.apply_array(arr, rng)
        else:
            try:
                arr = self.transform(load_image(item.impath), rng)
            except TypeError:
                arr = self.transform(load_image(item.impath))
        return arr.astype(np.float32), int(item.label)


class GrainLoader:
    def __init__(
        self,
        items: List[Datum],
        transform,
        batch_size: int,
        *,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 0,
        seed: int = 0,
        pad_to_batches: int = 0,
    ):
        self.items = items
        self.transform = transform
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.seed = seed
        self._drop_last = drop_last and len(items) >= batch_size
        self._epoch = 0
        self._dataset = _DecodeItems(items, transform, seed)
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

    def _empty_batch(self) -> dict:
        size = getattr(self.transform, "size", None)
        if self.items:  # infer the decoded shape from a real item
            shape = _DecodeItems(self.items, self.transform, self.seed)[0, 0][0].shape
        elif size is not None:
            shape = (size, size, 3)
        else:
            # empty item shard AND a size-less transform: the CLIP default
            shape = (224, 224, 3)
        return {
            "image": np.zeros((self.batch_size, *shape), np.float32),
            "label": np.zeros(self.batch_size, np.int32),
            "valid": np.zeros(self.batch_size, bool),
        }

    def set_epoch(self, epoch: int):
        """Fast-forward the epoch counter so a resumed run replays the exact
        shuffle/augmentation order an uninterrupted run would see (next
        __iter__ builds ``epoch``)."""
        self._epoch = int(epoch)

    def _batches(self, epoch: int) -> list:
        order = epoch_order(len(self.items), self.shuffle, self.seed + epoch)
        out = []
        for i in range(0, len(order), self.batch_size):
            chunk = order[i:i + self.batch_size]
            if self._drop_last and len(chunk) < self.batch_size:
                break
            out.append([(int(j), epoch) for j in chunk])
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
                    images = np.pad(
                        images, [(0, pad)] + [(0, 0)] * (images.ndim - 1)
                    )
                    labels = np.pad(labels, (0, pad))
                yield {
                    "image": np.asarray(images, np.float32),
                    "label": np.asarray(labels, np.int32),
                    "valid": np.arange(self.batch_size) < n,
                }
                emitted += 1
        if emitted < self.pad_to_batches:
            eb = self._empty_batch()  # consumers treat batches as read-only
            for _ in range(self.pad_to_batches - emitted):
                yield eb
