"""Host-side batching with background prefetch.

Replaces the reference's torch ``DataLoader`` over Dassl's
``DatasetWrapper``.  Batches are numpy dicts ``{image (B,H,W,3) f32,
label (B,) i32, valid (B,) bool}``; the final test batch is zero-padded to a
full batch with ``valid`` marking real rows — keeping every step at one
shape.

Decoding/augmentation runs in a small thread pool overlapped with device
compute via a bounded prefetch queue.  A copy of ``mudpt_tpu/data/loader.py``:
order and augmentation are pure functions of (seed, epoch, position), so
one config gives the same batches in both packages.
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List

import numpy as np

from mudpt_torch.data.datum import Datum
from mudpt_torch.data.transforms import load_image


class DataLoader:
    def __init__(
        self,
        items: List[Datum],
        transform,
        batch_size: int,
        *,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 4,
        seed: int = 0,
        prefetch: int = 2,
        pad_to_batches: int = 0,
    ):
        self.items = items
        self.transform = transform
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last and len(items) >= batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self._seed = seed
        self._epoch = 0
        # pod eval: hosts iterate in lockstep (collectives), so a host whose
        # item shard is short must still emit the same number of batches —
        # trailing batches are all-invalid zeros
        self.pad_to_batches = pad_to_batches

    def set_epoch(self, epoch: int):
        """Fast-forward the epoch counter (resume): shuffle order and
        augmentation RNGs are pure functions of (seed, epoch), so a resumed
        run replays exactly the batches an uninterrupted run would see."""
        self._epoch = int(epoch)

    def __len__(self) -> int:
        n = len(self.items)
        if self.drop_last:
            return n // self.batch_size
        return max(
            (n + self.batch_size - 1) // self.batch_size, self.pad_to_batches
        )

    def _decode(self, item_and_rng) -> np.ndarray:
        item, rng = item_and_rng
        if item.array is not None:
            arr = np.asarray(item.array, np.float32)
            if self.transform is not None and hasattr(self.transform, "apply_array"):
                arr = self.transform.apply_array(arr, rng)
            return arr
        try:
            return self.transform(load_image(item.impath), rng)
        except TypeError:
            return self.transform(load_image(item.impath))

    def _make_batch(self, chunk: List[Datum], rngs, pool) -> dict:
        images = list(pool.map(self._decode, zip(chunk, rngs)))
        labels = [it.label for it in chunk]
        n = len(chunk)
        pad = self.batch_size - n
        if pad:
            images.extend([np.zeros_like(images[0])] * pad)
            labels.extend([0] * pad)
        return {
            "image": np.stack(images).astype(np.float32),
            "label": np.asarray(labels, np.int32),
            "valid": np.arange(self.batch_size) < n,
        }

    def __iter__(self) -> Iterator[dict]:
        self._epoch += 1
        order = list(range(len(self.items)))
        if self.shuffle:
            # stateless: order is a pure function of (seed, epoch) — a
            # resumed run at epoch E shuffles identically to an
            # uninterrupted run's epoch E (position salt -1 never collides
            # with the per-item RNGs below, whose positions are >= 0)
            random.Random(
                hash((self._seed, self._epoch, -1)) & 0xFFFFFFFF
            ).shuffle(order)

        # per-item RNGs seeded by (loader seed, epoch, position): augmentation
        # is reproducible no matter how worker threads interleave
        chunks = []
        for i in range(0, len(order), self.batch_size):
            idxs = order[i : i + self.batch_size]
            chunk = [self.items[j] for j in idxs]
            if self.drop_last and len(chunk) < self.batch_size:
                continue
            rngs = [
                random.Random(hash((self._seed, self._epoch, i + n)) & 0xFFFFFFFF)
                for n in range(len(chunk))
            ]
            chunks.append((chunk, rngs))

        n_pad_batches = max(0, self.pad_to_batches - len(chunks))

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: List[BaseException] = []

        def empty_batch():
            size = getattr(self.transform, "size", None)
            if size is None and self.items:  # infer from a real item
                img = self._decode((self.items[0], random.Random(0)))
                size = img.shape[0]
            if size is None:
                # empty item shard (pod eval) AND a size-less transform:
                # nothing to infer from, so fall back to the CLIP default.
                # (Pod note: the shape must match the other hosts' batches;
                # real trainer transforms always expose .size, so this path
                # only covers array-item test loaders.)
                size = 224
            return {
                "image": np.zeros(
                    (self.batch_size, size, size, 3), np.float32
                ),
                "label": np.zeros(self.batch_size, np.int32),
                "valid": np.zeros(self.batch_size, bool),
            }

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for chunk, rngs in chunks:
                        q.put(self._make_batch(chunk, rngs, pool))
                if n_pad_batches:
                    eb = empty_batch()  # consumers treat batches as read-only
                    for _ in range(n_pad_batches):
                        q.put(eb)
            except BaseException as e:  # surface in consumer
                error.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            batch = q.get()
            if batch is sentinel:
                if error:
                    raise error[0]
                return
            yield batch
