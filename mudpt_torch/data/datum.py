"""Dataset item model + few-shot / base-new protocols.

Re-provides the Dassl surface the reference depends on (``Datum``,
``DatasetBase``, few-shot sampling, class subsampling — consumed at e.g.
reference datasets/oxford_pets.py:7,37-57,107-153) with identical semantics:

  * few-shot sampling picks ``num_shots`` items per class via
    ``random.sample`` in label-first-appearance order — the exact RNG call
    sequence of Dassl's ``generate_fewshot_dataset`` (default
    ``repeat=False``: a class with fewer items keeps all of them, drawing
    nothing from the stream) so a fresh split under the same seed selects
    the same items; val is capped at min(shots, 4) (oxford_pets.py:48-49);
  * per-(shots, seed) pickle caches under ``split_fewshot/`` and a
    whole-split ``preprocessed.pkl`` cache; reference-produced caches
    pickle dassl-classed ``Datum`` objects, which ``read_split_cache``
    loads WITHOUT dassl installed via a custom Unpickler, as it loads
    ``mudpt_tpu``-written caches without importing ``mudpt_tpu``;
  * ``subsample_classes``: sort labels, base = first ceil(n/2), new = rest,
    relabel from 0 (oxford_pets.py:107-153).
"""

from __future__ import annotations

import math
import os
import pickle
import random
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class Datum:
    impath: str = ""
    label: int = 0
    classname: str = ""
    # optional in-memory payload (synthetic datasets / pre-decoded arrays)
    array: object = field(default=None, repr=False, compare=False)


class _ForeignDatum:
    """Stand-in for dataset-item classes pickled by other frameworks.
    Dassl's ``Datum`` (the class inside reference-produced
    ``preprocessed.pkl`` / ``split_fewshot/*.pkl`` caches — reference
    datasets/oxford_pets.py:21-35) stores ``_impath``/``_label``/
    ``_classname`` behind read-only properties; unpickling restores that
    instance ``__dict__`` here and ``__getattr__`` re-exposes the
    property names ``_revive`` reads."""

    def __getattr__(self, name):
        try:
            return self.__dict__["_" + name]
        except KeyError:
            raise AttributeError(name) from None


class _CacheUnpickler(pickle.Unpickler):
    """``pickle.Unpickler`` that loads split caches written by other
    packages: a ``Datum`` class of any module but this one (Dassl's, in
    reference-produced caches, or ``mudpt_tpu``'s, whose readers share
    ``DATASET.ROOT`` with the port's) maps to :class:`_ForeignDatum`
    without importing that module, and ``_revive`` then normalizes it.
    Everything else resolves normally."""

    def find_class(self, module, name):
        if name == "Datum" and module != __name__:
            return _ForeignDatum
        return super().find_class(module, name)


def read_split_cache(path: str):
    if os.path.exists(path):
        with open(path, "rb") as f:
            return _CacheUnpickler(f).load()
    return None


def write_split_cache(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)


def generate_fewshot(
    items: Sequence[Datum], num_shots: int, repeat: bool = False
) -> List[Datum]:
    """Sample ``num_shots`` items per class — Dassl's
    ``generate_fewshot_dataset`` semantics AND RNG call sequence (one
    ``random.sample(group, num_shots)`` per label in first-appearance
    order; ``repeat=False`` default returns small classes whole without
    touching the stream), so a fresh split under ``set_seed(SEED)`` draws
    the same impaths a Dassl run would (tests/test_data.py pins this
    against an executable spec of the Dassl loop)."""
    if num_shots < 1:
        return list(items)
    tracker: Dict[int, List[Datum]] = defaultdict(list)
    for item in items:
        tracker[item.label].append(item)
    out: List[Datum] = []
    for label, group in tracker.items():
        if len(group) >= num_shots:
            out.extend(random.sample(group, num_shots))
        elif repeat:
            out.extend(random.choices(group, k=num_shots))
        else:
            out.extend(group)
    return out


def subsample_classes(*splits, subsample: str = "all"):
    assert subsample in ("all", "base", "new"), subsample
    if subsample == "all":
        return splits

    labels = sorted({item.label for item in splits[0]})
    m = math.ceil(len(labels) / 2)
    selected = labels[:m] if subsample == "base" else labels[m:]
    relabel = {y: i for i, y in enumerate(selected)}
    chosen = set(selected)

    out = []
    for split in splits:
        out.append(
            [
                Datum(
                    impath=item.impath,
                    label=relabel[item.label],
                    classname=item.classname,
                    array=item.array,
                )
                for item in split
                if item.label in chosen
            ]
        )
    return tuple(out)


class DatasetBase:
    """Holds train/val/test splits + derived classname table."""

    dataset_dir: str = ""

    def __init__(
        self,
        train_x: List[Datum],
        val: Optional[List[Datum]] = None,
        test: Optional[List[Datum]] = None,
    ):
        self.train_x = train_x
        self.val = val if val is not None else []
        self.test = test if test is not None else []
        self.lab2cname, self.classnames = self._build_classname_table()
        self.num_classes = len(self.classnames)

    def _build_classname_table(self) -> Tuple[Dict[int, str], List[str]]:
        mapping: Dict[int, str] = {}
        for split in (self.train_x, self.val, self.test):
            for item in split:
                mapping[item.label] = item.classname
        labels = sorted(mapping)
        return mapping, [mapping[y] for y in labels]

    # -- shared protocol driver used by every concrete loader ---------------
    @classmethod
    def build(cls, cfg):
        """Full reference pipeline: read (with preprocessed.pkl cache) ->
        few-shot (with per-shot/seed cache) -> subsample -> DatasetBase."""
        self = cls.__new__(cls)
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, cls.dataset_dir)
        preprocessed = os.path.join(self.dataset_dir, "preprocessed.pkl")

        cached = read_split_cache(preprocessed)
        if cached is not None:
            train, val, test = cached["train"], cached["val"], cached["test"]
            train, val, test = _revive(train), _revive(val), _revive(test)
        else:
            train, val, test = self.read_data()
            try:
                write_split_cache(
                    preprocessed, {"train": train, "val": val, "test": test}
                )
            except OSError:
                pass

        num_shots = cfg.DATASET.NUM_SHOTS
        if num_shots >= 1:
            cache = os.path.join(
                self.dataset_dir,
                "split_fewshot",
                f"shot_{num_shots}-seed_{cfg.SEED}.pkl",
            )
            cached = read_split_cache(cache)
            if cached is not None:
                train, val = _revive(cached["train"]), _revive(cached["val"])
            else:
                train = generate_fewshot(train, num_shots)
                val = generate_fewshot(val, min(num_shots, 4))
                try:
                    write_split_cache(cache, {"train": train, "val": val})
                except OSError:
                    pass

        train, val, test = subsample_classes(
            train, val, test, subsample=cfg.DATASET.SUBSAMPLE_CLASSES
        )
        DatasetBase.__init__(self, train_x=train, val=val, test=test)
        return self

    def read_data(self):  # pragma: no cover - abstract
        raise NotImplementedError


def _revive(items):
    """Accept items unpickled from reference-produced caches (plain objects
    with impath/label/classname attrs) and normalize to our Datum."""
    out = []
    for it in items:
        if isinstance(it, Datum):
            out.append(it)
        else:
            out.append(
                Datum(
                    impath=getattr(it, "impath", ""),
                    label=int(getattr(it, "label", 0)),
                    classname=getattr(it, "classname", ""),
                )
            )
    return out
