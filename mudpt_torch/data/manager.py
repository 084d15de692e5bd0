"""DataManager: dataset construction + train/val/test loaders from a Config
(counterpart of ``mudpt_tpu/data/manager.py:55``).

The Dassl equivalent is constructed inside every trainer's ``__init__``
(reference call stack SURVEY.md §3.1): DATASET_REGISTRY lookup -> few-shot
pipeline -> loaders with train/test transforms.  ``DATALOADER.PIPELINE``
selects the threaded PIL loader (``threads``), the grain pipeline's
counterpart (``grain``) or tf.data's (``tfdata``), as ``manager.py:97-158``
does: any other value runs the threaded loader there, and here.
``DATALOADER.HOST_SHARD`` splits the items across the mesh's data axis as
``manager.py:64-95`` and ``:176-210`` split them across hosts: the JAX
package's process is the rank's data index (ranks that share it decode the
same items), its process count the data axis's width.
"""

from __future__ import annotations

from mudpt_torch.data.grain_pipeline import GrainLoader
from mudpt_torch.data.loader import DataLoader
from mudpt_torch.data.tfdata import TFDataLoader
from mudpt_torch.data.transforms import build_transform
from mudpt_torch.utils.registry import DATASET_REGISTRY


def _import_datasets() -> None:
    # registration via import side effects (mirrors reference train.py:15-29)
    import mudpt_torch.data.datasets  # noqa: F401


def _train_shuffle(cfg) -> bool:
    """DATALOADER.TRAIN_X.SAMPLER -> shuffle flag, accepting both our
    vocabulary and Dassl's class names (``manager.py:21-39``)."""
    s = cfg.DATALOADER.TRAIN_X.SAMPLER
    canon = {
        "random": True, "randomsampler": True,
        "sequential": False, "sequentialsampler": False,
    }
    key = s.lower()
    if key not in canon:
        raise ValueError(
            f"DATALOADER.TRAIN_X.SAMPLER={s!r}: expected random|sequential "
            "(or Dassl's RandomSampler/SequentialSampler)"
        )
    return canon[key]


def _host_shard_mode(v) -> str:
    """Normalize DATALOADER.HOST_SHARD to auto|on|off (accepts booleans and
    their string spellings for reference-YAML compatibility;
    ``manager.py:39-51``)."""
    if isinstance(v, bool):
        return "on" if v else "off"
    s = str(v).strip().lower()
    if s in ("true", "1", "yes", "on"):
        return "on"
    if s in ("false", "0", "no", "off", ""):
        return "off"
    if s == "auto":
        return "auto"
    raise ValueError(f"DATALOADER.HOST_SHARD={v!r}: expected auto|on|off")


class DataManager:
    def __init__(self, cfg, dataset=None, n_data: int = 1, data_index: int = 0):
        self.cfg = cfg
        if dataset is None:
            _import_datasets()
            dataset_cls = DATASET_REGISTRY.get(cfg.DATASET.NAME)
            dataset = dataset_cls.build(cfg)
        self.dataset = dataset
        self._n_data, self._data_index = n_data, data_index

        # DATALOADER.HOST_SHARD: each data index decodes a DISJOINT shard of
        # the train items in batches of its rows; the items are cut to equal
        # lengths so that every rank runs the same number of steps (lockstep
        # collectives).  "auto" (the default) shards whenever the batch
        # divides by the data axis, else every rank decodes the global batch
        # and takes its rows (parallel/mesh.shard_batch)
        self.host_sharded = self.eval_host_sharded = False
        self._shard_mode = _host_shard_mode(cfg.DATALOADER.HOST_SHARD)
        train_items = dataset.train_x
        train_bs, test_bs = cfg.DATALOADER.TRAIN_X.BATCH_SIZE, cfg.DATALOADER.TEST.BATCH_SIZE
        if self._shard_mode != "off" and n_data > 1:
            if self._shard_mode == "on" and train_bs % n_data:
                raise ValueError(
                    f"DATALOADER.HOST_SHARD: global train batch "
                    f"{train_bs} must divide by process count {n_data}"
                )
            if train_bs % n_data == 0:
                n = (len(train_items) // n_data) * n_data
                train_items = train_items[data_index:n:n_data]
                train_bs = train_bs // n_data
                self.host_sharded = True
        pipeline = cfg.DATALOADER.PIPELINE

        if pipeline == "grain":
            train_tf = build_transform(cfg, is_train=True)
            test_tf = build_transform(cfg, is_train=False)
            self.train_loader = GrainLoader(
                train_items, train_tf, train_bs,
                shuffle=_train_shuffle(cfg), drop_last=True, seed=cfg.SEED,
            )
            mk_eval = lambda items, bs, pad: GrainLoader(  # noqa: E731
                items, test_tf, bs, pad_to_batches=pad)
        elif pipeline == "tfdata":
            mk_tf = lambda items, bs, train, pad=0: TFDataLoader(  # noqa: E731
                items, bs, size=cfg.INPUT.SIZE[0], is_train=train,
                shuffle=train and _train_shuffle(cfg), drop_last=train, seed=cfg.SEED,
                mean=cfg.INPUT.PIXEL_MEAN, std=cfg.INPUT.PIXEL_STD,
                num_workers=cfg.DATALOADER.NUM_WORKERS, pad_to_batches=pad,
            )
            self.train_loader = mk_tf(train_items, train_bs, True)
            mk_eval = lambda items, bs, pad: mk_tf(items, bs, False, pad)  # noqa: E731
        else:
            train_tf = build_transform(cfg, is_train=True)
            test_tf = build_transform(cfg, is_train=False)
            self.train_loader = DataLoader(
                train_items, train_tf, train_bs,
                shuffle=_train_shuffle(cfg), drop_last=True,
                num_workers=cfg.DATALOADER.NUM_WORKERS, seed=cfg.SEED,
            )
            mk_eval = lambda items, bs, pad: DataLoader(  # noqa: E731
                items, test_tf, bs, num_workers=cfg.DATALOADER.NUM_WORKERS,
                pad_to_batches=pad)

        def eval_loader(items):
            # the eval split applies to every pipeline: a data index decodes
            # only its block of every global batch (see _eval_shard)
            if not items:
                return None
            shard = self._eval_shard(items, test_bs)
            if shard is None:
                return mk_eval(items, test_bs, 0)
            host_items, bs_h, steps = shard
            self.eval_host_sharded = True
            loader = mk_eval(host_items, bs_h, steps)
            # evaluate() keys the rank-local path off the LOADER, so a
            # custom loader passed to evaluate() is never mis-sliced
            loader.host_sharded_eval = True
            return loader

        self.val_loader = eval_loader(dataset.val)
        self.test_loader = eval_loader(dataset.test)

    def _eval_shard(self, items, test_bs):
        """Split every global eval batch into contiguous blocks, one per
        data index (``manager.py:176-210``): index d decodes ONLY rows
        [d*bs_h, (d+1)*bs_h) of each global batch of ``test_bs`` (the block
        ``shard_batch`` would give it), so the union over the data axis
        covers every item once.  Returns (items, bs_h, pad_to_batches), or
        None when not splitting (one data index, HOST_SHARD off, or a batch
        that does not divide)."""
        n_data = self._n_data
        if self._shard_mode == "off" or n_data == 1 or not items:
            return None
        if test_bs % n_data:
            if self._shard_mode == "on":
                raise ValueError(
                    f"DATALOADER.HOST_SHARD: global eval batch {test_bs} "
                    f"must divide by process count {n_data}"
                )
            return None
        bs_h = test_bs // n_data
        d = self._data_index
        host_items = []
        for start in range(0, len(items), test_bs):
            host_items.extend(items[start + d * bs_h:start + (d + 1) * bs_h])
        steps = -(-len(items) // test_bs)
        return host_items, bs_h, steps

    @property
    def num_classes(self) -> int:
        return self.dataset.num_classes

    @property
    def classnames(self):
        return self.dataset.classnames
