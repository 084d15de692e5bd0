"""DataManager: dataset construction + train/val/test loaders from a Config
(counterpart of ``mudpt_tpu/data/manager.py:55``, one process).

The Dassl equivalent is constructed inside every trainer's ``__init__``
(reference call stack SURVEY.md §3.1): DATASET_REGISTRY lookup -> few-shot
pipeline -> loaders with train/test transforms.  ``DATALOADER.PIPELINE``
selects the threaded PIL loader (``threads``), the grain pipeline's
counterpart (``grain``) or tf.data's (``tfdata``), as ``manager.py:97-158``
does: any other value runs the threaded loader there, and here.
``DATALOADER.HOST_SHARD`` is parsed and validated as there; a single
process never shards, so the multi-host split waits with the mesh
(ROADMAP.md A, 'the mesh').
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
    def __init__(self, cfg, dataset=None):
        self.cfg = cfg
        if dataset is None:
            _import_datasets()
            dataset_cls = DATASET_REGISTRY.get(cfg.DATASET.NAME)
            dataset = dataset_cls.build(cfg)
        self.dataset = dataset
        # one process: nothing to split, whatever the mode
        self._shard_mode = _host_shard_mode(cfg.DATALOADER.HOST_SHARD)
        self.host_sharded = self.eval_host_sharded = False
        pipeline = cfg.DATALOADER.PIPELINE
        train_bs, test_bs = cfg.DATALOADER.TRAIN_X.BATCH_SIZE, cfg.DATALOADER.TEST.BATCH_SIZE

        if pipeline == "grain":
            train_tf = build_transform(cfg, is_train=True)
            test_tf = build_transform(cfg, is_train=False)
            self.train_loader = GrainLoader(
                dataset.train_x, train_tf, train_bs,
                shuffle=_train_shuffle(cfg), drop_last=True, seed=cfg.SEED,
            )
            mk_eval = lambda items: GrainLoader(items, test_tf, test_bs)  # noqa: E731
        elif pipeline == "tfdata":
            mk_tf = lambda items, bs, train: TFDataLoader(  # noqa: E731
                items, bs, size=cfg.INPUT.SIZE[0], is_train=train,
                shuffle=train and _train_shuffle(cfg), drop_last=train, seed=cfg.SEED,
                mean=cfg.INPUT.PIXEL_MEAN, std=cfg.INPUT.PIXEL_STD,
                num_workers=cfg.DATALOADER.NUM_WORKERS,
            )
            self.train_loader = mk_tf(dataset.train_x, train_bs, True)
            mk_eval = lambda items: mk_tf(items, test_bs, False)  # noqa: E731
        else:
            train_tf = build_transform(cfg, is_train=True)
            test_tf = build_transform(cfg, is_train=False)
            self.train_loader = DataLoader(
                dataset.train_x, train_tf, train_bs,
                shuffle=_train_shuffle(cfg), drop_last=True,
                num_workers=cfg.DATALOADER.NUM_WORKERS, seed=cfg.SEED,
            )
            mk_eval = lambda items: DataLoader(  # noqa: E731
                items, test_tf, test_bs, num_workers=cfg.DATALOADER.NUM_WORKERS)

        self.val_loader = mk_eval(dataset.val) if dataset.val else None
        self.test_loader = mk_eval(dataset.test) if dataset.test else None

    @property
    def num_classes(self) -> int:
        return self.dataset.num_classes

    @property
    def classnames(self):
        return self.dataset.classnames
