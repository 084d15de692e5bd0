"""DataManager: dataset construction + train/val/test loaders from a Config
(counterpart of ``mudpt_tpu/data/manager.py:55``, one process).

The Dassl equivalent is constructed inside every trainer's ``__init__``
(reference call stack SURVEY.md §3.1): DATASET_REGISTRY lookup -> few-shot
pipeline -> loaders with train/test transforms.  The port has the threaded
loader (``DATALOADER.PIPELINE threads``); the grain and tf.data pipelines
and the multi-host input split (``DATALOADER.HOST_SHARD``, which a single
process never engages) wait (ROADMAP.md A, 'the dataset readers').
"""

from __future__ import annotations

from mudpt_torch.data.loader import DataLoader
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


class DataManager:
    def __init__(self, cfg, dataset=None):
        self.cfg = cfg
        if cfg.DATALOADER.PIPELINE != "threads":
            raise NotImplementedError(
                f"DATALOADER.PIPELINE={cfg.DATALOADER.PIPELINE!r}: the port has the "
                "threaded loader only; grain and tf.data wait (ROADMAP.md A, 'the "
                "dataset readers')"
            )
        if dataset is None:
            _import_datasets()
            dataset_cls = DATASET_REGISTRY.get(cfg.DATASET.NAME)
            dataset = dataset_cls.build(cfg)
        self.dataset = dataset
        train_tf = build_transform(cfg, is_train=True)
        test_tf = build_transform(cfg, is_train=False)
        self.train_loader = DataLoader(
            dataset.train_x,
            train_tf,
            cfg.DATALOADER.TRAIN_X.BATCH_SIZE,
            shuffle=_train_shuffle(cfg),
            drop_last=True,
            num_workers=cfg.DATALOADER.NUM_WORKERS,
            seed=cfg.SEED,
        )

        def eval_loader(items):
            if not items:
                return None
            return DataLoader(items, test_tf, cfg.DATALOADER.TEST.BATCH_SIZE,
                              num_workers=cfg.DATALOADER.NUM_WORKERS)

        self.val_loader = eval_loader(dataset.val)
        self.test_loader = eval_loader(dataset.test)

    @property
    def num_classes(self) -> int:
        return self.dataset.num_classes

    @property
    def classnames(self):
        return self.dataset.classnames
