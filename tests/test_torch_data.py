"""The port's copy of the data pipeline against the JAX package's: the
Synthetic dataset through ``DataManager`` gives numpy-equal ``image`` /
``label`` / ``valid`` batches in both packages over two training epochs
(shuffle and flip drawn from (seed, epoch, position)), a resumed loader's
epoch, and one pass of the test and val splits, whose last batch is
zero-padded with ``valid`` marking the real rows."""

import numpy as np
import pytest

from mudpt_tpu.config import load_config as jload_config
from mudpt_tpu.data import DataManager as JDataManager

from mudpt_torch.config import load_config
from mudpt_torch.data import DataManager

FILES = ("configs/datasets/synthetic.yaml", "configs/trainers/test/tiny.yaml")
# 5 classes x 4 test images in batches of 6: the last batch holds 2 rows and
# 4 zero rows; 5 x 2 val images in batches of 6: 6 + 4
OPTS = ["DATASET.SYNTHETIC_NUM_CLASSES", "5", "DATASET.SYNTHETIC_PER_CLASS", "7",
        "DATALOADER.TEST.BATCH_SIZE", "6", "DATALOADER.TRAIN_X.BATCH_SIZE", "4", "SEED", "5"]


@pytest.fixture(scope="module")
def managers():
    return (JDataManager(jload_config(*FILES, opts=OPTS)),
            DataManager(load_config(*FILES, opts=OPTS)))


def _same_batches(jloader, tloader):
    jb, tb = list(jloader), list(tloader)
    assert len(jb) == len(tb) == len(tloader) > 0
    for a, b in zip(jb, tb):
        assert set(b) == {"image", "label", "valid"}
        for k in ("image", "label", "valid"):
            assert b[k].dtype == a[k].dtype and b[k].shape == a[k].shape
            np.testing.assert_array_equal(b[k], a[k])
    return tb


def test_train_epochs_equal(managers):
    jdm, tdm = managers
    assert tdm.classnames == jdm.classnames and tdm.num_classes == 5
    epochs = [_same_batches(jdm.train_loader, tdm.train_loader) for _ in range(2)]
    assert len(epochs[0]) == 35 // 4  # drop_last
    # the two epochs shuffle and flip differently
    assert not np.array_equal(epochs[0][0]["image"], epochs[1][0]["image"])
    for b in epochs[0]:
        assert b["valid"].all()


def test_resumed_epoch_equal(managers):
    """set_epoch(1), as resume does, replays epoch 2's batches."""
    jdm, tdm = managers
    jdm.train_loader.set_epoch(1)
    tdm.train_loader.set_epoch(1)
    _same_batches(jdm.train_loader, tdm.train_loader)


@pytest.mark.parametrize("split,valid_last", [("test", 2), ("val", 4)])
def test_eval_pass_equal_with_padded_last_batch(managers, split, valid_last):
    jdm, tdm = managers
    tb = _same_batches(getattr(jdm, f"{split}_loader"), getattr(tdm, f"{split}_loader"))
    last = tb[-1]
    assert last["valid"].sum() == valid_last and last["image"].shape[0] == 6
    assert not last["image"][valid_last:].any() and not last["label"][valid_last:].any()
    assert all(b["valid"].all() for b in tb[:-1])
