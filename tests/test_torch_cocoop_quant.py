"""CoCoOp under the int8 tiers, the port (``mudpt_torch/trainers/cocoop.py``)
against the JAX package, on the CPU at tiny size (test-tiny, the synthetic
dataset, PREC fp32, N_CTX 4), the JAX trainer's trees crossed over as in
``test_torch_zoo_quant.py``, whose bounds hold here:

* ``int8``: the logits of a test batch, unchunked and in chunks of three
  instances (the tail padded), each row within 2^-4 of the largest value
  and all rows but a quarter within 2^-12 (an int8 code that the order of
  fp32 sums moves across a rounding boundary stays in its image's row);
* ``int8_ste``: three steps on one batch, unchunked and in chunks: the
  chunked losses bit-equal to the unchunked ones (each chunk recomputes on
  the forward's routes and quant mode, and the dynamic chain quantizes row
  by row), and the first step's loss and gradients against the JAX
  trainer's (loss 2^-7 relative, gradients 2^-6);
* the static tiers raising the JAX package's ``ValueError``, which names
  the dynamic tiers: CoCoOp has no image-independent text to calibrate.

CoCoOp's ``pallas_int8`` artifact is exported and served in
``test_torch_export.py``.
"""

import pytest

from mudpt_tpu.config import load_config as jload_config
from mudpt_tpu.trainers import build_trainer as jbuild_trainer

from mudpt_torch.config import load_config
from mudpt_torch.models import layers as TL
from mudpt_torch.trainers import build_trainer
from tests.test_torch_zoo_quant import (FILES, _opts, build_pair, check_first_step,  # noqa: F401
                                        check_logits, modes)


def _case(chunk):
    return ("CoCoOp", ("N_CTX", "4", "ENCODE_CHUNK", str(chunk)))


@pytest.mark.parametrize("chunk", [-1, 3], ids=["unchunked", "chunked"])
def test_cocoop_int8_logits_match_jax(tmp_path, chunk):
    jtr, ttr = build_pair(_case(chunk), tmp_path, "int8")
    assert "q8_weights" in ttr.frozen["text"]["blocks"]
    check_logits(jtr, ttr)


def _three_steps(ttr, batch):
    out = []
    for _ in range(3):
        loss, _ = ttr._train_step(ttr._device_batch(batch))
        out.append(loss.item())
    return out


def test_cocoop_int8_ste_chunked_steps_and_gradients(tmp_path):
    jtr, ttr = build_pair(_case(-1), tmp_path / "unchunked", "int8_ste")
    check_first_step(jtr, ttr)
    batch = next(iter(ttr.dm.train_loader))
    _, tch = build_pair(_case(2), tmp_path / "chunked", "int8_ste")
    assert TL.quant_mode() == "int8_ste"
    losses, chunked = _three_steps(ttr, batch), _three_steps(tch, batch)
    assert chunked == losses, (chunked, losses)
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("quant", ["int8_static", "int8_ste_static"])
def test_cocoop_static_tiers_raise_as_jax(tmp_path, quant):
    case = _case(-1)
    with pytest.raises(ValueError) as jerr:
        jbuild_trainer(jload_config(*FILES, opts=_opts(case, tmp_path / "jax", quant)))
    with pytest.raises(ValueError) as terr:
        build_trainer(load_config(*FILES, opts=_opts(case, tmp_path / "torch", quant)),
                      devices="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "use the dynamic tiers instead: TRAIN.QUANT 'int8'" in str(terr.value)
