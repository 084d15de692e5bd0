"""The trainer zoo under the static int8 tiers against the JAX package's
trainers, as ``test_torch_zoo_quant.py`` sets out, with its cases, helpers
and bounds.  Each JAX trainer calibrates at build; the port's trainer,
on the JAX trainer's trees crossed over without their scales, calibrates
again: its scales within 2^-20 of the JAX trainer's (the order of fp32
sums, ``test_torch_static_calib.py``'s bound), then ``int8_static``'s
logits, or ``int8_ste_static``'s first step.  UMuDPT and UUMuDPT raise in
both packages with the same ``ValueError``: their prompt heads' blocks
enter the text tower's capture, so the scales do not fit the tower."""

import numpy as np
import pytest

from mudpt_tpu.config import load_config as jload_config
from mudpt_tpu.trainers import build_trainer as jbuild_trainer

from mudpt_torch.config import load_config
from mudpt_torch.trainers import build_trainer
from tests.test_torch_zoo_quant import (CASES, FILES, _opts, build_pair, check_first_step,
                                        check_logits, modes)  # noqa: F401

SCALE_RTOL = 2.0 ** -20


@pytest.mark.parametrize("quant", ["int8_static", "int8_ste_static"])
@pytest.mark.parametrize("case", list(CASES))
def test_zoo_static_tiers_match_jax(tmp_path, case, quant):
    if case in ("UMuDPT", "UUMuDPT"):
        with pytest.raises(ValueError) as jerr:
            jbuild_trainer(jload_config(*FILES, opts=_opts(case, tmp_path / "jax", quant)))
        with pytest.raises(ValueError) as terr:
            build_trainer(load_config(*FILES, opts=_opts(case, tmp_path / "torch", quant)),
                          devices="cpu")
        assert str(terr.value) == str(jerr.value)
        assert "scales shape (3, 4) != (2, 4) for this tower" in str(terr.value)
        return
    jtr, ttr = build_pair(case, tmp_path, quant)
    assert ttr._static_calibrated
    ttr._calibrate_static_quant()
    towers = ("visual",) if ttr.trainable is None else ("visual", "text")
    for tower in ("visual", "text"):
        blocks = ttr.frozen[tower]["blocks"]
        assert ("q8_scales" in blocks) == (tower in towers), tower
        if tower in towers:
            np.testing.assert_allclose(blocks["q8_scales"].double().numpy(),
                                       np.asarray(jtr.frozen[tower]["blocks"]["q8_scales"],
                                                  np.float64), rtol=SCALE_RTOL)
    if ttr.trainable is None or quant == "int8_static":
        check_logits(jtr, ttr)
    else:
        check_first_step(jtr, ttr)
