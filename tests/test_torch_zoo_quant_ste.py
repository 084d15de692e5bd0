"""The trainer zoo under ``int8_ste`` against the JAX package's trainers:
the first training batch's loss and the gradient of every trainable leaf
(the zero-shot pair: the logits), as ``test_torch_zoo_quant.py`` sets out,
with its cases, helpers and bounds."""

import pytest

from tests.test_torch_zoo_quant import CASES, check_dynamic, modes  # noqa: F401


@pytest.mark.parametrize("case", list(CASES))
def test_zoo_int8_ste_matches_jax(tmp_path, case):
    check_dynamic(tmp_path, case, "int8_ste")
