"""One epoch of each deep-prompt trainer of the port (VPT, MPT, UMuDPT,
UUMuDPT) through ``build_trainer(..., devices="cpu")`` against the JAX
trainer, from the same trees, as ``test_torch_zoo_engine.py`` holds CoOp and
CoCoOp: per-step losses and the final prompts within 1e-4, the test
predictions equal."""

import pytest

from tests.test_torch_zoo_engine import check_one_epoch, two_torch_threads  # noqa: F401


@pytest.mark.parametrize("trainer", ["VPT", "MPT", "UMuDPT", "UUMuDPT"])
def test_one_epoch_matches_jax_trainer(tmp_path, trainer):
    check_one_epoch(tmp_path, trainer)
