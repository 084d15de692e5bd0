"""The port's ``build_optimizer`` (torch.optim) against the JAX package's
(optax) under the same ``OptimCfg``: 8 steps of one seeded gradient
sequence with a warmup epoch and the cosine or single-step schedule at 2
steps per epoch; the parameters agree at 1e-6 after every step."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mudpt_tpu.config.config import OptimCfg
from mudpt_tpu.trainers.optim import build_optimizer as jbuild
from mudpt_tpu.trainers.optim import make_lr_schedule as jschedule

from mudpt_torch.trainers.optim import build_optimizer, make_lr_schedule

STEPS, SPE = 8, 2
CASES = {
    "sgd": dict(NAME="sgd"),
    "sgd_dampening": dict(NAME="sgd", SGD_DAMPNING=0.3),
    "sgd_nesterov": dict(NAME="sgd", SGD_NESTEROV=True),
    "sgd_linear_warmup": dict(NAME="sgd", WARMUP_TYPE="linear"),
    "sgd_single_step": dict(NAME="sgd", LR_SCHEDULER="single_step", WARMUP_EPOCH=0),
    "adam": dict(NAME="adam"),
    "adamw": dict(NAME="adamw", WEIGHT_DECAY=1e-2),
}


def _cfg(**kw):
    base = dict(LR=0.05, MAX_EPOCH=4, WARMUP_EPOCH=1, WARMUP_CONS_LR=1e-3,
                MOMENTUM=0.9, WEIGHT_DECAY=5e-3)
    base.update(kw)
    return OptimCfg(**base)


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_optimizer_matches_jax(case):
    cfg = _cfg(**CASES[case])
    rng = np.random.RandomState(0)
    w0 = {"a": rng.randn(3, 5).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in w0.items()}
             for _ in range(STEPS)]

    tx, _ = jbuild(cfg, SPE)
    jp = {k: jnp.asarray(v) for k, v in w0.items()}
    state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in w0.items()}
    opt, sched = build_optimizer(tp.values(), cfg, SPE)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k])
        opt.step()
        sched.step()
        for k, t in tp.items():
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", ["sgd", "sgd_linear_warmup", "sgd_single_step"])
def test_lr_schedule_matches_jax(case):
    cfg = _cfg(**CASES[case])
    j, t = jschedule(cfg, SPE), make_lr_schedule(cfg, SPE)
    for step in range(STEPS):
        np.testing.assert_allclose(t(step), float(j(jnp.asarray(step))), rtol=1e-6)


def test_unknown_optimizer_raises():
    with pytest.raises(NotImplementedError, match="OPTIM.NAME"):
        build_optimizer([torch.zeros(2, requires_grad=True)], _cfg(NAME="rmsprop"), SPE)
