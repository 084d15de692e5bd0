"""Apply the PERF config namespace to the port's kernel-policy module state
(counterpart of ``mudpt_tpu/config/perf.py:37-89``).

The knobs live as module globals so that library use without a Config
still works; this module is where the typed config meets that state.
Precedence per knob: module default < programmatic setter < explicit
config value.  A PERF field left unset does not touch the module state, so
tests and tools that call the setters directly keep working; a field that
a YAML file or an opt wrote, even at its default, calls the setter.  The
port reads no ``MUDPT_TPU_<FIELD>`` environment variables.

The port has the knobs of its models: SAVE_ACTS and SAVE_MLP_WIDE
(``ops/fused_block``), and BLOCK at 'auto' or 'pallas' (its hand-written
kernels are the Pallas route's port).  The text tower runs the JAX
package's auto rules for packing, truncation and recompute
(``models/text``), so TEXT_PACK, TEXT_TRUNC and TEXT_RECOMPUTE take their
defaults only.  A value that needs a part the port does not have yet
raises ``NotImplementedError`` naming its ROADMAP.md item.
``perf_snapshot()`` reports the resolved live values.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


def _as_bool(v: Any) -> bool:
    return str(v).lower() not in ("0", "false", "no", "")


def _not_ported(knob: str, allowed: tuple, item: str):
    def setter(v):
        if str(v) not in allowed:
            raise NotImplementedError(
                f"PERF.{knob}={v!r}: the port takes {allowed} only; the rest waits "
                f"for ROADMAP.md {item}"
            )
    return setter


def _setters() -> dict:
    from mudpt_torch.ops import fused_block

    return {
        "BLOCK": _not_ported("BLOCK", ("auto", "pallas"), "A, 'the XLA block route'"),
        "SAVE_ACTS": lambda v: fused_block.set_save_acts(_as_bool(v)),
        "SAVE_MLP_WIDE": lambda v: fused_block.set_save_mlp_wide(str(v)),
        # the port's towers run a Python loop over layers: no scan to unroll
        "SCAN_UNROLL": _not_ported("SCAN_UNROLL", ("auto",), "A, 'the XLA block route'"),
        "REMAT": _not_ported("REMAT", ("none",), "A, 'REMAT full'"),
        "TEXT_PACK": _not_ported("TEXT_PACK", ("0",), "A, 'the text tower's switches'"),
        "TEXT_TRUNC": _not_ported("TEXT_TRUNC", ("auto",), "A, 'the text tower's switches'"),
        "TEXT_RECOMPUTE": _not_ported("TEXT_RECOMPUTE", ("auto",),
                                      "A, 'the text tower's switches'"),
        "LN": _not_ported("LN", ("fp32",), "A, 'the XLA block route'"),
    }


def apply_perf_config(perf) -> Dict[str, Any]:
    """Push the set fields of ``cfg.PERF`` into the policy modules; returns
    the post-application :func:`perf_snapshot`."""
    setters = _setters()
    touched = getattr(perf, "_touched", frozenset())
    for f in dataclasses.fields(perf):
        if f.name in touched or getattr(perf, f.name) != f.default:
            setters[f.name](getattr(perf, f.name))
    return perf_snapshot()


def perf_snapshot() -> Dict[str, Any]:
    """The live, resolved policy state: what this process executes."""
    from mudpt_torch.models import layers
    from mudpt_torch.ops import fused_block

    return {
        "BLOCK": "pallas",
        "QUANT": layers.quant_mode(),
        "SAVE_ACTS": fused_block.save_acts_enabled(),
        "SAVE_MLP_WIDE": fused_block._SAVE_MLP_WIDE,
    }
