"""Apply the PERF config namespace to the port's kernel-policy module state
(counterpart of ``mudpt_tpu/config/perf.py:37-89``).

The knobs live as module globals so that library use without a Config
still works; this module is where the typed config meets that state.
Precedence per knob: module default < programmatic setter < explicit
config value.  A PERF field left unset does not touch the module state, so
tests and tools that call the setters directly keep working; a field that
a YAML file or an opt wrote, even at its default, calls the setter.  The
port reads no ``MUDPT_TPU_<FIELD>`` environment variables.

Every knob of the JAX package: BLOCK, LN (``models/layers``), SAVE_ACTS
and SAVE_MLP_WIDE (``ops/fused_block``), SCAN_UNROLL and REMAT
(``models/transformer``), and the text tower's TEXT_PACK, TEXT_TRUNC and
TEXT_RECOMPUTE (``models/text``).  TEXT_TRUNC shapes the class-prompt
bank, which a trainer builds after this runs (``TrainerBase.__init__``).
A tool that would set a ``MUDPT_TPU_*`` variable of the JAX package takes
a flag instead.  ``perf_snapshot()`` reports the resolved live values.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


def _as_bool(v: Any) -> bool:
    return str(v).lower() not in ("0", "false", "no", "")


def _setters() -> dict:
    from mudpt_torch.models import layers, text, transformer
    from mudpt_torch.ops import fused_block

    return {
        "BLOCK": lambda v: layers.set_block_impl(str(v)),
        "SAVE_ACTS": lambda v: fused_block.set_save_acts(_as_bool(v)),
        "SAVE_MLP_WIDE": lambda v: fused_block.set_save_mlp_wide(str(v)),
        "SCAN_UNROLL": lambda v: transformer.set_scan_unroll(v),
        "REMAT": lambda v: transformer.set_remat_mode(str(v)),
        "TEXT_PACK": lambda v: text.set_text_pack(int(v)),
        "TEXT_TRUNC": lambda v: text.set_text_truncate(str(v) != "0"),
        "TEXT_RECOMPUTE": lambda v: text.set_text_recompute(v),
        "LN": lambda v: layers.set_ln_dtype(str(v)),
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
    """The live, resolved policy state: what this process executes
    (``perf.py:87-107``)."""
    from mudpt_torch.models import layers, text, transformer
    from mudpt_torch.ops import fused_block

    return {
        "BLOCK": layers.block_impl(),
        "BLOCK_RESOLVED": layers.resolve_block_impl(),
        "QUANT": layers.quant_mode(),
        "SAVE_ACTS": fused_block.save_acts_enabled(),
        "SAVE_MLP_WIDE": fused_block._SAVE_MLP_WIDE,
        "SCAN_UNROLL": transformer._SCAN_UNROLL,
        "REMAT": transformer.remat_mode(),
        "TEXT_PACK": text.text_pack(),
        "TEXT_TRUNC": text.text_truncate(),
        "TEXT_RECOMPUTE": text.text_recompute(),
        "LN": layers.ln_dtype(),
    }
