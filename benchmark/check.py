"""The numbers that decide ``correct``: the program's readings against the
plain reference's.  Each cell's limits file names the numbers it compares;
the others are read for the record (``benchmark/calibrate.py``).

Training (set-up's checked steps, one on each batch of the pool, driven
through the window's own step; the first gradient is the optimizer's, SGD's
momentum buffer after step 1):

* ``loss_gap``: the widest |program - reference| / |reference| of the
  checked steps' losses;
* ``grad_gap``, ``change_gap``: by the worst leaf, the gap between the
  program's norm of the first gradient (of the change over the checked
  steps) and the reference's, over the reference's norm of that leaf;
* ``grad_err``, ``change_err``: the same with the norm of the program's
  and the reference's difference over that norm.

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out (none is, at MuDPT's leaves; the rule is there for a
leaf whose gradient sits under a softmax's shift).

Serving (a seeded sample of the window's requests, the largest among them;
the program claims its fp32 logits and, for the served class, its best
logit, since the served answer says that class scored best: a logit error
where the answer is the program's argmax, at least the reference's margin
where it is not):

* ``logit_err``: the widest |claimed - reference| of a logit, over the
  reference logits' standard deviation over the sample;
* ``top1_gap``: the widest gap by which the served class's reference logit
  lies below the reference's best, over the reference logits' standard
  deviation.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import torch

LEAF_FLOOR = 1e-3


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep) -> float:
    return max(abs(prog[k] - ref[k]) / ref[k] for k in keep)


def _leaf_err(prog: dict, ref: dict, ref_norms: Dict[str, float], keep) -> float:
    return max(float((prog[k].double() - ref[k].double()).norm()) / ref_norms[k] for k in keep)


def train_numbers(prog_losses: List[float], prog_grad1: dict, prog_change: dict,
                  ref_losses: List[float], ref_grad1: dict, ref_change: dict) -> Dict[str, float]:
    g_ref, d_ref = _norms(ref_grad1), _norms(ref_change)
    med = statistics.median(g_ref.values())
    keep = [k for k, v in g_ref.items() if v >= LEAF_FLOOR * med]
    return {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog_losses, ref_losses)),
        "grad_gap": _leaf_gap(_norms(prog_grad1), g_ref, keep),
        "change_gap": _leaf_gap(_norms(prog_change), d_ref, keep),
        "grad_err": _leaf_err(prog_grad1, ref_grad1, g_ref, keep),
        "change_err": _leaf_err(prog_change, ref_change, d_ref, keep),
    }


def serve_numbers(pairs: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]) -> Dict[str, float]:
    """``pairs``: (program logits, served classes, reference logits) of each
    sampled request."""
    ref = torch.cat([r for _, _, r in pairs]).double()
    prog = torch.cat([p for p, _, _ in pairs]).double()
    served = torch.cat([s for _, s, _ in pairs]).long()[:, None]
    sd = float(ref.std())
    claimed = prog.scatter(1, served, prog.max(-1, keepdim=True).values)
    top1 = ref.max(-1).values - ref.gather(1, served)[:, 0]
    return {"logit_err": float((claimed - ref).abs().max()) / sd,
            "top1_gap": float(top1.max()) / sd}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(every number that has a limit at or under it, {name: {value,
    limit}} of those); no limit at all, or a number not finite, fails."""
    out, ok = {}, bool(limits)
    for k, lim in limits.items():
        v = numbers.get(k, math.nan)
        ok &= math.isfinite(v) and v <= lim
        out[k] = {"value": v, "limit": lim}
    return ok, out


def train_detail(prog: dict, ref: dict) -> dict:
    """Per step and per leaf, for looking at the numbers: the loss gaps, the
    leaves' norm gaps (as ``grad_gap`` and ``change_gap`` take them), the
    norms of the differences over the reference's norms (as ``grad_err`` and
    ``change_err``) and the reference's norms."""
    out = {"loss": [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]}
    for key in ("grad1", "change"):
        r, p = _norms(ref[key]), _norms(prog[key])
        out[key] = {k: abs(p[k] - r[k]) / r[k] for k in r}
        out[key + "_norm"] = r
        out[key + "_diff"] = {k: float((prog[key][k] - ref[key][k]).double().norm()) / r[k]
                              for k in r}
    return out
