"""Checkpoint IO for prompt pytrees + optimizer state.

Design (SURVEY.md §5 checkpoint/resume): only the *trainable* prompt pytree
and its optimizer state are persisted — the frozen backbone is
content-addressed by the CLIP checkpoint it was loaded from, and the
class-dependent token prefix/suffix buffers are intentionally NOT saved.
That reproduces the reference's transfer semantics (delete
``token_prefix``/``token_suffix`` on load, rebuild from the live dataset's
classnames — reference trainers/mudpt.py:293-303) by construction: at load
time the receiving trainer has already rebuilt those buffers for its own
class set, and the checkpoint only restores learned prompt weights.

Format: flat .npz keyed by '/'-joined tree paths + a JSON meta sidecar.
Filenames mirror Dassl's (``model.pth.tar-<epoch>``, ``model-best.pth.tar``
consumed at reference mudpt.py:278-283) so sweep scripts keep working.

This is ``mudpt_tpu/utils/checkpoint.py``'s format exactly, so a trainable
tree written by either package loads in the other.  The optimizer state is
a list of arrays (``opt/<i>``) in each package's own leaf order, so it
resumes only the package that wrote it.  Leaves may be numpy arrays or
tensors; loaded leaves are numpy arrays, grafted onto a tensor template by
:func:`restore_into`.  A reference-trained (Dassl ``torch.save``)
checkpoint under the same names loads too: :func:`load_checkpoint` detects
the torch pickle and imports its prompt weights through
``models/import_reference.py`` (``mudpt_tpu/utils/checkpoint.py:120-130``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def to_numpy(leaf) -> np.ndarray:
    """A tensor (any device, bf16 as fp32) or array leaf as a numpy array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}[{i}]/"))
    elif tree is None:
        out[prefix.rstrip("/") + "#none"] = np.zeros(0)
    else:
        out[prefix.rstrip("/")] = to_numpy(tree)
    return out


def save_checkpoint(
    directory: str,
    name: str,
    epoch: int,
    trainable,
    opt_state=None,
    is_best: bool = False,
    meta: Optional[Dict[str, Any]] = None,
    tag: Optional[str] = None,
) -> str:
    """Write ``<directory>/<name>/model.pth.tar-<epoch>`` (.npz content).

    ``tag`` writes ``model-<tag>.pth.tar`` instead (used for the
    ``preempt`` mid-epoch checkpoint, whose meta carries the 0-based
    in-progress epoch plus ``batches_done``/``global_step``)."""
    outdir = os.path.join(directory, name)
    os.makedirs(outdir, exist_ok=True)
    fname = f"model-{tag}.pth.tar" if tag else f"model.pth.tar-{epoch}"
    path = os.path.join(outdir, fname)

    flat = {f"trainable/{k}": v for k, v in _flatten(trainable).items()}
    if opt_state is not None:
        for i, leaf in enumerate(opt_state):
            flat[f"opt/{i}"] = to_numpy(leaf)
    # meta rides INSIDE the npz so the checkpoint is one atomic unit — a
    # SIGKILL during the preemption grace period must never leave a
    # weights/meta mismatch (the json sidecar is kept for humans/tools but
    # load prefers the npz copy)
    full_meta = {"epoch": epoch, **(meta or {})}
    for k, v in full_meta.items():
        flat[f"meta/{k}"] = np.asarray(v)
    # write-to-temp + atomic rename: a kill mid-write leaves the previous
    # checkpoint intact instead of a torn file
    with open(path + ".tmp", "wb") as f:
        np.savez(f, **flat)
    os.replace(path + ".tmp", path)
    with open(path + ".json.tmp", "w") as f:
        json.dump(full_meta, f)
    os.replace(path + ".json.tmp", path + ".json")
    if is_best:
        best = os.path.join(outdir, "model-best.pth.tar")
        for src, dst in ((path, best), (path + ".json", best + ".json")):
            with open(src, "rb") as fi, open(dst + ".tmp", "wb") as fo:
                fo.write(fi.read())
            os.replace(dst + ".tmp", dst)
    return path


def _unflatten(flat: Dict[str, np.ndarray]):
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        leaf = parts[-1]
        node[leaf] = None if leaf.endswith("#none") else v
    return tree


def load_checkpoint(
    directory: str, name: str, epoch: Optional[int] = None,
    tag: Optional[str] = None,
) -> Tuple[dict, Optional[list], Dict[str, Any]]:
    """Load trainable tree + raw opt leaves + meta.

    ``epoch=None`` loads ``model-best.pth.tar`` (reference mudpt.py:276-283);
    ``tag`` loads ``model-<tag>.pth.tar`` (e.g. the preemption checkpoint).
    """
    if tag:
        fname = f"model-{tag}.pth.tar"
    else:
        fname = "model-best.pth.tar" if epoch is None else f"model.pth.tar-{epoch}"
    path = os.path.join(directory, name, fname)
    if not os.path.exists(path):
        raise FileNotFoundError(f'Model not found at "{path}"')
    # a reference-trained (PyTorch/Dassl) checkpoint keeps the same directory
    # and filename contract: import it, so `--eval_only --model_dir <reference
    # output dir>` loads its prompts (no optimizer state)
    from mudpt_torch.models.import_reference import is_torch_checkpoint, load_reference_checkpoint

    if is_torch_checkpoint(path):
        tree, meta = load_reference_checkpoint(path)
        return tree, None, meta
    data = dict(np.load(path, allow_pickle=False))
    trainable = _unflatten(
        {k[len("trainable/"):]: v for k, v in data.items() if k.startswith("trainable/")}
    )
    opt_leaves = [
        v for _, v in sorted(
            ((int(k.split("/")[1]), v) for k, v in data.items() if k.startswith("opt/")),
        )
    ]
    meta = {}
    if os.path.exists(path + ".json"):
        try:
            with open(path + ".json") as f:
                meta = json.load(f)
        except ValueError:  # torn sidecar: the npz copy is authoritative
            meta = {}
    # npz-embedded meta wins over the sidecar (single atomic unit)
    for k, v in data.items():
        if k.startswith("meta/"):
            meta[k[len("meta/"):]] = v.item() if v.ndim == 0 else v.tolist()
    return trainable, (opt_leaves or None), meta


def restore_into(template, loaded: dict, *, strict: bool = False):
    """Graft loaded arrays onto a template tree of tensors (strict=False mirrors the
    reference's ``load_state_dict(strict=False)``): keys present in both are
    taken from the checkpoint; template-only keys are kept (e.g. rebuilt
    class buffers); checkpoint-only keys are ignored."""
    if isinstance(template, dict):
        out = {}
        for k, v in template.items():
            if isinstance(loaded, dict) and k in loaded:
                out[k] = restore_into(v, loaded[k], strict=strict)
            else:
                if strict:
                    raise KeyError(f"Missing checkpoint key {k!r}")
                out[k] = v
        return out
    if isinstance(template, (list, tuple)):
        # _flatten writes sequence entries as '[i]' keys, which _unflatten
        # rebuilds as a dict — graft them back positionally (without this,
        # tuple/list subtrees silently kept the template's values)
        out_seq = []
        for i, v in enumerate(template):
            key = f"[{i}]"
            if isinstance(loaded, dict) and key in loaded:
                out_seq.append(restore_into(v, loaded[key], strict=strict))
            else:
                if strict:
                    raise KeyError(f"Missing checkpoint key {key!r}")
                out_seq.append(v)
        if hasattr(template, "_fields"):  # NamedTuple: positional fields
            return type(template)(*out_seq)
        return type(template)(out_seq)
    if loaded is None or template is None:
        return template
    arr = np.asarray(loaded)
    if tuple(arr.shape) != tuple(template.shape):
        if strict:
            raise ValueError(
                f"Shape mismatch: checkpoint {arr.shape} vs template "
                f"{tuple(template.shape)}"
            )
        return template
    return torch.from_numpy(np.array(arr, copy=True)).to(
        device=template.device, dtype=template.dtype
    )
