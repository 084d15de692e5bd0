"""Convert reference-trained (PyTorch/Dassl) checkpoints to the port's
``.npz`` checkpoints (counterpart of ``tools/import_reference_checkpoint.py``).

The port loads a reference ``model.pth.tar-<E>`` torch pickle as it is
(``utils/checkpoint.load_checkpoint`` detects it); this tool writes the
``.npz`` once, for a reader that takes the native format only, e.g. the JAX
package on a machine without torch.

  python -m mudpt_torch.tools.import_reference_checkpoint --src <reference output dir> \\
      [--dst <converted output dir>] [--device cpu]

``--src`` may also name one ``model.pth.tar-<E>`` / ``model-<tag>.pth.tar``
file.  With no ``--dst`` the files are written under the same names in a
``converted/`` directory beside the originals, which stay untouched.  The
conversion runs on the host; ``--device`` follows the port's rule for entry
points (the card unless told otherwise: without CUDA pass ``--device cpu``).
"""

from __future__ import annotations

import argparse
import os
import re

_EPOCH = re.compile(r"^model\.pth\.tar-(\d+)$")
_TAG = re.compile(r"^model-([A-Za-z0-9_]+)\.pth\.tar$")


def convert_file(path: str, dst_root: str, name: str) -> str:
    """Convert one checkpoint file into ``<dst_root>/<name>/<same fname>``."""
    from mudpt_torch.models.import_reference import load_reference_checkpoint
    from mudpt_torch.utils.checkpoint import save_checkpoint

    fname = os.path.basename(path)
    m_epoch, m_tag = _EPOCH.match(fname), _TAG.match(fname)
    if not (m_epoch or m_tag):
        raise ValueError(f"{fname!r} does not match the Dassl checkpoint naming "
                         "(model.pth.tar-<epoch> or model-<tag>.pth.tar)")
    tree, meta = load_reference_checkpoint(path)
    epoch = int(m_epoch.group(1)) if m_epoch else int(meta.get("epoch", 0))
    return save_checkpoint(dst_root, name, epoch, tree, meta=meta,
                           tag=m_tag.group(1) if m_tag else None)


def main(argv=None) -> int:
    from mudpt_torch.models.import_reference import is_torch_checkpoint
    from mudpt_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(prog="python -m mudpt_torch.tools.import_reference_checkpoint",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help="reference output dir (or one .pth.tar file)")
    ap.add_argument("--dst", default="", help="output dir (default: <src>/converted)")
    ap.add_argument("--device", default=None, help="'cpu' without a card; default the card")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    if os.path.isfile(args.src):
        files = [args.src]
        src_root = os.path.dirname(os.path.dirname(os.path.abspath(args.src)))
    else:
        src_root = os.path.abspath(args.src)
        files = [os.path.join(dirpath, f) for dirpath, _, fnames in os.walk(src_root)
                 for f in fnames if _EPOCH.match(f) or _TAG.match(f)]
    dst_root = args.dst or os.path.join(src_root, "converted")

    converted = skipped = 0
    for path in sorted(files):
        if not is_torch_checkpoint(path):
            print(f"skip (already .npz): {path}")
            skipped += 1
            continue
        # the registered-model subdirectory (e.g. MultimodalDeepPromptTuning)
        name = os.path.basename(os.path.dirname(os.path.abspath(path)))
        out = convert_file(path, dst_root, name)
        print(f"converted: {path} -> {out}")
        converted += 1
    if not files:
        print(f"no model.pth.tar-* / model-*.pth.tar files under {args.src}")
        return 1
    print(f"done: {converted} converted, {skipped} already native")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
