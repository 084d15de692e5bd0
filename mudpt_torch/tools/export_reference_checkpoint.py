"""Export the port's checkpoints as reference-format (PyTorch/Dassl)
checkpoints, so prompts trained here can be validated or served in the
reference stack (counterpart of ``tools/export_reference_checkpoint.py``, the
inverse of ``import_reference_checkpoint``).

  python -m mudpt_torch.tools.export_reference_checkpoint --src <output dir> \\
      [--dst <exported dir>] [--device cpu]

``--src`` may also name one ``model.pth.tar-<E>`` / ``model-<tag>.pth.tar``
``.npz`` file.  The exported files keep the Dassl names (default under
``<src>/exported``), so the reference's ``--model-dir`` / ``load_model`` take
the directory as it is.  Each file's family is its checkpoint's
``meta["trainer"]`` (``models/export_reference.py``).  The export runs on
the host; ``--device`` follows the port's rule for entry points (the card
unless told otherwise: without CUDA pass ``--device cpu``).
"""

from __future__ import annotations

import argparse
import os
import re

_NAME = re.compile(r"^model(\.pth\.tar-(\d+)|-[A-Za-z0-9_]+\.pth\.tar)$")


def main(argv=None) -> int:
    from mudpt_torch.models.export_reference import save_reference_checkpoint
    from mudpt_torch.models.import_reference import is_torch_checkpoint
    from mudpt_torch.utils.checkpoint import load_checkpoint
    from mudpt_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(prog="python -m mudpt_torch.tools.export_reference_checkpoint",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help="the port's output dir (or one checkpoint)")
    ap.add_argument("--dst", default="", help="output dir (default: <src>/exported)")
    ap.add_argument("--device", default=None, help="'cpu' without a card; default the card")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    if os.path.isfile(args.src):
        files = [os.path.abspath(args.src)]
        src_root = os.path.dirname(os.path.dirname(files[0]))
    else:
        src_root = os.path.abspath(args.src)
        files = [os.path.join(dirpath, f) for dirpath, _, fnames in os.walk(src_root)
                 for f in fnames if _NAME.match(f)]
    dst_root = args.dst or os.path.join(src_root, "exported")

    exported = skipped = 0
    for path in sorted(files):
        if is_torch_checkpoint(path):
            print(f"skip (already torch): {path}")
            skipped += 1
            continue
        name = os.path.basename(os.path.dirname(path))
        fname = os.path.basename(path)
        m = _NAME.match(fname)
        epoch = int(m.group(2)) if m.group(2) else 0
        tree, _, meta = load_checkpoint(
            os.path.dirname(os.path.dirname(path)), name,
            epoch=epoch if m.group(2) else None,
            tag=None if m.group(2) else fname[len("model-"):-len(".pth.tar")],
        )
        outdir = os.path.join(dst_root, name)
        os.makedirs(outdir, exist_ok=True)
        out = save_reference_checkpoint(os.path.join(outdir, fname), tree,
                                        epoch=int(meta.get("epoch", epoch)),
                                        trainer=meta.get("trainer"))
        print(f"exported: {path} -> {out}")
        exported += 1
    if not files:
        print(f"no model.pth.tar-* / model-*.pth.tar files under {args.src}")
        return 1
    print(f"done: {exported} exported, {skipped} already torch")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
