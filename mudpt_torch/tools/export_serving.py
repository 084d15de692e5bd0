"""Export a trained (or zero-shot) classifier as a serving artifact
(counterpart of ``tools/export_serving.py``).

Builds the trainer as ``python -m mudpt_torch.train`` does (the same config
cascade), optionally loads a trained checkpoint, then writes a
``torch.export`` artifact that loads without the port's model code
(``mudpt_torch/serving.py``):

  python -m mudpt_torch.tools.export_serving --trainer MuDPT \\
      --dataset_config configs/datasets/caltech101.yaml \\
      --dataset_root $DATA --model_dir output/... --load_epoch 10 \\
      --export_dir serving/caltech_mudpt [--batch N] [--platforms cpu cuda] \\
      [--block_impl xla|pallas|pallas_int8|pallas_int8_static] [--device cpu]

Without ``--device`` the trainer and the traced program are on the card
(raises without CUDA); ``--device cpu`` exports from the CPU.  Check the
artifact afterwards with ``python -m mudpt_torch.tools.predict``.
"""

from __future__ import annotations

import argparse

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset_root", type=str, default="")
    p.add_argument("--output_dir", type=str, default="")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--trainer_config", type=str, default="")
    p.add_argument("--dataset_config", type=str, default="")
    p.add_argument("--trainer", type=str, default="")
    p.add_argument("--backbone", type=str, default="")
    p.add_argument("--backbone_path", type=str, default="")
    p.add_argument("--model_dir", type=str, default="",
                   help="trained checkpoint dir (omit for untrained/zero-shot)")
    p.add_argument("--load_epoch", type=int, default=None)
    p.add_argument("--export_dir", type=str, required=True)
    p.add_argument("--batch", type=int, default=None,
                   help="pin the serving batch (default: symbolic batch; CoCoOp and "
                   "the kernel tiers need a pinned batch)")
    p.add_argument("--platforms", type=str, nargs="+", default=None)
    p.add_argument("--block_impl", choices=["xla", "pallas", "pallas_int8",
                                            "pallas_int8_static"], default="xla",
                   help="xla: PyTorch ops, any batch, CPU or card. pallas: the "
                   "hand-written kernel chains (card, pinned batch). pallas_int8: "
                   "the int8 chains with dynamic activation scales. "
                   "pallas_int8_static: the int8 chains with static scales "
                   "calibrated on --calib_images images of the training split")
    p.add_argument("--calib_images", type=int, default=64,
                   help="pallas_int8_static: training-split images to calibrate on")
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' for the plain versions; default the card")
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    if args.opts and args.opts[0] == "--":
        args.opts = args.opts[1:]
    return args


def main(args) -> None:
    from mudpt_torch.serving import export_trainer
    from mudpt_torch.train import setup_config
    from mudpt_torch.trainers import build_trainer
    from mudpt_torch.utils.rng import set_seed

    cfg = setup_config(args)
    if cfg.SEED >= 0:
        set_seed(cfg.SEED)
    trainer = build_trainer(cfg, devices=args.device)
    if args.model_dir:
        trainer.load_model(args.model_dir, epoch=args.load_epoch)
    calib = None
    if args.block_impl == "pallas_int8_static" and cfg.TRAIN.QUANT in (
            "int8_static", "int8_ste_static"):
        # the build (and a load's recalibration) attached calibrated scales
        # to the frozen towers: the export reuses them
        print("Reusing the trainer's calibrated static int8 scales")
    elif args.block_impl == "pallas_int8_static":
        rows, have = [], 0
        for batch in trainer.dm.train_loader:
            rows.append(np.asarray(batch["image"], np.float32))
            have += rows[-1].shape[0]
            if have >= args.calib_images:
                break
        calib = np.concatenate(rows)[: args.calib_images]
        print(f"Calibrating static int8 scales on {len(calib)} images")
    export_trainer(args.export_dir, trainer, batch=args.batch,
                   platforms=tuple(args.platforms) if args.platforms else None,
                   block_impl=args.block_impl, calib_images=calib)
    print(f"Exported {cfg.TRAINER.NAME} serving artifact -> {args.export_dir}")


if __name__ == "__main__":
    main(parse_args())
