"""Training and evaluation CLI of the port, ``train.py``'s surface
(reference train.py:176-196) with a ``--device`` flag:

  python -m mudpt_torch.train --dataset_root D --output_dir O --seed S \
      --trainer CoOp --trainer_config configs/trainers/CoOp/vit_b16_ep50.yaml \
      --dataset_config configs/datasets/synthetic.yaml \
      [--eval_only --model_dir M --load_epoch E] [--no_train] [--device cpu] \
      [KEY VALUE ...]

Without ``--device`` the run takes the card and raises when CUDA is absent;
``--device cpu`` runs the kernels' plain versions.  The config cascade is
``train.py``'s (reference train.py:136-150): code defaults -> dataset yaml
-> trainer yaml -> CLI flags -> trailing KEY VALUE opts.

Across devices, one process a device (the mesh of ``PARALLEL.DATA`` x
``PARALLEL.MODEL``, ``parallel/mesh.py``):

  torchrun --nproc_per_node N -m mudpt_torch.train ... PARALLEL.MODEL 2

Each rank joins the process group first (NCCL; gloo with ``--device
cpu``) and takes the card ``cuda:LOCAL_RANK`` unless ``--device`` names one.
"""

from __future__ import annotations

import argparse

import torch

from mudpt_torch.config import default_config, merge_from_file, merge_from_list
from mudpt_torch.parallel.multihost import (default_backend, local_rank,
                                            maybe_initialize_distributed)
from mudpt_torch.utils.logging import setup_logger
from mudpt_torch.utils.rng import set_seed


def print_args(args, cfg) -> None:
    print("***************")
    print("** Arguments **")
    print("***************")
    for key in sorted(vars(args)):
        print(f"{key}: {getattr(args, key)}")
    print("************")
    print("** Config **")
    print("************")
    print(cfg)


def setup_config(args):
    """The cascade of ``train.py:36-55``."""
    cfg = default_config()
    if args.dataset_config:
        merge_from_file(cfg, args.dataset_config)
    if args.trainer_config:
        merge_from_file(cfg, args.trainer_config)
    if args.dataset_root:
        cfg.DATASET.ROOT = args.dataset_root
    if args.output_dir:
        cfg.OUTPUT_DIR = args.output_dir
    if args.seed:
        cfg.SEED = args.seed
    if args.trainer:
        cfg.TRAINER.NAME = args.trainer
    if args.backbone:
        cfg.MODEL.BACKBONE.NAME = args.backbone
    if args.backbone_path:
        cfg.MODEL.BACKBONE.PATH = args.backbone_path
    merge_from_list(cfg, args.opts)
    return cfg


def rank_device(device):
    """The rank's device: ``device`` when named, else under a process group
    the card ``cuda:LOCAL_RANK`` (made current: the kernels launch on the
    current device's stream), else None, the card."""
    if device is None and torch.distributed.is_initialized():
        device = f"cuda:{local_rank()}"
    if device is not None and torch.device(device).type == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(torch.device(device))
    return device


def main(args):
    """Join the launcher's process group, if any (before anything else, as
    ``train.py:87-89``), build the trainer, then train it (or with
    ``--eval_only`` load and test it); returns the trainer."""
    maybe_initialize_distributed(default_backend(args.device))
    device = rank_device(args.device)
    cfg = setup_config(args)
    if cfg.SEED >= 0:
        print(f"Setting fixed seed: {cfg.SEED}")
        set_seed(cfg.SEED)
    setup_logger(cfg.OUTPUT_DIR)
    if torch.distributed.is_initialized():
        print(f"process group: backend {torch.distributed.get_backend()}, rank "
              f"{torch.distributed.get_rank()} of {torch.distributed.get_world_size()}, "
              f"device {device}")
    print_args(args, cfg)

    from mudpt_torch.trainers import build_trainer

    trainer = build_trainer(cfg, devices=device)
    if args.eval_only:
        trainer.load_model(args.model_dir, epoch=args.load_epoch)
        trainer.test()
        return trainer
    if not args.no_train:
        trainer.train()
    return trainer


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--dataset_root", type=str, default="", help="path to dataset")
    parser.add_argument("--output_dir", type=str, default="", help="output directory")
    parser.add_argument("--seed", type=int, default=1, help="fixed seed (>=0)")
    parser.add_argument("--trainer_config", type=str, default="", help="trainer yaml")
    parser.add_argument("--dataset_config", type=str, default="", help="dataset yaml")
    parser.add_argument("--trainer", type=str, default="", help="trainer name")
    parser.add_argument("--backbone", type=str, default="", help="CLIP backbone name")
    parser.add_argument("--backbone_path", type=str, default="",
                        help="local CLIP checkpoint (.pt/.npz), or 'random'")
    parser.add_argument("--eval_only", action="store_true")
    parser.add_argument("--model_dir", type=str, default="")
    parser.add_argument("--load_epoch", type=int, default=None)
    parser.add_argument("--no_train", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="'cpu' for the plain versions; default the card")
    # accepted for drop-in compatibility with reference launch scripts;
    # dead in the reference too (reference train.py:57-66 vs :193-194)
    parser.add_argument("--head", type=str, default="", help=argparse.SUPPRESS)
    parser.add_argument("--transforms", type=str, nargs="+", help=argparse.SUPPRESS)
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="KEY VALUE config overrides")
    args = parser.parse_args(argv)
    # a leading "--" separates nargs="+" flags (--transforms) from the
    # KEY VALUE overrides; REMAINDER keeps it
    if args.opts and args.opts[0] == "--":
        args.opts = args.opts[1:]
    return args


if __name__ == "__main__":
    try:
        main(parse_args())
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
