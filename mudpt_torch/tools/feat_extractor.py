"""Frozen CLIP image-feature extractor (counterpart of
``lpclip/feat_extractor.py``).

Runs the vision tower (``models/clip.encode_image`` on the kernel route) over
one split with the test transform and saves
``<output_dir>/<DatasetName>/<split>.npz`` holding ``feature_list`` (N,
embed_dim) fp32 and ``label_list`` (N,), the file ``lpclip/linear_probe.py``
reads (it takes either package's files; it needs ``sklearn``, which this
tool does not).

  python -m mudpt_torch.tools.feat_extractor --root DATA --output_dir clip_feat \\
      --dataset_config_file configs/datasets/caltech101.yaml --split train \\
      --backbone_path x.pt [--backbone_name ViT-B/16 --backbone_path random] \\
      [--dtype fp32|bf16] [--device cpu] [KEY VALUE ...]

``--dtype bf16`` casts the matmul weights (``cast_matmul_weights``) and
computes in bf16, as the serving path does; the features are saved in fp32.
Without ``--device`` it runs on the card and raises when CUDA is absent.
The throughput line counts the images whose features have reached the host,
from the first batch's collection on (that batch carries the first
launches).  ``main`` returns the run's record, also printed as the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def parse_args(argv=None):
    parser = argparse.ArgumentParser(prog="python -m mudpt_torch.tools.feat_extractor",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=str, default="")
    parser.add_argument("--output_dir", type=str, default="clip_feat")
    parser.add_argument("--config_file", type=str, default="")
    parser.add_argument("--dataset_config_file", type=str, default="")
    parser.add_argument("--split", type=str, required=True, choices=["train", "val", "test"])
    parser.add_argument("--backbone_name", type=str, default="")
    parser.add_argument("--backbone_path", type=str, default="",
                        help="a local CLIP .pt / .npz, or 'random' (seeded) for "
                             "--backbone_name's architecture")
    parser.add_argument("--dtype", choices=["fp32", "bf16"], default="fp32",
                        help="bf16: cast the matmul weights and compute as the serving "
                             "path does (features saved fp32)")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--device", type=str, default=None,
                        help="'cpu' for the plain versions; default the card")
    parser.add_argument("opts", default=[], nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def setup_config(args):
    """The JAX script's cascade: defaults -> dataset yaml -> config yaml ->
    flags -> opts, with the full splits (``NUM_SHOTS -1``)."""
    from mudpt_torch.config import default_config, merge_from_file, merge_from_list

    cfg = default_config()
    if args.dataset_config_file:
        merge_from_file(cfg, args.dataset_config_file)
    if args.config_file:
        merge_from_file(cfg, args.config_file)
    if args.root:
        cfg.DATASET.ROOT = args.root
    cfg.SEED = args.seed
    cfg.DATASET.NUM_SHOTS = -1  # full splits: sampling happens in the probe
    if args.backbone_name:
        cfg.MODEL.BACKBONE.NAME = args.backbone_name
    if args.backbone_path:
        cfg.MODEL.BACKBONE.PATH = args.backbone_path
    merge_from_list(cfg, args.opts)
    return cfg


def split_items(cfg, split: str) -> list:
    """The split's items in the order the tool reads them (the dataset built
    after ``set_seed(cfg.SEED)``)."""
    from mudpt_torch.data.manager import _import_datasets
    from mudpt_torch.utils.registry import DATASET_REGISTRY
    from mudpt_torch.utils.rng import set_seed

    _import_datasets()
    set_seed(cfg.SEED)
    dataset = DATASET_REGISTRY.get(cfg.DATASET.NAME).build(cfg)
    return {"train": dataset.train_x, "val": dataset.val, "test": dataset.test}[split]


def split_loader(cfg, items):
    """The test transform over ``items`` in order, batches of
    ``DATALOADER.TRAIN_X.BATCH_SIZE`` (the last zero-padded, ``valid``
    marking its rows)."""
    from mudpt_torch.data.loader import DataLoader
    from mudpt_torch.data.transforms import build_transform

    return DataLoader(items, build_transform(cfg, is_train=False),
                      cfg.DATALOADER.TRAIN_X.BATCH_SIZE, num_workers=cfg.DATALOADER.NUM_WORKERS)


def extract(params: dict, clip_cfg, loader, compute_dtype, device) -> tuple:
    """(features (N, embed_dim) fp32, labels (N,), images timed, seconds):
    each batch's features are copied to the host while the next batch
    encodes; the timed images are those collected after the first batch."""
    import numpy as np
    import torch

    from mudpt_torch.models.clip import encode_image

    on_card = device.type == "cuda"
    features, labels = [], []
    pending = None  # (host features, copy-done event, valid, labels)
    t0, n_done = None, 0

    def collect(p):
        nonlocal t0, n_done
        host, done, valid, lab = p
        if done is not None:
            done.synchronize()
        features.append(host.numpy()[valid])
        labels.append(lab[valid])
        if t0 is None:
            t0 = time.perf_counter()  # the first batch is in
        else:
            n_done += int(valid.sum())

    with torch.no_grad():
        for batch in loader:
            images = torch.from_numpy(batch["image"]).to(compute_dtype)
            if on_card:
                images = images.pin_memory().to(device, non_blocking=True)
            feats = encode_image(params, images, clip_cfg, compute_dtype=compute_dtype).float()
            done = None
            if on_card:
                host = torch.empty(feats.shape, dtype=torch.float32, pin_memory=True)
                host.copy_(feats, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                host = feats
            if pending is not None:
                collect(pending)
            pending = (host, done, batch["valid"], batch["label"])
        if pending is not None:
            collect(pending)
    seconds = time.perf_counter() - t0 if t0 is not None else 0.0
    return np.concatenate(features), np.concatenate(labels), n_done, seconds


def main(argv=None) -> dict:
    import numpy as np
    import torch

    from mudpt_torch.models.clip import cast_matmul_weights
    from mudpt_torch.trainers.base import load_backbone
    from mudpt_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = setup_config(args)

    print(f"Setup dataset: {cfg.DATASET.NAME}")
    items = split_items(cfg, args.split)
    print(f"Load CLIP backbone: {cfg.MODEL.BACKBONE.NAME}")
    clip_cfg, params = load_backbone(cfg, device)
    compute_dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    if args.dtype == "bf16":
        # the serving precision (the reference extracts with the fp16 model
        # clip.load returns); features come back fp32
        params = cast_matmul_weights(params, torch.bfloat16)

    features, labels, n_done, seconds = extract(params, clip_cfg, split_loader(cfg, items),
                                                compute_dtype, device)
    rate = n_done / seconds if seconds > 0 else None
    if n_done:
        print(f"Extraction throughput: {rate:.1f} img/s ({n_done} imgs collected after the "
              f"first batch, {seconds:.2f}s, dtype={args.dtype})")

    save_dir = os.path.join(args.output_dir, cfg.DATASET.NAME)
    os.makedirs(save_dir, exist_ok=True)
    out = os.path.join(save_dir, args.split)
    np.savez(out, feature_list=features, label_list=labels)
    print(f"Saved {len(labels)} features to {out}.npz")
    record = {"path": out + ".npz", "split": args.split, "dtype": args.dtype,
              "device": device.type, "n_images": int(len(labels)), "timed_images": n_done,
              "seconds": seconds, "img_per_sec": rate}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
