"""Image preprocessing matching CLIP's torchvision pipeline.

Test-time: bicubic resize of the short side to SIZE, center crop, scale to
[0,1], normalize with the CLIP mean/std (reference clip/clip.py:80-87).
Train-time: random resized crop (scale 0.08-1.0, ratio 3/4-4/3 — the
torchvision defaults Dassl uses), random horizontal flip p=0.5, normalize
(reference configs INPUT.TRANSFORMS, e.g.
configs/trainers/MuDPT/vit_b16_bz4_ep10_nctx2_depth9.yaml:13).

Implemented on PIL + numpy; returns float32 HWC arrays ready to batch.
A copy of ``mudpt_tpu/data/transforms.py``.
"""

from __future__ import annotations

import math
import random
from typing import Sequence, Tuple

import numpy as np
from PIL import Image

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

_INTERP = {
    "bicubic": Image.BICUBIC,
    "bilinear": Image.BILINEAR,
    "nearest": Image.NEAREST,
}


def _normalize(arr: np.ndarray, mean, std) -> np.ndarray:
    return (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def load_image(path: str) -> Image.Image:
    img = Image.open(path)
    return img.convert("RGB")


class EvalTransform:
    def __init__(self, size: int = 224, interpolation: str = "bicubic",
                 mean=CLIP_MEAN, std=CLIP_STD):
        self.size = size
        self.interp = _INTERP[interpolation]
        self.mean, self.std = mean, std

    def apply_array(self, arr: np.ndarray, rng=None) -> np.ndarray:
        """Normalize a pre-decoded [0,1] HWC array (synthetic datasets)."""
        return _normalize(np.asarray(arr, np.float32), self.mean, self.std)

    def __call__(self, img: Image.Image) -> np.ndarray:
        # Geometry replicates torchvision exactly (the reference preprocesses
        # with torchvision's PIL backend, clip/clip.py:80-87): Resize(int)
        # maps the short side to `size` and the long side to
        # int(size * long / short) — truncation, not rounding — and skips the
        # resample entirely when the short side already equals `size`;
        # CenterCrop picks the origin with int(round(delta / 2)) (Python
        # round, half-to-even).  Off-by-one geometry shifts every pixel, so
        # these details are part of the accuracy-parity surface.
        w, h = img.size
        if min(w, h) != self.size:
            if w < h:
                nw, nh = self.size, int(self.size * h / w)
            else:
                nw, nh = int(self.size * w / h), self.size
            img = img.resize((nw, nh), self.interp)
        else:
            nw, nh = w, h
        left = int(round((nw - self.size) / 2.0))
        top = int(round((nh - self.size) / 2.0))
        img = img.crop((left, top, left + self.size, top + self.size))
        arr = np.asarray(img, np.float32) / 255.0
        return _normalize(arr, self.mean, self.std)


class TrainTransform:
    def __init__(
        self,
        size: int = 224,
        interpolation: str = "bicubic",
        mean=CLIP_MEAN,
        std=CLIP_STD,
        scale: Tuple[float, float] = (0.08, 1.0),
        ratio: Tuple[float, float] = (3 / 4, 4 / 3),
        transforms: Sequence[str] = ("random_resized_crop", "random_flip", "normalize"),
    ):
        self.size = size
        self.interp = _INTERP[interpolation]
        self.mean, self.std = mean, std
        self.scale, self.ratio = scale, ratio
        self.ops = tuple(transforms)
        self._fallback = EvalTransform(size, interpolation, mean, std)

    def _random_resized_crop(self, img: Image.Image, rng) -> Image.Image:
        w, h = img.size
        area = w * h
        for _ in range(10):
            target_area = area * rng.uniform(*self.scale)
            log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
            aspect = math.exp(rng.uniform(*log_ratio))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                left = rng.randint(0, w - cw)
                top = rng.randint(0, h - ch)
                return img.resize(
                    (self.size, self.size),
                    self.interp,
                    box=(left, top, left + cw, top + ch),
                )
        # fallback: center crop at the constrained aspect (torchvision rule)
        in_ratio = w / h
        if in_ratio < self.ratio[0]:
            cw, ch = w, int(round(w / self.ratio[0]))
        elif in_ratio > self.ratio[1]:
            cw, ch = int(round(h * self.ratio[1])), h
        else:
            cw, ch = w, h
        left, top = (w - cw) // 2, (h - ch) // 2
        return img.resize(
            (self.size, self.size), self.interp, box=(left, top, left + cw, top + ch)
        )

    def apply_array(self, arr: np.ndarray, rng=random) -> np.ndarray:
        """Normalize + random flip for pre-decoded [0,1] HWC arrays."""
        arr = np.asarray(arr, np.float32)
        if "random_flip" in self.ops and rng.random() < 0.5:
            arr = arr[:, ::-1]
        if "normalize" in self.ops:
            arr = _normalize(arr, self.mean, self.std)
        return arr

    def __call__(self, img: Image.Image, rng=random) -> np.ndarray:
        """``rng``: a random.Random (or the module) — the loader passes a
        per-item seeded instance so augmentation is deterministic regardless
        of worker-thread interleaving."""
        if "random_resized_crop" in self.ops:
            img = self._random_resized_crop(img, rng)
        else:
            return self._fallback(img)
        if "random_flip" in self.ops and rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        arr = np.asarray(img, np.float32) / 255.0
        if "normalize" in self.ops:
            arr = _normalize(arr, self.mean, self.std)
        return arr


def build_transform(cfg, is_train: bool):
    size = cfg.INPUT.SIZE[0]
    if is_train:
        return TrainTransform(
            size=size,
            interpolation=cfg.INPUT.INTERPOLATION,
            mean=cfg.INPUT.PIXEL_MEAN,
            std=cfg.INPUT.PIXEL_STD,
            transforms=cfg.INPUT.TRANSFORMS,
        )
    return EvalTransform(
        size=size,
        interpolation=cfg.INPUT.INTERPOLATION,
        mean=cfg.INPUT.PIXEL_MEAN,
        std=cfg.INPUT.PIXEL_STD,
    )
