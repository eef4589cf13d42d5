"""Strong augmentation library (host-side, PIL/numpy).

Ports the semantics of reference datasets/sltransform.py:14-246
(AdjustContrast/AdjustBrightness, PCA LightingNoise, box-aware Rotate,
box-keeping RandomCrop, RandomSelectMulti) and datasets/random_crop.py:49-134
(SSD-style IoU-constrained random crop).  These are library augs: the active
reference configs train with the plain pipeline (hflip + multiscale resize /
resize-crop-resize), so none of these are in TrainTransform by default.

The port's own copy of the JAX package's data/strong_aug.py.  Every transform
draws from the generator it is given (a random.Random, or for LightingNoise
and IoUCrop a numpy RandomState), seeded 0 when none is given, never from the
modules' global generators: equal seeds give the JAX package's outputs.
"""
from __future__ import annotations

import math
import random
from typing import List, Optional, Sequence

import numpy as np
from PIL import Image, ImageEnhance

from .transforms import Sample, crop


class AdjustContrast:
    def __init__(self, contrast_factor: float = 0.5, rng: Optional[random.Random] = None):
        self.factor = contrast_factor
        self.rng = rng or random.Random(0)

    def __call__(self, s: Sample) -> Sample:
        f = 1.0 + self.rng.uniform(-self.factor, self.factor)
        img = ImageEnhance.Contrast(s.image).enhance(f)
        return Sample(img, s.boxes, s.labels, s.image_id, s.orig_size,
                      s.caption, s.cap_list)


class AdjustBrightness:
    def __init__(self, brightness_factor: float = 0.5, rng=None):
        self.factor = brightness_factor
        self.rng = rng or random.Random(0)

    def __call__(self, s: Sample) -> Sample:
        f = 1.0 + self.rng.uniform(-self.factor, self.factor)
        img = ImageEnhance.Brightness(s.image).enhance(f)
        return Sample(img, s.boxes, s.labels, s.image_id, s.orig_size,
                      s.caption, s.cap_list)


class LightingNoise:
    """PCA color noise (AlexNet-style) with ImageNet eigen-decomposition."""

    _EIGVAL = np.asarray([0.2175, 0.0188, 0.0045], np.float32)
    _EIGVEC = np.asarray(
        [[-0.5675, 0.7192, 0.4009],
         [-0.5808, -0.0045, -0.8140],
         [-0.5836, -0.6948, 0.4203]], np.float32
    )

    def __init__(self, alphastd: float = 0.1, rng=None):
        self.alphastd = alphastd
        self.rng = rng or np.random.RandomState(0)

    def __call__(self, s: Sample) -> Sample:
        alpha = self.rng.randn(3).astype(np.float32) * self.alphastd
        delta = (self._EIGVEC * alpha * self._EIGVAL).sum(axis=1) * 255.0
        arr = np.asarray(s.image, np.float32) + delta[None, None, :]
        img = Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))
        return Sample(img, s.boxes, s.labels, s.image_id, s.orig_size,
                      s.caption, s.cap_list)


class Rotate:
    """Rotate by one of `angles`, expanding the canvas; boxes become the
    axis-aligned hulls of the rotated corners (reference sltransform Rotate)."""

    def __init__(self, angles: Sequence[float] = (-10, -5, 5, 10), rng=None):
        self.angles = list(angles)
        self.rng = rng or random.Random(0)

    def __call__(self, s: Sample) -> Sample:
        angle = self.rng.choice(self.angles)
        w, h = s.image.size
        img = s.image.rotate(angle, expand=True, resample=Image.BILINEAR)
        nw, nh = img.size
        theta = math.radians(-angle)  # PIL rotates counter-clockwise
        cos, sin = math.cos(theta), math.sin(theta)
        cx, cy = w / 2, h / 2
        ncx, ncy = nw / 2, nh / 2
        if len(s.boxes):
            corners = np.stack(
                [
                    s.boxes[:, [0, 1]], s.boxes[:, [2, 1]],
                    s.boxes[:, [0, 3]], s.boxes[:, [2, 3]],
                ],
                axis=1,
            )  # (N, 4, 2)
            rel = corners - np.asarray([cx, cy])
            rot = np.stack(
                [
                    rel[..., 0] * cos - rel[..., 1] * sin,
                    rel[..., 0] * sin + rel[..., 1] * cos,
                ],
                axis=-1,
            ) + np.asarray([ncx, ncy])
            boxes = np.concatenate([rot.min(1), rot.max(1)], axis=1).astype(np.float32)
            boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, nw)
            boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, nh)
        else:
            boxes = s.boxes
        return Sample(img, boxes, s.labels, s.image_id, s.orig_size,
                      s.caption, s.cap_list)


class RandomCropKeepBox:
    """Random crop retrying until at least one box survives
    (reference sltransform RandomCrop keeping >=1 box)."""

    def __init__(self, min_frac: float = 0.5, attempts: int = 10, rng=None):
        self.min_frac = min_frac
        self.attempts = attempts
        self.rng = rng or random.Random(0)

    def __call__(self, s: Sample) -> Sample:
        if len(s.boxes) == 0:
            return s
        w, h = s.image.size
        for _ in range(self.attempts):
            cw = int(w * self.rng.uniform(self.min_frac, 1.0))
            ch = int(h * self.rng.uniform(self.min_frac, 1.0))
            left = self.rng.randint(0, w - cw) if w > cw else 0
            top = self.rng.randint(0, h - ch) if h > ch else 0
            out = crop(s, (top, left, ch, cw))
            if len(out.boxes) > 0:
                return out
        return s


class IoUCrop:
    """SSD-style random crop constrained by minimum IoU with a kept box;
    boxes whose centers fall outside are dropped
    (reference datasets/random_crop.py:49-134)."""

    def __init__(self, min_ious=(0.1, 0.3, 0.5, 0.7, 0.9), attempts: int = 50, rng=None):
        self.sample_options = (None, *min_ious)
        self.attempts = attempts
        self.rng = rng or np.random.RandomState(0)

    def __call__(self, s: Sample) -> Sample:
        if len(s.boxes) == 0:
            return s
        w, h = s.image.size
        while True:
            mode = self.sample_options[self.rng.randint(len(self.sample_options))]
            if mode is None:
                return s
            for _ in range(self.attempts):
                cw = self.rng.uniform(0.3 * w, w)
                ch = self.rng.uniform(0.3 * h, h)
                if ch / cw < 0.5 or ch / cw > 2:
                    continue
                left = self.rng.uniform(0, w - cw)
                top = self.rng.uniform(0, h - ch)
                rect = np.asarray([left, top, left + cw, top + ch], np.float32)
                lt = np.maximum(s.boxes[:, :2], rect[:2])
                rb = np.minimum(s.boxes[:, 2:], rect[2:])
                wh = np.clip(rb - lt, 0, None)
                inter = wh[:, 0] * wh[:, 1]
                area_b = (s.boxes[:, 2] - s.boxes[:, 0]) * (s.boxes[:, 3] - s.boxes[:, 1])
                area_r = cw * ch
                iou = inter / np.maximum(area_b + area_r - inter, 1e-12)
                if iou.max() < mode:
                    continue
                centers = (s.boxes[:, :2] + s.boxes[:, 2:]) / 2
                keep = (
                    (centers[:, 0] > rect[0]) & (centers[:, 0] < rect[2])
                    & (centers[:, 1] > rect[1]) & (centers[:, 1] < rect[3])
                )
                if not keep.any():
                    continue
                out = crop(
                    Sample(s.image, s.boxes[keep], s.labels[keep], s.image_id,
                           s.orig_size, s.caption, s.cap_list),
                    (int(top), int(left), int(ch), int(cw)),
                )
                if len(out.boxes):
                    return out


class RandomSelectMulti:
    """Apply one randomly chosen transform (reference RandomSelectMulti)."""

    def __init__(self, transforms: List, rng=None):
        self.transforms = transforms
        self.rng = rng or random.Random(0)

    def __call__(self, s: Sample) -> Sample:
        return self.rng.choice(self.transforms)(s)
