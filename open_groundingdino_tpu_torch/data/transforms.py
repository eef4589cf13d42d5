"""Host-side image/box transforms (numpy + PIL): the port's own copy of the
JAX package's data/transforms.py.

Shortest-edge resize with max_size (PIL bilinear, the resampler torchvision
uses), horizontal flip, random size crop, ImageNet normalization, the final
boxes-to-normalized-cxcywh conversion (reference transforms.py:251-267), the
train and eval pipelines, and `Bucketer`, which pads an image up to a static
bucket from a fixed lattice (the JAX package's replacement for the
reference's NestedTensor dynamic padding, kept so both packages see the same
padded inputs).  The train pipeline draws from a `random.Random` exactly as
the JAX package's does, so one seed gives both packages the same samples.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


@dataclass
class Sample:
    """A host-side sample; boxes are xyxy absolute pixels."""

    image: Image.Image
    boxes: np.ndarray          # (N, 4) xyxy absolute
    labels: np.ndarray         # (N,) int
    image_id: int = -1
    orig_size: Tuple[int, int] = (0, 0)  # (h, w)
    caption: str = ""
    cap_list: Optional[List[str]] = None


def get_size_with_aspect_ratio(
    image_size: Tuple[int, int], size: int, max_size: Optional[int] = None
) -> Tuple[int, int]:
    """(w, h) -> output (h, w), shortest-edge semantics of reference
    transforms.py:100-118."""
    w, h = image_size
    if max_size is not None:
        min_orig = float(min(w, h))
        max_orig = float(max(w, h))
        if max_orig / min_orig * size > max_size:
            size = int(round(max_size * min_orig / max_orig))
    if (w <= h and w == size) or (h <= w and h == size):
        return (h, w)
    if w < h:
        ow = size
        oh = int(size * h / w)
    else:
        oh = size
        ow = int(size * w / h)
    return (oh, ow)


def resize(sample: Sample, size: int, max_size: Optional[int] = None) -> Sample:
    oh, ow = get_size_with_aspect_ratio(sample.image.size, size, max_size)
    w, h = sample.image.size
    img = sample.image.resize((ow, oh), Image.BILINEAR)
    sx, sy = ow / w, oh / h
    boxes = sample.boxes * np.asarray([sx, sy, sx, sy], np.float32)
    return Sample(img, boxes, sample.labels, sample.image_id, sample.orig_size,
                  sample.caption, sample.cap_list)


def hflip(sample: Sample) -> Sample:
    img = sample.image.transpose(Image.FLIP_LEFT_RIGHT)
    w = sample.image.size[0]
    b = sample.boxes.copy()
    b[:, [0, 2]] = w - sample.boxes[:, [2, 0]]
    return Sample(img, b, sample.labels, sample.image_id, sample.orig_size,
                  sample.caption, sample.cap_list)


def crop(sample: Sample, region: Tuple[int, int, int, int]) -> Sample:
    """region: (top, left, h, w).  Boxes clamped; empty boxes dropped
    (reference transforms.py:16-63 semantics for boxes)."""
    top, left, h, w = region
    img = sample.image.crop((left, top, left + w, top + h))
    b = sample.boxes - np.asarray([left, top, left, top], np.float32)
    b = np.minimum(b.reshape(-1, 2, 2), np.asarray([w, h], np.float32))
    b = np.clip(b, 0, None).reshape(-1, 4)
    keep = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
    return Sample(img, b[keep], sample.labels[keep], sample.image_id,
                  sample.orig_size, sample.caption, sample.cap_list)


def random_size_crop(sample: Sample, min_size: int, max_size: int, rng) -> Sample:
    w, h = sample.image.size
    cw = rng.randint(min_size, min(w, max_size))
    ch = rng.randint(min_size, min(h, max_size))
    if cw >= w and ch >= h:
        return sample
    top = rng.randint(0, max(h - ch, 0)) if h > ch else 0
    left = rng.randint(0, max(w - cw, 0)) if w > cw else 0
    return crop(sample, (top, left, min(ch, h), min(cw, w)))


def normalize_image(img: Image.Image) -> np.ndarray:
    arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def boxes_to_cxcywh_norm(boxes: np.ndarray, h: int, w: int) -> np.ndarray:
    """xyxy absolute -> cxcywh normalized by the unpadded size (reference
    transforms.py:251-267)."""
    if len(boxes) == 0:
        return boxes.reshape(0, 4)
    cx = (boxes[:, 0] + boxes[:, 2]) / 2 / w
    cy = (boxes[:, 1] + boxes[:, 3]) / 2 / h
    bw = (boxes[:, 2] - boxes[:, 0]) / w
    bh = (boxes[:, 3] - boxes[:, 1]) / h
    return np.stack([cx, cy, bw, bh], -1).astype(np.float32)


class TrainTransform:
    """Reference make_coco_transforms 'train' pipeline
    (datasets/odvg.py:277-341): hflip(0.5) then either a multi-scale resize
    or resize -> crop -> resize, both capped at max_size.  `rng` is the
    dataset's per-index random.Random."""

    def __init__(self, scales: Sequence[int], max_size: int = 1333,
                 scales2_resize: Sequence[int] = (400, 500, 600),
                 scales2_crop: Tuple[int, int] = (384, 600)):
        self.scales = list(scales)
        self.max_size = max_size
        self.scales2_resize = list(scales2_resize)
        self.scales2_crop = tuple(scales2_crop)

    def __call__(self, sample: Sample, rng) -> Sample:
        r = rng
        if r.random() < 0.5:
            sample = hflip(sample)
        if r.random() < 0.5:
            sample = resize(sample, r.choice(self.scales), self.max_size)
        else:
            sample = resize(sample, r.choice(self.scales2_resize))
            sample = random_size_crop(sample, *self.scales2_crop, rng=r)
            sample = resize(sample, r.choice(self.scales), self.max_size)
        return sample


class EvalTransform:
    """Reference 'val' pipeline: RandomResize([800], max_size=1333)."""

    def __init__(self, size: int = 800, max_size: int = 1333):
        self.size = size
        self.max_size = max_size

    def __call__(self, sample: Sample, rng=None) -> Sample:
        return resize(sample, self.size, self.max_size)


class Bucketer:
    """Pick the smallest static bucket that fits (h, w); pad with zeros."""

    def __init__(self, buckets: Sequence[Tuple[int, int]]):
        self.buckets = sorted(
            ((int(h), int(w)) for h, w in buckets), key=lambda s: s[0] * s[1]
        )

    def bucket_for(self, h: int, w: int) -> Tuple[int, int]:
        for bh, bw in self.buckets:
            if h <= bh and w <= bw:
                return (bh, bw)
        return self.buckets[-1]

    def pad_batch(self, images: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        """images: list of (h, w, 3) float arrays -> (B, Hb, Wb, 3) padded +
        (B, 2) valid sizes.  One bucket per batch (the max over samples)."""
        hs = [im.shape[0] for im in images]
        ws = [im.shape[1] for im in images]
        bh, bw = self.bucket_for(max(hs), max(ws))
        out = np.zeros((len(images), bh, bw, 3), images[0].dtype)
        sizes = np.zeros((len(images), 2), np.int32)
        for i, im in enumerate(images):
            h, w = im.shape[:2]
            if h > bh or w > bw:  # clip oversize (shouldn't happen in-policy)
                im = im[:bh, :bw]
                h, w = im.shape[:2]
            out[i, :h, :w] = im
            sizes[i] = (h, w)
        return out, sizes
