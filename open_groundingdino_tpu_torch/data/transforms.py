"""Host-side eval transforms (numpy + PIL): the port's own copy of the eval
half of the JAX package's data/transforms.py.

Shortest-edge resize with max_size (PIL bilinear, the resampler torchvision
uses), ImageNet normalization, and `Bucketer`, which pads an image up to a
static bucket from a fixed lattice (the JAX package's replacement for the
reference's NestedTensor dynamic padding, kept so both packages see the same
padded inputs).
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


def normalize_image(img: Image.Image) -> np.ndarray:
    arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


class EvalTransform:
    """Reference 'val' pipeline: RandomResize([800], max_size=1333)."""

    def __init__(self, size: int = 800, max_size: int = 1333):
        self.size = size
        self.max_size = max_size

    def __call__(self, sample: Sample) -> Sample:
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
