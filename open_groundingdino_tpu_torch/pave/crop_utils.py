"""PAVE sliding-window crop pipeline (host-side numpy): the port's own copy
of the JAX package's pave/crop_utils.py.

Semantics of reference crop_utils.py:3-62 (create_crops_v3) plus the GT
translation helpers used by engine_multi.py:381-497 and
test_inference_new.py:337 (translate_bbox_to_original_image).  Every crop is
512x512, so a crop batch pads into one image bucket.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

Box = Tuple[float, float, float, float]          # x0, y0, x1, y1
CropBox = Tuple[Tuple[int, int], Tuple[int, int]]  # (x0, y0), (x1, y1)


def create_crop_boxes(
    image_hw: Tuple[int, int],
    car_bbox: Sequence[float],
    padding: int = 100,
    crop_size: Tuple[int, int] = (512, 512),
    stride: Tuple[int, int] = (256, 256),
) -> List[CropBox]:
    """Sliding-window crop rectangles around the (padded) car bbox, clamped
    to the image; windows that would overrun are pinned to the padded-box
    edge (reference create_crops_v3 loop structure, incl. its
    `width//stride + 1` x / `height//stride` y counts)."""
    H, W = image_hw
    ch, cw = crop_size
    sy, sx = stride
    x0, y0, x1, y1 = car_bbox
    px0 = int(max(x0 - padding, 0))
    py0 = int(max(y0 - padding, 0))
    px1 = int(min(x1 + padding, W))
    py1 = int(min(y1 + padding, H))

    n_x = (px1 - px0) // sx + 1
    n_y = max((py1 - py0) // sy, 1)

    boxes: List[CropBox] = []
    for i in range(n_x):
        for j in range(n_y):
            x = px0 + sx * i
            y = py0 + sy * j
            x_end, y_end = x + cw, y + ch
            if x_end > px1:
                x, x_end = px1 - cw, px1
            if y_end > py1:
                y, y_end = py1 - ch, py1
            x, y = max(x, 0), max(y, 0)
            boxes.append(((x, y), (x_end, y_end)))
    return boxes


def crop_image(image: np.ndarray, crop_box: CropBox) -> np.ndarray:
    """(H, W, C) -> crop; short crops (image smaller than window) are
    zero-padded to the full crop size."""
    (x0, y0), (x1, y1) = crop_box
    ch, cw = y1 - y0, x1 - x0
    crop = image[max(y0, 0) : y1, max(x0, 0) : x1]
    if crop.shape[0] != ch or crop.shape[1] != cw:
        out = np.zeros((ch, cw) + image.shape[2:], image.dtype)
        out[: crop.shape[0], : crop.shape[1]] = crop
        return out
    return crop


def is_inside(box: Box, crop_box: CropBox) -> bool:
    (cx0, cy0), (cx1, cy1) = crop_box
    x0, y0, x1, y1 = box
    return x0 >= cx0 and y0 >= cy0 and x1 <= cx1 and y1 <= cy1


def translate_box_to_crop(box: Box, crop_box: CropBox) -> Box:
    (cx0, cy0), _ = crop_box
    return (box[0] - cx0, box[1] - cy0, box[2] - cx0, box[3] - cy0)


def translate_box_to_image(box: Box, crop_box: CropBox) -> Box:
    """Inverse of translate_box_to_crop (reference
    test_inference_new.py translate_bbox_to_original_image)."""
    (cx0, cy0), _ = crop_box
    return (box[0] + cx0, box[1] + cy0, box[2] + cx0, box[3] + cy0)


def crops_with_boxes(
    image: np.ndarray,
    car_bbox: Sequence[float],
    gt_boxes: np.ndarray,          # (N, 4) xyxy absolute
    gt_labels: np.ndarray,
    padding: int = 100,
    crop_size: Tuple[int, int] = (512, 512),
    stride: Tuple[int, int] = (256, 256),
    keep_empty: bool = False,
    max_crops: int = 64,
    rng: np.random.RandomState = None,
):
    """Full crop pipeline for one frame: crops + translated GT, empty crops
    dropped, capped at max_crops by random sampling (a RandomState(0) when
    no rng is given; reference engine_multi.py:464-490)."""
    crop_boxes = create_crop_boxes(image.shape[:2], car_bbox, padding,
                                   crop_size, stride)
    out = []
    for cb in crop_boxes:
        keep_idx = [
            i for i, b in enumerate(gt_boxes) if is_inside(tuple(b), cb)
        ]
        if not keep_idx and not keep_empty:
            continue
        boxes = np.asarray(
            [translate_box_to_crop(tuple(gt_boxes[i]), cb) for i in keep_idx],
            np.float32,
        ).reshape(-1, 4)
        out.append(
            {
                "image": crop_image(image, cb),
                "crop_box": cb,
                "boxes": boxes,
                "labels": np.asarray([gt_labels[i] for i in keep_idx], np.int64),
            }
        )
    if len(out) > max_crops:
        rng = rng or np.random.RandomState(0)
        idx = rng.choice(len(out), max_crops, replace=False)
        out = [out[i] for i in idx]
    return out
