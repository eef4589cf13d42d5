"""Detection drawing with PIL (the port's own copy of the JAX package's
utils/visualizer.py; reference groundingdino/util/visualizer.py)."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw

_PALETTE = [
    (230, 25, 75), (60, 180, 75), (255, 225, 25), (0, 130, 200),
    (245, 130, 48), (145, 30, 180), (70, 240, 240), (240, 50, 230),
    (210, 245, 60), (250, 190, 190),
]


def draw_boxes(image: Image.Image, boxes_xyxy: np.ndarray,
               labels: Optional[Sequence[str]] = None, scores: Optional[np.ndarray] = None,
               width: int = 3) -> Image.Image:
    """A copy of `image` with absolute xyxy boxes and "label score" texts."""
    out = image.convert("RGB").copy()
    draw = ImageDraw.Draw(out)
    for i, box in enumerate(np.asarray(boxes_xyxy)):
        color = _PALETTE[i % len(_PALETTE)]
        x0, y0, x1, y1 = [float(v) for v in box]
        draw.rectangle([x0, y0, x1, y1], outline=color, width=width)
        text = ""
        if labels is not None and i < len(labels):
            text = str(labels[i])
        if scores is not None and i < len(scores):
            text = f"{text} {float(scores[i]):.2f}".strip()
        if text:
            draw.text((x0 + 2, max(y0 - 12, 0)), text, fill=color)
    return out


def draw_cxcywh_norm(image: Image.Image, boxes: np.ndarray, labels=None,
                     scores=None) -> Image.Image:
    """draw_boxes for normalized cxcywh boxes."""
    w, h = image.size
    b = np.asarray(boxes, np.float32)
    xyxy = np.stack([(b[:, 0] - b[:, 2] / 2) * w, (b[:, 1] - b[:, 3] / 2) * h,
                     (b[:, 0] + b[:, 2] / 2) * w, (b[:, 1] + b[:, 3] / 2) * h], axis=1)
    return draw_boxes(image, xyxy, labels, scores)
