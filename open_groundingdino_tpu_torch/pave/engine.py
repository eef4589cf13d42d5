"""PAVE crop-level engine: the port's own copy of the JAX package's
pave/engine.py.

The reference's crop engines (engine_multi.py:353-949) slide 512x512 windows
over the vehicle bbox, translate damage GT into each crop, drop empty crops,
cap at 64, and feed the crop batch through the detector with the damage
caption.  Here the host-side crop pipeline (pave/crop_utils.py) produces
the port's collator samples (data/transforms.Sample); every crop is
512x512, so a crop batch pads into one image bucket.

Inference side: predictions are translated back to the full frame
(translate_box_to_image) and class-agnostic NMS'd (models/postprocess.
nms_numpy), then scored with pave/metrics.py: the reference
test_inference_new.py flow on local files.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
from PIL import Image

from ..data.transforms import Sample
from ..models.postprocess import nms_numpy
from . import crop_utils
from .metrics import per_image_records, summarize


def crops_to_samples(
    image: np.ndarray,          # (H, W, 3) uint8 full frame
    car_bbox: Sequence[float],
    gt_boxes: np.ndarray,
    gt_labels: np.ndarray,
    caption: str,
    cap_list: List[str],
    image_id: int = -1,
    max_crops: int = 64,
    keep_empty: bool = False,
    rng=None,
) -> Tuple[List[Sample], List]:
    """Returns (samples for the Collator, crop boxes)."""
    crops = crop_utils.crops_with_boxes(
        image, car_bbox, gt_boxes, gt_labels,
        keep_empty=keep_empty, max_crops=max_crops, rng=rng,
    )
    samples, crop_boxes = [], []
    for c in crops:
        samples.append(
            Sample(
                image=Image.fromarray(c["image"].astype(np.uint8)),
                boxes=c["boxes"],
                labels=c["labels"],
                image_id=image_id,
                orig_size=c["image"].shape[:2],
                caption=caption,
                cap_list=cap_list,
            )
        )
        crop_boxes.append(c["crop_box"])
    return samples, crop_boxes


def merge_crop_predictions(
    crop_results: Sequence[Dict[str, np.ndarray]],  # per crop: scores/boxes xyxy
    crop_boxes: Sequence,
    nms_iou: float = 0.5,
) -> Dict[str, np.ndarray]:
    """Translate per-crop detections back to frame coordinates and NMS
    (reference test_inference_new.py:337 + torchvision nms)."""
    all_boxes, all_scores = [], []
    phrases: List[str] = []
    for res, cb in zip(crop_results, crop_boxes):
        for i, b in enumerate(np.asarray(res["boxes"]).reshape(-1, 4)):
            all_boxes.append(crop_utils.translate_box_to_image(tuple(b), cb))
            all_scores.append(float(res["scores"][i]))
            if "phrases" in res:
                phrases.append(res["phrases"][i])
    if not all_boxes:
        return {"boxes": np.zeros((0, 4), np.float32),
                "scores": np.zeros((0,), np.float32), "phrases": []}
    boxes = np.asarray(all_boxes, np.float32)
    scores = np.asarray(all_scores, np.float32)
    keep = nms_numpy(boxes, scores, nms_iou)
    return {
        "boxes": boxes[keep],
        "scores": scores[keep],
        "phrases": [phrases[i] for i in keep] if phrases else [],
    }


def evaluate_frames(
    frame_predictions: Sequence[np.ndarray],
    frame_gts: Sequence[np.ndarray],
    iou_thresh: float = 0.5,
    dist_thresh: float = 400.0,
) -> Dict[str, float]:
    """End-to-end PAVE scoring over frames (pred/gt boxes xyxy absolute)."""
    records = [
        per_image_records(np.asarray(p).reshape(-1, 4),
                          np.asarray(g).reshape(-1, 4))
        for p, g in zip(frame_predictions, frame_gts)
    ]
    return summarize(records, iou_thresh, dist_thresh)
