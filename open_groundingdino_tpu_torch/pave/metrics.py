"""PAVE damage-detection metrics: the port's own copy of the JAX package's
pave/metrics.py.

TP/FP/FN rule of reference util/calculate_metrics.py:14-112: a prediction is
TP if (best IoU vs any GT >= iou_thresh) OR (best center distance <=
dist_thresh); a GT is missed (FN) if no prediction satisfies either; TN is
the reference's fixed constant (10).  Per-image precision/recall/accuracy/
specificity averaged over frames, plus the threshold-sweep of
get_metrics.py:8-101.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4) x (M,4) pairwise IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-12)


def center_dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.full((len(a), len(b)), np.inf)
    ca = (a[:, :2] + a[:, 2:]) / 2
    cb = (b[:, :2] + b[:, 2:]) / 2
    return np.linalg.norm(ca[:, None] - cb[None], axis=-1)


def per_image_records(pred_boxes: np.ndarray, gt_boxes: np.ndarray):
    """metrics_per_pred / metrics_per_gt tables: best IoU + best center
    distance per prediction and per GT (reference test_inference_new.py
    evaluate tables)."""
    iou = iou_xyxy(pred_boxes, gt_boxes)
    dist = center_dist(pred_boxes, gt_boxes)
    per_pred = {}
    for p in range(len(pred_boxes)):
        if len(gt_boxes):
            bi, bd = int(iou[p].argmax()), int(dist[p].argmin())
            per_pred[p] = (float(iou[p, bi]), bi, float(dist[p, bd]), bd)
        else:
            per_pred[p] = (0.0, -1, float("inf"), -1)
    per_gt = {}
    for g in range(len(gt_boxes)):
        if len(pred_boxes):
            bi, bd = int(iou[:, g].argmax()), int(dist[:, g].argmin())
            per_gt[g] = (float(iou[bi, g]), bi, float(dist[bd, g]), bd)
        else:
            per_gt[g] = (0.0, -1, float("inf"), -1)
    return per_pred, per_gt


def count_tp_fp_fn(per_pred: Dict, per_gt: Dict, iou_thresh: float,
                   dist_thresh: float) -> Tuple[int, int, int]:
    tp = sum(
        1 for iou, _, d, _ in per_pred.values()
        if iou >= iou_thresh or d <= dist_thresh
    )
    fp = sum(
        1 for iou, _, d, _ in per_pred.values()
        if iou < iou_thresh and d > dist_thresh
    )
    fn = sum(
        1 for iou, _, d, _ in per_gt.values()
        if iou < iou_thresh and d > dist_thresh
    )
    return tp, fp, fn


def summarize(
    records: Sequence[Tuple[Dict, Dict]],
    iou_thresh: float = 0.5,
    dist_thresh: float = 400.0,
    tn_constant: int = 10,
) -> Dict[str, float]:
    """Frame-averaged metrics (reference calculate_metrics __main__)."""
    accs, specs, precs, recs = [], [], [], []
    for per_pred, per_gt in records:
        tp, fp, fn = count_tp_fp_fn(per_pred, per_gt, iou_thresh, dist_thresh)
        tn = tn_constant
        total = tp + tn + fp + fn
        accs.append((tp + tn) / total if total else 0.0)
        specs.append(tn / (tn + fp) if (tn + fp) else 0.0)
        precs.append(tp / (tp + fp) if (tp + fp) else 0.0)
        recs.append(tp / (tp + fn) if (tp + fn) else 0.0)
    return {
        "accuracy": float(np.mean(accs)) if accs else 0.0,
        "specificity": float(np.mean(specs)) if specs else 0.0,
        "precision": float(np.mean(precs)) if precs else 0.0,
        "recall": float(np.mean(recs)) if recs else 0.0,
    }


def threshold_sweep(
    records: Sequence[Tuple[Dict, Dict]],
    iou_threshs: Sequence[float] = (0.1, 0.3, 0.5, 0.7),
    dist_threshs: Sequence[float] = (100, 200, 400),
) -> List[Dict]:
    """reference get_metrics.py threshold search."""
    out = []
    for it in iou_threshs:
        for dt in dist_threshs:
            s = summarize(records, it, dt)
            out.append({"iou_thresh": it, "dist_thresh": dt, **s})
    return out
