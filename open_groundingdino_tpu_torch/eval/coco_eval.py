"""COCO-style bbox mAP on the host: the port's own copy of the JAX package's
eval/coco_eval.py.  The greedy matcher runs in C++ (utils/native.py,
native/coco_match.cpp) by default, as the JAX package's does; the numpy
matcher is its plain version, taken with use_native=False or when the
library cannot be built.

The pycocotools COCOeval bbox protocol: greedy per-category matching at IoU
thresholds 0.5:0.05:0.95, area ranges (all/small/medium/large), maxDets
(1/10/100), crowd-ignore handling, and the 101-point interpolated precision
envelope.  `summarize` gives the standard 12 COCO numbers, comparable to the
reference's CocoGroundingEvaluator (reference datasets/cocogrounding_eval.py).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def bbox_iou_xywh(det: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """IoU between det (D,4) and gt (G,4) in xywh; for crowd GT the union is
    the detection area (pycocotools 'iou with ignore region' semantics)."""
    if len(det) == 0 or len(gt) == 0:
        return np.zeros((len(det), len(gt)), np.float64)
    dx0, dy0 = det[:, 0], det[:, 1]
    dx1, dy1 = det[:, 0] + det[:, 2], det[:, 1] + det[:, 3]
    gx0, gy0 = gt[:, 0], gt[:, 1]
    gx1, gy1 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]

    ix0 = np.maximum(dx0[:, None], gx0[None])
    iy0 = np.maximum(dy0[:, None], gy0[None])
    ix1 = np.minimum(dx1[:, None], gx1[None])
    iy1 = np.minimum(dy1[:, None], gy1[None])
    inter = np.clip(ix1 - ix0, 0, None) * np.clip(iy1 - iy0, 0, None)
    d_area = (det[:, 2] * det[:, 3])[:, None]
    g_area = (gt[:, 2] * gt[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), d_area, d_area + g_area - inter)
    return inter / np.maximum(union, 1e-12)


class CocoBboxEvaluator:
    """update() with per-image detections, then accumulate()/summarize()."""

    def __init__(self, coco_index, use_native: bool = True):
        """coco_index: data/coco.CocoIndex of the GT annotation file.
        use_native: the C++ greedy matcher (numpy when it cannot be built)."""
        self.coco = coco_index
        self.use_native = use_native
        self.cat_ids = coco_index.get_cat_ids()
        self.img_ids: List[int] = []
        # evalImgs[(img_id, cat_id)] -> match record
        self.eval_imgs: Dict = {}
        self._gt_cache: Dict = {}

    # -- GT ------------------------------------------------------------------
    def _gt_for(self, img_id: int, cat_id: int):
        key = (img_id, cat_id)
        if key not in self._gt_cache:
            anns = [
                a
                for a in self.coco.load_anns_for_img(img_id)
                if a["category_id"] == cat_id
            ]
            boxes = np.asarray([a["bbox"] for a in anns], np.float64).reshape(-1, 4)
            iscrowd = np.asarray([a.get("iscrowd", 0) for a in anns], np.int64)
            ignore = np.asarray(
                [a.get("ignore", 0) or a.get("iscrowd", 0) for a in anns], bool
            )
            areas = np.asarray([a.get("area", a["bbox"][2] * a["bbox"][3]) for a in anns])
            self._gt_cache[key] = (boxes, iscrowd, ignore, areas)
        return self._gt_cache[key]

    # -- per image -----------------------------------------------------------
    def update(self, predictions: Dict[int, Dict[str, np.ndarray]]):
        """predictions: {image_id: {'scores', 'labels' (COCO cat ids),
        'boxes' (xyxy absolute)}}"""
        for img_id, pred in predictions.items():
            self.img_ids.append(img_id)
            boxes = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)
            xywh = boxes.copy()
            xywh[:, 2:] -= xywh[:, :2]
            scores = np.asarray(pred["scores"], np.float64)
            labels = np.asarray(pred["labels"], np.int64)
            for cat_id in self.cat_ids:
                sel = labels == cat_id
                rec = self._evaluate_img(img_id, cat_id, xywh[sel], scores[sel])
                if rec is not None:  # no dets and no GT: nothing to record
                    self.eval_imgs[(img_id, cat_id)] = rec

    def _match(self, ious_s, gt_ignore_s, iscrowd_s, D, G):
        """Greedy pycocotools match against ignore-sorted GT.  Returns
        (dt_m, gt_m, dt_ig_gt) of shapes (T,D)/(T,G)/(T,D)."""
        T = len(IOU_THRS)
        dt_m = np.zeros((T, D), np.int64) - 1      # matched gt index or -1
        gt_m = np.zeros((T, G), np.int64) - 1
        dt_ig_gt = np.zeros((T, D), bool)          # matched-to-ignored flag
        if not (G and D):
            return dt_m, gt_m, dt_ig_gt
        if self.use_native:
            from ..utils.native import coco_greedy_match

            native = coco_greedy_match(ious_s, gt_ignore_s, iscrowd_s, IOU_THRS)
            if native is not None:
                return native
        for t, thr in enumerate(IOU_THRS):
            thr_eff = min(thr, 1 - 1e-10)
            for d in range(D):
                # greedy: best available non-ignored GT first, else best
                # available ignored GT (pycocotools ordering semantics)
                avail = (gt_m[t] < 0) | iscrowd_s.astype(bool)
                cand = np.where(avail, ious_s[d], -1.0)
                real = np.where(~gt_ignore_s, cand, -1.0)
                best_g = -1
                if real.max() >= thr_eff:
                    best_g = int(real.argmax())
                else:
                    ig = np.where(gt_ignore_s, cand, -1.0)
                    if ig.size and ig.max() >= thr_eff:
                        best_g = int(ig.argmax())
                if best_g >= 0:
                    dt_m[t, d] = best_g
                    gt_m[t, best_g] = d
                    dt_ig_gt[t, d] = gt_ignore_s[best_g]
        return dt_m, gt_m, dt_ig_gt

    def _evaluate_img(self, img_id, cat_id, det_xywh, det_scores):
        """One record per area range, matching pycocotools' evaluateImg per
        aRng: out-of-range GT are marked ignore BEFORE matching and sorted
        last, so a det overlapping both an in-range and an out-of-range GT
        matches the in-range one — an area-agnostic single match diverges on
        APs/APm/APl (advisor finding, round 1)."""
        gt_boxes, iscrowd, gt_ignore, gt_areas = self._gt_for(img_id, cat_id)
        order = np.argsort(-det_scores, kind="mergesort")[: max(MAX_DETS)]
        det_xywh = det_xywh[order]
        det_scores = det_scores[order]
        D, G = len(det_xywh), len(gt_boxes)
        if D == 0 and G == 0:
            return None
        ious = bbox_iou_xywh(det_xywh, gt_boxes, iscrowd)
        det_areas = det_xywh[:, 2] * det_xywh[:, 3]

        areas = {}
        for aname, (amin, amax) in AREA_RANGES.items():
            g_ig = gt_ignore | (gt_areas < amin) | (gt_areas > amax)
            gt_order = np.argsort(g_ig, kind="mergesort")
            g_ig_s = g_ig[gt_order]
            crowd_s = iscrowd[gt_order]
            ious_s = ious[:, gt_order] if G else ious
            dt_m, _, dt_ig_gt = self._match(ious_s, g_ig_s, crowd_s, D, G)
            matched = dt_m >= 0
            out_of_area = (det_areas < amin) | (det_areas > amax)
            dt_ig = np.where(matched, dt_ig_gt, out_of_area[None])
            areas[aname] = {
                "tp": matched & ~dt_ig,
                "ig": dt_ig,
                "npig": int((~g_ig_s).sum()),
            }
        return {"det_scores": det_scores, "areas": areas}

    # -- accumulate ------------------------------------------------------------
    def accumulate(self):
        T = len(IOU_THRS)
        R = len(REC_THRS)
        K = len(self.cat_ids)
        A = len(AREA_RANGES)
        M = len(MAX_DETS)
        self.precision = -np.ones((T, R, K, A, M))
        self.recall = -np.ones((T, K, A, M))
        img_ids = sorted(set(self.img_ids))

        for k, cat_id in enumerate(self.cat_ids):
            recs = [self.eval_imgs.get((i, cat_id)) for i in img_ids]
            recs = [r for r in recs if r is not None]
            if not recs:
                continue
            for a, aname in enumerate(AREA_RANGES):
                # per-record tp/fp at full maxDets (matched per area range in
                # _evaluate_img); per-maxDet views are prefixes
                per_rec = []
                npig = 0
                for r in recs:
                    ar = r["areas"][aname]
                    npig += ar["npig"]
                    per_rec.append(
                        (r["det_scores"], ar["tp"], ~ar["tp"] & ~ar["ig"])
                    )
                if npig == 0:
                    continue
                for m, max_det in enumerate(MAX_DETS):
                    scores = np.concatenate([s[:max_det] for s, _, _ in per_rec])
                    tps = np.concatenate(
                        [tp[:, :max_det] for _, tp, _ in per_rec], axis=1
                    )
                    fps = np.concatenate(
                        [fp[:, :max_det] for _, _, fp in per_rec], axis=1
                    )
                    order = np.argsort(-scores, kind="mergesort")
                    tps = np.cumsum(tps[:, order], axis=1)
                    fps = np.cumsum(fps[:, order], axis=1)
                    rc_all = tps / npig
                    pr_all = tps / np.maximum(tps + fps, 1e-12)
                    # precision envelope (monotone non-increasing), vectorized
                    pr_env = np.maximum.accumulate(pr_all[:, ::-1], axis=1)[:, ::-1]
                    n = rc_all.shape[1]
                    self.recall[:, k, a, m] = rc_all[:, -1] if n else 0
                    for t in range(T):
                        inds = np.searchsorted(rc_all[t], REC_THRS, side="left")
                        valid_i = inds < n
                        q = np.zeros(R)
                        q[valid_i] = pr_env[t, inds[valid_i]]
                        self.precision[t, :, k, a, m] = q

    # -- summarize ------------------------------------------------------------
    def _summarize(self, ap=True, iou_thr=None, area="all", max_dets=100):
        a = list(AREA_RANGES).index(area)
        m = MAX_DETS.index(max_dets)
        if ap:
            s = self.precision
            if iou_thr is not None:
                s = s[np.where(np.isclose(IOU_THRS, iou_thr))[0]]
            s = s[:, :, :, a, m]
        else:
            s = self.recall
            if iou_thr is not None:
                s = s[np.where(np.isclose(IOU_THRS, iou_thr))[0]]
            s = s[:, :, a, m]
        valid = s[s > -1]
        return float(valid.mean()) if valid.size else -1.0

    def summarize(self) -> Dict[str, float]:
        stats = {
            "AP": self._summarize(True),
            "AP50": self._summarize(True, 0.5),
            "AP75": self._summarize(True, 0.75),
            "APs": self._summarize(True, area="small"),
            "APm": self._summarize(True, area="medium"),
            "APl": self._summarize(True, area="large"),
            "AR1": self._summarize(False, max_dets=1),
            "AR10": self._summarize(False, max_dets=10),
            "AR100": self._summarize(False),
            "ARs": self._summarize(False, area="small"),
            "ARm": self._summarize(False, area="medium"),
            "ARl": self._summarize(False, area="large"),
        }
        return stats
