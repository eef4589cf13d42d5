"""PAVE damage-manifest dataset, a CSV of frames with damage keypoints: the
port's own copy of the JAX package's pave/dmg_dataset.py.

Semantics of reference dmg_dataset.py:11-102 (DmgDataset) and the GT
construction in test_inference_new.py:494-517 (get_coco_bbox: keypoint ->
fixed-size box by damage severity) and :989-1021 (damage-name -> category /
size mapping).  Host-side numpy; images load from paths relative to the
CSV (CDN fetching lives in pave/infer_utils.py).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
from PIL import Image

# reference test_inference_new.py:497-499: half-extents by severity
_HALF = {"small": 16.0, "medium": 32.0, "large": 64.0}

# canonical damage vocabulary (reference gen_coco_cat / cat_id_dct)
DAMAGE_CATEGORIES = ("dent", "scratch", "missing", "scraped", "broken",
                     "others")


def get_coco_bbox(kpts: Sequence[float], h: float, w: float,
                  dmg: str = "small") -> List[float]:
    """Damage keypoint (normalized x, y) -> xyxy box of fixed half-extent
    by severity (reference test_inference_new.py:494-517)."""
    kx, ky = kpts[0] * w, kpts[1] * h
    half = _HALF.get(dmg, _HALF["small"])
    return [round(v, 1) for v in (kx - half, ky - half, kx + half, ky + half)]


def damage_name_to_category(cat: str) -> Tuple[str, str]:
    """Raw damage name -> (label category, size category)
    (reference test_inference_new.py:989-1014)."""
    up = cat.upper()
    if "DENT" in up:
        lbl = "dent"
    elif "SCRATCH" in up:
        lbl = "scratch"
    elif "MISSING" in up:
        lbl = "missing"
    elif "SCRAPED" in up:
        lbl = "scraped"
    elif "BROKEN" in up:
        lbl = "broken"
    else:
        lbl = "others"
    if "MAJOR" in up:
        size = "large"
    elif "MEDIUM" in up:
        size = "medium"
    else:  # MINOR or unknown
        size = "small"
    return lbl, size


class DmgDataset:
    """Iterates damage-annotated frames from a CSV manifest.

    CSV columns (reference dmg_dataset.py:19-22): file_name, dmg_count,
    dmg_kpts (json list of [x, y] normalized), car_bbox (json
    [ymin, ymax, xmin, xmax], the reference's odd ordering, re-ordered
    here to xyxy), and optionally dmg_names (json list of raw names).
    Rows with dmg_count == 0 are dropped, as upstream does.
    """

    def __init__(self, csv_path: str):
        import csv as _csv

        self.csv_path = csv_path
        self.rows: List[Dict] = []
        with open(csv_path, newline="") as f:
            for row in _csv.DictReader(f):
                if int(float(row.get("dmg_count", "0"))) > 0:
                    self.rows.append(row)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> Dict:
        row = self.rows[idx]
        img_path = os.path.join(
            os.path.dirname(self.csv_path), row["file_name"]
        )
        img = Image.open(img_path).convert("RGB")
        w, h = img.size

        # reference dmg_dataset.py:99-101: car_bbox arrives
        # [ymin, ymax, xmin, xmax]; emit xyxy
        cb = json.loads(row["car_bbox"])
        car_bbox = np.asarray([cb[2], cb[0], cb[3], cb[1]], np.float32)

        kpts = json.loads(row["dmg_kpts"])
        names = json.loads(row["dmg_names"]) if row.get("dmg_names") else \
            ["MINOR_DENT"] * len(kpts)
        boxes, labels, label_names = [], [], []
        for kp, name in zip(kpts, names):
            lbl, size = damage_name_to_category(name)
            boxes.append(get_coco_bbox(kp, h, w, size))
            labels.append(DAMAGE_CATEGORIES.index(lbl))
            label_names.append(lbl)
        return {
            "image": np.asarray(img, np.uint8),
            "image_hw": (h, w),
            "car_bbox": car_bbox,
            "gt_boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "gt_labels": np.asarray(labels, np.int64),
            "gt_label_names": label_names,
            "file_name": row["file_name"],
        }
