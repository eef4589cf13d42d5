"""PAVE CSV-driven batch evaluation harness: the port's own copy of the JAX
package's pave/batch_eval.py.

The reference's test_inference_new.py:745-1310: a manifest of frames with
damage GT + car bbox -> 512x512 crop batches -> detector -> translate back
-> NMS -> per-pred/per-GT IoU & center-distance tables -> CSV.  This version
runs on local files and a caller's forward function (for example the port's
parallel/train_state.make_eval_step followed by PostProcess.device, on the
card); results feed pave/metrics.threshold_sweep (= get_metrics.py).

Manifest: CSV with columns
  image_path, car_bbox ("x0,y0,x1,y1"), gt_boxes ("x0,y0,x1,y1;..."),
  gt_labels ("dent;scratch;...")
"""
from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Sequence

import numpy as np

from ..data.loader import Collator
from ..data.tokenization import build_caption
from .engine import crops_to_samples, merge_crop_predictions
from .metrics import per_image_records, summarize, threshold_sweep


def parse_manifest(path: str) -> List[Dict]:
    rows = []
    with open(path) as f:
        for row in csv.DictReader(f):
            rows.append(
                {
                    "image_path": row["image_path"],
                    "car_bbox": [float(v) for v in row["car_bbox"].split(",")],
                    "gt_boxes": np.asarray(
                        [
                            [float(v) for v in b.split(",")]
                            for b in row["gt_boxes"].split(";")
                            if b
                        ],
                        np.float32,
                    ).reshape(-1, 4),
                    "gt_labels": [s for s in row.get("gt_labels", "").split(";") if s],
                }
            )
    return rows


def run_ab_eval(
    forward_fns: Dict[str, object],
    collator: Collator,
    manifest_rows: Sequence[Dict],
    label_list: Sequence[str],
    out_dir: str = "test_results",
    **kwargs,
) -> Dict[str, Dict]:
    """A/B checkpoint comparison (reference test_inference_ab.py): run the
    same manifest through several models, one CSV per tag, return summaries
    keyed by tag."""
    os.makedirs(out_dir, exist_ok=True)
    results = {}
    for tag, fn in forward_fns.items():
        results[tag] = run_batch_eval(
            fn, collator, manifest_rows, label_list,
            out_csv=os.path.join(out_dir, f"{tag}.csv"), **kwargs,
        )
    return results


def run_batch_eval(
    forward_fn,                 # (batch dict) -> {"scores","boxes" per crop}
    collator: Collator,
    manifest_rows: Sequence[Dict],
    label_list: Sequence[str],
    box_threshold: float = 0.3,
    out_csv: str = None,
    batch_size: int = 16,
) -> Dict:
    """forward_fn consumes a collated batch and returns per-crop detections
    {'scores': (B, K), 'boxes': (B, K, 4) xyxy in crop coords}.  A frame's
    last batch holds what is left of its crops (no padding)."""
    from PIL import Image

    caption = build_caption(list(label_list))
    records, csv_rows = [], []
    for row in manifest_rows:
        img = np.asarray(Image.open(row["image_path"]).convert("RGB"))
        label_idx = np.asarray(
            [label_list.index(l) if l in label_list else 0
             for l in row["gt_labels"]],
            np.int64,
        )
        samples, crop_boxes = crops_to_samples(
            img, row["car_bbox"], row["gt_boxes"], label_idx,
            caption, list(label_list), keep_empty=True,
        )
        crop_results = []
        for i in range(0, len(samples), batch_size):
            chunk = samples[i : i + batch_size]
            batch = collator(chunk)
            out = forward_fn(batch)
            for b in range(len(chunk)):
                scores = np.asarray(out["scores"][b])
                boxes = np.asarray(out["boxes"][b])
                keep = scores > box_threshold
                crop_results.append({"scores": scores[keep], "boxes": boxes[keep]})
        merged = merge_crop_predictions(crop_results, crop_boxes)
        per_pred, per_gt = per_image_records(merged["boxes"], row["gt_boxes"])
        records.append((per_pred, per_gt))
        csv_rows.append(
            {
                "fname": os.path.basename(row["image_path"]),
                "pred_boxes": json.dumps(merged["boxes"].tolist()),
                "scores": json.dumps(merged["scores"].tolist()),
                "gt_labels": json.dumps(row["gt_labels"]),
                "metrics_per_pred": json.dumps(per_pred),
                "metrics_per_gt": json.dumps(per_gt),
            }
        )

    if out_csv:
        with open(out_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(csv_rows[0].keys()))
            w.writeheader()
            w.writerows(csv_rows)

    return {
        "summary": summarize(records),
        "sweep": threshold_sweep(records),
        "n_frames": len(records),
    }
