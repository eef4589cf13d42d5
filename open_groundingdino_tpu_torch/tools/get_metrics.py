"""PAVE metrics from a batch-eval CSV (the JAX package's tools/get_metrics.py;
reference get_metrics.py): frame-averaged precision / recall / accuracy /
specificity at one IoU and distance threshold, and the threshold sweep.

    python -m open_groundingdino_tpu_torch.tools.get_metrics results.csv \\
        [--iou 0.5] [--dist 400]

The CSV is what pave/batch_eval.run_batch_eval writes (its metrics_per_pred
and metrics_per_gt columns).  Host-only: no model, no device.
"""
from __future__ import annotations

import argparse
import csv
import json

from ..pave.metrics import summarize, threshold_sweep


def load_records(path: str):
    """[(per_pred, per_gt)] of each frame of a batch-eval CSV."""
    records = []
    with open(path) as f:
        for row in csv.DictReader(f):
            per_pred = {int(k): tuple(v) for k, v in json.loads(row["metrics_per_pred"]).items()}
            per_gt = {int(k): tuple(v) for k, v in json.loads(row["metrics_per_gt"]).items()}
            records.append((per_pred, per_gt))
    return records


def get_args_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("GroundingDINO port: PAVE metrics of a batch-eval CSV")
    ap.add_argument("csv_path")
    ap.add_argument("--iou", type=float, default=0.5)
    ap.add_argument("--dist", type=float, default=400.0)
    return ap


def main(args) -> dict:
    """Prints the summary and the sweep; returns {"summary", "sweep", "n_frames"}."""
    records = load_records(args.csv_path)
    s = summarize(records, args.iou, args.dist)
    sweep = threshold_sweep(records)
    print(f"frames={len(records)} iou>={args.iou} dist<={args.dist}")
    for k, v in s.items():
        print(f"  {k}: {v:.4f}")
    print("threshold sweep:")
    for row in sweep:
        print(f"  iou={row['iou_thresh']:<4} dist={row['dist_thresh']:<5} "
              f"P={row['precision']:.3f} R={row['recall']:.3f}")
    return {"summary": s, "sweep": sweep, "n_frames": len(records)}


if __name__ == "__main__":
    main(get_args_parser().parse_args())
