"""CSV-driven batch inference with the port (the JAX package's
tools/inference_from_csv.py; reference tools/inference_from_csv.py:210-326).

    python -m open_groundingdino_tpu_torch.tools.inference_from_csv \\
        -c CONFIG -p CKPT --vocab vocab.txt --csv manifest.csv \\
        -t "dent . scratch ." -o results.csv [--image_col input] \\
        [--idx 0 --chunks 1] [--draw_dir out/] [--device cuda]

Reads a CSV manifest with an image column (a local path), runs grounded
detection on each row with one caption, and writes a results CSV with the
top box per image (the reference's output shape) plus all boxes as JSON
(columns input, bbox, size, labels, all_boxes, all_scores; a row where
nothing was found holds the reference's sentinel).  The model runs on CUDA
unless --device says otherwise.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import time

import numpy as np
from PIL import Image, ImageDraw

from ..inference import load_model, predict

FIELDS = ["input", "bbox", "size", "labels", "all_boxes", "all_scores"]


def get_args_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("GroundingDINO port: CSV batch inference")
    ap.add_argument("--config_file", "-c", required=True)
    ap.add_argument("--checkpoint_path", "-p", required=True)
    ap.add_argument("--vocab", required=True)
    ap.add_argument("--csv", required=True)
    ap.add_argument("--text_prompt", "-t", required=True)
    ap.add_argument("--output", "-o", default="inference_results.csv")
    ap.add_argument("--image_col", default="input")
    ap.add_argument("--box_threshold", type=float, default=0.3)
    ap.add_argument("--text_threshold", type=float, default=0.25)
    # the reference's sharding knobs for parallel runs over a big manifest
    ap.add_argument("--idx", type=int, default=0)
    ap.add_argument("--chunks", type=int, default=1)
    ap.add_argument("--draw_dir", default=None, help="optionally save box-overlay images here")
    ap.add_argument("--device", default="cuda")
    return ap


def cxcywh_to_xyxy_abs(box, H, W):
    """reference inference_from_csv.py:21-32 xywh_to_xyxy: normalized
    cxcywh -> absolute xyxy."""
    cx, cy, w, h = (np.asarray(box, np.float32) * np.asarray([W, H, W, H], np.float32)).tolist()
    return [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]


def main(args) -> list:
    """Writes the results CSV; returns its rows."""
    model = load_model(args.config_file, args.checkpoint_path, args.vocab, device=args.device)
    with open(args.csv, newline="") as f:
        rows = list(csv.DictReader(f))
    rows = rows[args.idx::args.chunks]
    if args.draw_dir:
        os.makedirs(args.draw_dir, exist_ok=True)

    results = []
    t0 = time.time()
    for i, row in enumerate(rows):
        src = row[args.image_col]
        try:
            image = Image.open(src).convert("RGB")
        except Exception as e:  # missing/corrupt file: skip like upstream
            print(f"skip {src}: {e}")
            continue
        boxes, scores, phrases = predict(model, image, args.text_prompt,
                                         box_threshold=args.box_threshold,
                                         text_threshold=args.text_threshold)
        W, H = image.size
        xyxy = [cxcywh_to_xyxy_abs(b, H, W) for b in boxes]
        if xyxy:
            top = xyxy[0]
        else:  # reference emits a sentinel row when nothing is found
            top = [17.0, 17.0, 17.0, 17.0]
            phrases = ["-17"]
        results.append({
            "input": src,
            "bbox": json.dumps(top),
            "size": json.dumps([H, W]),
            "labels": json.dumps(list(phrases)),
            "all_boxes": json.dumps(xyxy),
            "all_scores": json.dumps(np.asarray(scores).tolist()),
        })
        if args.draw_dir and xyxy:
            im = image.copy()
            d = ImageDraw.Draw(im)
            for b, ph in zip(xyxy, phrases):
                d.rectangle(b, outline=(255, 0, 0), width=2)
                d.text((b[0], max(0, b[1] - 12)), str(ph), fill=(255, 0, 0))
            im.save(os.path.join(args.draw_dir, f"pred{i}.jpg"))

    with open(args.output, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FIELDS)
        w.writeheader()
        w.writerows(results)
    print(f"{len(results)} rows -> {args.output} in {time.time() - t0:.1f}s")
    return results


if __name__ == "__main__":
    main(get_args_parser().parse_args())
