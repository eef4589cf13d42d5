"""Folder inference with the port (the JAX package's
tools/inference_a_folder.py; reference tools/inference_a_folder.py, which
shells out per image): the model stays resident and each image goes through
predict.

    python -m open_groundingdino_tpu_torch.tools.inference_a_folder \\
        -c CONFIG -p CKPT --vocab vocab.txt -i images_dir -t "dog . cat ." \\
        -o out_dir [--device cuda]

Writes out_dir/predictions.json: per file name its normalized cxcywh boxes,
scores and phrases.  The model runs on CUDA unless --device says otherwise.
"""
from __future__ import annotations

import argparse
import json
import os

from PIL import Image

from ..inference import load_model, predict

EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def get_args_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("GroundingDINO port: inference on a folder")
    ap.add_argument("--config_file", "-c", required=True)
    ap.add_argument("--checkpoint_path", "-p", required=True)
    ap.add_argument("--vocab", required=True)
    ap.add_argument("--image_dir", "-i", required=True)
    ap.add_argument("--text_prompt", "-t", required=True)
    ap.add_argument("--output_dir", "-o", default="pred_folder")
    ap.add_argument("--box_threshold", type=float, default=0.3)
    ap.add_argument("--text_threshold", type=float, default=0.25)
    ap.add_argument("--device", default="cuda")
    return ap


def main(args) -> dict:
    """Writes predictions.json; returns what it holds."""
    os.makedirs(args.output_dir, exist_ok=True)
    model = load_model(args.config_file, args.checkpoint_path, args.vocab, device=args.device)
    results = {}
    files = sorted(f for f in os.listdir(args.image_dir) if f.lower().endswith(EXTS))
    for name in files:
        image = Image.open(os.path.join(args.image_dir, name)).convert("RGB")
        boxes, scores, phrases = predict(model, image, args.text_prompt,
                                         box_threshold=args.box_threshold,
                                         text_threshold=args.text_threshold)
        results[name] = {"boxes_cxcywh_norm": boxes.tolist(), "scores": scores.tolist(),
                         "phrases": phrases}
        print(f"{name}: {len(boxes)} detections")
    with open(os.path.join(args.output_dir, "predictions.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main(get_args_parser().parse_args())
