"""Single-image zero-shot inference with the port (the JAX package's
tools/inference_on_a_image.py; reference tools/inference_on_a_image.py).

    python -m open_groundingdino_tpu_torch.tools.inference_on_a_image \\
        -c CONFIG -p CKPT --vocab vocab.txt -i image.jpg -t "dog . cat ." \\
        -o out_dir [--box_threshold 0.3] [--text_threshold 0.25] \\
        [--token_spans "[[(0, 3)], [(6, 9)]]"] [--device cuda]

CONFIG picks the model (the port's config/cfg_coco.py for Swin-T,
cfg_swinb.py, cfg_swinl.py, cfg_resnet50.py); CKPT is a reference-keyed
.pth.  Writes out_dir/pred.json (normalized cxcywh boxes, scores, phrases)
and out_dir/pred.jpg, the image with the boxes drawn.  The model runs on
CUDA unless --device says otherwise.
"""
from __future__ import annotations

import argparse
import ast
import json
import os

import numpy as np
from PIL import Image

from ..inference import annotate, load_model, predict, predict_with_spans


def get_args_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("GroundingDINO port: inference on one image")
    ap.add_argument("--config_file", "-c", required=True)
    ap.add_argument("--checkpoint_path", "-p", required=True)
    ap.add_argument("--vocab", required=True, help="bert vocab.txt path")
    ap.add_argument("--image_path", "-i", required=True)
    ap.add_argument("--text_prompt", "-t", required=True)
    ap.add_argument("--output_dir", "-o", default="pred_out")
    ap.add_argument("--box_threshold", type=float, default=0.3)
    ap.add_argument("--text_threshold", type=float, default=0.25)
    ap.add_argument("--token_spans", default=None,
                    help="given-phrase mode (reference inference_on_a_image.py:116-142): a "
                         'Python literal list of char-span lists, e.g. "[[(0, 3)], [(6, 9)]]"; '
                         "each phrase is scored by its tokens' mean probability instead of the "
                         "thresholded largest one")
    ap.add_argument("--device", default="cuda")
    return ap


def main(args) -> dict:
    """Runs the request and writes its files; returns what pred.json holds."""
    os.makedirs(args.output_dir, exist_ok=True)
    im = load_model(args.config_file, args.checkpoint_path, args.vocab, device=args.device)
    image = Image.open(args.image_path).convert("RGB")
    if args.token_spans is not None:
        boxes, scores, phrases = predict_with_spans(
            im, image, args.text_prompt, ast.literal_eval(args.token_spans),
            box_threshold=args.box_threshold)
    else:
        boxes, scores, phrases = predict(im, image, args.text_prompt,
                                         box_threshold=args.box_threshold,
                                         text_threshold=args.text_threshold)
    pred = {"boxes_cxcywh_norm": np.asarray(boxes).tolist(),
            "scores": np.asarray(scores).tolist(), "phrases": list(phrases)}
    with open(os.path.join(args.output_dir, "pred.json"), "w") as f:
        json.dump(pred, f, indent=2)
    drawn = annotate(np.asarray(image), boxes, scores, phrases)
    Image.fromarray(drawn).save(os.path.join(args.output_dir, "pred.jpg"))
    print(f"{len(boxes)} detections -> {args.output_dir}")
    return pred


if __name__ == "__main__":
    main(get_args_parser().parse_args())
