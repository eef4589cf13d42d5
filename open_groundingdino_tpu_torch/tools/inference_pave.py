"""PAVE single-frame damage inference with the port (the JAX package's
tools/inference_pave.py; reference inference_on_a_image_pave.py).

    python -m open_groundingdino_tpu_torch.tools.inference_pave \\
        -c CONFIG -p CKPT --vocab vocab.txt -i frame.jpg \\
        (--car_bbox 400,300,1500,900 | --car_seg_checkpoint seg.pth \\
         [--car_seg_variant m1_1] [--car_seg_infer_size 512,1024]) \\
        [-t "dent . scratch . broken ."] [-o out_dir] [--device cuda]

The car bbox that seeds the crop grid comes from --car_bbox or from the
port's RepViT + Semantic-FPN segmentor (pave/repvit_seg.py; its checkpoint
is a torch.save state dict, pave.repvit_seg.save_segmentor), whose car mask
is reduced to a tight bbox.  Slides 512x512 crops over the (padded) car
bbox, runs one predict(size=512, max_size=512) per crop, translates the
detections back to frame coordinates and NMS-merges them.  Writes
out_dir/pred.json (xyxy frame-pixel boxes, scores, phrases, the crop count)
and out_dir/pred.jpg.  The models run on CUDA unless --device says
otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
from PIL import Image

from ..inference import InferenceModel, load_model, predict
from ..pave import crop_utils
from ..pave.engine import merge_crop_predictions
from ..utils.visualizer import draw_boxes


def get_args_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("GroundingDINO port: PAVE inference on one frame")
    ap.add_argument("--config_file", "-c", required=True)
    ap.add_argument("--checkpoint_path", "-p", required=True)
    ap.add_argument("--vocab", required=True, help="bert vocab.txt path")
    ap.add_argument("--image_path", "-i", required=True)
    ap.add_argument("--car_bbox", default=None, help="x0,y0,x1,y1 in frame pixels")
    ap.add_argument("--car_seg_checkpoint", default=None,
                    help="a .pth state dict of pave.repvit_seg.RepViTSegmentor; derives the "
                         "car bbox when --car_bbox is absent")
    ap.add_argument("--car_seg_variant", default="m1_1")
    ap.add_argument("--car_seg_infer_size", default="512,1024",
                    help="h,w the frame is resized to for segmentation")
    ap.add_argument("--text_prompt", "-t", default="dent . scratch . missing . scraped . broken .")
    ap.add_argument("--output_dir", "-o", default="pave_out")
    ap.add_argument("--box_threshold", type=float, default=0.3)
    ap.add_argument("--text_threshold", type=float, default=0.25)
    ap.add_argument("--nms_iou", type=float, default=0.5)
    ap.add_argument("--device", default="cuda")
    return ap


def car_bbox_from_args(args, frame: np.ndarray) -> List[float]:
    """--car_bbox, or the bbox the --car_seg_checkpoint segmentor derives."""
    if args.car_bbox is not None:
        return [float(v) for v in args.car_bbox.split(",")]
    if args.car_seg_checkpoint is None:
        raise SystemExit("one of --car_bbox / --car_seg_checkpoint required")
    from ..pave.repvit_seg import RepViTConfig, derive_car_bbox, load_segmentor

    segmentor = load_segmentor(args.car_seg_checkpoint,
                               RepViTConfig.from_name(args.car_seg_variant), device=args.device)
    ih, iw = (int(v) for v in args.car_seg_infer_size.split(","))
    car = derive_car_bbox(segmentor, frame, infer_size=(ih, iw))
    if car is None:
        raise SystemExit("car segmentor found no car pixels in the frame")
    print(f"car bbox from segmentation: {[round(v, 1) for v in car]}")
    return list(car)


def predict_frame(im: InferenceModel, frame: np.ndarray, car_bbox: Sequence[float],
                  caption: str, box_threshold: float = 0.3, text_threshold: float = 0.25,
                  nms_iou: float = 0.5) -> Tuple[Dict, List]:
    """One predict per 512x512 crop around the car, the crops' detections
    (normalized cxcywh -> crop-pixel xyxy) merged in frame pixels; returns
    (merge_crop_predictions' result, the crop boxes)."""
    crop_boxes = crop_utils.create_crop_boxes(frame.shape[:2], car_bbox)
    crop_results = []
    for cb in crop_boxes:
        crop = crop_utils.crop_image(frame, cb)
        boxes, scores, phrases = predict(im, Image.fromarray(crop), caption,
                                         box_threshold=box_threshold,
                                         text_threshold=text_threshold, size=512, max_size=512)
        h, w = crop.shape[:2]
        if len(boxes):
            b = boxes * np.asarray([w, h, w, h], np.float32)
            xyxy = np.stack([b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2,
                             b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2], axis=1)
        else:
            xyxy = np.zeros((0, 4), np.float32)
        crop_results.append({"scores": scores, "boxes": xyxy, "phrases": phrases})
    return merge_crop_predictions(crop_results, crop_boxes, nms_iou), crop_boxes


def main(args) -> dict:
    """Runs the frame and writes its files; returns what pred.json holds."""
    os.makedirs(args.output_dir, exist_ok=True)
    im = load_model(args.config_file, args.checkpoint_path, args.vocab, device=args.device)
    frame = Image.open(args.image_path).convert("RGB")
    arr = np.asarray(frame)
    car = car_bbox_from_args(args, arr)
    merged, crop_boxes = predict_frame(im, arr, car, args.text_prompt, args.box_threshold,
                                       args.text_threshold, args.nms_iou)
    pred = {"boxes_xyxy": merged["boxes"].tolist(), "scores": merged["scores"].tolist(),
            "phrases": merged["phrases"], "n_crops": len(crop_boxes)}
    with open(os.path.join(args.output_dir, "pred.json"), "w") as f:
        json.dump(pred, f, indent=2)
    draw_boxes(frame, merged["boxes"], merged["phrases"], merged["scores"]).save(
        os.path.join(args.output_dir, "pred.jpg"))
    print(f"{len(merged['boxes'])} detections from {len(crop_boxes)} crops -> {args.output_dir}")
    return pred


if __name__ == "__main__":
    main(get_args_parser().parse_args())
