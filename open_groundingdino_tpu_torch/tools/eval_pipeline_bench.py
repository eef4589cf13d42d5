"""End-to-end eval-pipeline throughput (the JAX package's
tools/eval_pipeline_bench.py, plus --device).

Measures the whole eval surface: JPEG decode + resize (loader threads) ->
Collator bucket-pad + tokenize -> the eval step (make_eval_step) ->
PostProcess (device top-k + host NMS) -> the COCO evaluator, on synthetic
COCO-sized data with the real 80-category caption, and prints the
pipeline's images/s beside the raw eval step's on the same batch shape, so
that the overlap of engine.evaluate_coco's one-deep pipeline (host work
behind the card's) is a measured number.

    python -m open_groundingdino_tpu_torch.tools.eval_pipeline_bench            # flagship, card
    python -m open_groundingdino_tpu_torch.tools.eval_pipeline_bench --nano --images 8 --device cpu

Output: ONE JSON line {"pipeline_img_s", "raw_fwd_img_s", "ratio", ...};
ratio >= ~0.9 means the pipeline is bound by the card.  The weights are a
seeded random init.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Dict, Optional

import numpy as np

from .benchmark import DEFAULT_CONFIG, build_model, platform, sync

COCO_CATS = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
]
# the JAX package's DataLoader's threads, which its tool keeps
LOADER_THREADS = 4
# the JAX tool's --nano geometry
NANO = dict(backbone="swin_nano_test", hidden_dim=32, nheads=4, enc_layers=1, dec_layers=2,
            dim_feedforward=64, num_queries=12, max_text_len=48, bert_vocab_size=256,
            bert_hidden_size=32, bert_layers=1, bert_heads=4, bert_intermediate=32,
            num_select=10, use_checkpoint=False, use_transformer_ckpt=False,
            image_buckets=[(64, 96), (96, 96)], eval_shortest_edge=64, eval_max_size=96)


def make_vocab(cats):
    """Minimal WordPiece vocab covering the caption built from `cats`."""
    words = set()
    for c in cats:
        words.update(c.lower().split())
    return ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "."] + sorted(words)


def build_workspace(root, n_images, size_hw, cats, seed=0):
    """Synthetic COCO val: real JPEG files (decode cost is real), random
    boxes, category ids cycling through the list (the JAX tool's files,
    byte for byte)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    H, W = size_hw
    images, anns = [], []
    for i in range(n_images):
        arr = rng.randint(0, 255, (H, W, 3), np.uint8)
        Image.fromarray(arr).save(os.path.join(root, "images", f"img_{i}.jpg"), quality=90)
        images.append({"id": i, "file_name": f"images/img_{i}.jpg", "width": W, "height": H})
        for j in range(4):
            x, y = rng.randint(0, W // 2), rng.randint(0, H // 2)
            w, h = rng.randint(20, W // 2), rng.randint(20, H // 2)
            anns.append({"id": len(anns) + 1, "image_id": i,
                         "category_id": (i * 4 + j) % len(cats) + 1,
                         "bbox": [int(x), int(y), int(w), int(h)],
                         "area": int(w * h), "iscrowd": 0})
    coco = {"images": images,
            "categories": [{"id": i + 1, "name": c} for i, c in enumerate(cats)],
            "annotations": anns}
    with open(os.path.join(root, "coco.json"), "w") as f:
        json.dump(coco, f)
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(make_vocab(cats)) + "\n")
    return root


def get_args_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("eval_pipeline_bench")
    ap.add_argument("-c", "--config", default=DEFAULT_CONFIG)
    ap.add_argument("--images", type=int, default=64)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--img_size", default="750x1000",
                    help="source HxW; the eval resize maps it into a bucket")
    ap.add_argument("--nano", action="store_true", help="nano model + tiny images (CPU smoke)")
    ap.add_argument("--workspace", default=None)
    ap.add_argument("--fwd_iters", type=int, default=10)
    ap.add_argument("--u8", action="store_true",
                    help="ship uint8 images, normalize on the device (3 B/px host->device "
                         "instead of 12)")
    ap.add_argument("--device_resident", action="store_true",
                    help="stage every batch on the device before timing: the pipeline's "
                         "ceiling without the decode, collate and copy")
    ap.add_argument("--device", default="cuda")
    return ap


def run(cli, cfg=None) -> Dict:
    """The benchmark of parsed `cli`; `cfg` stands in for --config.  Returns
    the line it prints."""
    import torch

    from ..config import SLConfig
    from ..data.loader import Collator, DataLoader
    from ..data.tokenization import build_tokenizer
    from ..engine import evaluate_coco
    from ..main import build_datasets
    from ..models.postprocess import PostProcess
    from ..parallel.train_state import (MODEL_INPUT_KEYS, cast_floating, make_eval_step,
                                        resolve_compute_dtype, to_device)

    args = cfg if cfg is not None else SLConfig.fromfile(cli.config)
    cats, img_size = COCO_CATS, cli.img_size
    if cli.nano:
        for k, v in NANO.items():
            setattr(args, k, v)
        cats, img_size = COCO_CATS[:6], "80x110"
    H, W = (int(x) for x in img_size.split("x"))
    device = torch.device(cli.device)
    ws = cli.workspace or tempfile.mkdtemp(prefix="evalbench_")
    try:
        build_workspace(ws, cli.images, (H, W), cats)
        manifest = {"val": [{"root": ws, "anno": os.path.join(ws, "coco.json"),
                             "dataset_mode": "coco"}]}
        tokenizer = build_tokenizer(os.path.join(ws, "vocab.txt"))
        val_dataset = build_datasets(manifest, "val", args, tokenizer)
        collator = Collator(tokenizer, args.image_buckets, max_text_len=int(args.max_text_len),
                            max_gt=int(getattr(args, "max_gt_boxes", 128)), u8_images=cli.u8)
        model = build_model(args, device)
        compute_dtype = str(getattr(args, "compute_dtype", "bfloat16"))
        eval_step = make_eval_step(model, compute_dtype=compute_dtype)
        postprocessor = PostProcess(tokenizer, list(val_dataset.cat_list),
                                    num_select=int(args.num_select),
                                    max_text_len=int(args.max_text_len),
                                    nms_iou_threshold=float(args.nms_iou_threshold))
        params = dict(model.named_parameters())
        dtype = resolve_compute_dtype(compute_dtype)

        # ---- the raw eval step on the first batch, a host fetch each call
        first = next(iter(DataLoader(val_dataset, collator, batch_size=cli.batch)))
        cast = params
        if dtype is not None:
            with torch.no_grad():
                cast = cast_floating(params, dtype)   # once, as evaluate_coco does
        eval_step(first, cast)["pred_boxes"].cpu()   # warm-up
        t0 = time.perf_counter()
        for _ in range(cli.fwd_iters):
            eval_step(first, cast)["pred_boxes"].cpu()
        raw_dt = (time.perf_counter() - t0) / max(cli.fwd_iters, 1)
        raw_ips = cli.batch / raw_dt

        # ---- the whole pipeline on a fresh loader
        loader = DataLoader(val_dataset, collator, batch_size=cli.batch,
                            num_threads=LOADER_THREADS)
        if cli.device_resident:
            # decode, collate and copy before the clock starts: the timed loop
            # is the eval step, the postprocess and the evaluator only
            loader = [dict(b, **to_device(b, device, MODEL_INPUT_KEYS)) for b in loader]
            sync(device)
        t0 = time.perf_counter()
        evaluate_coco(eval_step, params, loader, postprocessor, val_dataset.coco,
                      val_dataset.contiguous_to_catid, logger=None, precast_dtype=dtype)
        pipe_ips = cli.images / (time.perf_counter() - t0)
    finally:
        if cli.workspace is None:
            shutil.rmtree(ws, ignore_errors=True)

    line = {
        "metric": ("eval pipeline images/sec (nano, cpu)" if cli.nano
                   else f"eval pipeline images/sec ({args.backbone})"),
        "pipeline_img_s": round(pipe_ips, 3),
        "raw_fwd_img_s": round(raw_ips, 3),
        "ratio": round(pipe_ips / raw_ips, 3),
        "images": cli.images,
        "batch": cli.batch,
        "device_resident": bool(cli.device_resident),
        "platform": platform(device),
    }
    print(json.dumps(line), flush=True)
    return line


def main(argv: Optional[list] = None) -> Dict:
    return run(get_args_parser().parse_args(argv))


if __name__ == "__main__":
    main()
