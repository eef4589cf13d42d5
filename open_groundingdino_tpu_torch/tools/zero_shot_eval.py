"""One command from (checkpoint, vocab, val images, annotations) to the 12
COCO numbers: the port's zero-shot COCO eval runbook (the JAX package's
tools/zero_shot_eval.py, plus --device).

    python -m open_groundingdino_tpu_torch.tools.zero_shot_eval \\
        --checkpoint groundingdino_swint_ogc.pth \\
        --vocab vocab.txt \\
        --images /data/coco/val2017 \\
        --annotations /data/coco/annotations/instances_val2017.json \\
        [--config open_groundingdino_tpu_torch/config/cfg_coco.py] \\
        [--output_dir out_zeroshot] [--options key=value ...] [--debug] \\
        [--device cuda]

--vocab is a bert-base-uncased vocab.txt, or a directory holding roberta-base's
vocab.json + merges.txt (with a roberta-base config).  The tool writes the
val manifest OUT/datasets_val.json, runs the port's `main --eval` on it
(--debug: the first 15 batches), and prints the pycocotools-shaped 12-line
summary and then the stats as one JSON line (OUT/eval_stats.json holds
them too).  The checkpoint is a reference-keyed .pth.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the pycocotools 12-line summary (eval/coco_eval.py summarize's keys)
SUMMARY_ROWS = (
    ("Average Precision  (AP) @[ IoU=0.50:0.95 | area=   all | maxDets=100 ]", "AP"),
    ("Average Precision  (AP) @[ IoU=0.50      | area=   all | maxDets=100 ]", "AP50"),
    ("Average Precision  (AP) @[ IoU=0.75      | area=   all | maxDets=100 ]", "AP75"),
    ("Average Precision  (AP) @[ IoU=0.50:0.95 | area= small | maxDets=100 ]", "APs"),
    ("Average Precision  (AP) @[ IoU=0.50:0.95 | area=medium | maxDets=100 ]", "APm"),
    ("Average Precision  (AP) @[ IoU=0.50:0.95 | area= large | maxDets=100 ]", "APl"),
    ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets=  1 ]", "AR1"),
    ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets= 10 ]", "AR10"),
    ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets=100 ]", "AR100"),
    ("Average Recall     (AR) @[ IoU=0.50:0.95 | area= small | maxDets=100 ]", "ARs"),
    ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=medium | maxDets=100 ]", "ARm"),
    ("Average Recall     (AR) @[ IoU=0.50:0.95 | area= large | maxDets=100 ]", "ARl"),
)


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("zero_shot_eval")
    p.add_argument("--checkpoint", required=True, help="reference-keyed .pth")
    p.add_argument("--vocab", required=True,
                   help="bert-base vocab.txt, or a roberta-base vocab.json + merges.txt directory")
    p.add_argument("--images", required=True, help="val2017 image root")
    p.add_argument("--annotations", required=True, help="instances_val2017.json")
    p.add_argument("--config", default=os.path.join(PKG_DIR, "config", "cfg_coco.py"))
    p.add_argument("--output_dir", default="out_zeroshot")
    p.add_argument("--options", nargs="+", default=None, help="config overrides: key=value ...")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--debug", action="store_true", help="stop after 15 batches (a smoke)")
    p.add_argument("--device", default="cuda")
    return p


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Runs the eval and prints the summary; returns the 12 stats."""
    from .. import main as main_mod

    a = get_args_parser().parse_args(argv)
    os.makedirs(a.output_dir, exist_ok=True)
    manifest = {"val": [{"root": os.path.abspath(a.images),
                         "anno": os.path.abspath(a.annotations), "dataset_mode": "coco"}]}
    manifest_path = os.path.join(a.output_dir, "datasets_val.json")
    with open(manifest_path, "w") as f:
        json.dump(manifest, f, indent=2)

    cli = main_mod.get_args_parser().parse_args([
        "-c", a.config, "--datasets", manifest_path, "--output_dir", a.output_dir,
        "--vocab", a.vocab, "--pretrain_model_path", a.checkpoint, "--eval",
        "--num_workers", str(a.num_workers), "--device", a.device,
    ] + (["--debug"] if a.debug else []) + (["--options"] + a.options if a.options else []))
    main_mod.main(cli)

    with open(os.path.join(a.output_dir, "eval_stats.json")) as f:
        stats = json.load(f)
    for label, key in SUMMARY_ROWS:
        print(f" {label} = {stats[key]:.3f}")
    print(json.dumps(stats), flush=True)
    return stats


if __name__ == "__main__":
    main()
