"""Training entry point of the port (the training branch of the JAX package's
main.py; reference main.py CLI surface).

    python -m open_groundingdino_tpu_torch.main -c CFG --datasets MANIFEST \\
        --output_dir OUT --vocab VOCAB [--max_steps N] [--device cuda] \\
        [--pretrain_model_path ckpt.pth] [--options key=value ...]

MANIFEST is the JAX package's datasets.json shape; the train split's
entries must be ODVG:
    {"train": [{"root": ..., "anno": ..., "label_map": ..., "dataset_mode": "odvg"}]}

Each epoch appends one JSON line of training stats to OUT/log.txt, as the
JAX package's main.py does.  Evaluation, checkpoint saving and resuming are
not ported yet (ROADMAP.md).  The model trains on CUDA unless --device says
otherwise.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import Dict


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("GroundingDINO port: training", add_help=False)
    p.add_argument("--config_file", "-c", type=str, required=True)
    p.add_argument("--options", nargs="+", default=None,
                   help="override config keys: key=value ...")
    p.add_argument("--datasets", type=str, required=True, help="dataset manifest json")
    p.add_argument("--output_dir", default="output")
    p.add_argument("--vocab", required=True, help="bert vocab.txt path")
    p.add_argument("--pretrain_model_path", default="",
                   help="reference-keyed .pth to initialize from (default: seeded random init)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num_workers", type=int, default=2,
                   help="loader threads (0: collate in the training thread)")
    p.add_argument("--max_steps", type=int, default=None,
                   help="stop each epoch after this many steps")
    p.add_argument("--print_freq", type=int, default=50)
    return p


def setup_logger(output_dir: str) -> logging.Logger:
    logger = logging.getLogger("ogd_torch")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("[%(asctime)s] %(message)s", "%m/%d %H:%M:%S")
    for h in (logging.StreamHandler(sys.stdout),
              logging.FileHandler(os.path.join(output_dir, "info.txt"))):
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


def build_train_dataset(manifest: Dict, args):
    from .data.odvg import ConcatDataset, ODVGDataset
    from .data.transforms import TrainTransform

    tf = TrainTransform(scales=args.data_aug_scales, max_size=args.data_aug_max_size,
                        scales2_resize=args.data_aug_scales2_resize,
                        scales2_crop=args.data_aug_scales2_crop)
    parts = []
    for entry in manifest["train"]:
        mode = entry.get("dataset_mode", "coco")
        if mode != "odvg":
            raise ValueError(f"dataset_mode {mode!r}: the port trains on ODVG only so far")
        parts.append(ODVGDataset(entry["root"], entry["anno"], entry.get("label_map"),
                                 max_labels=args.max_labels, transform=tf))
    return parts[0] if len(parts) == 1 else ConcatDataset(parts)


def main(cli) -> Dict:
    """Train; returns {"state", "train_step", "loader", "records"} (the
    per-step metrics and host seconds of the run)."""
    import torch

    from .config import SLConfig
    from .config.slconfig import parse_override_value
    from .data.loader import Collator, DataLoader
    from .data.tokenization import build_tokenizer
    from .engine import train_one_epoch
    from .inference import load_reference_state_dict
    from .models.criterion import build_criterion
    from .models.groundingdino import build_groundingdino, init_weights_
    from .parallel.optim import make_lr_schedule, make_optimizer
    from .parallel.train_state import TrainState, make_train_step

    args = SLConfig.fromfile(cli.config_file)
    if cli.options:
        args.merge_from_dict({kv.split("=", 1)[0]: parse_override_value(kv.split("=", 1)[1])
                              for kv in cli.options})
    for key in ("epochs", "batch_size", "num_queries", "max_text_len", "max_gt_boxes"):
        int(args.get(key))
    for key in ("lr", "lr_backbone", "weight_decay", "clip_max_norm"):
        float(args.get(key))
    train_step = make_train_step(
        build_criterion(args), compute_dtype=args.compute_dtype,
        ema_decay=float(args.get("ema_decay", 0.9997)) if args.get("use_ema", False) else 0.0)

    os.makedirs(cli.output_dir, exist_ok=True)
    args.dump(os.path.join(cli.output_dir, "config_cfg.py"))
    logger = setup_logger(cli.output_dir)
    device = torch.device(cli.device)
    logger.info(f"device: {device}"
                + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    logger.info(f"config: {cli.config_file} output: {cli.output_dir}")

    tokenizer = build_tokenizer(cli.vocab)
    with open(cli.datasets) as f:
        manifest = json.load(f)
    dataset = build_train_dataset(manifest, args)
    collator = Collator(tokenizer, args.image_buckets, int(args.max_text_len),
                        int(args.max_gt_boxes), u8_images=bool(args.get("u8_images", False)))
    loader = DataLoader(dataset, collator, batch_size=int(args.batch_size), shuffle=True,
                        seed=cli.seed, num_threads=cli.num_workers)

    model = build_groundingdino(args, device="cpu")
    if cli.pretrain_model_path:
        load_reference_state_dict(model, cli.pretrain_model_path)
        logger.info(f"loaded {cli.pretrain_model_path}")
    else:
        init_weights_(model, cli.seed)
    model = model.to(device).train()

    steps_per_epoch = max(len(loader), 1)
    optimizer = make_optimizer(
        model, lr=make_lr_schedule(args, steps_per_epoch), base_lr=float(args.lr),
        lr_backbone=float(args.lr_backbone), lr_linear_proj_mult=float(args.lr_linear_proj_mult),
        weight_decay=float(args.weight_decay), clip_max_norm=float(args.clip_max_norm),
        frozen_keys=tuple(args.freeze_keywords or ()))
    state = TrainState.create(model, optimizer, seed=cli.seed,
                              use_ema=bool(args.get("use_ema", False)))

    records = []
    for epoch in range(int(args.epochs)):
        loader.set_epoch(epoch)
        t0 = time.time()
        state, stats = train_one_epoch(train_step, state, loader, epoch, logger,
                                       print_freq=cli.print_freq, max_steps=cli.max_steps,
                                       step_records=records)
        logger.info(f"epoch {epoch} train stats: {stats} ({time.time() - t0:.1f}s)")
        with open(os.path.join(cli.output_dir, "log.txt"), "a") as f:
            f.write(json.dumps({"epoch": epoch, **stats}) + "\n")
    return {"state": state, "train_step": train_step, "loader": loader, "records": records}


if __name__ == "__main__":
    parser = argparse.ArgumentParser("GroundingDINO port: training", parents=[get_args_parser()])
    main(parser.parse_args())
