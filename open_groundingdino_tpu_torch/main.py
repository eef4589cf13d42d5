"""Training and evaluation entry point of the port (the JAX package's
main.py; reference main.py CLI surface).

    python -m open_groundingdino_tpu_torch.main -c CFG --datasets MANIFEST \\
        --output_dir OUT --vocab VOCAB [--eval] [--resume ckpt.pth] \\
        [--pretrain_model_path ckpt.pth] [--finetune_ignore KW ...] \\
        [--frozen_weights ckpt.pth] [--max_steps N] [--debug] [--stage_dir DIR] \\
        [--device cuda] [--dist_backend nccl|gloo] [--options key=value ...]

    torchrun --nproc_per_node N -m open_groundingdino_tpu_torch.main ...

On N processes (torchrun, or SLURM's SLURM_PROCID / SLURM_NTASKS /
SLURM_LOCALID with MASTER_ADDR / MASTER_PORT set; parallel/dist.py) each rank
runs on cuda:LOCAL_RANK (or the device --device names with an index) over
NCCL (gloo for --device cpu, or as --dist_backend says), with batch_size
images a rank: the global batch is N x batch_size, and a step gives the
update one process would give on it.  Rank 0 alone writes config_cfg.py,
the checkpoints, best/, best_ema/, log.txt and eval_stats.json; every rank
writes info.txt and resumes from the same checkpoint.  Without those
variables main runs one process, as it always has.

MANIFEST is the JAX package's datasets.json shape; each split lists COCO or
ODVG entries:
    {"train": [{"root": ..., "anno": ..., "label_map": ..., "dataset_mode": "odvg"}],
     "val":   [{"root": ..., "anno": ..., "dataset_mode": "coco"}]}

--eval evaluates the val split (COCO bbox mAP) and writes OUT/eval_stats.json.
Training resumes from --resume, or else from the newest OUT/checkpoint_N.pth,
at epoch N + 1; it saves OUT/checkpoint_{epoch}.pth every
save_checkpoint_interval epochs and at the last; after each epoch it
evaluates the model, and its EMA under use_ema, keeps the best in OUT/best/
and OUT/best_ema/, and appends one JSON line to OUT/log.txt.  Unlike the JAX
package's main, a manifest without a "val" split trains without evaluating.
Evaluation runs in the config's compute_dtype (bf16 by default, as the JAX
package's), on every msda_kernel.  The model runs on CUDA unless --device
says otherwise.  VOCAB is a bert-base-uncased vocab.txt, or a roberta-base
directory (vocab.json + merges.txt) for a config with text_encoder_type
"roberta-base" and its geometry (data/tokenization.build_tokenizer).
--debug stops each epoch and each evaluation after 15 batches (the JAX
package's), --max_steps after N optimizer steps (the smaller of the two when
both are given).  A training step reads nothing back to the host; the loop
reads its metrics every --print_freq steps (engine.train_one_epoch), and the
config's steps_per_call = N > 1 runs chunks of N same-shape batches a call
(the JAX package's main.py:353-375).
--stage_dir copies the manifest's datasets there first (data/staging.py; zips
are extracted), runs on the copies and removes them when main returns.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Dict

# what --frozen_weights freezes on top of freeze_keywords: every part a
# pretrained checkpoint provides, so only the heads train (the JAX package's
# main.py:285-292, reference main.py:338-341)
FROZEN_WEIGHTS_KEYS = ("backbone", "bert", "transformer", "feat_map", "input_proj")
DEBUG_STEPS = 15   # --debug: batches an epoch and an evaluation (the JAX package's main.py:183)


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("GroundingDINO port: training and eval", add_help=False)
    p.add_argument("--config_file", "-c", type=str, required=True)
    p.add_argument("--options", nargs="+", default=None,
                   help="override config keys: key=value ...")
    p.add_argument("--datasets", type=str, required=True, help="dataset manifest json")
    p.add_argument("--output_dir", default="output")
    p.add_argument("--eval", action="store_true",
                   help="evaluate the val split and write eval_stats.json, in the config's "
                        "compute_dtype (bf16 by default)")
    p.add_argument("--resume", default="",
                   help="checkpoint_N.pth to resume from (default: the newest in output_dir)")
    p.add_argument("--vocab", required=True,
                   help="bert vocab.txt, or a directory with roberta-base's vocab.json + "
                        "merges.txt")
    p.add_argument("--pretrain_model_path", default="",
                   help="reference-keyed .pth to initialize from (default: seeded random init)")
    p.add_argument("--finetune_ignore", type=str, nargs="+", default=None,
                   help="pretrain keys containing any of these keywords keep their fresh init "
                        "(reference main.py:343-358, e.g. label_enc.weight class_embed)")
    p.add_argument("--frozen_weights", type=str, default=None,
                   help="checkpoint loaded as a pretrain whose parts (backbone, bert, "
                        "transformer, feat_map, input_proj) are then frozen")
    p.add_argument("--device", default="cuda",
                   help="cuda (on N processes cuda:LOCAL_RANK), cuda:I, or cpu")
    p.add_argument("--dist_backend", default=None,
                   help="torch.distributed backend on N processes (default: nccl for cuda, "
                        "gloo for cpu; two ranks on one GPU need gloo)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num_workers", type=int, default=2,
                   help="loader threads (0: collate in the calling thread)")
    p.add_argument("--max_steps", type=int, default=None,
                   help="stop each epoch (and each evaluation) after this many batches")
    p.add_argument("--debug", action="store_true",
                   help=f"stop each epoch and each evaluation after {DEBUG_STEPS} batches")
    p.add_argument("--stage_dir", default="",
                   help="copy the manifest's datasets to this local directory first (zips are "
                        "extracted) and remove the copies at the end (reference "
                        "datasets/data_util.py preparing_dataset)")
    p.add_argument("--print_freq", type=int, default=50)
    return p


def build_datasets(manifest: Dict, split: str, args, tokenizer=None):
    """The `split` entries of the manifest ("train": TrainTransform, else
    EvalTransform), COCO or ODVG, concatenated when there are several (the
    JAX package's main.build_datasets; the tokenizer is not used)."""
    from .data.coco import CocoDetection
    from .data.odvg import ConcatDataset, ODVGDataset
    from .data.transforms import EvalTransform, TrainTransform

    if split == "train":
        tf = TrainTransform(scales=args.data_aug_scales, max_size=args.data_aug_max_size,
                            scales2_resize=args.data_aug_scales2_resize,
                            scales2_crop=args.data_aug_scales2_crop)
    else:
        tf = EvalTransform(args.eval_shortest_edge, args.eval_max_size)
    parts = []
    for entry in manifest[split]:
        mode = entry.get("dataset_mode", "coco")
        if mode == "coco":
            parts.append(CocoDetection(entry["root"], entry["anno"], transform=tf))
        elif mode == "odvg":
            parts.append(ODVGDataset(entry["root"], entry["anno"], entry.get("label_map"),
                                     max_labels=args.max_labels, transform=tf))
        else:
            raise ValueError(f"unknown dataset_mode {mode!r}")
    return parts[0] if len(parts) == 1 else ConcatDataset(parts)


def main(cli) -> Dict:
    """Evaluate (--eval) or train.  Returns, after --eval, {"stats", "model",
    "run_eval"} (run_eval(params, max_steps, use_native) evaluates again);
    after training {"state", "train_step", "multi_step" (None unless
    steps_per_call > 1), "loader", "records" (the per-step metrics and host
    seconds, engine.train_one_epoch's step_records), "eval" (each epoch's eval stats), "best",
    "run_eval" (None without a val split)}.  On N processes it joins the
    group the environment describes, or the one its caller already joined.
    With --stage_dir the staged copies are gone when it returns."""
    from .config import SLConfig
    from .config.slconfig import parse_override_value
    from .data.staging import cleanup_staged, stage_datasets_for_node
    from .parallel import dist
    from .parallel.train_state import resolve_compute_dtype
    from .utils.logger import setup_logger

    # the process group first (the JAX package's jax.distributed.initialize);
    # main leaves a group it made, and keeps one its caller made
    own_group = not dist.is_initialized()
    info = dist.init_distributed(cli.device, cli.dist_backend)
    copyfilelist = []
    try:
        args = SLConfig.fromfile(cli.config_file)
        if cli.options:
            args.merge_from_dict({kv.split("=", 1)[0]: parse_override_value(kv.split("=", 1)[1])
                                  for kv in cli.options})
        for key in ("epochs", "batch_size", "num_queries", "max_text_len", "max_gt_boxes",
                    "save_checkpoint_interval"):
            int(args.get(key))
        for key in ("lr", "lr_backbone", "weight_decay", "clip_max_norm"):
            float(args.get(key))
        compute_dtype = resolve_compute_dtype(args.compute_dtype)
        logger = setup_logger(cli.output_dir, process_index=info.rank)
        with open(cli.datasets) as f:
            manifest = json.load(f)
        if cli.stage_dir:
            manifest, copyfilelist = stage_datasets_for_node(manifest, cli.stage_dir,
                                                             info.local_rank)
            logger.info(f"staged {len(copyfilelist)} dataset paths to {cli.stage_dir}")
        out = _run(cli, info, args, compute_dtype, manifest, logger)
        dist.barrier()   # no rank removes staged copies another still reads
        return out
    finally:
        cleanup_staged(copyfilelist)
        if own_group:
            dist.cleanup()


def _run(cli, info, args, compute_dtype, manifest: Dict, logger: logging.Logger) -> Dict:
    import torch

    from .data.loader import Collator, DataLoader
    from .data.tokenization import build_tokenizer
    from .engine import evaluate_coco, train_one_epoch
    from .inference import load_reference_state_dict
    from .models.criterion import build_criterion
    from .models.groundingdino import build_groundingdino, init_weights_
    from .models.postprocess import PostProcess
    from .models.resnet import ResNetConfig
    from .models.resnet import frozen_param_keys as resnet_frozen_keys
    from .parallel import dist
    from .parallel.optim import make_lr_schedule, make_optimizer
    from .parallel.train_state import (TrainState, make_eval_step, make_multi_train_step,
                                       make_train_step)
    from .utils import checkpoint as ckpt
    from .utils.ema import BestMetricHolder

    use_ema = bool(args.get("use_ema", False))
    max_steps = cli.max_steps
    if cli.debug:
        max_steps = DEBUG_STEPS if max_steps is None else min(max_steps, DEBUG_STEPS)

    main_process = info.rank == 0
    if main_process:
        args.dump(os.path.join(cli.output_dir, "config_cfg.py"))
    device = info.device
    logger.info(f"device: {device}"
                + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
                + (f", rank {info.rank} of {info.world_size} ({dist.tdist.get_backend()})"
                   if dist.is_initialized() else ""))
    logger.info(f"config: {cli.config_file} output: {cli.output_dir}")

    tokenizer = build_tokenizer(cli.vocab)
    collator = Collator(tokenizer, args.image_buckets, int(args.max_text_len),
                        int(args.max_gt_boxes), u8_images=bool(args.get("u8_images", False)))
    batch_size = int(args.batch_size)   # a rank's: the global batch is world_size x this
    shard = dict(process_index=info.rank, process_count=info.world_size)

    model = build_groundingdino(args, device="cpu")
    pretrain_path = cli.frozen_weights or cli.pretrain_model_path
    if pretrain_path:
        if cli.finetune_ignore:
            init_weights_(model, cli.seed)   # the fresh init the ignored keys keep
            logger.info(f"finetune_ignore: {cli.finetune_ignore}")
        load_reference_state_dict(model, pretrain_path, ignore=tuple(cli.finetune_ignore or ()))
        logger.info(f"loaded {pretrain_path}")
    else:
        init_weights_(model, cli.seed)
    model = model.to(device)
    # every rank starts from the same weights (the seeded init, or the file)
    dist.check_replicas(list(model.state_dict().values()), "the initial parameters")

    # ---- eval: the val split, when the manifest has one ----------------------
    run_eval = None
    if manifest.get("val"):
        val_dataset = build_datasets(manifest, "val", args, tokenizer)
        if not hasattr(val_dataset, "coco"):
            raise ValueError("the val split must be one COCO-format dataset (dataset_mode coco)")
        postprocessor = PostProcess(
            tokenizer, getattr(val_dataset, "cat_list", None) or args.label_list,
            num_select=int(args.num_select), max_text_len=int(args.max_text_len),
            nms_iou_threshold=float(args.nms_iou_threshold))
        eval_loader = DataLoader(val_dataset, collator, batch_size=batch_size,
                                 num_threads=cli.num_workers, **shard)
        # no criterion: its host matching would wait for every batch's
        # forward and undo the pipelining (the JAX package's runs on device)
        eval_step = make_eval_step(model, compute_dtype=compute_dtype)

        def run_eval(params, max_steps=max_steps, use_native=True):
            return evaluate_coco(eval_step, params, eval_loader, postprocessor, val_dataset.coco,
                                 val_dataset.contiguous_to_catid, logger,
                                 print_freq=cli.print_freq, max_steps=max_steps,
                                 precast_dtype=compute_dtype, use_native=use_native)

    if cli.eval:
        if run_eval is None:
            raise SystemExit("--eval needs a 'val' split in the dataset manifest")
        stats = run_eval(dict(model.named_parameters()))
        if main_process:
            with open(os.path.join(cli.output_dir, "eval_stats.json"), "w") as f:
                json.dump(stats, f, indent=2)
        return {"stats": stats, "model": model, "run_eval": run_eval}

    # ---- train ---------------------------------------------------------------
    step_kwargs = dict(compute_dtype=compute_dtype,
                       ema_decay=float(args.get("ema_decay", 0.9997)) if use_ema else 0.0)
    criterion = build_criterion(args)
    train_step = make_train_step(criterion, **step_kwargs)
    # steps_per_call > 1: chunks of that many same-shape batches a call,
    # with no host read between their steps (the JAX package's main.py:353-375)
    steps_per_call = int(args.get("steps_per_call", 1))
    multi_step = (make_multi_train_step(criterion, steps_per_call, **step_kwargs)
                  if steps_per_call > 1 else None)
    dataset = build_datasets(manifest, "train", args, tokenizer)
    loader = DataLoader(dataset, collator, batch_size=batch_size, shuffle=True,
                        seed=cli.seed, num_threads=cli.num_workers, **shard)
    steps_per_epoch = max(len(loader), 1)
    frozen_keys = tuple(args.freeze_keywords or ())
    if isinstance(model.backbone_cfg, ResNetConfig):
        # the reference's requires_grad policy (backbone.py:82-89): the stem and
        # layer1 always, the whole trunk at lr_backbone 0; the FrozenBN
        # statistics are buffers and never reach the optimizer
        trunk = resnet_frozen_keys(float(args.lr_backbone) > 0)
        frozen_keys += trunk
        logger.info(f"ResNet backbone: {trunk} frozen")
    if cli.frozen_weights:
        frozen_keys += FROZEN_WEIGHTS_KEYS
        logger.info(f"frozen_weights: {FROZEN_WEIGHTS_KEYS} frozen")
    optimizer = make_optimizer(
        model, lr=make_lr_schedule(args, steps_per_epoch), base_lr=float(args.lr),
        lr_backbone=float(args.lr_backbone), lr_linear_proj_mult=float(args.lr_linear_proj_mult),
        weight_decay=float(args.weight_decay), clip_max_norm=float(args.clip_max_norm),
        frozen_keys=frozen_keys)
    state = TrainState.create(model, optimizer, seed=cli.seed, use_ema=use_ema)

    start_epoch = 0
    resume_path = cli.resume or ckpt.latest_checkpoint(cli.output_dir)
    if resume_path:
        restored = ckpt.restore_checkpoint(resume_path)
        state.load_state_dict(restored)
        start_epoch = int(restored["epoch"]) + 1
        logger.info(f"resumed from {resume_path} at epoch {start_epoch}")

    on_disk = {}   # the (epoch, step) of the last state written, and its file

    def save(ckpt_dir: str, epoch: int, tag: int) -> None:
        """Rank 0 writes; every rank waits for the file.  The state just
        written (best/ of the epoch's checkpoint) is linked, not written
        again."""
        if main_process:
            if on_disk.get("at") == (epoch, state.step):
                ckpt.link_checkpoint(on_disk["path"], ckpt_dir, tag)
            else:
                on_disk["at"] = (epoch, state.step)
                on_disk["path"] = ckpt.save_checkpoint(ckpt_dir, tag,
                                                       {**state.state_dict(), "epoch": epoch})
        dist.barrier()

    best = BestMetricHolder(use_ema=use_ema)
    records, evals = [], []
    epochs = int(args.epochs)
    for epoch in range(start_epoch, epochs):
        loader.set_epoch(epoch)
        t0 = time.time()
        state, stats = train_one_epoch(train_step, state, loader, epoch, logger,
                                       print_freq=cli.print_freq, max_steps=max_steps,
                                       step_records=records, multi_step=multi_step,
                                       steps_per_call=steps_per_call)
        logger.info(f"epoch {epoch} train stats: {stats} ({time.time() - t0:.1f}s)")
        if (epoch + 1) % int(args.save_checkpoint_interval) == 0 or epoch == epochs - 1:
            save(cli.output_dir, epoch, epoch)

        eval_stats, ema_stats = {}, {}
        if run_eval is not None:
            eval_stats = run_eval(dict(model.named_parameters()))
            if best.update(float(eval_stats.get("AP", -1.0)), epoch):
                save(os.path.join(cli.output_dir, "best"), epoch, 0)
                logger.info(f"new best AP {best.best_all:.4f} at epoch {epoch}")
            if state.ema is not None:
                # the second pass, on the EMA weights (reference main.py:481-494)
                ema_raw = run_eval(dict(zip(optimizer.names, state.ema)))
                ema_stats = {f"ema_{k}": v for k, v in ema_raw.items()}
                if best.update(float(ema_raw.get("AP", -1.0)), epoch, is_ema=True):
                    save(os.path.join(cli.output_dir, "best_ema"), epoch, 0)
                    logger.info(f"new best EMA AP {best.best_ema:.4f}")
            evals.append({**eval_stats, **ema_stats})
        line = {"epoch": epoch, **stats, **eval_stats, **ema_stats}
        if run_eval is not None:
            line["best_AP"] = best.best_all
        if main_process:
            with open(os.path.join(cli.output_dir, "log.txt"), "a") as f:
                f.write(json.dumps(line) + "\n")
    return {"state": state, "train_step": train_step, "multi_step": multi_step,
            "loader": loader, "records": records,
            "eval": evals, "best": best.summary(), "run_eval": run_eval}


if __name__ == "__main__":
    parser = argparse.ArgumentParser("GroundingDINO port: training and eval",
                                     parents=[get_args_parser()])
    main(parser.parse_args())
