"""FLOPs / latency / FPS of the port's forward, or with --train of its
training step (the JAX package's tools/benchmark.py, plus --device).

    python -m open_groundingdino_tpu_torch.tools.benchmark -c CONFIG -o out \\
        [--height 800 --width 1216] [--batch 1] [--train [--compute_dtype bfloat16] \\
        [--steps_per_call N]] [--device cuda]

FLOPs come from `torch.utils.flop_counter.FlopCounterMode` over one call on
the timed inputs (the JAX tool reads XLA's cost analysis of the compiled
program): PyTorch's formulas for its own operators and the ogd_torch ops'
registered formulas (ops/library.py) for the hand-written kernels, K1 and K2
in a forward, K3 and K4 too in a training step (a multi-step call's count
over its steps).  Times are the host clock
over `--iters` calls after `--warmup`, closed by a CUDA sync.  Writes the
JSON result to OUTPUT_DIR/flops/log.txt and prints it.  The weights are a
seeded random init; the inputs are the JAX tool's (seeded random image and
token ids; 8 synthetic boxes an image in training).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CONFIG = os.path.join(PKG_DIR, "config", "cfg_coco.py")


def synthetic_inputs(B: int, H: int, W: int, T: int, vocab: int, seed: int = 0
                     ) -> Dict[str, np.ndarray]:
    """The JAX tool's model inputs: a random (B, H, W, 3) image, random token
    ids with [CLS] first and [SEP] at 120, 121 live tokens."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(min(1000, vocab - 1), min(20000, vocab), size=(B, T)).astype(np.int64)
    ids[:, 0] = min(101, vocab - 1)          # [CLS] (101 in the real vocab)
    ids[:, min(120, T - 1)] = min(102, vocab - 1)  # [SEP]
    return dict(
        images=rng.randn(B, H, W, 3).astype(np.float32),
        image_sizes=np.asarray([[H, W]] * B, np.int64),
        input_ids=ids,
        text_token_mask=(np.arange(T)[None] < min(121, T)).repeat(B, 0),
        position_ids=np.tile(np.arange(T, dtype=np.int64)[None], (B, 1)),
        text_self_attention_masks=np.ones((B, T, T), bool),
    )


def synthetic_targets(B: int, G: int, T: int, seed: int = 1) -> Dict[str, np.ndarray]:
    """The JAX tool's padded ground truth: 8 real boxes an image, each
    grounding tokens [1, 8)."""
    rng = np.random.RandomState(seed)
    n_real = 8
    gt_boxes = np.concatenate([rng.uniform(0.2, 0.8, size=(B, G, 2)),
                               rng.uniform(0.05, 0.3, size=(B, G, 2))], -1).astype(np.float32)
    gt_pos_maps = np.zeros((B, G, T), np.float32)
    gt_pos_maps[:, :, 1:8] = 1.0
    return dict(gt_boxes=gt_boxes, gt_pos_maps=gt_pos_maps,
                gt_valid=(np.arange(G)[None] < n_real).repeat(B, 0))


def build_model(cfg, device, seed: int = 0):
    """The config's model with seeded random weights on `device`."""
    from ..models.groundingdino import build_groundingdino, init_weights_

    model = build_groundingdino(cfg, device="cpu")
    init_weights_(model, seed)
    return model.to(device)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def platform(device) -> str:
    """The JAX tool's `platform` key: "gpu" for a CUDA device."""
    import torch

    return "gpu" if torch.device(device).type == "cuda" else torch.device(device).type


def count_flops(fn) -> Dict[str, object]:
    """fn() under FlopCounterMode: {"flops": total, "by_op": {op: flops}}
    (the ogd_torch ops and the rest by PyTorch operator name)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    by_op = {str(op): int(n) for op, n in counter.get_flop_counts().get("Global", {}).items()}
    return {"flops": int(counter.get_total_flops()), "by_op": by_op}


def kernel_flops(by_op: Dict[str, int]) -> Dict[str, int]:
    """The hand-written kernels' share of a count, by op name."""
    return {op.split(".")[-1]: n for op, n in by_op.items() if op.startswith("ogd_torch.")}


def bench_forward(args, cfg, model, inputs, nparam: int) -> Dict:
    import torch

    device = args.device
    t = {k: torch.from_numpy(v).to(device) for k, v in inputs.items()}
    # a forward-only model: FlopCounterMode's module tracker cannot hook a
    # parameter handed to a submodule under no_grad
    model.eval().requires_grad_(False)

    @torch.no_grad()
    def fwd():
        out = model(**t)
        # a scalar checksum of the boxes, as the JAX tool's
        return out["pred_boxes"].float().sum()

    flops = count_flops(fwd)
    for _ in range(args.warmup):
        fwd()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        chk = fwd()
    sync(device)
    float(chk)
    dt = (time.perf_counter() - t0) / max(args.iters, 1)
    return {
        "nparam": nparam,
        "flops_per_forward": flops["flops"],
        "gflops": flops["flops"] / 1e9 if flops["flops"] > 0 else -1,
        "kernel_flops": kernel_flops(flops["by_op"]),
        "time_s": dt,
        "fps": args.batch / dt,
        "shape": [args.batch, args.height, args.width],
        "platform": platform(device),
    }


def bench_train(args, cfg, model, inputs, nparam: int) -> Dict:
    """The port's training step (parallel/train_state.py: forward, Hungarian
    matching on the device, criterion, backward, clip, grouped AdamW) on one
    batch, or with --steps_per_call N > 1 its N-step call
    (make_multi_train_step) on the batch stacked N deep, as the JAX tool
    times it: --iters calls after --warmup, closed by a CUDA sync, the time
    a step the calls' over their steps.  The steps read nothing back, so the
    calls queue behind each other (--loss_curve reads each call's losses)."""
    import torch

    from ..models.criterion import build_criterion
    from ..parallel.optim import make_optimizer
    from ..parallel.train_state import TrainState, make_multi_train_step, make_train_step

    spc = max(args.steps_per_call, 1)
    batch = dict(inputs, **synthetic_targets(args.batch, int(getattr(cfg, "max_gt_boxes", 128)),
                                             int(cfg.max_text_len)))
    optimizer = make_optimizer(
        model, lr=float(cfg.lr), base_lr=float(cfg.lr), lr_backbone=float(cfg.lr_backbone),
        lr_linear_proj_mult=float(getattr(cfg, "lr_linear_proj_mult", 0.1)),
        weight_decay=float(cfg.weight_decay), clip_max_norm=float(cfg.clip_max_norm))
    state = TrainState.create(model, optimizer, seed=0)
    dtype = args.compute_dtype or str(getattr(cfg, "compute_dtype", "float32"))
    if spc > 1:
        step = make_multi_train_step(build_criterion(cfg), spc, compute_dtype=dtype)
        batch = {k: np.broadcast_to(v, (spc,) + v.shape) for k, v in batch.items()}
    else:
        step = make_train_step(build_criterion(cfg), compute_dtype=dtype)

    curve = []
    metrics = {}

    def run():
        nonlocal metrics
        metrics = step(state, batch)
        if args.loss_curve:
            curve.extend(torch.as_tensor(metrics["loss"]).reshape(-1).tolist())

    flops = count_flops(run)
    for _ in range(max(args.warmup, 1)):
        run()
    sync(args.device)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        run()
    sync(args.device)
    dt = (time.perf_counter() - t0) / (max(args.iters, 1) * spc)
    result = {
        "mode": "train",
        "nparam": nparam,
        "compute_dtype": step.compute_dtype,
        "step_time_s": dt,
        "steps_per_call": spc,
        "imgs_per_sec": args.batch / dt,
        "loss": float(metrics["loss"].reshape(-1)[-1]),
        "flops_per_step": flops["flops"] // spc,
        "gflops": flops["flops"] / spc / 1e9 if flops["flops"] > 0 else -1,
        "kernel_flops": {op: n // spc for op, n in kernel_flops(flops["by_op"]).items()},
        "shape": [args.batch, args.height, args.width],
        "platform": platform(args.device),
    }
    if args.loss_curve:
        # the per-step losses at fixed inputs (numerics A/Bs); the warm-up's
        # and the FLOP count's steps included
        result["loss_curve"] = [round(x, 4) for x in curve]
    return result


def get_args_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("benchmark")
    ap.add_argument("--config_file", "-c", default=DEFAULT_CONFIG)
    ap.add_argument("--output_dir", "-o", default="bench_out")
    ap.add_argument("--height", type=int, default=800)
    ap.add_argument("--width", type=int, default=1216)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--steps_per_call", type=int, default=1,
                    help="(train) optimizer steps a call on the batch stacked that deep "
                         "(make_multi_train_step)")
    ap.add_argument("--loss_curve", action="store_true",
                    help="(train) report the per-step losses at fixed inputs")
    ap.add_argument("--train", action="store_true",
                    help="time the training step (forward, Hungarian matching on the device, "
                         "backward, clip, AdamW) instead of the forward")
    ap.add_argument("--compute_dtype", default=None, choices=[None, "bfloat16", "float32"],
                    help="(train) override the config's compute dtype")
    ap.add_argument("--device", default="cuda")
    return ap


def run(args, cfg=None) -> Dict:
    """The benchmark of parsed `args`; `cfg` (an SLConfig) stands in for
    --config_file.  Returns the result it writes and prints."""
    import torch

    from ..config import SLConfig

    cfg = cfg if cfg is not None else SLConfig.fromfile(args.config_file)
    model = build_model(cfg, args.device)
    nparam = sum(p.numel() for p in model.parameters())
    inputs = synthetic_inputs(args.batch, args.height, args.width, int(cfg.max_text_len),
                              int(getattr(cfg, "bert_vocab_size", 30522)))
    with torch.random.fork_rng(devices=[]):
        result = (bench_train if args.train else bench_forward)(args, cfg, model, inputs, nparam)
    out_dir = os.path.join(args.output_dir, "flops")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "log.txt"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2), flush=True)
    return result


def main(argv: Optional[list] = None) -> Dict:
    return run(get_args_parser().parse_args(argv))


if __name__ == "__main__":
    main()
