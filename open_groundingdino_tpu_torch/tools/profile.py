"""A torch.profiler trace of the port's forward, or with --train of its
training step (the JAX package's tools/profile.py, plus --device).

    python -m open_groundingdino_tpu_torch.tools.profile -c CONFIG -o trace_dir \\
        [--height 800 --width 1216] [--batch 4] [--iters 5] \\
        [--compute_dtype bfloat16] [--train] [--device cuda]

Writes OUTPUT_DIR/trace.json (a Chrome trace, viewable in Perfetto or
chrome://tracing) of `--iters` calls after as many under the profiler's
warm-up step, then prints the JAX tool's summary read from the profile's
raw device events (utils/profiling.summarize: device self-time per
iteration, the top buckets by device time with their launch counts), and
the wall time of `--iters` more calls without the profiler.  The weights are
a seeded random init, the inputs tools/benchmark.py's.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Dict, Optional

from .benchmark import (DEFAULT_CONFIG, build_model, sync, synthetic_inputs,
                        synthetic_targets)


def _forward(args, cfg, model, inputs):
    """A device-resident forward in --compute_dtype (the parameters cast
    once, as make_eval_step's bf16 does each call), returning a scalar of
    the boxes."""
    import torch

    from ..parallel.train_state import cast_floating, resolve_compute_dtype, swapped_parameters

    dtype = resolve_compute_dtype(args.compute_dtype)
    t = {k: torch.from_numpy(v).to(args.device) for k, v in inputs.items()}
    values = None
    if dtype is not None:
        t["images"] = t["images"].to(dtype)
        with torch.no_grad():
            values = cast_floating(dict(model.named_parameters()), dtype)
    model.eval()

    @torch.no_grad()
    def fwd():
        with swapped_parameters(model, values) if values else contextlib.nullcontext():
            return model(**t)["pred_boxes"].float().sum()

    return fwd


def _train_step(args, cfg, model, inputs):
    from ..models.criterion import build_criterion
    from ..parallel.optim import make_optimizer
    from ..parallel.train_state import TrainState, make_train_step

    batch = dict(inputs, **synthetic_targets(args.batch, int(getattr(cfg, "max_gt_boxes", 128)),
                                             int(cfg.max_text_len)))
    optimizer = make_optimizer(model, lr=float(cfg.lr), base_lr=float(cfg.lr),
                               lr_backbone=float(cfg.lr_backbone))
    state = TrainState.create(model, optimizer, seed=0)
    step = make_train_step(build_criterion(cfg), compute_dtype=args.compute_dtype)
    return lambda: step(state, batch)


def get_args_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("profile")
    ap.add_argument("--config_file", "-c", default=DEFAULT_CONFIG)
    ap.add_argument("--output_dir", "-o", default="trace_out")
    ap.add_argument("--height", type=int, default=800)
    ap.add_argument("--width", type=int, default=1216)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"],
                    help="bfloat16: the configs' training default")
    ap.add_argument("--train", action="store_true",
                    help="trace the training step instead of the forward")
    ap.add_argument("--device", default="cuda")
    return ap


def run(args, cfg=None) -> Dict:
    """The profile of parsed `args`; `cfg` stands in for --config_file.
    Returns {"trace", "summary", "ms", "img_s", "profiled_wall_ms"}."""
    from ..config import SLConfig
    from ..utils import profiling

    cfg = cfg if cfg is not None else SLConfig.fromfile(args.config_file)
    model = build_model(cfg, args.device)
    inputs = synthetic_inputs(args.batch, args.height, args.width, int(cfg.max_text_len),
                              int(getattr(cfg, "bert_vocab_size", 30522)))
    fn = (_train_step if args.train else _forward)(args, cfg, model, inputs)
    fn()
    sync(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    trace = os.path.join(args.output_dir, "trace.json")
    prof, wall_ms = profiling.profile_calls(fn, args.iters, trace_path=trace)
    what = "train" if args.train else "fwd"
    print(f"{what} trace -> {trace}", flush=True)
    summary = profiling.summarize(prof, args.iters)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        fn()
    sync(args.device)
    dt = (time.perf_counter() - t0) / max(args.iters, 1)
    unit = "step" if args.train else "batch"
    print(f"{what}: {dt * 1e3:.1f} ms/{unit} ({args.batch / dt:.2f} img/s)", flush=True)
    return {"trace": trace, "summary": summary, "ms": dt * 1e3, "img_s": args.batch / dt,
            "profiled_wall_ms": wall_ms / max(args.iters, 1)}


def main(argv: Optional[list] = None) -> Dict:
    return run(get_args_parser().parse_args(argv))


if __name__ == "__main__":
    main()
