"""Optimizer-update microbenchmark (the JAX package's
tools/opt_microbench.py, plus --device): one overflow-safe
global-norm clip + grouped AdamW + apply pass (parallel/optim.py, as the
training step runs it: the norm fetched to the host, then
GroupedAdamW.step) over the flagship model's real parameters, apart from
the model's forward and backward.

    python -m open_groundingdino_tpu_torch.tools.opt_microbench [--iters 20] \\
        [--profile DIR] [--device cuda]

Each time is the host clock's mean over --iters passes, closed by a CUDA
sync, the least of --repeats.  The gradients are a constant 1e-6.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional

from .benchmark import DEFAULT_CONFIG, build_model, sync


def get_args_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("opt_microbench")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--profile", default="",
                    help="directory: a torch.profiler trace of --iters passes and the summary "
                         "of its device time by kernel")
    ap.add_argument("--device", default="cuda")
    return ap


def run(args, cfg=None) -> Dict:
    """The benchmark of parsed `args` over the flagship config's model
    (`cfg`: another SLConfig's).  Returns {"params", "leaves", "ms",
    "summary"}."""
    import torch

    from ..config import SLConfig
    from ..parallel.optim import make_optimizer, safe_global_norm
    from ..utils import profiling

    cfg = cfg if cfg is not None else SLConfig.fromfile(DEFAULT_CONFIG)
    model = build_model(cfg, args.device)
    params = list(model.parameters())
    n = sum(p.numel() for p in params)
    print(f"params: {n / 1e6:.1f}M in {len(params)} leaves", flush=True)
    opt = make_optimizer(model, lr=1e-4, base_lr=1e-4, lr_backbone=1e-5, clip_max_norm=0.1)
    grads = [torch.full_like(p, 1e-6) for p in params]

    def step():
        opt.step(grads, float(safe_global_norm(grads)))

    step()
    sync(args.device)
    best = float("inf")
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        for _ in range(args.iters):
            step()
        sync(args.device)
        best = min(best, (time.perf_counter() - t0) / args.iters)
    summary = None
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        prof, _ = profiling.profile_calls(step, args.iters,
                                          trace_path=os.path.join(args.profile, "trace.json"))
        summary = profiling.summarize(prof, args.iters, top=15)
    print(f"optimizer update: {best * 1e3:.2f} ms/step (min of {args.repeats})", flush=True)
    return {"params": n, "leaves": len(params), "ms": best * 1e3, "summary": summary}


def main(argv: Optional[list] = None) -> Dict:
    return run(get_args_parser().parse_args(argv))


if __name__ == "__main__":
    main()
