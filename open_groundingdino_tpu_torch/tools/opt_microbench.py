"""Optimizer-update microbenchmark (the JAX package's
tools/opt_microbench.py, plus --device): one overflow-safe
global-norm clip + grouped AdamW + apply pass (parallel/optim.py, as the
training step runs it: the norm on the device, GroupedAdamW.step with its
count, clip scale, learning rate and finite guard there, no host read) over
the flagship model's real parameters, apart from the model's forward and
backward.

    python -m open_groundingdino_tpu_torch.tools.opt_microbench [--iters 20] \\
        [--profile DIR] [--device cuda] [--ema]

Each time is the host clock's mean over --iters passes, closed by a CUDA
sync, the least of --repeats.  The gradients are a constant 1e-6.  --ema
also times the EMA update a step under use_ema makes (utils/ema.py, masked
by the device's finite flag) beside the same update unmasked in place
(`_foreach_mul_` and `_foreach_add_(..., alpha)`, no temporary).
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
    ap.add_argument("--ema", action="store_true",
                    help="also time the masked EMA update and its unmasked in-place form")
    return ap


def run(args, cfg=None) -> Dict:
    """The benchmark of parsed `args` over the flagship config's model
    (`cfg`: another SLConfig's).  Returns {"params", "leaves", "ms",
    "summary"}, and "ema_ms", "ema_inplace_ms" under --ema."""
    import torch

    from ..config import SLConfig
    from ..parallel.optim import make_optimizer, safe_global_norm
    from ..utils import profiling
    from ..utils.ema import ema_update

    cfg = cfg if cfg is not None else SLConfig.fromfile(DEFAULT_CONFIG)
    model = build_model(cfg, args.device)
    params = list(model.parameters())
    n = sum(p.numel() for p in params)
    print(f"params: {n / 1e6:.1f}M in {len(params)} leaves", flush=True)
    opt = make_optimizer(model, lr=1e-4, base_lr=1e-4, lr_backbone=1e-5, clip_max_norm=0.1)
    grads = [torch.full_like(p, 1e-6) for p in params]

    def step():
        norm = safe_global_norm(grads)
        opt.step(grads, norm, torch.isfinite(norm))

    def best_ms(fn) -> float:
        fn()
        sync(args.device)
        best = float("inf")
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            for _ in range(args.iters):
                fn()
            sync(args.device)
            best = min(best, (time.perf_counter() - t0) / args.iters)
        return best * 1e3

    ms = best_ms(step)
    ema_ms = {}
    if args.ema:
        ema = [p.detach().clone() for p in params]
        finite = torch.ones((), dtype=torch.bool, device=params[0].device)

        def inplace():
            torch._foreach_mul_(ema, 0.9997)
            torch._foreach_add_(ema, params, alpha=1.0 - 0.9997)

        ema_ms = {"ema_ms": best_ms(lambda: ema_update(ema, params, 0.9997, finite)),
                  "ema_inplace_ms": best_ms(inplace)}
        print(f"EMA update: masked {ema_ms['ema_ms']:.2f} ms, unmasked in place "
              f"{ema_ms['ema_inplace_ms']:.2f} ms (min of {args.repeats})", flush=True)
    summary = None
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        prof, _ = profiling.profile_calls(step, args.iters,
                                          trace_path=os.path.join(args.profile, "trace.json"))
        summary = profiling.summarize(prof, args.iters, top=15)
    print(f"optimizer update: {ms:.2f} ms/step (min of {args.repeats})", flush=True)
    return {"params": n, "leaves": len(params), "ms": ms, **ema_ms, "summary": summary}


def main(argv: Optional[list] = None) -> Dict:
    return run(get_args_parser().parse_args(argv))


if __name__ == "__main__":
    main()
