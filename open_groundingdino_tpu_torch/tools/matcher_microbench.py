"""Matcher microbenchmark (the JAX package's tools/matcher_microbench.py,
plus --device): the stacked cost-matrix build on the card against the
assignment, at the flagship's training shapes (S = 7 output sets, B = 4,
Q = 900, G = max_gt, T = 256), apart from the rest of the training step.

The port builds the costs on the card (models/matcher.compute_cost_matrix)
and assigns on the host with scipy (models/matcher.hungarian_assign: one
copy of the (S*B, Q, G) costs to the host), as the reference does; the JAX
package's device JV solver (ops/hungarian.py) is not ported.

    python -m open_groundingdino_tpu_torch.tools.matcher_microbench [--iters 20] \\
        [--costs_only | --assign_only] [--profile DIR] [--device cuda]

Each time is the host clock's mean over --iters calls, closed by a CUDA
sync (the assignment's host fetch closes its own), the least of --repeats.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional

import numpy as np

from .benchmark import sync


def seeded_inputs(S: int, B: int, Q: int, G: int, T: int, n_real_gt: int):
    """The JAX tool's inputs, drawn in its order from RandomState(0):
    logits (S, B, Q, T) around -3, boxes (S, B, Q, 4), gt_boxes (B, G, 4),
    pos_maps (B, G, T) with 3 tokens a box, gt_valid (B, G) with n_real_gt
    real boxes an image."""
    rng = np.random.RandomState(0)
    logits = rng.randn(S, B, Q, T).astype(np.float32) - 3.0
    boxes = rng.uniform(0.2, 0.8, (S, B, Q, 4)).astype(np.float32)
    gt_boxes = rng.uniform(0.3, 0.7, (B, G, 4)).astype(np.float32) \
        * np.asarray([1, 1, 0.3, 0.3], np.float32)
    pos_maps = np.zeros((B, G, T), np.float32)
    for b in range(B):
        for g in range(G):
            a = rng.randint(1, T - 4)
            pos_maps[b, g, a: a + 3] = 1.0
    gt_valid = np.zeros((B, G), bool)
    gt_valid[:, :n_real_gt] = True
    return logits, boxes, gt_boxes, pos_maps, gt_valid


def build_costs(logits, boxes, gt_boxes, pos_maps, gt_valid):
    """(S, B, Q, G): each output set's cost matrix (compute_cost_matrix)."""
    import torch

    from ..models.matcher import compute_cost_matrix

    return torch.stack([compute_cost_matrix(logits[s], boxes[s], gt_boxes, pos_maps, gt_valid)
                        for s in range(logits.shape[0])])


def get_args_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("matcher_microbench")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--S", type=int, default=7)
    ap.add_argument("--B", type=int, default=4)
    ap.add_argument("--Q", type=int, default=900)
    ap.add_argument("--G", type=int, default=128)
    ap.add_argument("--T", type=int, default=256)
    ap.add_argument("--n_real_gt", type=int, default=24,
                    help="valid GT per image (rest padded invalid)")
    ap.add_argument("--costs_only", action="store_true")
    ap.add_argument("--assign_only", action="store_true")
    ap.add_argument("--profile", default="",
                    help="directory: a torch.profiler trace of --iters calls and its summary")
    ap.add_argument("--device", default="cuda")
    return ap


def run(args) -> Dict:
    """The benchmark of parsed `args`; returns {"label", "ms", "summary"}."""
    import torch

    from ..models.matcher import hungarian_assign
    from ..utils import profiling

    S, B, Q, G, T = args.S, args.B, args.Q, args.G, args.T
    device = torch.device(args.device)
    # the operands go to the device once, as the JAX tool uploads them once
    lg, bx, gtb, gpm, gv = (torch.from_numpy(a).to(device) for a in seeded_inputs(
        S, B, Q, G, T, args.n_real_gt))
    valid = gv.repeat(S, 1)

    if args.costs_only:
        label = "cost build"
        call = lambda: build_costs(lg, bx, gtb, gpm, gv).sum()   # noqa: E731
    elif args.assign_only:
        label = "assign"
        costs = build_costs(lg, bx, gtb, gpm, gv).reshape(S * B, Q, G)
        call = lambda: hungarian_assign(costs, valid).sum()   # noqa: E731
    else:
        label = "cost build + assign"
        call = lambda: hungarian_assign(                       # noqa: E731
            build_costs(lg, bx, gtb, gpm, gv).reshape(S * B, Q, G), valid).sum()
    float(call())   # warm-up, and a fence

    best = float("inf")
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = call()
        sync(device)
        float(out)
        best = min(best, (time.perf_counter() - t0) / args.iters)
    summary = None
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        prof, _ = profiling.profile_calls(call, args.iters,
                                          trace_path=os.path.join(args.profile, "trace.json"))
        summary = profiling.summarize(prof, args.iters, top=15)
    print(f"{label} (S={S} B={B} Q={Q} G={G} T={T}): {best * 1e3:.2f} ms "
          f"(min of {args.repeats})", flush=True)
    return {"label": label, "ms": best * 1e3, "summary": summary}


def main(argv: Optional[list] = None) -> Dict:
    return run(get_args_parser().parse_args(argv))


if __name__ == "__main__":
    main()
