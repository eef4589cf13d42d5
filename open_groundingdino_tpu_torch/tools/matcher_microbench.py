"""Matcher microbenchmark (the JAX package's tools/matcher_microbench.py,
plus --device): the stacked cost-matrix build against the assignment, at the
flagship's training shapes (S = 7 output sets, B = 4, Q = 900, G = max_gt,
T = 256), apart from the rest of the training step.

The port builds the costs on the card (models/matcher.compute_cost_matrix)
and assigns them there too (models/matcher.hungarian_assign, method
"device": the LSAP kernel, ops/lsap.py, the JAX package's default device
solver).  Beside it the tool times the reference's host path, method
"callback": one copy of the (S*B, Q, G) costs to the host and scipy's
linear_sum_assignment on each problem.

    python -m open_groundingdino_tpu_torch.tools.matcher_microbench [--iters 20] \\
        [--costs_only | --assign_only] [--profile DIR] [--device cuda]

Each time is the host clock's mean over --iters calls, closed by a CUDA
sync (the host assignment's fetch closes its own), the least of --repeats.
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
    """The benchmark of parsed `args`; returns {"label", "ms" (the device
    assignment's), "host_ms" (scipy's, None with --costs_only), "summary"
    (the device path's profile)}."""
    import torch

    from ..models.matcher import hungarian_assign
    from ..utils import profiling

    S, B, Q, G, T = args.S, args.B, args.Q, args.G, args.T
    device = torch.device(args.device)
    # the operands go to the device once, as the JAX tool uploads them once
    lg, bx, gtb, gpm, gv = (torch.from_numpy(a).to(device) for a in seeded_inputs(
        S, B, Q, G, T, args.n_real_gt))
    valid = gv.repeat(S, 1)
    costs = build_costs(lg, bx, gtb, gpm, gv).reshape(S * B, Q, G)

    def calls(method):
        if args.costs_only:
            return "cost build", lambda: build_costs(lg, bx, gtb, gpm, gv).sum()
        if args.assign_only:
            return "assign", lambda: hungarian_assign(costs, valid, method).sum()
        return "cost build + assign", lambda: hungarian_assign(
            build_costs(lg, bx, gtb, gpm, gv).reshape(S * B, Q, G), valid, method).sum()

    def timed(call) -> float:
        float(call())   # warm-up, and a fence
        best = float("inf")
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            for _ in range(args.iters):
                out = call()
            sync(device)
            float(out)
            best = min(best, (time.perf_counter() - t0) / args.iters)
        return best

    label, call = calls("device")
    ms = timed(call) * 1e3
    host_ms = None if args.costs_only else timed(calls("callback")[1]) * 1e3
    summary = None
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        prof, _ = profiling.profile_calls(call, args.iters,
                                          trace_path=os.path.join(args.profile, "trace.json"))
        summary = profiling.summarize(prof, args.iters, top=15)
    shape = f"(S={S} B={B} Q={Q} G={G} T={T})"
    print(f"{label} {shape}: {ms:.2f} ms (min of {args.repeats})", flush=True)
    if host_ms is not None:
        print(f"{label}, host assignment (scipy) {shape}: {host_ms:.2f} ms "
              f"(min of {args.repeats})", flush=True)
    return {"label": label, "ms": ms, "host_ms": host_ms, "summary": summary}


def main(argv: Optional[list] = None) -> Dict:
    return run(get_args_parser().parse_args(argv))


if __name__ == "__main__":
    main()
