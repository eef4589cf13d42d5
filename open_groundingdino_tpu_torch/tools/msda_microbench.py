"""MSDA kernel microbenchmark on one GPU: one encoder layer's deformable
attention at the flagship training shapes (B = 4, the 800x1216 bucket's
levels -> Q = L = 20197 queries, 8 heads of 32 channels, 4 points), with
seeded trained-like sampling offsets.  The port of the JAX package's
tools/msda_microbench.py; times each kernel path alone, without a whole
model step.

    python -m open_groundingdino_tpu_torch.tools.msda_microbench \\
        [--banded_mp {1,0}] [--sweep [--fwd_variant {rowtap,corner}]] [--bwd] [--xla] \\
        [--iters N] [--repeats N] [--spread S] [--jitter J] [--dtype {f32,bf16}] \\
        [--profile] [--device cuda]

Always timed: the banded family, `--banded_mp 1` the union-band forward K1
(ops/msda.ms_deform_attn), `--banded_mp 0` the per-point forward K5
(ops/msda_banded.ms_deform_attn_banded); with `--bwd` also forward +
backward (K3).  `--sweep` adds the tile sweep (ops/msda_sweep, the op-level
path): the row-tap forward K6 or, with `--fwd_variant corner`, the corner
forward K8; with `--bwd` forward + backward (K9).  `--xla` adds the plain
PyTorch op and the largest |banded - plain|.  The JAX tool's environment
switches (MSDA_BANDED_MP, MSDA_FWD_VARIANT) are these flags.  Each line is
the least, over `--repeats`, of the mean milliseconds a call over `--iters`
calls (CUDA events; the host clock on the CPU); `--profile` adds
torch.profiler's device time by kernel.  Queries stay in raster order (the
JAX tool's interleaved order is a TPU layout trick).  Locations and
weights stay f32; `--dtype bf16` casts the value, which every path takes
through its kernels' bf16 entries (K1 or K5, K6 or K8; with `--bwd` K3 and
K9).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict

import numpy as np
import torch

from ..ops import msda, msda_banded, msda_sweep

SHAPES = ((100, 152), (50, 76), (25, 38), (13, 19))   # 800x1216 -> strides 8, 16, 32, 64
BATCH, HEADS, HEAD_DIM, POINTS = 4, 8, 32, 4


def get_args_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--xla", action="store_true",
                    help="also time the plain op and print max |banded - plain|")
    ap.add_argument("--sweep", action="store_true", help="also time the tile sweep op")
    ap.add_argument("--bwd", action="store_true", help="also time forward + backward")
    ap.add_argument("--banded_mp", type=int, choices=(1, 0), default=1,
                    help="the banded forward: 1 = union band (K1), 0 = per point (K5)")
    ap.add_argument("--fwd_variant", choices=msda_sweep.SWEEP_FWD, default="rowtap",
                    help="the sweep forward: row taps (K6) or corner taps (K8)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3,
                    help="timing repeats; the least is reported")
    ap.add_argument("--spread", type=float, default=1.0,
                    help="multiplier on the reference grid-bias offsets (1 = init)")
    ap.add_argument("--jitter", type=float, default=0.5,
                    help="per-query random offset in cells on top of the grid bias")
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32", help="value dtype")
    ap.add_argument("--profile", action="store_true",
                    help="print torch.profiler's device time by kernel for each timed path")
    ap.add_argument("--device", default="cuda")
    return ap


def make_operands(spread: float = 1.0, jitter: float = 0.5, shapes=SHAPES, batch: int = BATCH,
                  heads: int = HEADS, head_dim: int = HEAD_DIM, points: int = POINTS):
    """The JAX tool's seeded operands, f32 numpy: value (B, L, H, D) ~ N(0, 1);
    each query at its own position's centre on every level, plus the
    reference grid-bias offsets (a unit ray per head scaled by the point's
    index) times `spread` and N(0, jitter) cells; weights uniform, summing
    to 1 over levels and points.  -> (value, locs (B, Q, H, NL, P, 2),
    attn (B, Q, H, NL, P)), Q = L."""
    NL = len(shapes)
    L = sum(h * w for h, w in shapes)
    rng = np.random.RandomState(0)
    value = rng.randn(batch, L, heads, head_dim).astype(np.float32)
    ref = []
    for h, w in shapes:
        ys, xs = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w, indexing="ij")
        ref.append(np.stack([xs, ys], -1).reshape(-1, 2))
    ref = np.concatenate(ref, 0)
    theta = np.arange(heads) * (2 * np.pi / heads)
    grid = np.stack([np.cos(theta), np.sin(theta)], -1)
    grid /= np.abs(grid).max(-1, keepdims=True)
    bias = grid[:, None, :] * (np.arange(points) + 1)[None, :, None]      # (H, P, 2)
    bias = np.tile(bias[:, None], (1, NL, 1, 1))                          # (H, NL, P, 2)
    offs = (bias[None, None] * spread
            + rng.randn(batch, L, heads, NL, points, 2) * jitter).astype(np.float32)
    wh = np.asarray([[w, h] for h, w in shapes], np.float32)
    locs = (ref[None, :, None, None, None, :] + offs / wh[None, None, None, :, None, :])
    attn = rng.rand(batch, L, heads, NL, points).astype(np.float32)
    attn /= attn.sum(axis=(3, 4), keepdims=True)
    return value, locs.astype(np.float32), attn


def timed_ms(fn: Callable[[], object], iters: int, repeats: int, device: torch.device) -> float:
    """The least, over `repeats`, of the mean milliseconds of fn over `iters`
    back-to-back calls, after one warm-up call: CUDA events on the card,
    the host clock elsewhere."""
    fn()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    best = float("inf")
    for _ in range(repeats):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms = (time.perf_counter() - t0) * 1e3 / iters
        best = min(best, ms)
    return best


def device_time_summary(fn: Callable[[], object], calls: int, device: torch.device,
                        top: int = 12) -> Dict[str, float]:
    """torch.profiler over `calls` calls of fn: milliseconds a call by kernel
    (device time on the card, host time elsewhere), the `top` largest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        if cuda:
            torch.cuda.synchronize(device)
    rows = {}
    for e in prof.key_averages():
        if cuda and e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            rows[e.key] = e.self_device_time_total / 1e3 / calls
        elif not cuda and e.self_cpu_time_total > 0:
            rows[e.key] = e.self_cpu_time_total / 1e3 / calls
    return dict(sorted(rows.items(), key=lambda kv: -kv[1])[:top])


def run(args, shapes=SHAPES, batch: int = BATCH) -> Dict[str, object]:
    """Time the paths `args` selects at `shapes` and `batch` (the flagship's
    by default); prints one line a path and returns {name: ms a layer},
    with "max_abs_diff" under --xla and "profiles" under --profile."""
    device = torch.device(args.device)
    value, locs, attn = (torch.from_numpy(a).to(device) for a in make_operands(
        args.spread, args.jitter, shapes, batch))
    value = value.to(torch.bfloat16 if args.dtype == "bf16" else torch.float32)
    starts = msda.level_starts(shapes)
    banded = (msda.ms_deform_attn if args.banded_mp else msda_banded.ms_deform_attn_banded)
    ops = {f"banded fwd ({'K1' if args.banded_mp else 'K5'})": banded}
    if args.sweep:
        sweep = lambda v, s, st, l, a: msda_sweep.ms_deform_attn_sweep(v, s, st, l, a,
                                                                      fwd=args.fwd_variant)
        ops[f"sweep fwd ({'K8' if args.fwd_variant == 'corner' else 'K6'})"] = sweep
    if args.xla:
        ops["xla fwd (plain)"] = msda.ms_deform_attn_plain

    results: Dict[str, object] = {}
    profiles = {}
    leaves = [t.detach().clone().requires_grad_(True) for t in (value, locs, attn)]

    def fwd_bwd(op):
        out = op(leaves[0], shapes, starts, leaves[1], leaves[2])
        return torch.autograd.grad((out.float() ** 2).sum(), leaves)

    for name, op in ops.items():
        paths = [(name, lambda op=op: op(value, shapes, starts, locs, attn))]
        if args.bwd and "plain" not in name:
            paths.append((name.replace("fwd", "fwd+bwd"), lambda op=op: fwd_bwd(op)))
        for label, fn in paths:
            with torch.set_grad_enabled("bwd" in label):
                ms = timed_ms(fn, args.iters, args.repeats, device)
                if args.profile:
                    profiles[label] = device_time_summary(fn, args.iters, device)
            results[label] = ms
            print(f"{label}: {ms:.3f} ms/layer (min of {args.repeats})", flush=True)
            if args.profile:
                print(f"--- device time a call [{label}]: "
                      f"{ {k[:60]: round(v, 4) for k, v in profiles[label].items()} }", flush=True)
    if args.xla:
        with torch.no_grad():
            diff = float((banded(value, shapes, starts, locs, attn).float()
                          - msda.ms_deform_attn_plain(value, shapes, starts, locs, attn).float())
                         .abs().max())
        results["max_abs_diff"] = diff
        print(f"max abs diff banded vs plain: {diff:.2e}", flush=True)
    if args.profile:
        results["profiles"] = profiles
    return results


def main(argv=None) -> Dict[str, object]:
    return run(get_args_parser().parse_args(argv))


if __name__ == "__main__":
    main()
