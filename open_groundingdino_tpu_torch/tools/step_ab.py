"""A/B of the training step and the optimizer update between two checkouts
(this one, "change", and another, "parent": say the parent commit unpacked
with `git archive`), in turns on one card.

    python -m open_groundingdino_tpu_torch.tools.step_ab --other DIR [--pairs 10] \\
        [--warmup 2] [--iters 5] [--out DIR]

Each pair runs tools/benchmark.py --train (bf16, B = 4, 800x1216, one step
a call) and tools/opt_microbench.py once in each checkout, every run a
fresh process started in that checkout's root; the pairs alternate which
checkout goes first (parent, change, change, parent, ...), so that a drift
of the host's speed falls on both alike.  Prints one line a run, then one
JSON object: each checkout's step times (the benchmark's `step_time_s`) and
optimizer times (ms), their medians, the parent's interquartile spread,
each pair's change / parent ratios with their median, and the number of
pairs in which the change was faster.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
from typing import Dict, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OPT_LINE = re.compile(r"optimizer update: ([0-9.]+) ms/step")


def get_args_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("step_ab")
    ap.add_argument("--other", required=True, help="the other checkout's root (the parent)")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "step_ab"),
                    help="directory for the benchmark's output files")
    return ap


def _run(cmd, cwd: str) -> str:
    r = subprocess.run([sys.executable, "-m", *cmd], cwd=cwd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{' '.join(cmd)} in {cwd} exited {r.returncode}:\n"
                           f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    return r.stdout


def measure(tree: str, root: str, args, tag: str) -> Dict[str, float]:
    """One bf16 B = 4 step time (s) and one optimizer update time (ms) in
    `root`, each from a fresh process."""
    out = os.path.join(args.out, tag)
    _run(["open_groundingdino_tpu_torch.tools.benchmark", "--train", "--batch", "4",
          "--compute_dtype", "bfloat16", "--warmup", str(args.warmup), "--iters",
          str(args.iters), "-o", out], root)
    with open(os.path.join(out, "flops", "log.txt")) as f:
        step_s = json.load(f)["step_time_s"]
    opt_ms = float(OPT_LINE.search(_run(["open_groundingdino_tpu_torch.tools.opt_microbench",
                                         "--iters", "10", "--repeats", "3"], root)).group(1))
    print(f"[{tag}] {tree}: step {step_s} s, optimizer {opt_ms} ms", flush=True)
    return {"step_s": step_s, "opt_ms": opt_ms}


def run(args) -> Dict:
    if args.pairs < 2:
        raise SystemExit("step_ab needs --pairs 2 or more")
    roots = {"change": ROOT, "parent": os.path.abspath(args.other)}
    args.out = os.path.abspath(args.out)   # each run's working directory is its checkout
    runs = {"change": [], "parent": []}
    for i in range(args.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for tree in order:
            runs[tree].append(measure(tree, roots[tree], args, f"pair{i}_{tree}"))
    result = {"pairs": args.pairs, "order": "parent first in even pairs, change first in odd"}
    for key in ("step_s", "opt_ms"):
        for tree in runs:
            values = [r[key] for r in runs[tree]]
            result[f"{tree}_{key}"] = values
            result[f"{tree}_{key}_median"] = statistics.median(values)
        q1, _, q3 = statistics.quantiles(result[f"parent_{key}"], n=4)
        result[f"parent_{key}_iqr"] = q3 - q1
        ratios = [c[key] / p[key] for c, p in zip(runs["change"], runs["parent"])]
        result[f"{key}_ratios"] = ratios
        result[f"{key}_ratio_median"] = statistics.median(ratios)
        result[f"{key}_change_faster_pairs"] = sum(r < 1.0 for r in ratios)
    print(json.dumps(result), flush=True)
    return result


def main(argv: Optional[list] = None) -> Dict:
    return run(get_args_parser().parse_args(argv))


if __name__ == "__main__":
    main()
