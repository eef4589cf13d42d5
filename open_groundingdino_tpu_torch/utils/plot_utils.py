"""Training-log plotting (the JAX package's utils/plot_utils.py; reference
util/plot_utils.py:13-112).

Reads the JSON-lines `log.txt` that the port's main writes an epoch and
plots chosen fields over the epochs; `plot_precision_recall` draws P/R
curves from the evaluator's accumulated precision and recall.  A host-only
tool: matplotlib is imported inside each function, on its Agg backend, so
that the package imports where matplotlib is not installed.
"""
from __future__ import annotations

import json
import os
from typing import List, Sequence, Tuple


def _load_log(log_dir: str, log_name: str = "log.txt") -> List[dict]:
    path = os.path.join(str(log_dir), log_name)
    if not os.path.exists(path):
        raise FileNotFoundError(f"missing {log_name} in {log_dir}: has epoch 0 finished?")
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def plot_logs(logs: Sequence[str], fields: Tuple[str, ...] = ("loss", "loss_bbox", "AP"),
              ewm_com: float = 0.0, log_name: str = "log.txt"):
    """Plot training and eval fields from one or more output directories
    (the reference's plot_logs: a line a run, a subplot a field; an epoch
    that lacks a field is skipped; `ewm_com` > 0 smooths each line with an
    exponential moving average of that centre of mass).  Returns (fig,
    axes)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if isinstance(logs, (str, os.PathLike)):
        logs = [logs]
    runs = [(str(d), _load_log(d, log_name)) for d in logs]

    fig, axs = plt.subplots(ncols=len(fields), figsize=(5 * len(fields), 4))
    if len(fields) == 1:
        axs = [axs]
    for name, recs in runs:
        label = os.path.basename(os.path.normpath(name))
        for ax, field in zip(axs, fields):
            ys = [r.get(field) for r in recs]
            xs = [i for i, y in enumerate(ys) if y is not None]
            ys = [y for y in ys if y is not None]
            if ewm_com > 0 and ys:
                smoothed, alpha, acc = [], 1.0 / (1.0 + ewm_com), ys[0]
                for y in ys:
                    acc = alpha * y + (1 - alpha) * acc
                    smoothed.append(acc)
                ys = smoothed
            ax.plot(xs, ys, label=label)
    for ax, field in zip(axs, fields):
        ax.set_title(field)
        ax.set_xlabel("epoch")
        ax.legend()
    fig.tight_layout()
    return fig, axs


def plot_precision_recall(curves: Sequence[Tuple[str, Sequence[float], Sequence[float]]]):
    """P/R curves: [(label, recalls, precisions), ...] -> (fig, ax)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 5))
    for label, recalls, precisions in curves:
        ax.plot(recalls, precisions, label=label)
    ax.set_xlabel("recall")
    ax.set_ylabel("precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1.05)
    ax.legend()
    return fig, ax
