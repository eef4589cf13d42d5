"""The training loop (the port of the JAX package's engine.py::train_one_epoch;
reference engine_multi.py:353-593).

One train step per batch.  The loss and gradient norm reach the host every
step (the matcher synchronises anyway), so the abort on a non-finite loss or
a growing `nonfinite_count` (reference engine_multi.py:544-547) is checked
every step.  Evaluation is not ported yet.
"""
from __future__ import annotations

import datetime
import logging
import math
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional

LOGGED_KEYS = ("loss", "loss_ce", "loss_bbox", "loss_giou", "grad_norm")


class SmoothedValue:
    """Running window and global average of a scalar (reference
    util/misc.py SmoothedValue)."""

    def __init__(self, window: int = 20):
        self.window: List[float] = []
        self.size = window
        self.total, self.count = 0.0, 0

    def update(self, value: float) -> None:
        self.window = (self.window + [value])[-self.size:]
        self.total += value
        self.count += 1

    @property
    def median(self) -> float:
        d = sorted(self.window)
        return d[len(d) // 2] if d else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


def train_one_epoch(train_step, state, loader, epoch: int,
                    logger: Optional[logging.Logger] = None, print_freq: int = 50,
                    max_steps: Optional[int] = None,
                    step_records: Optional[List[Dict]] = None):
    """One epoch; returns (state, {metric: global average over the epoch's
    steps}).  `step_records`, when given, receives every step's metrics and
    its host seconds (the step ends in a host read, so these are wall times
    of whole steps)."""
    meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
    emit = logger.info if logger else print
    # nonfinite_count is cumulative over the run: abort on growth since the
    # epoch began, not on its value
    base_nonfinite = state.nonfinite_count
    total = len(loader)
    t_epoch = time.perf_counter()
    t_data = time.perf_counter()
    for i, batch in enumerate(loader):
        data_s = time.perf_counter() - t_data
        t0 = time.perf_counter()
        metrics = train_step(state, batch)
        step_s = time.perf_counter() - t0
        if step_records is not None:
            step_records.append(dict(metrics, step_seconds=step_s, data_seconds=data_s))
        loss = metrics["loss"]
        if not math.isfinite(loss) or metrics["nonfinite_count"] > base_nonfinite:
            (logger.error if logger else print)(
                f"Loss is {loss} (nonfinite steps: {metrics['nonfinite_count']}), "
                f"stopping training: {metrics}")
            sys.exit(1)
        for k in LOGGED_KEYS:
            if k in metrics:
                meters[k].update(metrics[k])
        if i % print_freq == 0 or i == total - 1:
            shown = "  ".join(f"{k}: {m.median:.4f}" for k, m in meters.items())
            emit(f"Epoch [{epoch}] [{i}/{total}] {shown}  step_t: {step_s:.4f}  "
                 f"data_t: {data_s:.4f}")
        if max_steps is not None and i + 1 >= max_steps:
            break
        t_data = time.perf_counter()
    emit(f"Epoch [{epoch}] done in "
         f"{datetime.timedelta(seconds=int(time.perf_counter() - t_epoch))}")
    return state, {k: m.global_avg for k, m in meters.items()}
