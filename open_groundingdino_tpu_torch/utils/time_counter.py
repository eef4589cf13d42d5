"""Section timing helpers: the port's own copy of the JAX package's
utils/time_counter.py (reference util/time_counter.py:4-60)."""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict


class AverageMeter:
    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, v: float, n: int = 1):
        self.sum += v * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class TimeCounter:
    """with TimeCounter(holder, 'section'): ...  accumulates wall time."""

    def __init__(self, holder: "TimeHolder", name: str):
        self.holder = holder
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.holder.update(self.name, time.perf_counter() - self.t0)
        return False


class TimeHolder:
    def __init__(self):
        self.meters: Dict[str, AverageMeter] = defaultdict(AverageMeter)

    def update(self, name: str, dt: float):
        self.meters[name].update(dt)

    def section(self, name: str) -> TimeCounter:
        return TimeCounter(self, name)

    def summary(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}
