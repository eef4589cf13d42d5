"""Process-aware logger and windowed metric meters (the port's own copy of
the JAX package's utils/logger.py; reference util/logger.py:11-73 and
util/misc.py:32-263).

`setup_logger` logs to the console on process 0 only and, from every
process, to OUTPUT_DIR/info.txt.  Unlike the JAX package's it replaces the
handlers a logger of that name already has, so that each `main` call in one
process logs to its own output directory.  `MetricLogger` keeps windowed
medians and global averages; with no logger it prints on process 0 only.
The JAX package's MetricLogger.log_every is not ported: the port's loops
(engine.py) time and print their own steps.
"""
from __future__ import annotations

import logging
import os
import sys
from collections import defaultdict, deque
from typing import Dict, Optional

from ..parallel import dist


def setup_logger(output_dir: Optional[str] = None, name: str = "ogd_torch",
                 process_index: int = 0) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("[%(asctime)s] %(message)s", "%m/%d %H:%M:%S")
    handlers = []
    if process_index == 0:
        handlers.append(logging.StreamHandler(sys.stdout))
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        handlers.append(logging.FileHandler(os.path.join(output_dir, "info.txt")))
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


class SmoothedValue:
    """A window of the last 20 values (its median) and the global average."""

    def __init__(self):
        self.deque = deque(maxlen=20)
        self.total = 0.0
        self.count = 0

    def update(self, value: float) -> None:
        self.deque.append(value)
        self.count += 1
        self.total += value

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    def __str__(self) -> str:
        return f"{self.median:.4f}"


class MetricLogger:
    def __init__(self, logger: Optional[logging.Logger] = None):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.logger = logger

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self) -> str:
        return "  ".join(f"{k}: {v}" for k, v in self.meters.items())

    def print(self, msg: str) -> None:
        """To the logger, or else to stdout on process 0."""
        if self.logger:
            self.logger.info(msg)
        elif dist.is_main_process():
            print(msg)
