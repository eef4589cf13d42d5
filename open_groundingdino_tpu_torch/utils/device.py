"""Host data onto the device without a host synchronisation.

A blocking copy from pageable host memory to a card waits for the copy, and
so for every kernel queued before it: inside a training step that is a host
sync.  The step runs with none (parallel/train_state.py), so the tensors it
builds from host data arrive by one of two ways:

  device_constant  a tensor that depends only on static shapes (a level's
                   reference grid, its (w, h), the ImageNet mean): made once
                   per key and device, then read from the cache;
  to_device_async  a tensor drawn anew each step (the stochastic-depth
                   factors of the CPU generator): staged in page-locked
                   memory and copied behind the work already queued.
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable, Tuple

import torch

_CONSTANTS: Dict[Tuple[Hashable, str], torch.Tensor] = {}


def device_constant(key: Hashable, make: Callable[[], torch.Tensor], device) -> torch.Tensor:
    """make() on `device`, made once per (key, device).  Made outside
    inference mode whatever the caller's mode, so that a training forward
    after a serving one may save it for backward.  One made while a graph is
    traced (torch.export: a fake tensor) is not kept; a kept one is read
    there as a constant of the graph."""
    slot = (key, str(torch.device(device)))
    t = _CONSTANTS.get(slot)
    if t is not None:
        return t
    with torch.inference_mode(False):
        t = make().to(device)
    if not torch.compiler.is_compiling():
        _CONSTANTS[slot] = t
    return t


def to_device_async(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on `device`: for a card, staged in page-locked memory
    and copied without blocking the host."""
    device = torch.device(device)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
