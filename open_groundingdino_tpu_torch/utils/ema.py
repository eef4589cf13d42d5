"""Model EMA and best-metric tracking (the port of the JAX package's
utils/ema.py; reference util/utils.py:373-470 ModelEma, BestMetricHolder)."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch


@torch.no_grad()
def ema_update(ema: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
               decay: float = 0.9997, finite: Optional[torch.Tensor] = None) -> None:
    """In place: ema = ema * decay + params * (1 - decay), tensor by tensor
    (the JAX package returns the new tree; the port updates its buffers).
    `finite` (a device bool, True when None) masks the update on the device,
    as the JAX package's train step does (parallel/train_state.py:160-168):
    where it is False the factors are 1 and 0 and the EMA keeps its values
    exactly.  The weighted parameters are one foreach pass into a temporary
    of the parameters' size: foreach ops take a device factor only in a
    product (`_foreach_mul`), not as the weight of an in-place add."""
    ema = list(ema)
    params = [p.to(e.dtype) for e, p in zip(ema, params)]
    finite = torch.as_tensor(True if finite is None else finite, device=ema[0].device)
    torch._foreach_mul_(ema, torch.where(finite, decay, 1.0))
    torch._foreach_add_(ema, torch._foreach_mul(params, torch.where(finite, 1.0 - decay, 0.0)))


class BestMetricHolder:
    """The best mAP across epochs, with and without the EMA's slot
    (reference util/utils.py:433-470, used at main.py:400)."""

    def __init__(self, use_ema: bool = False):
        self.best_all: float = -1.0
        self.best_regular: float = -1.0
        self.best_ema: float = -1.0
        self.use_ema = use_ema

    def update(self, new_res: float, epoch: int, is_ema: bool = False) -> bool:
        """True if new_res is the new overall best."""
        if not self.use_ema:
            is_best = new_res > self.best_regular
            if is_best:
                self.best_regular = new_res
                self.best_all = new_res
            return is_best
        if is_ema:
            self.best_ema = max(self.best_ema, new_res)
        else:
            self.best_regular = max(self.best_regular, new_res)
        if new_res > self.best_all:
            self.best_all = new_res
            return True
        return False

    def summary(self) -> Dict[str, float]:
        return {"best_all": self.best_all, "best_regular": self.best_regular,
                "best_ema": self.best_ema}
