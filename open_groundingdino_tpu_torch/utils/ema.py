"""Model EMA (the port of the JAX package's utils/ema.py; reference
util/utils.py:373-396 ModelEma)."""
from __future__ import annotations

from typing import Sequence

import torch


@torch.no_grad()
def ema_update(ema: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
               decay: float = 0.9997) -> None:
    """In place: ema = ema * decay + params * (1 - decay), tensor by tensor
    (the JAX package returns the new tree; the port updates its buffers)."""
    ema = list(ema)
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, [p.to(e.dtype) for e, p in zip(ema, params)], alpha=1.0 - decay)
