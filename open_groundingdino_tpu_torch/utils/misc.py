"""Small numeric helpers (the port's counterpart of utils/misc.py)."""
from __future__ import annotations

from typing import Dict

import torch


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Logit with clamping, matching reference util/misc.py:614-618."""
    x = x.clamp(0.0, 1.0)
    x1 = x.clamp(min=eps)
    x2 = (1.0 - x).clamp(min=eps)
    return torch.log(x1 / x2)


def clean_state_dict(state_dict: Dict) -> Dict:
    """Strip a leading 'module.' from checkpoint keys (DDP artifact), the
    semantics of reference util/utils.py:22-28."""
    return {
        (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in state_dict.items()
    }
