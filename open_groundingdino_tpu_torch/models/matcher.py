"""Hungarian matching (the port of the JAX package's models/matcher.py;
reference matcher.py:25-217).

The cost tensor is computed on the device with static shapes (GT padded to
max_gt with a validity mask; padded columns get a large constant cost), and
the assignment runs on the device too, by default: `hungarian_assign(...,
method="device")` is the JAX package's default Jonker-Volgenant solver
(ops/hungarian.py::hungarian_device), here ops/lsap.py: the CUDA kernel for
CUDA tensors, its plain version for CPU tensors.  No host round trip, so a
training step runs with no host read inside it.  `method="callback"` keeps
the reference's path, as the JAX package keeps it: the (S*B, Q, G) costs are
copied to the host and scipy's `linear_sum_assignment` solves them
(`host_lsa`).
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from ..ops.lsap import lsap
from ..utils import box_ops

BIG_COST = 1e6


@torch.no_grad()
def compute_cost_matrix(
    pred_logits: torch.Tensor,   # (B, Q, T)
    pred_boxes: torch.Tensor,    # (B, Q, 4) cxcywh sigmoid
    gt_boxes: torch.Tensor,      # (B, G, 4) cxcywh normalized
    gt_pos_maps: torch.Tensor,   # (B, G, T) 0/1 token map per GT
    gt_valid: torch.Tensor,      # (B, G) bool
    cost_class: float = 1.0,
    cost_bbox: float = 5.0,
    cost_giou: float = 2.0,
    focal_alpha: float = 0.25,
    focal_gamma: float = 2.0,
) -> torch.Tensor:
    """(B, Q, G) matching cost (reference matcher.py:66-106, vectorized over
    the batch with padded GT columns at BIG_COST)."""
    prob = pred_logits.float().sigmoid()
    neg = (1 - focal_alpha) * (prob ** focal_gamma) * (-torch.log(1 - prob + 1e-8))
    pos = focal_alpha * ((1 - prob) ** focal_gamma) * (-torch.log(prob + 1e-8))
    # each GT's token map normalized to sum 1 (reference matcher.py:90)
    maps = gt_pos_maps / gt_pos_maps.sum(-1, keepdim=True).clamp(min=1e-6)
    c_class = torch.einsum("bqt,bgt->bqg", pos - neg, maps)
    pred_boxes, gt_boxes = pred_boxes.float(), gt_boxes.float()
    c_bbox = (pred_boxes[:, :, None, :] - gt_boxes[:, None, :, :]).abs().sum(-1)
    giou = box_ops.generalized_box_iou(box_ops.box_cxcywh_to_xyxy(pred_boxes),
                                       box_ops.box_cxcywh_to_xyxy(gt_boxes))
    C = cost_bbox * c_bbox + cost_class * c_class + cost_giou * (-giou)
    C = torch.where(torch.isfinite(C), C, torch.zeros_like(C))   # reference matcher.py:105-106
    return torch.where(gt_valid[:, None, :], C, torch.full_like(C, BIG_COST))


def host_lsa(cost: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """cost (N, Q, G), valid (N, G) -> matched query per GT (N, G) int64;
    padded slots get the sentinel Q.  scipy's LSA on each sample's valid
    columns, with the reference's greedy fallback (matcher.py:112-119)."""
    N, Q, G = cost.shape
    out = np.full((N, G), Q, np.int64)
    for n in range(N):
        cols = np.nonzero(valid[n])[0]
        if len(cols) == 0:
            continue
        c = cost[n][:, cols]
        try:
            rows, cidx = linear_sum_assignment(c)
        except ValueError:
            rows = np.argmin(c, axis=0)[np.arange(len(cols))]
            cidx = np.arange(len(cols))
        out[n, cols[cidx]] = rows
    return out


def hungarian_assign(cost: torch.Tensor, gt_valid: torch.Tensor,
                     method: str = "device") -> torch.Tensor:
    """(N, Q, G) costs -> (N, G) matched query indices on the cost's device
    (sentinel Q for padded GT).  method="device": the LSAP solver on the
    cost's device (ops/lsap.py), the kernel on a card; "callback": scipy on
    the host, through one copy of the costs there and back."""
    if method == "device":
        # the overflow flags stay on the device: costs of compute_cost_matrix
        # are finite and below 1e6, and never reach the solver's bound while
        # an image has no more valid GT than queries
        return lsap(cost, gt_valid)[0]
    if method != "callback":
        raise ValueError(f"hungarian_assign: unknown method {method!r} (device or callback)")
    src = host_lsa(cost.detach().float().cpu().numpy(), gt_valid.cpu().numpy())
    return torch.from_numpy(src).to(cost.device)


def minsum_assign(cost: torch.Tensor, gt_valid: torch.Tensor) -> torch.Tensor:
    """SimpleMinsumMatcher semantics (reference matcher.py:123-201): every GT
    independently takes its min-cost query, so two GTs may claim the same
    query, exactly as upstream.  (N, Q, G) -> (N, G), sentinel Q on padded
    slots."""
    src = cost.detach().argmin(dim=1)
    return torch.where(gt_valid, src, torch.full_like(src, cost.shape[1]))
