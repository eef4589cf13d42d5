"""SetCriterion: token-level sigmoid focal loss + L1 + GIoU box losses over
matched query/GT pairs, for the final decoder layer, every aux layer and the
encoder's interm outputs (the port of the JAX package's models/criterion.py;
reference groundingdino.py:407-639).

GT arrive padded to max_gt with a validity mask.  The costs of every output
set are stacked and assigned in one call on their device (models/matcher.py:
the LSAP kernel on a card), so the criterion reads nothing back to the host.
Normalizers follow the reference: boxes by the total GT count, the focal
loss by the number of matched pairs of each set, both counted over the
global batch (summed over the ranks, reference groundingdino.py:570-576; the
JAX package's one program sees the global batch).  So each rank's total is
its share of the global loss, and the ranks' shares sum to it.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..parallel import dist
from ..utils import box_ops
from .matcher import compute_cost_matrix, hungarian_assign, minsum_assign


def build_one_hot_targets(src_idx: torch.Tensor, gt_pos_maps: torch.Tensor,
                          gt_valid: torch.Tensor, num_queries: int) -> torch.Tensor:
    """(B, Q, T) token targets: each matched query gets its GT's token map
    (reference groundingdino.py:560-565); the sentinel Q drops out."""
    B, G, T = gt_pos_maps.shape
    rows = torch.where(gt_valid[..., None], gt_pos_maps, torch.zeros_like(gt_pos_maps))
    tgt = torch.zeros(B, num_queries + 1, T, dtype=rows.dtype, device=rows.device)
    tgt[torch.arange(B, device=rows.device)[:, None], src_idx] = rows
    return tgt[:, :num_queries]


def token_sigmoid_focal_loss(pred_logits, one_hot, text_mask, num_pos, alpha: float,
                             gamma: float) -> torch.Tensor:
    """Reference groundingdino.py:467-501 with the masked select as a masked
    sum.  Padded text positions carry -inf logits: they are replaced by 0
    before the BCE and masked out of the sum."""
    logits = pred_logits.float()
    tgt = one_hot.float()
    mask = text_mask[:, None, :]
    safe_logits = torch.where(mask, logits, torch.zeros_like(logits))
    p = safe_logits.sigmoid()
    ce = (safe_logits.clamp(min=0) - safe_logits * tgt
          + torch.log1p(torch.exp(-safe_logits.abs())))
    p_t = p * tgt + (1 - p) * (1 - tgt)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * tgt + (1 - alpha) * (1 - tgt)) * loss
    loss = torch.where(mask, loss, torch.zeros_like(loss))
    return loss.sum() / num_pos


def matched_box_losses(pred_boxes, src_idx, gt_boxes, gt_valid, num_boxes):
    """(L1, GIoU, L1 of cx/cy, L1 of w/h) over matched pairs (reference
    groundingdino.py:438-464)."""
    B, Q, _ = pred_boxes.shape
    idx = src_idx.clamp(max=Q - 1)   # the sentinel's contribution is masked
    matched = torch.gather(pred_boxes, 1, idx[..., None].expand(-1, -1, 4))
    valid = gt_valid[..., None].to(pred_boxes.dtype)
    l1 = (matched - gt_boxes).abs() * valid
    giou = box_ops.generalized_box_iou_elementwise(
        box_ops.box_cxcywh_to_xyxy(matched), box_ops.box_cxcywh_to_xyxy(gt_boxes))
    loss_giou = torch.where(gt_valid, 1.0 - giou, torch.zeros_like(giou)).sum() / num_boxes
    return (l1.sum() / num_boxes, loss_giou, l1[..., :2].sum() / num_boxes,
            l1[..., 2:].sum() / num_boxes)


class SetCriterion:
    def __init__(self, num_queries: int = 900, cost_class: float = 1.0, cost_bbox: float = 5.0,
                 cost_giou: float = 2.0, cls_loss_coef: float = 2.0,
                 bbox_loss_coef: float = 5.0, giou_loss_coef: float = 2.0,
                 interm_loss_coef: float = 1.0, focal_alpha: float = 0.25,
                 focal_gamma: float = 2.0, matcher_type: str = "HungarianMatcher"):
        if matcher_type not in ("HungarianMatcher", "SimpleMinsumMatcher"):
            raise ValueError(f"Unknown matcher_type: {matcher_type}")  # reference matcher.py:205
        self.matcher_type = matcher_type
        self.num_queries = num_queries
        self.cost_class, self.cost_bbox, self.cost_giou = cost_class, cost_bbox, cost_giou
        self.weight_dict = {"loss_ce": cls_loss_coef, "loss_bbox": bbox_loss_coef,
                            "loss_giou": giou_loss_coef}
        self.interm_loss_coef = interm_loss_coef
        self.focal_alpha, self.focal_gamma = focal_alpha, focal_gamma

    def __call__(self, outputs: Dict, gt_boxes: torch.Tensor, gt_pos_maps: torch.Tensor,
                 gt_valid: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Returns (total loss, {loss name: scalar tensor})."""
        text_mask = outputs["text_mask"]
        sets: List[Dict] = [{"pred_logits": outputs["pred_logits"],
                             "pred_boxes": outputs["pred_boxes"]}]
        suffixes = [""]
        for i, aux in enumerate(outputs.get("aux_outputs", [])):
            sets.append(aux)
            suffixes.append(f"_{i}")
        if "interm_outputs" in outputs:
            sets.append(outputs["interm_outputs"])
            suffixes.append("_interm")

        costs = torch.stack([
            compute_cost_matrix(s["pred_logits"], s["pred_boxes"], gt_boxes, gt_pos_maps,
                                gt_valid, self.cost_class, self.cost_bbox, self.cost_giou,
                                self.focal_alpha, self.focal_gamma)
            for s in sets
        ])   # (S, B, Q, G)
        S, B, Q, G = costs.shape
        assign = minsum_assign if self.matcher_type == "SimpleMinsumMatcher" else hungarian_assign
        src_idx = assign(costs.reshape(S * B, Q, G), gt_valid.repeat(S, 1)).reshape(S, B, G)

        # the GT count and each set's matched pairs, over the global batch
        counts = torch.stack([gt_valid.sum()]
                             + [((src_idx[s_i] < Q) & gt_valid).sum() for s_i in range(S)]).float()
        dist.all_reduce_sum_([counts])
        counts = counts.clamp(min=1.0)
        num_boxes = counts[0]
        gt_boxes = gt_boxes.float()
        losses: Dict[str, torch.Tensor] = {}
        total = 0.0
        for s_i, (s, sfx) in enumerate(zip(sets, suffixes)):
            idx = src_idx[s_i]
            num_pos = counts[1 + s_i]
            one_hot = build_one_hot_targets(idx, gt_pos_maps, gt_valid, Q)
            loss_ce = token_sigmoid_focal_loss(s["pred_logits"], one_hot, text_mask, num_pos,
                                               self.focal_alpha, self.focal_gamma)
            loss_bbox, loss_giou, loss_xy, loss_hw = matched_box_losses(
                s["pred_boxes"].float(), idx, gt_boxes, gt_valid, num_boxes)
            losses[f"loss_ce{sfx}"] = loss_ce
            losses[f"loss_bbox{sfx}"] = loss_bbox
            losses[f"loss_giou{sfx}"] = loss_giou
            losses[f"loss_xy{sfx}"] = loss_xy
            losses[f"loss_hw{sfx}"] = loss_hw
            coef = self.interm_loss_coef if sfx == "_interm" else 1.0
            total = total + coef * (self.weight_dict["loss_ce"] * loss_ce
                                    + self.weight_dict["loss_bbox"] * loss_bbox
                                    + self.weight_dict["loss_giou"] * loss_giou)
        return total, losses


def build_criterion(args) -> SetCriterion:
    """From an SLConfig-style args namespace (the JAX package's main.py:152-160)."""
    return SetCriterion(
        num_queries=args.num_queries, cost_class=args.set_cost_class,
        cost_bbox=args.set_cost_bbox, cost_giou=args.set_cost_giou,
        cls_loss_coef=args.cls_loss_coef, bbox_loss_coef=args.bbox_loss_coef,
        giou_loss_coef=args.giou_loss_coef, interm_loss_coef=args.interm_loss_coef,
        focal_alpha=args.focal_alpha, focal_gamma=args.focal_gamma,
        matcher_type=str(getattr(args, "matcher_type", "HungarianMatcher")),
    )
