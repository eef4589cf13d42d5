"""Box utilities (reference util/box_ops.py; the port's counterpart of the
JAX package's utils/box_ops.py): cxcywh<->xyxy conversions, pairwise and
elementwise IoU and generalized IoU, broadcast over leading dims; the
reference's CIoU and DIoU losses."""
from __future__ import annotations

import math

import torch


def box_cxcywh_to_xyxy(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) center-size -> corner format."""
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], -1)


def box_xyxy_to_cxcywh(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) corner -> center-size format."""
    x0, y0, x1, y1 = x.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], -1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyxy -> (...,) area."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Pairwise IoU of (..., N, 4) and (..., M, 4) xyxy boxes -> (iou, union),
    each (..., N, M)."""
    area1, area2 = box_area(boxes1), box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union, union


def generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU (https://giou.stanford.edu/) of xyxy boxes -> (..., N, M).
    No degeneracy asserts: invalid boxes give invalid values that the caller
    masks, as the JAX package's does."""
    iou, union = box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area


def box_iou_elementwise(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """IoU of same-shaped (..., 4) xyxy boxes -> (iou, union), each (...)."""
    area1, area2 = box_area(boxes1), box_area(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    return inter / union, union


def generalized_box_iou_elementwise(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """GIoU of same-shaped (..., 4) xyxy boxes."""
    iou, union = box_iou_elementwise(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area


def _sigmoid_boxes(bboxes1: torch.Tensor, bboxes2: torch.Tensor):
    """The CIoU/DIoU terms of raw (N, 4) box parameters under the
    reference's parameterization (sigmoid, then widths and heights exp'd
    from the sigmoided values): (iou, inter_diag / c_diag, w1, h1, w2, h2)."""
    b1, b2 = bboxes1.float().sigmoid(), bboxes2.float().sigmoid()
    w1, h1 = torch.exp(b1[:, 2]), torch.exp(b1[:, 3])
    w2, h2 = torch.exp(b2[:, 2]), torch.exp(b2[:, 3])
    cx1, cy1, cx2, cy2 = b1[:, 0], b1[:, 1], b2[:, 0], b2[:, 1]
    inter_w = (torch.minimum(cx1 + w1 / 2, cx2 + w2 / 2)
               - torch.maximum(cx1 - w1 / 2, cx2 - w2 / 2)).clamp(min=0)
    inter_h = (torch.minimum(cy1 + h1 / 2, cy2 + h2 / 2)
               - torch.maximum(cy1 - h1 / 2, cy2 - h2 / 2)).clamp(min=0)
    inter = inter_w * inter_h
    c_w = (torch.maximum(cx1 + w1 / 2, cx2 + w2 / 2)
           - torch.minimum(cx1 - w1 / 2, cx2 - w2 / 2)).clamp(min=0)
    c_h = (torch.maximum(cy1 + h1 / 2, cy2 + h2 / 2)
           - torch.minimum(cy1 - h1 / 2, cy2 - h2 / 2)).clamp(min=0)
    inter_diag = (cx2 - cx1) ** 2 + (cy2 - cy1) ** 2
    c_diag = c_w ** 2 + c_h ** 2
    union = w1 * h1 + w2 * h2 - inter
    return inter / union, inter_diag / c_diag, w1, h1, w2, h2


def ciou_loss(bboxes1: torch.Tensor, bboxes2: torch.Tensor) -> torch.Tensor:
    """Complete-IoU loss, 1 - CIoU, elementwise over matched pairs (N, 4) ->
    (N,) (reference util/box_loss.py:7-57, the JAX package's ciou_loss): raw
    box parameters through the reference's sigmoid/exp parameterization; the
    trade-off weight alpha carries no gradient, as the JAX package's
    stop_gradient.  No shipped config uses it (the box loss is L1 + GIoU)."""
    iou, u, w1, h1, w2, h2 = _sigmoid_boxes(bboxes1, bboxes2)
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    alpha = torch.where(iou > 0.5, v / (1 - iou + v), 0.0).detach()
    return 1 - (iou - u - alpha * v).clamp(-1.0, 1.0)


def diou_loss(bboxes1: torch.Tensor, bboxes2: torch.Tensor) -> torch.Tensor:
    """Distance-IoU loss, 1 - DIoU (reference util/box_loss.py:59-111, the
    JAX package's diou_loss); the parameterization of ciou_loss."""
    iou, u, *_ = _sigmoid_boxes(bboxes1, bboxes2)
    return 1 - (iou - u).clamp(-1.0, 1.0)
