"""PostProcess: model outputs -> COCO-style detections (the port of the JAX
package's models/postprocess.py; reference groundingdino.py:642-723).

Sigmoid token logits, projected to class probabilities through the
row-normalized label positive map, top-num_select over (query x class),
cxcywh -> xyxy scaled to the original size, optional class-agnostic NMS.
The projection and top-k run on the logits' device (`PostProcess.device`,
no host sync); the host half (`PostProcess.host`) makes the one
device-to-host copy and the NMS.  An eval loop that launches the next batch
before the host half starts that copy first (`PostProcess.copy_to_host`).  The COCO 80 -> 91 category-id remap lives
here as in the reference (:661-666).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..utils.box_ops import box_cxcywh_to_xyxy

COCO_ID_MAP = {i: cid for i, cid in enumerate(
    [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21,
     22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
     43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61,
     62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84,
     85, 86, 87, 88, 89, 90]
)}


def normalize_pos_map(pos_map: np.ndarray) -> np.ndarray:
    """Row-normalize a (n_classes, T) positive map (rows with zero sum stay
    zero), reference groundingdino.py:687-689."""
    s = pos_map.sum(-1, keepdims=True)
    return np.where(s > 0, pos_map / np.maximum(s, 1e-12), 0.0)


def postprocess(pred_logits: torch.Tensor, pred_boxes: torch.Tensor, pos_map: torch.Tensor,
                target_sizes: torch.Tensor, num_select: int = 300):
    """pred_logits (B, Q, T), pred_boxes (B, Q, 4) cxcywh, pos_map (C, T)
    row-normalized, target_sizes (B, 2) (h, w).  Returns (scores (B, K),
    labels (B, K) int64, boxes (B, K, 4) xyxy in pixels), K = num_select,
    scores in descending order."""
    prob_token = torch.sigmoid(pred_logits.float())
    # -inf logits on padded text sigmoid to 0; the projection is a product
    prob_label = torch.matmul(prob_token, pos_map.float().T)   # (B, Q, C)
    B, Q, C = prob_label.shape
    scores, idx = torch.topk(prob_label.reshape(B, Q * C), num_select, dim=1)
    query, labels = idx // C, idx % C
    boxes = box_cxcywh_to_xyxy(pred_boxes.float())
    boxes = torch.gather(boxes, 1, query[..., None].expand(-1, -1, 4))
    h, w = target_sizes[:, 0], target_sizes[:, 1]
    scale = torch.stack([w, h, w, h], dim=1).float()
    return scores, labels, boxes * scale[:, None, :]


def nms_numpy(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Greedy class-agnostic NMS on the host (eval only): the kept indices,
    highest score first."""
    order = np.argsort(-scores)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        rest = order[~suppressed[order]]
        if len(rest) == 0:
            break
        xx0 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy0 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx1 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy1 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.clip(xx1 - xx0, 0, None) * np.clip(yy1 - yy0, 0, None)
        a = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        b = (boxes[rest, 2] - boxes[rest, 0]) * (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / np.maximum(a + b - inter, 1e-12)
        suppressed[rest[iou > iou_threshold]] = True
    return np.asarray(keep, np.int64)


class PostProcess:
    """Binds a fixed category list: its caption's positive map is built once
    (reference PostProcess.__init__:644-670).  With coco_id_remap the labels
    are COCO category ids (`emits_coco_ids`), and eval callers skip their
    dataset's contiguous_to_catid."""

    def __init__(self, tokenizer, cat_list: Sequence[str], num_select: int = 300,
                 max_text_len: int = 256, nms_iou_threshold: float = -1.0,
                 coco_id_remap: bool = False):
        from ..data.tokenization import build_caption, create_positive_map

        caption = build_caption(cat_list)
        tok = tokenizer([caption], padding=max_text_len)
        pm = create_positive_map(tok, 0, list(range(len(cat_list))), cat_list, caption,
                                 max_text_len)
        if coco_id_remap:
            remapped = np.zeros((91, max_text_len), np.float32)
            for i in range(len(cat_list)):
                remapped[COCO_ID_MAP[i]] = pm[i]
            pm = remapped
        self.pos_map = normalize_pos_map(pm)
        self.caption = caption
        self.tokenized = tok
        self.num_select = num_select
        self.nms_iou_threshold = nms_iou_threshold
        self.emits_coco_ids = coco_id_remap
        self._pos_map_on: Dict[torch.device, torch.Tensor] = {}

    def device(self, outputs: Dict, target_sizes: np.ndarray) -> torch.Tensor:
        """The device half on the logits' device: one packed (B, K, 6) f32
        tensor (score, label, x0, y0, x1, y1), with no host sync, so an eval
        loop can launch the next batch before it reads these."""
        logits = outputs["pred_logits"]
        dev = logits.device
        if dev not in self._pos_map_on:
            self._pos_map_on[dev] = torch.from_numpy(self.pos_map).float().to(dev)
        sizes = torch.from_numpy(np.asarray(target_sizes, np.int64))
        if dev.type == "cuda":
            sizes = sizes.pin_memory()
        s, l, b = postprocess(logits, outputs["pred_boxes"], self._pos_map_on[dev],
                              sizes.to(dev, non_blocking=True), self.num_select)
        return torch.cat([s[..., None], l[..., None].to(s.dtype), b], dim=-1)

    @staticmethod
    def copy_to_host(packed: torch.Tensor):
        """Start the device-to-host copy of device()'s result now, into
        page-locked memory, and return it for host(): the copy then queues
        ahead of whatever is launched next on the stream (the next batch's
        forward), and host() waits for it alone.  A CPU tensor comes back as
        it is."""
        if packed.device.type != "cuda":
            return packed
        out = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        out.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(packed.device))
        return out, done

    def host(self, packed) -> List[Dict]:
        """The host half: the one device-to-host copy (or the wait for the
        one copy_to_host started), then per image the optional NMS;
        [{"scores", "labels", "boxes"}] in numpy."""
        if isinstance(packed, tuple):
            packed, done = packed
            done.synchronize()
        packed = packed.cpu().numpy()
        scores, labels, boxes = packed[..., 0], packed[..., 1].astype(np.int32), packed[..., 2:6]
        results = []
        for s, l, b in zip(scores, labels, boxes):
            if self.nms_iou_threshold > 0:
                keep = nms_numpy(b, s, self.nms_iou_threshold)
                s, l, b = s[keep], l[keep], b[keep]
            results.append({"scores": s, "labels": l, "boxes": b})
        return results

    def __call__(self, outputs: Dict, target_sizes: np.ndarray) -> List[Dict]:
        return self.host(self.device(outputs, target_sizes))
