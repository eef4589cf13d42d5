"""Train state and train step (the port of the JAX package's
parallel/train_state.py::make_train_step).

One step = forward in training mode, criterion (host Hungarian matching),
backward, overflow-safe global-norm clip, grouped AdamW, optional EMA.  A
step whose loss or gradient norm is not finite changes nothing (parameters,
AdamW moments and count, EMA) and adds one to `nonfinite_count`; the JAX
package masks the update on the device, the port decides on the host, which
the matcher synchronises with every step anyway.

The slice trains in float32 (`compute_dtype` None or "float32"): the fusion
kernels are f32-only, so bf16 autocast waits for a later slice and asking for
it raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD
from ..utils.ema import ema_update
from .optim import GroupedAdamW, safe_global_norm

MODEL_INPUT_KEYS = (
    "images", "image_sizes", "input_ids", "text_token_mask",
    "position_ids", "text_self_attention_masks",
)
TARGET_KEYS = ("gt_boxes", "gt_pos_maps", "gt_valid")


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: GroupedAdamW
    generator: torch.Generator          # the fusion blocks' stochastic depth
    step: int = 0
    nonfinite_count: int = 0
    ema: Optional[List[torch.Tensor]] = None   # EMA of model.parameters(), or None

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer: GroupedAdamW, seed: int = 0,
               use_ema: bool = False) -> "TrainState":
        ema = [p.detach().clone() for p in optimizer.params] if use_ema else None
        return cls(model=model, optimizer=optimizer,
                   generator=torch.Generator().manual_seed(seed), ema=ema)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The model inputs and targets of a Collator batch as tensors on
    `device` (integer arrays as int64)."""
    out = {}
    for k in MODEL_INPUT_KEYS + TARGET_KEYS:
        v = np.asarray(batch[k])
        if v.dtype.kind in "iu" and v.dtype != np.uint8:
            v = v.astype(np.int64)
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
    return out


def maybe_device_normalize(images: torch.Tensor, image_sizes: torch.Tensor) -> torch.Tensor:
    """uint8 batches (the Collator's u8_images mode) normalize on the device:
    (x/255 - mean)/std in f32, then the pad region is zeroed again, which
    equals the f32 path's zero padding (the JAX package's
    _maybe_device_normalize).  Float batches pass through."""
    if images.dtype != torch.uint8:
        return images
    mean = torch.as_tensor(IMAGENET_MEAN, device=images.device)
    std = torch.as_tensor(IMAGENET_STD, device=images.device)
    x = (images.float() / 255.0 - mean) / std
    _, H, W, _ = x.shape
    rows = torch.arange(H, device=x.device)[None, :, None, None] < image_sizes[:, 0, None, None, None]
    cols = torch.arange(W, device=x.device)[None, None, :, None] < image_sizes[:, 1, None, None, None]
    return torch.where(rows & cols, x, torch.zeros_like(x))


def make_train_step(criterion, compute_dtype=None, ema_decay: float = 0.0
                    ) -> Callable[[TrainState, Dict], Dict[str, float]]:
    """Returns train_step(state, batch) -> metrics (host floats); it updates
    `state` in place.  `batch` is a Collator batch (numpy)."""
    if compute_dtype not in (None, "float32", "fp32", torch.float32):
        raise ValueError(f"compute_dtype {compute_dtype!r}: the port trains in float32 only "
                         "(bf16 training is queued in ROADMAP.md)")

    def train_step(state: TrainState, batch: Dict) -> Dict[str, float]:
        model, opt = state.model, state.optimizer
        device = opt.params[0].device
        t = to_device(batch, device)
        inputs = {k: t[k] for k in MODEL_INPUT_KEYS}
        inputs["images"] = maybe_device_normalize(inputs["images"], inputs["image_sizes"])
        model.train()
        for p in opt.params:
            p.grad = None
        out = model(**inputs, generator=state.generator)
        total, losses = criterion(out, t["gt_boxes"], t["gt_pos_maps"], t["gt_valid"])
        total.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in opt.params]
        norm = safe_global_norm(grads)
        names = list(losses)
        host = torch.stack([losses[k].detach().float() for k in names]
                           + [total.detach().float(), norm]).tolist()
        metrics = dict(zip(names, host[:-2]))
        metrics["loss"], metrics["grad_norm"] = host[-2], host[-1]
        if np.isfinite(metrics["loss"]) and np.isfinite(metrics["grad_norm"]):
            opt.step(grads, metrics["grad_norm"])
            if state.ema is not None and ema_decay > 0.0:
                ema_update(state.ema, opt.params, ema_decay)
        else:
            state.nonfinite_count += 1
        for p in opt.params:
            p.grad = None
        state.step += 1
        metrics["nonfinite_count"] = state.nonfinite_count
        return metrics

    return train_step
