"""Train state, train step and eval step (the port of the JAX package's
parallel/train_state.py::make_train_step, make_multi_train_step and
make_eval_step).

One step = forward in training mode, criterion (Hungarian matching on the
device, models/matcher.py), backward, overflow-safe global-norm clip,
grouped AdamW, optional EMA, with no host read inside it, as the JAX
package's jitted step: once the batch is on the device the host only
queues work.  A step whose loss or gradient norm is not finite changes
nothing (parameters, AdamW moments and count, EMA) and adds one to
`nonfinite_count`, all masked on the device (the JAX package's
train_state.py:119-151); the metrics it returns are device tensors, which
the training loop reads at its logging cadence (engine.py).
`make_multi_train_step` runs n such steps on a batch stacked n deep.

Mixed precision (`compute_dtype="bfloat16"`, the configs' default, as the
JAX package's): the forward runs on every floating parameter cast to bf16 by
a differentiable `.to` and on bf16 images, so the gradients reach the f32
master parameters in f32, and the clip, AdamW and the EMA stay f32.  No loss
scaling: bf16 has f32's exponent range.  No torch.autocast: the model runs
on what it is given, with the JAX package's casts and promotions
(models/precision.py).  None or "float32" runs the f32 step unchanged.

Under a process group (parallel/dist.py) each rank runs the step on its
shard of the global batch: the criterion normalises by the global counts,
and the gradients and losses are summed over the ranks (bucketed
all_reduce) before the global norm, so the clip, AdamW, the EMA, the finite
check and the logged metrics see the global batch's values on every rank,
and the ranks' parameters, counts and `nonfinite_count` stay equal.  No DistributedDataParallel: the bf16
step runs the model on swapped-in cast parameters, which DDP's hooks do not
see.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD
from ..utils.device import device_constant
from ..utils.ema import ema_update
from . import dist
from .optim import GroupedAdamW, host_copy, safe_global_norm

MODEL_INPUT_KEYS = (
    "images", "image_sizes", "input_ids", "text_token_mask",
    "position_ids", "text_self_attention_masks",
)
TARGET_KEYS = ("gt_boxes", "gt_pos_maps", "gt_valid")


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: GroupedAdamW
    generator: torch.Generator          # the fusion blocks' stochastic depth, text dropout
    step: int = 0
    # the steps whose loss or gradients were not finite: a device int64
    # tensor the step updates with no host read (an int where set by hand)
    nonfinite_count: Union[int, torch.Tensor] = 0
    ema: Optional[List[torch.Tensor]] = None   # EMA of model.parameters(), or None

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer: GroupedAdamW, seed: int = 0,
               use_ema: bool = False) -> "TrainState":
        ema = [p.detach().clone() for p in optimizer.params] if use_ema else None
        return cls(model=model, optimizer=optimizer,
                   generator=torch.Generator().manual_seed(seed), ema=ema,
                   nonfinite_count=torch.zeros((), dtype=torch.int64,
                                               device=optimizer.params[0].device))

    def state_dict(self) -> Dict:
        """Host copies of everything a resumed run needs: "model" (the
        model's reference-keyed state dict, so the dict reads as a reference
        .pth), "optimizer", "ema" (by parameter name, or None), "step",
        "nonfinite_count" (an int) and "generator" (the stochastic-depth
        generator's state)."""
        names = self.optimizer.names
        return {
            "model": {k: host_copy(v) for k, v in self.model.state_dict().items()},
            "optimizer": self.optimizer.state_dict(),
            "ema": None if self.ema is None else {n: host_copy(e) for n, e in zip(names, self.ema)},
            "step": self.step,
            "nonfinite_count": int(self.nonfinite_count),
            "generator": self.generator.get_state(),
        }

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Restore a state_dict() in place: the model strictly, the moments,
        the EMA (when both sides keep one), the counters and the generator."""
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        if (self.ema is None) != (state["ema"] is None):
            raise ValueError("the checkpoint and the run disagree on use_ema")
        if self.ema is not None:
            for n, e in zip(self.optimizer.names, self.ema):
                e.copy_(state["ema"][n])
        self.step = int(state["step"])
        self.nonfinite_count = torch.tensor(int(state["nonfinite_count"]), dtype=torch.int64,
                                            device=self.optimizer.params[0].device)
        self.generator.set_state(state["generator"])


def to_device(batch: Dict[str, np.ndarray], device,
              keys=MODEL_INPUT_KEYS + TARGET_KEYS) -> Dict[str, torch.Tensor]:
    """The model inputs and targets (`keys`) of a Collator batch as tensors
    on `device` (integer arrays as int64).  For a CUDA device each array is
    staged in page-locked memory, so that its copy queues behind the work
    already launched instead of waiting for it (the eval loop launches a
    batch while the card still runs the one before).  A tensor (a batch
    staged on the device ahead) is moved only if it lies elsewhere."""
    out = {}
    pin = torch.device(device).type == "cuda"
    for k in keys:
        if isinstance(batch[k], torch.Tensor):
            out[k] = batch[k].to(device)
            continue
        v = np.asarray(batch[k])
        if v.dtype.kind in "iu" and v.dtype != np.uint8:
            v = v.astype(np.int64)
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.pin_memory() if pin else t).to(device, non_blocking=True)
    return out


def maybe_device_normalize(images: torch.Tensor, image_sizes: torch.Tensor) -> torch.Tensor:
    """uint8 batches (the Collator's u8_images mode) normalize on the device:
    (x/255 - mean)/std in f32, then the pad region is zeroed again, which
    equals the f32 path's zero padding (the JAX package's
    _maybe_device_normalize).  Float batches pass through."""
    if images.dtype != torch.uint8:
        return images
    mean = device_constant("imagenet_mean", lambda: torch.tensor(IMAGENET_MEAN), images.device)
    std = device_constant("imagenet_std", lambda: torch.tensor(IMAGENET_STD), images.device)
    x = (images.float() / 255.0 - mean) / std
    _, H, W, _ = x.shape
    rows = torch.arange(H, device=x.device)[None, :, None, None] < image_sizes[:, 0, None, None, None]
    cols = torch.arange(W, device=x.device)[None, None, :, None] < image_sizes[:, 1, None, None, None]
    return torch.where(rows & cols, x, torch.zeros_like(x))


_DTYPES = {None: None, "float32": None, "fp32": None, torch.float32: None,
           "bfloat16": torch.bfloat16, torch.bfloat16: torch.bfloat16}


def resolve_compute_dtype(compute_dtype) -> Optional[torch.dtype]:
    """None for the f32 step (None, "float32"), torch.bfloat16 for mixed
    precision; anything else raises."""
    try:
        return _DTYPES[compute_dtype]
    except (KeyError, TypeError):
        raise ValueError(f"compute_dtype {compute_dtype!r}: the port computes in float32 or "
                         "bfloat16") from None


def cast_floating(params: Dict[str, torch.Tensor], dtype) -> Dict[str, torch.Tensor]:
    """Floating tensors cast to `dtype` by a differentiable `.to` (the JAX
    package's cast_floating): gradients reach the originals in their own
    dtype.  Already-cast tensors come back as they are."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in params.items()}


@contextlib.contextmanager
def swapped_parameters(model: torch.nn.Module, values: Dict[str, torch.Tensor]) -> Iterator[None]:
    """Within the block each parameter named in `values` (by
    model.named_parameters()) reads as its value there, under every name it
    has: a tied parameter (the shared box head) is swapped by identity, so
    its aliases stay tied.  Unlike torch.func.functional_call, the swap
    lasts past the forward, through the backward, where torch.utils.checkpoint
    replays the fusion and encoder blocks on the same cast weights."""
    by_id = {id(p): values[n] for n, p in model.named_parameters() if n in values}
    saved = []
    for m in model.modules():
        for name, p in m._parameters.items():
            if p is not None and id(p) in by_id:
                saved.append((m, name, p))
                m._parameters[name] = by_id[id(p)]
    try:
        yield
    finally:
        for m, name, p in saved:
            m._parameters[name] = p


def make_train_step(criterion, compute_dtype=None, ema_decay: float = 0.0
                    ) -> Callable[[TrainState, Dict], Dict[str, torch.Tensor]]:
    """Returns train_step(state, batch) -> metrics, 0-dim device tensors (each
    loss, "loss", "grad_norm", "nonfinite_count" after the step); it updates
    `state` in place and reads nothing back to the host.  `batch` is a
    Collator batch (numpy, or tensors already on the device).
    compute_dtype: None / "float32" (f32) or "bfloat16" (mixed precision,
    see above)."""
    dtype = resolve_compute_dtype(compute_dtype)

    def train_step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        model, opt = state.model, state.optimizer
        device = opt.params[0].device
        t = to_device(batch, device)
        inputs = {k: t[k] for k in MODEL_INPUT_KEYS}
        inputs["images"] = maybe_device_normalize(inputs["images"], inputs["image_sizes"])
        model.train()
        for p in opt.params:
            p.grad = None
        if dtype is None:
            out = model(**inputs, generator=state.generator)
            total, losses = criterion(out, t["gt_boxes"], t["gt_pos_maps"], t["gt_valid"])
            total.backward()
        else:
            inputs["images"] = inputs["images"].to(dtype)
            with swapped_parameters(model, cast_floating(dict(model.named_parameters()), dtype)):
                out = model(**inputs, generator=state.generator)
                total, losses = criterion(out, t["gt_boxes"], t["gt_pos_maps"], t["gt_valid"])
                total.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in opt.params]
        names = list(losses)
        reduced = torch.stack([losses[k].detach().float() for k in names]
                              + [total.detach().float()])
        # the global batch's gradients and losses: the ranks' shares summed
        dist.all_reduce_sum_(grads + [reduced])
        norm = safe_global_norm(grads)
        # the JAX package's guard, on the device and the same on every rank
        # (both terms are all-reduced): a non-finite loss or norm skips the
        # whole update
        finite = torch.isfinite(reduced[-1]) & torch.isfinite(norm)
        opt.step(grads, norm, finite)
        if state.ema is not None and ema_decay > 0.0:
            ema_update(state.ema, opt.params, ema_decay, finite)
        for p in opt.params:
            p.grad = None
        state.step += 1
        count = torch.as_tensor(state.nonfinite_count, dtype=torch.int64, device=device)
        state.nonfinite_count = count + (~finite).to(torch.int64)
        metrics = dict(zip(names, reduced[:-1]))
        metrics["loss"], metrics["grad_norm"] = reduced[-1], norm
        metrics["nonfinite_count"] = state.nonfinite_count
        return metrics

    train_step.compute_dtype = "float32" if dtype is None else "bfloat16"
    return train_step


def make_multi_train_step(criterion, n_steps: int, **step_kwargs
                          ) -> Callable[[TrainState, Dict], Dict[str, torch.Tensor]]:
    """Returns multi_step(state, batches) -> metrics stacked to (n_steps,):
    n_steps optimizer steps on a batch whose model inputs and targets are
    stacked n_steps deep (the JAX package's make_multi_train_step, a
    lax.scan there; a loop of the same step here).  The stack goes to the
    device in one copy a key, then the steps run with no host read between
    them: each draws its stochastic depth and text dropout from the state's
    generator as n single steps would, and the non-finite guard acts on each
    step."""
    step = make_train_step(criterion, **step_kwargs)

    def multi_step(state: TrainState, batches: Dict) -> Dict[str, torch.Tensor]:
        device = state.optimizer.params[0].device
        stacked = to_device(batches, device)
        per_step = [step(state, {k: v[i] for k, v in stacked.items()}) for i in range(n_steps)]
        return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

    multi_step.compute_dtype = step.compute_dtype
    return multi_step


def make_eval_step(model: torch.nn.Module, criterion=None, compute_dtype=None) -> Callable:
    """Returns eval_step(batch, params=None) -> {"pred_logits", "pred_boxes"}
    (plus "loss" and "losses" with a criterion and GT in the batch), the JAX
    package's make_eval_step: the model in eval mode, no gradients.  `params`
    (name -> tensor, e.g. a copy cast once ahead of an evaluation) stands in
    for the model's parameters; under bf16 they are cast, which leaves
    already-cast ones as they are."""
    dtype = resolve_compute_dtype(compute_dtype)

    @torch.no_grad()
    def eval_step(batch: Dict, params: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
        device = next(model.parameters()).device
        has_gt = criterion is not None and "gt_boxes" in batch
        t = to_device(batch, device, MODEL_INPUT_KEYS + (TARGET_KEYS if has_gt else ()))
        inputs = {k: t[k] for k in MODEL_INPUT_KEYS}
        inputs["images"] = maybe_device_normalize(inputs["images"], inputs["image_sizes"])
        values = dict(model.named_parameters()) if params is None else params
        if dtype is not None:
            inputs["images"] = inputs["images"].to(dtype)
            values = cast_floating(values, dtype)
        model.eval()
        with swapped_parameters(model, values):
            out = model(**inputs)
        result = {"pred_logits": out["pred_logits"], "pred_boxes": out["pred_boxes"]}
        if has_gt:
            total, losses = criterion(out, t["gt_boxes"], t["gt_pos_maps"], t["gt_valid"])
            result["loss"], result["losses"] = total, losses
        return result

    return eval_step
