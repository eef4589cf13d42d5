"""AdamW with the reference's parameter groups, the overflow-safe global-norm
clip and the learning-rate schedules (the port of the JAX package's
parallel/optim.py; reference util/get_param_dicts.py 'ddetr_in_mmdet').

Groups: backbone and text-encoder parameters at lr_backbone, the linear
projections (ref_point_head, sampling_offsets) at lr * lr_linear_proj_mult,
everything else at lr; uniform weight decay; parameters whose name holds a
frozen keyword never change.  The arithmetic is optax's, in the JAX
package's order: `optax.chain(safe_clip_by_global_norm, multi_transform(
{group: adamw}))`, so the clip norm runs over every gradient, frozen ones
included, and each group's AdamW is optax.adamw (b1 0.9, b2 0.999, eps 1e-8,
decoupled weight decay scaled by the group's learning rate).

The update runs on the device with no host read, as the JAX package's does
inside its jitted step: the update count is a device tensor, the clip
scale, the bias corrections and the learning rate (a device lookup of the
schedule's f32 values, `Schedule.table`) are computed from it there, and a
step whose gradients are not finite keeps the parameters, both moments and
the count, as the JAX package masks the optax state
(parallel/train_state.py:119-151).

Each group's gradients and moments are one f32 buffer (the JAX package's
OPT_FLAT=1 layout, without its clip over the non-frozen groups only), so an
update is a number of device operations that does not grow with the number
of parameter tensors but for the batched copies into and out of the
buffers; the guard's norm (`safe_global_norm`) is a few multi-tensor
operations over the whole list.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

BACKBONE_KEYS = ("backbone", "bert")
LINEAR_PROJ_KEYS = ("ref_point_head", "sampling_offsets")


def host_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` on the host, which later in-place updates of `t` leave
    as it is (also where `t` already lies on the host)."""
    return t.detach().to("cpu", copy=True)


@torch.no_grad()
def safe_global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Overflow-safe global L2 norm: rescale by the global max |x| before the
    sum of squares (at a fresh random init single gradients can reach ~1e19,
    whose f32 squares overflow).  Each pass is one multi-tensor operation
    over the list, so its launches do not grow with the number of tensors."""
    tensors = [t.float() for t in tensors]
    if not tensors:
        return torch.zeros(())
    gmax = torch.stack(torch._foreach_norm(tensors, float("inf"))).max().clamp(min=1e-30)
    norms = torch.stack(torch._foreach_norm(torch._foreach_div(tensors, gmax), 2.0))
    return gmax * torch.sqrt((norms * norms).sum())


def clip_scale(norm: float, max_norm: float) -> float:
    """min(1, max_norm / max(norm, 1e-30)): the JAX package's
    safe_clip_by_global_norm (no 1e-6 in the denominator, unlike
    torch.nn.utils.clip_grad_norm_).  GroupedAdamW.step computes the same on
    the device, in f32."""
    return min(1.0, max_norm / max(norm, 1e-30))


def label_for_name(name: str, backbone_keys: Sequence[str] = BACKBONE_KEYS,
                   proj_keys: Sequence[str] = LINEAR_PROJ_KEYS) -> str:
    """'backbone', 'linear_proj' or 'base' by substring of the parameter
    name (the JAX package's _label_for_path)."""
    if any(k in name for k in backbone_keys):
        return "backbone"
    if any(k in name for k in proj_keys):
        return "linear_proj"
    return "base"


def label_params(named_params: Iterable[Tuple[str, torch.Tensor]],
                 frozen_keys: Sequence[str] = ()) -> Dict[str, str]:
    """{parameter name: group}; a name holding a frozen keyword is 'frozen'."""
    return {n: ("frozen" if any(k in n for k in frozen_keys) else label_for_name(n))
            for n, _ in named_params}


class GroupedAdamW:
    """AdamW over the parameter groups above, on one f32 buffer a group (the
    layout of the JAX package's OPT_FLAT=1 `_flat_grouped_adamw`,
    parallel/optim.py:152-275, with optax's clip).  `step(grads, norm,
    finite)` clips by the given global norm, then updates every non-frozen
    parameter in place, on the device, where `finite` holds: each group's
    gradients are copied into one buffer (one `torch.cat`), the clip, the
    moments and the update are a fixed number of operations on the group's
    buffers, and the update reaches the parameters through one
    `_foreach_add_` over the buffer's split, so the number of operations of
    an update does not grow with the number of parameter tensors.  The
    parameters stay tensors of their own.

    `m` and `v` (the moments, by parameter) are views of the group buffers
    in each parameter's shape, frozen parameters' zeros of their own that
    never change; `count` is the update count (optax's
    ScaleByAdamState.count, a device int64 tensor; the schedule reads the
    count before the step).  `lr` is a Schedule of this module
    (make_optimizer wraps a float)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 lr: "Schedule", base_lr: float, lr_backbone: float,
                 lr_linear_proj_mult: float = 0.1, weight_decay: float = 1e-4,
                 clip_max_norm: float = 0.1, frozen_keys: Sequence[str] = (),
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        if not isinstance(lr, Schedule):
            raise TypeError("GroupedAdamW's lr is a Schedule of parallel/optim.py "
                            "(make_optimizer takes a float too)")
        named = list(named_params)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.labels = label_params(named, frozen_keys)
        self.mults = {"base": 1.0, "backbone": lr_backbone / float(base_lr),
                      "linear_proj": lr_linear_proj_mult}
        self.lr, self.weight_decay, self.clip_max_norm = lr, weight_decay, clip_max_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.groups: Dict[str, List[int]] = {g: [] for g in self.mults}
        for i, n in enumerate(self.names):
            if self.labels[n] != "frozen":
                self.groups[self.labels[n]].append(i)
        self.groups = {g: idx for g, idx in self.groups.items() if idx}
        # {group: (its first moment's buffer, its second's)}, f32
        self.buffers = {g: tuple(torch.zeros(sum(self.params[i].numel() for i in idx),
                                             dtype=torch.float32, device=self.params[idx[0]].device)
                                 for _ in range(2))
                        for g, idx in self.groups.items()}
        self.m, self.v = self._moment_views(0), self._moment_views(1)
        self.count = torch.zeros((), dtype=torch.int64,
                                 device=self.params[0].device if self.params else "cpu")
        self._lr_table = None   # (starts, f32 values) of `lr` on the parameters' device

    def _moment_views(self, k: int) -> List[torch.Tensor]:
        """Moment k of each parameter: a view of its group's buffer, or for a
        frozen parameter zeros of its own."""
        views = {}
        for g, idx in self.groups.items():
            views.update(zip(idx, _unflatten_dense_tensors(
                self.buffers[g][k], [self.params[i] for i in idx])))
        return [views[i] if i in views else torch.zeros_like(p)
                for i, p in enumerate(self.params)]

    def state_dict(self) -> Dict:
        """{"m": {name: first moment}, "v": {name: second moment}, "count"}:
        host copies by parameter name, the count an int."""
        return {"m": {n: host_copy(t) for n, t in zip(self.names, self.m)},
                "v": {n: host_copy(t) for n, t in zip(self.names, self.v)},
                "count": int(self.count)}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Copy a state_dict() into the moments in place (on their device);
        the names must be this optimizer's."""
        for key, moments in (("m", self.m), ("v", self.v)):
            if set(state[key]) != set(self.names):
                raise KeyError(f"optimizer state {key!r} names other parameters than the model's")
            for n, t in zip(self.names, moments):
                t.copy_(state[key][n])
        self.count = torch.tensor(int(state["count"]), dtype=torch.int64,
                                  device=self.params[0].device if self.params else "cpu")

    def _schedule(self, norm, finite):
        """The device scalars of one update: (finite, lr, bias corrections
        bc1 and bc2, the first and second moments' decays, the clip scale
        by `norm`), the decays 1 and the clip scale 1 where not finite;
        `count` becomes a device tensor if it was a host number."""
        dev = self.params[0].device
        norm = torch.as_tensor(norm, dtype=torch.float32, device=dev)
        finite = torch.as_tensor(finite, dtype=torch.bool, device=dev)
        count = torch.as_tensor(self.count, dtype=torch.int64, device=dev)
        self.count = count
        t = (count + 1).to(torch.float32)
        scale = torch.where(finite, (self.clip_max_norm / norm.clamp(min=1e-30)).clamp(max=1.0), 1.0)
        return (finite, self.lr_at(count), 1.0 - torch.pow(self.b1, t),
                1.0 - torch.pow(self.b2, t), torch.where(finite, self.b1, 1.0),
                torch.where(finite, self.b2, 1.0), scale)

    def lr_at(self, count: torch.Tensor) -> torch.Tensor:
        """The schedule's f32 value at a device count, looked up there."""
        if self._lr_table is None or self._lr_table[0].device != count.device:
            starts, values = self.lr.table()
            self._lr_table = (torch.from_numpy(starts).to(count.device),
                              torch.from_numpy(values).to(count.device))
        starts, values = self._lr_table
        idx = torch.searchsorted(starts, count.reshape(1), right=True) - 1
        return values.index_select(0, idx.clamp(min=0)).reshape(())

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], norm, finite) -> None:
        """One update with no host read.  `grads`: a gradient of each
        parameter; `norm`: their global norm, frozen ones included (the clip
        norm, optax's); `finite`: whether the step is taken (the train
        step's guard: the loss and the norm finite); each a device tensor,
        or a host number.  Where `finite` is False the gradients are taken
        as zero (by torch.where: NaN * 0 is NaN), the moments and the count
        keep their values and the parameters do not move: the decays act as
        1, the step size as 0."""
        finite, lr, bc1, bc2, b1, b2, scale = self._schedule(norm, finite)
        for group, idx in self.groups.items():
            params = [self.params[i] for i in idx]
            m, v = self.buffers[group]
            g = torch.where(finite, _flatten_dense_tensors([grads[i] for i in idx]).float(), 0.0)
            g.mul_(scale)
            m.mul_(b1)
            m.add_(g, alpha=1.0 - self.b1)
            v.mul_(b2)
            v.add_(g * g, alpha=1.0 - self.b2)
            upd = m / bc1
            den = (v / bc2).sqrt_()
            den.add_(self.eps)
            upd.div_(den)
            upd.add_(_flatten_dense_tensors(params), alpha=self.weight_decay)
            upd.mul_(torch.where(finite, -(lr * self.mults[group]), 0.0))
            torch._foreach_add_(params, _unflatten_dense_tensors(upd, params))
        self.count = torch.where(finite, self.count + 1, self.count)


def make_optimizer(model: torch.nn.Module, lr, base_lr: float, lr_backbone: float,
                   lr_linear_proj_mult: float = 0.1, weight_decay: float = 1e-4,
                   clip_max_norm: float = 0.1, frozen_keys: Sequence[str] = ()) -> GroupedAdamW:
    """`lr` is a float or a Schedule (count -> lr); the backbone multiplier is
    lr_backbone / base_lr, base_lr being the schedule's nominal peak
    (reference get_param_dicts.py:34-53)."""
    schedule = lr if isinstance(lr, Schedule) else constant_schedule(float(lr))
    return GroupedAdamW(model.named_parameters(), schedule, base_lr, lr_backbone,
                        lr_linear_proj_mult, weight_decay, clip_max_norm, frozen_keys)


class Schedule:
    """A learning-rate schedule of the update count.  `values(counts)` gives
    the rate at an array of counts (numpy), `schedule(count)` at one, and
    `table()` the (starts, f32 values) it takes on the device: the rate is
    values[k] from starts[k] until starts[k + 1] (and after the last start),
    the f32 of `values` at each start, so the device reads the host's values
    to the last bit (GroupedAdamW.lr_at)."""

    def __init__(self, values: Callable[[np.ndarray], np.ndarray], starts: Sequence[int]):
        self.values = values
        self.starts = np.asarray(starts, np.int64)

    def __call__(self, count: int) -> float:
        return float(self.values(np.asarray([count], np.int64))[0])

    def table(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.starts, self.values(self.starts).astype(np.float32)


def constant_schedule(value: float) -> Schedule:
    return Schedule(lambda counts: np.full(np.shape(counts), float(value)), [0])


def cosine_onecycle_schedule(transition_steps: int, peak_value: float, pct_start: float = 0.3,
                             div_factor: float = 25.0,
                             final_div_factor: float = 1e4) -> Schedule:
    """optax.cosine_onecycle_schedule: piecewise cosine interpolation from
    peak/div_factor up to peak at int(pct_start * transition_steps), down to
    peak/(div_factor * final_div_factor) at transition_steps, constant after.
    The interpolation runs in float32 in optax's order, so the values are
    optax's to the last bits (the f32 cancellation near the ends included).
    Its device table holds every count up to transition_steps."""
    if transition_steps <= 0:
        raise ValueError("a onecycle schedule needs transition_steps > 0")
    bounds = [0, int(pct_start * transition_steps), int(transition_steps)]
    values = np.cumprod([peak_value / div_factor, div_factor,
                         1.0 / (div_factor * final_div_factor)])

    def rates(counts: np.ndarray) -> np.ndarray:
        counts = np.asarray(counts, np.int64)
        out = np.full(counts.shape, float(np.float32(values[-1])))
        for i in range(len(bounds) - 1):
            sel = (counts >= bounds[i]) & (counts < bounds[i + 1])
            if not sel.any():
                continue
            pct = (counts[sel] - bounds[i]) / (bounds[i + 1] - bounds[i])
            cos = np.cos((math.pi * pct).astype(np.float32), dtype=np.float32)
            half = np.float32((values[i] - values[i + 1]) / 2.0)
            out[sel] = np.float32(values[i + 1]) + half * (cos + np.float32(1.0))
        return out

    return Schedule(rates, np.arange(bounds[-1] + 1))


def piecewise_constant_schedule(init_value: float,
                                boundaries_and_scales: Dict[int, float]) -> Schedule:
    """optax.piecewise_constant_schedule: init_value times every scale whose
    boundary the count has reached."""
    steps = sorted(boundaries_and_scales.items())

    def rates(counts: np.ndarray) -> np.ndarray:
        counts = np.asarray(counts, np.int64)
        v = np.full(counts.shape, float(init_value))
        for threshold, scale in steps:
            v = np.where(counts >= threshold, v * scale, v)
        return v

    return Schedule(rates, sorted({0, *(max(int(t), 0) for t, _ in steps)}))


def make_lr_schedule(args, steps_per_epoch: int) -> Schedule:
    """Reference main.py:334-339 as the JAX package builds it: OneCycle
    (pct_start 0.2) / MultiStep / StepLR, in optimizer steps."""
    base = float(args.lr)
    total_steps = int(args.epochs) * steps_per_epoch
    if getattr(args, "onecyclelr", False):
        return cosine_onecycle_schedule(total_steps, base, pct_start=0.2)
    if getattr(args, "multi_step_lr", False):
        return piecewise_constant_schedule(
            base, {int(e) * steps_per_epoch: 0.1 for e in args.lr_drop_list})
    return piecewise_constant_schedule(base, {int(args.lr_drop) * steps_per_epoch: 0.1})
