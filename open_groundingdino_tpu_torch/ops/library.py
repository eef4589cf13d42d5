"""The serving paths' forward kernels as `torch.library` custom ops.

Each kernel that a forward of the model launches has a dispatcher-level
identity in the namespace `ogd_torch`, so that PyTorch's graph tools
(`torch.export`, serving.py) see it as one operator and not as the ctypes
call inside it:

  ogd_torch::msda_fwd        K1, ops/msda.py            (gather path)
  ogd_torch::fusion_fwd      K2, ops/fusion.py          (every path)
  ogd_torch::banded_fwd      K5, ops/msda_banded.py     (banded_point path)
  ogd_torch::sweep_fwd       K6, ops/msda_sweep.py      (sweep path)
  ogd_torch::sweep_fwd_allq  K7, ops/msda_sweep.py      (sweep, dec_fused)

Each op is defined beside its launcher.  Its CUDA implementation is the
launcher, unchanged, on the current stream (which counts the launch); its CPU
implementation is the kernel's plain version; its fake implementation gives
the output shapes and dtypes without touching data.  Schemas take the level
shapes flat (h0, w0, h1, w1, ...), as custom-op schemas take no nested
tuples.  The ops carry no autograd formula: the training path reaches the
kernels through the autograd Functions of those modules, whose forwards call
the ops and whose backwards launch K3, K4, K9 and K10.

`custom_ops()` imports the four modules, which registers every op, and
returns them by name; a program saved by torch.export resolves its ops only
once they are registered.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

NAMESPACE = "ogd_torch"


def flat_shapes(spatial_shapes: Sequence[Tuple[int, int]]) -> List[int]:
    """((h0, w0), (h1, w1), ...) -> [h0, w0, h1, w1, ...], the ops' form."""
    return [int(v) for hw in spatial_shapes for v in hw]


def shape_pairs(flat: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """The inverse of flat_shapes."""
    return tuple((int(h), int(w)) for h, w in zip(flat[::2], flat[1::2]))


def with_flat_shapes(op):
    """`op` called as the launchers are, launch(value, spatial_shapes, *rest),
    the level shapes handed over flat."""
    return lambda value, spatial_shapes, *rest: op(value, flat_shapes(spatial_shapes), *rest)


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record an op on these tensors: the wrappers
    take the autograd Functions (CUDA) or the differentiable plain versions
    (CPU) then, and the op directly otherwise."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def custom_ops() -> Dict[str, object]:
    """{op name: the op}, every op of the namespace registered."""
    from . import fusion, msda, msda_banded, msda_sweep

    return {"msda_fwd": msda.msda_fwd, "fusion_fwd": fusion.fusion_fwd,
            "banded_fwd": msda_banded.banded_fwd_op, "sweep_fwd": msda_sweep.sweep_fwd_op,
            "sweep_fwd_allq": msda_sweep.sweep_fwd_allq_op}
