"""Multi-scale deformable attention module (the port of the raster path of
the JAX package's models/deformable.py; reference ms_deform_attn.py:137-363).

Value projection with padding-mask zeroing, per-query sampling offsets and
softmaxed attention weights, sampling locations from 2-d or 4-d reference
points, the core op, output projection.  Parameter names are the
reference's; sampling_offsets starts at zero weight with the rotated-grid
bias (reference ms_deform_attn.py:198-221).

The core op is `kernel="gather"` (K1/K3, ops/msda.py; the JAX package's
default banded path), `kernel="sweep"` (K6/K7 forward, K9/K10 backward,
ops/msda_sweep.py; the JAX package's `msda_impl="pallas"` with
`MSDA_BANDED=0`, deformable.py:176-177) or `kernel="banded_point"` (K5
forward, K3 backward, ops/msda_banded.py; the banded path with
`MSDA_BANDED_MP=0`, one band sweep per sample point, window height 4).  All
take the same projections and parameters: the JAX package's
`_transposed_path` keeps the nn.Dense parameter tree (deformable.py:165-167),
so one checkpoint serves every kernel.  In bf16 (the default compute
dtype) every kernel takes a bf16 value; the gather rounds the softmax
weights to bf16 (the JAX package's XLA path), the sweep and banded_point
keep them f32 (its Pallas path).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.msda import level_starts, ms_deform_attn
from ..ops.msda_banded import ms_deform_attn_banded
from ..ops.msda_sweep import SWEEP_BWD, ms_deform_attn_sweep
from ..utils.device import device_constant
from .precision import Linear

KERNELS = ("gather", "sweep", "banded_point")


def sampling_offsets_bias(num_heads: int, num_levels: int, num_points: int) -> np.ndarray:
    """Rotated-grid init of the sampling_offsets bias, (H*NL*P*2,)."""
    thetas = np.arange(num_heads, dtype=np.float32) * (2.0 * math.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)  # (H, 2)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid.reshape(num_heads, 1, 1, 2), (1, num_levels, num_points, 1))
    for i in range(num_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


class MSDeformAttn(nn.Module):
    def __init__(self, embed_dim: int = 256, num_heads: int = 8,
                 num_levels: int = 4, num_points: int = 4, kernel: str = "gather",
                 sweep_bwd: str = "corner", dec_fused: bool = False):
        super().__init__()
        if kernel not in KERNELS:
            raise ValueError(f"msda kernel must be one of {KERNELS}, got {kernel!r}")
        if sweep_bwd not in SWEEP_BWD:
            raise ValueError(f"msda sweep backward must be one of {SWEEP_BWD}, got {sweep_bwd!r}")
        self.kernel, self.sweep_bwd, self.dec_fused = kernel, sweep_bwd, bool(dec_fused)
        self.num_heads, self.num_levels, self.num_points = num_heads, num_levels, num_points
        self.value_proj = Linear(embed_dim, embed_dim)
        self.sampling_offsets = Linear(embed_dim, num_heads * num_levels * num_points * 2)
        self.attention_weights = Linear(embed_dim, num_heads * num_levels * num_points)
        self.output_proj = Linear(embed_dim, embed_dim)

    def init_weights_(self, g: torch.Generator) -> None:
        bias = sampling_offsets_bias(self.num_heads, self.num_levels, self.num_points)
        with torch.no_grad():
            self.sampling_offsets.weight.zero_()
            self.sampling_offsets.bias.copy_(torch.from_numpy(bias))
            self.attention_weights.weight.zero_()
            self.attention_weights.bias.zero_()

    def forward(
        self,
        query: torch.Tensor,               # (B, Q, C), positions already added
        value: torch.Tensor,               # (B, L, C) flattened multi-level
        reference_points: torch.Tensor,    # (B, Q, NL, 2|4) normalized
        spatial_shapes: Sequence[Tuple[int, int]],
        key_padding_mask: torch.Tensor = None,  # (B, L) bool, True = pad
    ) -> torch.Tensor:
        B, Q, C = query.shape
        L = value.shape[1]
        H, NL, P = self.num_heads, self.num_levels, self.num_points
        D = C // H

        v = self.value_proj(value)
        if key_padding_mask is not None:
            v = v.masked_fill(key_padding_mask[..., None], 0.0)
        v = v.view(B, L, H, D)

        offsets = self.sampling_offsets(query).view(B, Q, H, NL, P, 2)
        attn = self.attention_weights(query).view(B, Q, H, NL * P)
        # softmax in f32 (the kernels take f32 weights); the gather rounds
        # it to the query's dtype as the JAX package's XLA path does
        # (deformable.py:134), the sweep and banded_point keep it f32 as its
        # Pallas path does (_transposed_path, deformable.py:251-256)
        attn = torch.softmax(attn.float(), dim=-1)
        if self.kernel == "gather":
            attn = attn.to(query.dtype).float()
        attn = attn.view(B, Q, H, NL, P)

        rp = reference_points.float()
        if rp.shape[-1] == 2:
            shapes = tuple(tuple(hw) for hw in spatial_shapes)
            wh = device_constant(("msda_wh", shapes), lambda: torch.tensor(
                [[w, h] for h, w in shapes], dtype=torch.float32), query.device)
            locs = rp[:, :, None, :, None, :] + offsets / wh[None, None, None, :, None, :]
        elif rp.shape[-1] == 4:
            locs = (
                rp[:, :, None, :, None, :2]
                + offsets / P * rp[:, :, None, :, None, 2:] * 0.5
            )
        else:
            raise ValueError("reference_points last dim must be 2 or 4")

        args = (v.contiguous(), spatial_shapes, level_starts(spatial_shapes),
                locs.contiguous(), attn.contiguous())
        if self.kernel == "sweep":
            out = ms_deform_attn_sweep(*args, bwd=self.sweep_bwd, dec_fused=self.dec_fused)
        elif self.kernel == "banded_point":
            out = ms_deform_attn_banded(*args)
        else:
            out = ms_deform_attn(*args)
        return self.output_proj(out)
