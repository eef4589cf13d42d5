"""Multi-scale deformable attention module (the port of the raster path of
the JAX package's models/deformable.py; reference ms_deform_attn.py:137-363).

Value projection with padding-mask zeroing, per-query sampling offsets and
softmaxed attention weights, sampling locations from 2-d or 4-d reference
points, the core op (K1, ops/msda.py), output projection.  Parameter names
are the reference's; sampling_offsets starts at zero weight with the
rotated-grid bias (reference ms_deform_attn.py:198-221).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.msda import level_starts, ms_deform_attn


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
                 num_levels: int = 4, num_points: int = 4):
        super().__init__()
        self.num_heads, self.num_levels, self.num_points = num_heads, num_levels, num_points
        self.value_proj = nn.Linear(embed_dim, embed_dim)
        self.sampling_offsets = nn.Linear(embed_dim, num_heads * num_levels * num_points * 2)
        self.attention_weights = nn.Linear(embed_dim, num_heads * num_levels * num_points)
        self.output_proj = nn.Linear(embed_dim, embed_dim)

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
        attn = torch.softmax(attn.float(), dim=-1).view(B, Q, H, NL, P)

        rp = reference_points.float()
        if rp.shape[-1] == 2:
            wh = torch.tensor([[w, h] for h, w in spatial_shapes],
                              dtype=torch.float32, device=query.device)
            locs = rp[:, :, None, :, None, :] + offsets / wh[None, None, None, :, None, :]
        elif rp.shape[-1] == 4:
            locs = (
                rp[:, :, None, :, None, :2]
                + offsets / P * rp[:, :, None, :, None, 2:] * 0.5
            )
        else:
            raise ValueError("reference_points last dim must be 2 or 4")

        out = ms_deform_attn(
            v.contiguous(), spatial_shapes, level_starts(spatial_shapes),
            locs.contiguous(), attn.contiguous(),
        )
        return self.output_proj(out)
