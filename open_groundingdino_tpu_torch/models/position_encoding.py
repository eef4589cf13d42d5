"""Sine position embeddings (the port of the JAX package's
models/position_encoding.py; reference position_encoding.py:78-131 and
GroundingDINO/utils.py:24-53,204-230).  Channel-last, batch-first."""
from __future__ import annotations

import math

import torch


def _interleave_sin_cos(x: torch.Tensor) -> torch.Tensor:
    """sin on even channels, cos on odd channels, interleaved."""
    return torch.stack([x[..., 0::2].sin(), x[..., 1::2].cos()], dim=-1).flatten(-2)


def _dim_t(num_pos_feats: int, temperature: float, device) -> torch.Tensor:
    dim_i = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    return temperature ** (2 * torch.floor(dim_i / 2) / num_pos_feats)


def position_embedding_sine_hw(
    pad_mask: torch.Tensor,
    num_pos_feats: int = 128,
    temperature_h: float = 20.0,
    temperature_w: float = 20.0,
    scale: float = 2 * math.pi,
) -> torch.Tensor:
    """pad_mask (B, H, W) bool, True on padded pixels ->
    (B, H, W, 2*num_pos_feats) float32."""
    not_mask = (~pad_mask).float()
    y_embed = not_mask.cumsum(1)
    x_embed = not_mask.cumsum(2)
    eps = 1e-6
    y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    dim_tx = _dim_t(num_pos_feats, temperature_w, pad_mask.device)
    dim_ty = _dim_t(num_pos_feats, temperature_h, pad_mask.device)
    pos_x = _interleave_sin_cos(x_embed[..., None] / dim_tx)
    pos_y = _interleave_sin_cos(y_embed[..., None] / dim_ty)
    return torch.cat([pos_y, pos_x], dim=-1)


def get_sine_pos_embed(
    pos: torch.Tensor,
    num_pos_feats: int = 128,
    temperature: float = 10000.0,
    exchange_xy: bool = True,
) -> torch.Tensor:
    """Per-coordinate sine embedding; pos (..., n) -> (..., n*num_pos_feats)."""
    dim_t = _dim_t(num_pos_feats, temperature, pos.device)
    parts = [
        _interleave_sin_cos(pos[..., i : i + 1] * (2 * math.pi) / dim_t)
        for i in range(pos.shape[-1])
    ]
    if exchange_xy and len(parts) >= 2:
        parts[0], parts[1] = parts[1], parts[0]
    return torch.cat(parts, dim=-1)


def gen_sineembed_for_position(pos: torch.Tensor) -> torch.Tensor:
    """Decoder query sine embedding from (B, Q, 2|4) normalized boxes, output
    order (y, x[, w, h]) with 128 feats each."""
    dim_t = _dim_t(128, 10000.0, pos.device)

    def embed(coord):
        return _interleave_sin_cos(coord[..., None] * (2 * math.pi) / dim_t)

    pos_x = embed(pos[..., 0])
    pos_y = embed(pos[..., 1])
    if pos.shape[-1] == 2:
        return torch.cat([pos_y, pos_x], dim=-1)
    if pos.shape[-1] == 4:
        return torch.cat([pos_y, pos_x, embed(pos[..., 2]), embed(pos[..., 3])], dim=-1)
    raise ValueError(f"pos last dim must be 2 or 4, got {pos.shape[-1]}")
