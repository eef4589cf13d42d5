"""Swin Transformer backbone (the port of the JAX package's models/swin.py;
reference backbone/swin_transformer.py).

Patch-embed conv 4x4, stages of (shifted-)window attention with relative
position bias, PatchMerging between stages, a LayerNorm per output stage, and
window padding when H/W are not multiples of the window.  Channel-last
(B, H, W, C) at the interfaces like the JAX package; parameter names follow
the reference state dict (`layers.{i}.blocks.{j}.attn.qkv`, `norm{i}`, ...).
The shift mask and the relative-position index are computed in numpy from
the static shapes and kept on the device once per shape (the reference's
relative_position_index buffer is not a parameter and is not loaded).
With `use_checkpoint`, a forward in training mode with gradients on keeps
only each block's input and recomputes the block in the backward (the JAX
package's `nn.remat(SwinBlock)`); eval and no-grad forwards run plainly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..utils.device import device_constant
from .precision import LayerNorm, Linear

SWIN_VARIANTS = {
    # nano variant for tests only (no published checkpoint)
    "swin_nano_test": dict(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 4), window_size=4),
    "swin_T_224_1k": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
                          window_size=7),
    "swin_B_224_22k": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
                           window_size=7),
    "swin_B_384_22k": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
                           window_size=12),
    "swin_L_224_22k": dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48),
                           window_size=7),
    "swin_L_384_22k": dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48),
                           window_size=12),
}


@dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    patch_size: int = 4
    mlp_ratio: float = 4.0
    out_indices: Tuple[int, ...] = (1, 2, 3)
    use_checkpoint: bool = False

    @property
    def num_features(self) -> Tuple[int, ...]:
        return tuple(self.embed_dim * (2 ** i) for i in range(len(self.depths)))

    @property
    def strides(self) -> Tuple[int, ...]:
        """Each stage's stride: patch 4, then a 2x merge a stage."""
        return tuple(self.patch_size * 2 ** i for i in range(len(self.depths)))

    @classmethod
    def from_name(cls, name: str, out_indices=(1, 2, 3), use_checkpoint=False) -> "SwinConfig":
        if name not in SWIN_VARIANTS:
            raise ValueError(f"unknown Swin backbone {name!r}")
        return cls(out_indices=tuple(out_indices), use_checkpoint=bool(use_checkpoint),
                   **SWIN_VARIANTS[name])


def relative_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) indices into the (2*ws-1)^2 relative-bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def shift_attn_mask(Hp: int, Wp: int, ws: int, shift: int) -> np.ndarray:
    """Static (nW, ws*ws, ws*ws) additive mask (0 / -100) for SW-MSA."""
    img = np.zeros((Hp, Wp), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(Hp // ws, ws, Wp // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C); H, W divisible by ws."""
    B, H, W, C = x.shape
    x = x.view(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(wins: torch.Tensor, ws: int, B: int, H: int, W: int) -> torch.Tensor:
    x = wins.view(B, H // ws, W // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window_size - 1) ** 2, num_heads)
        )

    def init_weights_(self, g: torch.Generator) -> None:
        with torch.no_grad():
            t = torch.randn(self.relative_position_bias_table.shape, generator=g)
            self.relative_position_bias_table.copy_(t.clamp(-2.0, 2.0) * 0.02)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor = None) -> torch.Tensor:
        """x: (B_, N, C) windows; attn_mask: (nW, N, N) additive or None."""
        B_, N, C = x.shape
        H = self.num_heads
        D = C // H
        qkv = self.qkv(x).view(B_, N, 3, H, D).permute(2, 0, 3, 1, 4)  # (3, B_, H, N, D)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q * D ** -0.5) @ k.transpose(-2, -1)                    # (B_, H, N, N)
        ws = self.window_size
        rel_index = device_constant(("swin_rel_index", ws), lambda: torch.from_numpy(
            relative_position_index(ws).reshape(-1)), x.device)
        bias = self.relative_position_bias_table[rel_index]
        attn = attn + bias.view(N, N, H).permute(2, 0, 1)[None]
        if attn_mask is not None:
            nW = attn_mask.shape[0]
            attn = attn.view(B_ // nW, nW, H, N, N) + attn_mask[None, :, None]
            attn = attn.view(B_, H, N, N)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B_, N, C)
        return self.proj(out)


class SwinMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = SwinMlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        """x: (B, H*W, C)."""
        B, L, C = x.shape
        ws, shift = self.window_size, self.shift_size
        shortcut = x
        x = self.norm1(x).view(B, H, W, C)
        pad_b = (ws - H % ws) % ws
        pad_r = (ws - W % ws) % ws
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = device_constant(("swin_shift_mask", Hp, Wp, ws, shift), lambda: torch.from_numpy(
                shift_attn_mask(Hp, Wp, ws, shift)), x.device).to(x.dtype)
        wins = self.attn(window_partition(x, ws), mask)
        x = window_reverse(wins, ws, B, Hp, Wp)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        if pad_b or pad_r:
            x = x[:, :H, :W]
        x = shortcut + x.reshape(B, L, C)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=1e-5)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, L, C = x.shape
        x = x.view(B, H, W, C)
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat(
            [x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1
        ).view(B, -1, 4 * C)
        return self.reduction(self.norm(x))


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size,
                      0 if b % 2 == 0 else window_size // 2, mlp_ratio)
            for b in range(depth)
        )
        self.downsample = PatchMerging(dim) if downsample else None


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.norm = LayerNorm(embed_dim, eps=1e-5)


class SwinTransformer(nn.Module):
    """Returns a list of (B, H, W, C) feature maps for cfg.out_indices."""

    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.embed_dim)
        n = len(cfg.depths)
        self.layers = nn.ModuleList(
            SwinStage(cfg.num_features[i], cfg.depths[i], cfg.num_heads[i],
                      cfg.window_size, cfg.mlp_ratio, downsample=i < n - 1)
            for i in range(n)
        )
        for i in cfg.out_indices:
            self.add_module(f"norm{i}", LayerNorm(cfg.num_features[i], eps=1e-5))

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        """images: (B, H, W, 3), H/W multiples of patch_size (bucketed)."""
        B = images.shape[0]
        x = self.patch_embed.proj(images.permute(0, 3, 1, 2))     # (B, C, Wh, Ww)
        Wh, Ww = x.shape[2], x.shape[3]
        x = self.patch_embed.norm(x.flatten(2).transpose(1, 2))   # (B, Wh*Ww, C)
        remat = self.cfg.use_checkpoint and self.training and torch.is_grad_enabled()
        outs = []
        for i, stage in enumerate(self.layers):
            for blk in stage.blocks:
                x = checkpoint(blk, x, Wh, Ww, use_reentrant=False) if remat else blk(x, Wh, Ww)
            if i in self.cfg.out_indices:
                y = getattr(self, f"norm{i}")(x)
                outs.append(y.view(B, Wh, Ww, -1))
            if stage.downsample is not None:
                x = stage.downsample(x, Wh, Ww)
                Wh, Ww = (Wh + 1) // 2, (Ww + 1) // 2
        return outs
