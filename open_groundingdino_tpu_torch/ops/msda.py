"""Multi-scale deformable attention core op: K1 (csrc/msda_fwd.cu) and its
plain PyTorch version.

Semantics (the JAX package's ops/msda.py::ms_deform_attn_xla): for every
(batch, query, head), sample each level's value map at num_levels*num_points
locations with bilinear interpolation (align_corners=False, zero padding —
F.grid_sample on grids 2*loc-1) and reduce with the attention weights.

Layouts (the JAX package's, at this public function):
  value    (B, L, H, D), padded positions pre-zeroed, levels concatenated
  locs     (B, Q, H, NL, P, 2) normalized (x, y)
  attn     (B, Q, H, NL, P)
  returns  (B, Q, H*D)
`spatial_shapes` and `level_start` are static sequences of ints:
((h, w), ...) per level and the offset of each level in L.

`ms_deform_attn` launches the CUDA kernel for CUDA tensors and takes
`ms_deform_attn_plain` for CPU tensors; nothing else reaches the plain
version.  `ms_deform_attn.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import build

Shapes = Sequence[Tuple[int, int]]


def level_starts(spatial_shapes: Shapes) -> Tuple[int, ...]:
    """Offset of each level in the concatenated value sequence."""
    starts, s = [], 0
    for h, w in spatial_shapes:
        starts.append(s)
        s += h * w
    return tuple(starts)


def ms_deform_attn_plain(
    value: torch.Tensor,
    spatial_shapes: Shapes,
    level_start: Sequence[int],
    locs: torch.Tensor,
    attn: torch.Tensor,
) -> torch.Tensor:
    """Transcription of ms_deform_attn_xla: per level, the four corner indices
    and bilinear weights (zeroed outside the map), then one gather per tap
    (level, point, corner) accumulated in that order, in f32 (as the kernel
    does) and returned in value's dtype."""
    B, L, H, D = value.shape
    _, Q, _, NL, P, _ = locs.shape
    assert len(spatial_shapes) == NL and sum(h * w for h, w in spatial_shapes) == L
    locs = locs.float()
    idx_levels, w_levels = [], []
    for lvl, (Hl, Wl) in enumerate(spatial_shapes):
        loc = locs[:, :, :, lvl]                      # (B, Q, H, P, 2)
        px = loc[..., 0] * Wl - 0.5
        py = loc[..., 1] * Hl - 0.5
        x0 = torch.floor(px)
        y0 = torch.floor(py)
        fx = px - x0
        fy = py - y0
        cw = torch.stack(
            [(1.0 - fx) * (1.0 - fy), fx * (1.0 - fy), (1.0 - fx) * fy, fx * fy],
            dim=-1,
        )
        x0i = x0.long()
        y0i = y0.long()
        xs = torch.stack([x0i, x0i + 1, x0i, x0i + 1], dim=-1)
        ys = torch.stack([y0i, y0i, y0i + 1, y0i + 1], dim=-1)
        valid = (xs >= 0) & (xs <= Wl - 1) & (ys >= 0) & (ys <= Hl - 1)
        cw = torch.where(valid, cw, torch.zeros_like(cw))
        idx = level_start[lvl] + ys.clamp(0, Hl - 1) * Wl + xs.clamp(0, Wl - 1)
        idx_levels.append(idx)
        w_levels.append(cw)
    idx = torch.stack(idx_levels, dim=3)              # (B, Q, H, NL, P, 4)
    w = torch.stack(w_levels, dim=3) * attn.float()[..., None]

    K = NL * P * 4
    idx_t = idx.permute(3, 4, 5, 0, 2, 1).reshape(K, B, H, Q)
    w_t = w.permute(3, 4, 5, 0, 2, 1).reshape(K, B, H, Q)
    value_bh = value.permute(0, 2, 1, 3)              # (B, H, L, D)
    out = torch.zeros(B, H, Q, D, dtype=torch.float32, device=value.device)
    for t in range(K):
        g = torch.gather(value_bh, 2, idx_t[t][..., None].expand(B, H, Q, D))
        out = out + g.float() * w_t[t][..., None]
    return out.to(value.dtype).permute(0, 2, 1, 3).reshape(B, Q, H * D)


_CTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
    + [ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.c_void_p]
)


def ms_deform_attn(
    value: torch.Tensor,
    spatial_shapes: Shapes,
    level_start: Sequence[int],
    locs: torch.Tensor,
    attn: torch.Tensor,
) -> torch.Tensor:
    """K1 for CUDA tensors (f32 or bf16 value, f32 locs/attn, all contiguous),
    the plain version for CPU tensors.  Returns (B, Q, H*D) in value's dtype."""
    if value.device.type == "cpu":
        return ms_deform_attn_plain(value, spatial_shapes, level_start, locs, attn)
    if value.device.type != "cuda":
        raise ValueError(f"ms_deform_attn: unsupported device {value.device}")
    B, L, H, D = value.shape
    if locs.dim() != 6 or locs.shape[-1] != 2:
        raise ValueError(f"locs must be (B, Q, H, NL, P, 2), got {tuple(locs.shape)}")
    _, Q, _, NL, P, _ = locs.shape
    if tuple(locs.shape[:3]) != (B, Q, H) or tuple(attn.shape) != (B, Q, H, NL, P):
        raise ValueError(
            f"shape mismatch: value {tuple(value.shape)} locs {tuple(locs.shape)} "
            f"attn {tuple(attn.shape)}"
        )
    if len(spatial_shapes) != NL or len(level_start) != NL:
        raise ValueError("spatial_shapes / level_start must have one entry per level")
    if sum(h * w for h, w in spatial_shapes) != L:
        raise ValueError("sum of level sizes must equal value's L")
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"value must be float32 or bfloat16, got {value.dtype}")
    if locs.dtype != torch.float32 or attn.dtype != torch.float32:
        raise TypeError("locs and attn must be float32")
    for name, t in (("value", value), ("locs", locs), ("attn", attn)):
        if t.device != value.device:
            raise ValueError(f"{name} is on {t.device}, value on {value.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    out = torch.empty(B, Q, H * D, dtype=value.dtype, device=value.device)
    lib = build.load("msda_fwd")
    fn = lib.msda_fwd_f32 if value.dtype == torch.float32 else lib.msda_fwd_bf16
    fn.argtypes = _CTYPES
    fn.restype = ctypes.c_int
    hw = (ctypes.c_int * (2 * NL))(*[int(v) for hw_ in spatial_shapes for v in hw_])
    starts = (ctypes.c_int * NL)(*[int(s) for s in level_start])
    err = fn(
        value.data_ptr(), locs.data_ptr(), attn.data_ptr(), out.data_ptr(),
        B, L, H, D, Q, NL, P, hw, starts,
        torch.cuda.current_stream(value.device).cuda_stream,
    )
    build.check(err, "msda_fwd")
    ms_deform_attn.launches += 1
    return out


ms_deform_attn.launches = 0
