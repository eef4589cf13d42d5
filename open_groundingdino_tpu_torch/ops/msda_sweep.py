"""Multi-scale deformable attention on sweep taps: K6 and K7 (forwards on row
taps, csrc/msda_rowtap_fwd.cu; K7 for the decoder under dec_fused), K8
(forward on corner taps, csrc/msda_corner_fwd.cu), K9 (backward on corner
taps, csrc/msda_corner_bwd.cu) and K10 (backward on row taps,
csrc/msda_rowtap_bwd.cu), their plain PyTorch versions, and their ops.

The port of the JAX package's ops/msda_pallas.py::ms_deform_attn_pallas_t,
the model path of `msda_impl="pallas"` with `MSDA_BANDED=0`, and of its
op-level ms_deform_attn_pallas under MSDA_FWD_VARIANT=corner (`fwd="corner"`:
corner taps into K8, the tools' microbench path).  The function is
ms_deform_attn_xla's (ops/msda.py here), written on taps: each sample point
is expanded into taps on the flat value sequence.  The TPU kernels then
build, for each query block and each value tile its taps touch, a dense
weight matrix S (queries x tile positions) and accumulate S @ V; the kernels
here gather the rows of the live taps instead.

Expansions (kernel layout, raster value order):
  row taps     row (int32), px, w (f32), (BH, NL*2*P, Q): each point's two
               bilinear rows as the flat position of the row's first pixel,
               a continuous position px within the row (weight
               relu(1 - |px - x|) at pixel x) and the row's weight; edge
               points collapse to their one valid corner at an integer px,
               dead taps (w == 0) are clipped into their level
               (rowtap_positions_and_weights)
  corner taps  idx (int32), w  (BH, NL*P*4, Q) (corner_indices_and_weights)
Rows and taps are grouped by level (2*P rows or 4*P taps a level).  The TPU
kernels take a row tap as one f32 flat position, row + px; at the 800x1216
bucket (L = 20197) that sum rounds by up to 2^-10 of a pixel, which moved
the flagship forward's logits by up to 4.9e-2 against the gather path (H100
smoke).  Split, px keeps its fraction to 2^-16 (rows are at most 152 wide
there) and the sweep computes the gather's function.

Kernel operands: value in the reference layout (B, L, H, D) f32 (or bf16,
below), D = 32, taps (BH, R, Q_pad) with Q_pad a multiple of QBLOCK (padded
queries have w == 0), upstream gradient and output (BH, Q_pad, D) in
value's dtype, grad_value (B, L, H, D).  Query sets with Q != L (the
decoder) are sorted by their first row tap's position (K8: their first
corner tap's, as msda_pallas.py:937-943 sorts), so that a block's taps are
local; the output and the per-tap gradients are un-sorted afterwards.
Every kernel gathers (the backwards also scatter) the rows of its taps'
corners (K1's and K3's design, ops/msda.py), with K1's and K3's launch
plans; K7 is K6's kernel under its own name.

bf16 (the JAX package's default mixed precision; value and upstream
gradient bf16, taps f32): every kernel here has a bf16 entry, as the TPU
kernels have bf16 branches (msda_pallas.py:244-246, 520, 651, 998-1001,
1220-1242).  Each reads bf16 value (and g) rows and sums in f32: the
forwards (K6, K7, K8) round their output to bf16 once; the backwards write
gw (and gpx) in f32 and grad_value into an f32 buffer on the f32 entry's
path, which the wrapper rounds to bf16 once, as the TPU kernels write
grad_value in f32 (msda_pallas.py:1093, 1315) and cast it once.  The tap
weights stay f32 (the TPU kernels round them to bf16 for the MXU).

Every kernel is a custom op (ops/library.py): `ogd_torch::sweep_fwd` (K6),
`sweep_fwd_allq` (K7), `sweep_fwd_corner` (K8), `sweep_bwd_corner` (K9) and
`sweep_bwd_rowtap` (K10); on CUDA tensors the kernels, on CPU ones the plain
versions.  The forwards carry registered autograd formulas.  K8's gradient
is K9 on its own corner taps.  K6's and K7's is named by their `bwd`
argument: K10 on their row taps, or (the default) K9 on the corner taps of
those row taps (`corner_taps_of_rows`: a row tap's two positions, weighted
r0 * w and r1 * w, in the corner expansion's layout) with the corner
gradients folded back onto the rows (`row_grads_of_corners`); autograd
chains the tap gradients to the locations and weights through the
expansion and the decoder's sort (the JAX package's jax.vjp).
`ms_deform_attn_sweep` calls the ops whether or not a gradient is needed.
The launchers (`sweep_fwd`, `sweep_fwd_allq` and `sweep_fwd_corner` reach
their kernels through the ops; `sweep_bwd_corner` and `sweep_bwd_rowtap`
are the backward ops' CUDA implementations) take CUDA tensors only and
count their launches (`sweep_fwd.launches`, ...; the bf16 entries' apart,
in `.launches_bf16`); nothing on the card reaches a plain version.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from . import build, library, msda
from .library import flat_shapes, is_real, kernel_rows, msda_flops, shape_pairs
from .msda import level_starts

Shapes = Sequence[Tuple[int, int]]

QBLOCK = 128          # queries per kernel block
HEAD_DIM = 32         # the kernels' channels per head
MAX_POINTS = 4        # the kernels hold up to 4 points (16 corner taps) a level
SWEEP_BWD = ("corner", "rowtap")
SWEEP_FWD = ("rowtap", "corner")


# ---------------------------------------------------------------- expansions
def _row_base(spatial_shapes: Shapes, lvl: int, yc: torch.Tensor) -> torch.Tensor:
    """Flat position of (lvl, clip(yc), 0) in the raster value sequence."""
    Hl, Wl = spatial_shapes[lvl]
    start = sum(h * w for h, w in spatial_shapes[:lvl])
    return start + yc.clamp(0, Hl - 1) * Wl


def rowtap_positions_and_weights(locs_t: torch.Tensor, attn_t: torch.Tensor,
                                 spatial_shapes: Shapes):
    """Row-tap expansion (msda_pallas.py::_rowtap_positions_and_weights_t,
    raster layout, with each position split into its row's flat start and
    the position within the row).  locs_t (BH, NL, P, 2, Q), attn_t
    (BH, NL, P, Q), f32 -> (row int32, px, w) (BH, NL*2*P, Q); px and w are
    differentiable in both inputs."""
    row_parts, px_parts, w_parts = [], [], []
    for lvl, (Hl, Wl) in enumerate(spatial_shapes):
        pxc = locs_t[:, lvl, :, 0, :] * Wl - 0.5          # (BH, P, Q)
        pyc = locs_t[:, lvl, :, 1, :] * Hl - 0.5
        a = attn_t[:, lvl]
        x0 = torch.floor(pxc)
        fx = pxc - x0
        y0 = torch.floor(pyc)
        fy = pyc - y0
        x0i, y0i = x0.long(), y0.long()
        v0 = (x0i >= 0) & (x0i <= Wl - 1)
        v1 = (x0i + 1 >= 0) & (x0i + 1 <= Wl - 1)
        interior = v0 & v1
        # an edge point keeps its one valid corner, at an integer position
        edge_px = torch.where(v0, x0, x0 + 1.0)
        edge_wx = torch.where(v0, 1.0 - fx, torch.where(v1, fx, torch.zeros_like(fx)))
        px_x = torch.where(interior, pxc, edge_px)
        wx = torch.where(interior, torch.ones_like(fx), edge_wx)
        # dead taps stay inside their level, so they never widen a sweep
        px_x = px_x.clamp(0.0, float(max(Wl - 1, 0)))
        for yc, wy in ((y0i, 1.0 - fy), (y0i + 1, fy)):
            yv = (yc >= 0) & (yc <= Hl - 1)
            w_row = torch.where(yv, wy * wx * a, torch.zeros_like(a))
            row_parts.append(_row_base(spatial_shapes, lvl, yc))
            px_parts.append(px_x)
            w_parts.append(w_row)
    BH, Q = locs_t.shape[0], locs_t.shape[-1]
    stack = lambda parts: torch.stack(parts, 1).reshape(BH, -1, Q)
    return stack(row_parts).to(torch.int32), stack(px_parts), stack(w_parts)


def corner_indices_and_weights(locs_t: torch.Tensor, attn_t: torch.Tensor,
                               spatial_shapes: Shapes):
    """Corner expansion (msda_pallas.py::_corner_indices_and_weights_t, raster
    layout): locs_t (BH, NL, P, 2, Q), attn_t (BH, NL, P, Q) -> idx int32 and
    w f32, (BH, NL*P*4, Q); w is differentiable in both inputs."""
    idx_parts, w_parts = [], []
    for lvl, (Hl, Wl) in enumerate(spatial_shapes):
        px = locs_t[:, lvl, :, 0, :] * Wl - 0.5
        py = locs_t[:, lvl, :, 1, :] * Hl - 0.5
        a = attn_t[:, lvl]
        x0 = torch.floor(px)
        y0 = torch.floor(py)
        fx, fy = px - x0, py - y0
        x0i, y0i = x0.long(), y0.long()
        cw = ((1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy)
        xs = (x0i, x0i + 1, x0i, x0i + 1)
        ys = (y0i, y0i, y0i + 1, y0i + 1)
        idx_c, w_c = [], []
        for c in range(4):
            valid = (xs[c] >= 0) & (xs[c] <= Wl - 1) & (ys[c] >= 0) & (ys[c] <= Hl - 1)
            w_c.append(torch.where(valid, cw[c] * a, torch.zeros_like(a)))
            idx_c.append(_row_base(spatial_shapes, lvl, ys[c]) + xs[c].clamp(0, Wl - 1))
        idx_parts.append(torch.stack(idx_c, 2))            # (BH, P, 4, Q)
        w_parts.append(torch.stack(w_c, 2))
    BH, Q = locs_t.shape[0], locs_t.shape[-1]
    idx = torch.stack(idx_parts, 1).reshape(BH, -1, Q).to(torch.int32)
    return idx, torch.stack(w_parts, 1).reshape(BH, -1, Q)


# ---------------------------------------------------------------- plain versions
def _value_bh(value: torch.Tensor) -> torch.Tensor:
    """(B, L, H, D) -> (B*H, L, D) f32 (a bf16 value upcast exactly)."""
    B, L, H, D = value.shape
    return value.float().permute(0, 2, 1, 3).reshape(B * H, L, D)


def _gather_rows(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v (BH, L, D), idx (BH, Q) -> (BH, Q, D)."""
    return torch.gather(v, 1, idx[..., None].expand(-1, -1, v.shape[-1]))


def _rowtap_corners(row: torch.Tensor, px: torch.Tensor, L: int):
    """The two positions a row tap touches and its relu(1 - |px - x|) there,
    computed as the dense formulation does: 1 - (px - x) at x = floor(px),
    1 - ((x + 1) - px) at the next pixel (0 where px is an integer)."""
    p0 = torch.floor(px)
    r0 = 1.0 - (px - p0)
    r1 = 1.0 - ((p0 + 1.0) - px)
    i0 = (row.long() + p0.long()).clamp(0, L - 1)
    i1 = (i0 + 1).clamp(0, L - 1)
    return i0, i1, r0, r1


def sweep_fwd_plain(value, row, px, w):
    """K6's and K7's function: out[bh, q] = sum_r w[r, q] * sum_x
    relu(1 - |px[r, q] - x|) * V[bh, row[r, q] + x].  value (B, L, H, D);
    row, px, w (BH, R, Q) -> (BH, Q, D) f32.  Each row touches two
    positions, gathered; rows are summed in order.  A bf16 value is upcast
    and summed in f32: rounded to bf16 once, the result is the bf16
    entries' plain version."""
    v = _value_bh(value)
    L = v.shape[1]
    i0, i1, r0, r1 = _rowtap_corners(row, px, L)
    out = torch.zeros(px.shape[0], px.shape[2], v.shape[2], dtype=torch.float32,
                      device=v.device)
    for r in range(px.shape[1]):
        out = out + (_gather_rows(v, i0[:, r]) * (r0[:, r] * w[:, r])[..., None]
                     + _gather_rows(v, i1[:, r]) * (r1[:, r] * w[:, r])[..., None])
    return out


def sweep_fwd_corner_plain(value, idx, w):
    """K8's function: out[bh, q] = sum_t w[t, q] * V[bh, idx[t, q]], the
    taps gathered in order.  value (B, L, H, D); idx, w (BH, T, Q) ->
    (BH, Q, D) f32."""
    v = _value_bh(value)
    out = torch.zeros(w.shape[0], w.shape[2], v.shape[2], dtype=torch.float32, device=v.device)
    for t in range(w.shape[1]):
        out = out + _gather_rows(v, idx[:, t].long()) * w[:, t][..., None]
    return out


def _scatter_rows(shape, idx, rows):
    """grad_value (B, L, H, D) from per-tap rows: rows (BH, T, Q, D) added at
    positions idx (BH, T, Q) of their (b, h) value map."""
    B, L, H, D = shape
    BH = B * H
    flat = (torch.arange(BH, device=idx.device)[:, None, None] * L + idx.long()).reshape(-1)
    gv = torch.zeros(BH * L, D, dtype=torch.float32, device=rows.device)
    gv.index_add_(0, flat, rows.reshape(-1, D))
    return gv.view(B, H, L, D).permute(0, 2, 1, 3).contiguous()


def sweep_bwd_rowtap_plain(value, row, px, w, g):
    """K10's function: with P[x, q] = V[row + x] . g[q],
      gw[r, q]  = sum_x relu(1 - |px - x|) * P[x, q]
      gpx[r, q] = sum_x -sign(px - x) [|px - x| < 1] * P[x, q]  (without the
                  row weight: the caller multiplies by w)
      grad_value[row + x] = sum_{r, q} relu(1 - |px - x|) * w * g[q].
    value (B, L, H, D); row, px, w (BH, R, Q); g (BH, Q, D) -> (grad_value
    (B, L, H, D), gpx, gw (BH, R, Q)), all f32.  A bf16 value and g are
    upcast and summed in f32: with grad_value rounded to bf16 once, this is
    the bf16 entry's plain version."""
    v = _value_bh(value)
    L = v.shape[1]
    i0, i1, r0, r1 = _rowtap_corners(row, px, L)
    R = px.shape[1]
    g = g.float()
    P0 = torch.stack([(_gather_rows(v, i0[:, r]) * g).sum(-1) for r in range(R)], 1)
    P1 = torch.stack([(_gather_rows(v, i1[:, r]) * g).sum(-1) for r in range(R)], 1)
    gw = r0 * P0 + r1 * P1
    gpx = torch.where(px > torch.floor(px), P1 - P0, torch.zeros_like(P0))
    rows = torch.cat([(r0 * w)[..., None] * g[:, None], (r1 * w)[..., None] * g[:, None]], 1)
    gv = _scatter_rows(value.shape, torch.cat([i0, i1], 1), rows)
    return gv, gpx, gw


def sweep_bwd_corner_plain(value, idx, w, g):
    """K9's function: gw[t, q] = V[idx[t, q]] . g[q] and grad_value[s] =
    sum_{t, q: idx == s} w[t, q] * g[q].  value (B, L, H, D); idx, w
    (BH, T, Q); g (BH, Q, D) -> (grad_value (B, L, H, D), gw (BH, T, Q)), f32.
    A bf16 value and g are upcast and summed in f32: with grad_value
    rounded to bf16 once, this is the bf16 entry's plain version."""
    v = _value_bh(value)
    g = g.float()
    idx = idx.long()
    gw = torch.stack([(_gather_rows(v, idx[:, t]) * g).sum(-1) for t in range(idx.shape[1])], 1)
    gv = _scatter_rows(value.shape, idx, w[..., None] * g[:, None])
    return gv, gw


# ---------------------------------------------------------------- kernel wrappers
_FWD_CORNER_CTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_ROWTAP_FWD_CTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_PLAN_CTYPES = ([ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
                + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_CORNER_BWD_CTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + _PLAN_CTYPES
_ROWTAP_BWD_CTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + _PLAN_CTYPES
BWD_WARPS = 16                     # csrc/msda_corner_bwd.cu, msda_rowtap_bwd.cu: warps a CTA
BWD_CHUNK = 2 * BWD_WARPS          # queries whose taps a CTA stages at a time
CORNER_TAPS = msda.SAMPLES * 4     # corner taps a query, at most
ROWTAP_TAPS = msda.SAMPLES * 2     # row taps a query, at most


def _check(value, taps, w, what, g=None, row=None):
    """Raise unless the operands are what the sweep kernels take (value f32
    or bf16, g in value's dtype, the taps f32); returns (B, L, H, R, Q_pad)."""
    for name, t in (("value", value), ("taps", taps), ("w", w), ("g", g), ("row", row)):
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{what}: unsupported device {t.device} for {name}")
        if t.device != value.device:
            raise ValueError(f"{what}: {name} is on {t.device}, value on {value.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if (value.dim() != 4 or value.shape[-1] != HEAD_DIM
            or value.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError(f"{what}: value must be float32 or bfloat16 (B, L, H, {HEAD_DIM}), got "
                         f"{value.dtype} {tuple(value.shape)}")
    B, L, H, _ = value.shape
    BH, R, Q_pad = taps.shape
    if BH != B * H or tuple(w.shape) != (BH, R, Q_pad) or w.dtype != torch.float32:
        raise ValueError(f"{what}: taps {tuple(taps.shape)} / w {w.dtype} {tuple(w.shape)} "
                         f"do not fit value {tuple(value.shape)}")
    if Q_pad % QBLOCK:
        raise ValueError(f"{what}: the query axis ({Q_pad}) must be a multiple of {QBLOCK}")
    if g is not None and (tuple(g.shape) != (BH, Q_pad, HEAD_DIM) or g.dtype != value.dtype):
        raise ValueError(f"{what}: g must be {value.dtype} {(BH, Q_pad, HEAD_DIM)}, as value")
    if row is not None and (row.shape != taps.shape or row.dtype != torch.int32
                            or taps.dtype != torch.float32):
        raise ValueError(f"{what}: row taps are int32 rows and float32 positions of one shape")
    return B, L, H, R, Q_pad


def _levels(spatial_shapes, R: int, per_point: int):
    NL = len(spatial_shapes)
    if R % (NL * per_point) or R // (NL * per_point) > MAX_POINTS:
        raise ValueError(f"{R} taps do not make {NL} levels of at most {MAX_POINTS} points")
    return NL, R // NL


def _check_gather(value, g, spatial_shapes, R, taps_per_point, what):
    """Raise unless the gather kernels (K6-K10) are built for these operands
    (value and g 16-byte aligned, D = 32, P = 4, NL <= 4); returns (NL, P)."""
    if value.data_ptr() % 16 or (g is not None and g.data_ptr() % 16):
        raise ValueError(f"{what}: value and g must be 16-byte aligned")
    NL, per_level = _levels(spatial_shapes, R, taps_per_point)
    msda.check_geometry(value.shape[-1], NL, per_level // taps_per_point)
    return NL, per_level // taps_per_point


def rowtap_fwd_smem_bytes(NL: int, tile_q: int) -> int:
    """K6's and K7's dynamic shared memory (csrc/msda_rowtap_fwd.cu
    msda_rowtap_fwd_smem_bytes): each (point, query) of a tile's four corner
    positions (int4) and weights (float4), a row of tile_q + 1 a point."""
    return NL * msda.POINTS * (tile_q + 1) * 32


# K8 stages the same four corners a (point, query) (csrc/msda_corner_fwd.cu
# msda_corner_fwd_smem_bytes)
corner_fwd_smem_bytes = rowtap_fwd_smem_bytes


def _entry(name: str, value: torch.Tensor) -> str:
    """The C entry of `name` for value's dtype."""
    return f"{name}_{'bf16' if value.dtype == torch.bfloat16 else 'f32'}"


def _count(wrapper, value: torch.Tensor) -> None:
    """One launch on wrapper's count for value's dtype."""
    if value.dtype == torch.bfloat16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1


def _rowtap_fwd(entry, wrapper, value, spatial_shapes, row, px, w):
    """Launch K6 or K7 (the C entry `entry` of csrc/msda_rowtap_fwd.cu, its
    f32 or bf16 one by value's dtype) on the row taps, counted on
    `wrapper` (sweep_fwd or sweep_fwd_allq): one kernel block per (b*h,
    tile of queries), the tile chosen as K1's (msda.msda_fwd_tile).  The
    output is in value's dtype."""
    what = wrapper.__name__
    B, L, H, R, Q_pad = _check(value, px, w, what, row=row)
    NL, P = _check_gather(value, None, spatial_shapes, R, 2, what)
    out = torch.empty(B * H, Q_pad, HEAD_DIM, dtype=value.dtype, device=value.device)
    entry = _entry(entry, value)
    fn = getattr(build.load("msda_rowtap_fwd"), entry)
    fn.argtypes = _ROWTAP_FWD_CTYPES
    fn.restype = ctypes.c_int
    err = fn(value.data_ptr(), row.data_ptr(), px.data_ptr(), w.data_ptr(), out.data_ptr(),
             B, L, H, Q_pad, NL, P, msda.msda_fwd_tile(B, Q_pad, H),
             torch.cuda.current_stream(value.device).cuda_stream)
    build.check(err, entry)
    _count(wrapper, value)
    return out


def _cuda_only(what: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is on a CUDA device: a launcher never
    reaches a plain version."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: unsupported device {t.device}")


@torch.library.custom_op("ogd_torch::sweep_fwd", mutates_args=(), device_types="cuda")
def sweep_fwd_op(value: torch.Tensor, spatial_shapes: List[int], row: torch.Tensor,
                 px: torch.Tensor, w: torch.Tensor, bwd: str = "corner") -> torch.Tensor:
    """K6 as an op (`spatial_shapes` flat): on CUDA tensors the kernel,
    counted on sweep_fwd.launches(_bf16).  `bwd` names its gradient's
    kernel: K9 on the corner taps of these row taps ("corner") or K10 on
    them ("rowtap"); the forward does not read it."""
    return library.kernel_output("sweep_fwd", _rowtap_fwd, "msda_rowtap_fwd", sweep_fwd, value,
                                 shape_pairs(spatial_shapes), row, px, w)


@torch.library.custom_op("ogd_torch::sweep_fwd_allq", mutates_args=(), device_types="cuda")
def sweep_fwd_allq_op(value: torch.Tensor, spatial_shapes: List[int], row: torch.Tensor,
                      px: torch.Tensor, w: torch.Tensor, bwd: str = "corner") -> torch.Tensor:
    """K7 as an op: on CUDA tensors the kernel, counted on
    sweep_fwd_allq.launches(_bf16); its gradient is sweep_fwd_op's."""
    return library.kernel_output("sweep_fwd_allq", _rowtap_fwd, "msda_sweep_fwd_allq",
                                 sweep_fwd_allq, value, shape_pairs(spatial_shapes), row, px, w)


def _rowtap_fwd_plain(value, row, px, w):
    return sweep_fwd_plain(value, row, px, w).to(value.dtype)


def _sweep_fwd_cpu(value, spatial_shapes, row, px, w, bwd="corner"):
    return library.kernel_output("sweep_fwd", _rowtap_fwd_plain, value, row, px, w)


def _sweep_fwd_allq_cpu(value, spatial_shapes, row, px, w, bwd="corner"):
    return library.kernel_output("sweep_fwd_allq", _rowtap_fwd_plain, value, row, px, w)


def _rowtap_fwd_fake(value, spatial_shapes, row, px, w, bwd="corner"):
    return value.new_empty(px.shape[0], px.shape[2], value.shape[-1])


def sweep_fwd(value, spatial_shapes, row, px, w):
    """K6 on CUDA tensors, through its op: each live tap reads its at most
    two rows.  value (B, L, H, 32) f32 or bf16, 16-byte aligned; row int32,
    px, w f32 (BH, NL*2*P, Q_pad) -> (BH, Q_pad, D) in value's dtype (bf16:
    f32 sums, rounded once)."""
    _cuda_only("sweep_fwd", value, row, px, w)
    return sweep_fwd_op(value, flat_shapes(spatial_shapes), row, px, w)


def sweep_fwd_allq(value, spatial_shapes, row, px, w):
    """K7 on CUDA tensors, through its op: K6's function, operands and
    launch, for the decoder's sorted query set under dec_fused, as a kernel
    of its own (its own name in a profile, its own count)."""
    _cuda_only("sweep_fwd_allq", value, row, px, w)
    return sweep_fwd_allq_op(value, flat_shapes(spatial_shapes), row, px, w)


def _sweep_fwd_corner_cuda(value, spatial_shapes, idx, w):
    """K8 on CUDA tensors: one kernel block per (b*h, tile of queries), the
    tile chosen as K1's (msda.msda_fwd_tile); each live corner tap reads its
    row.  value (B, L, H, 32) f32 or bf16, 16-byte aligned; idx int32 and w
    f32 (BH, NL*P*4, Q_pad) -> (BH, Q_pad, D) in value's dtype (bf16: f32
    sums, rounded once)."""
    B, L, H, R, Q_pad = _check(value, idx, w, "sweep_fwd_corner")
    if idx.dtype != torch.int32:
        raise ValueError("sweep_fwd_corner: idx must be int32")
    NL, P = _check_gather(value, None, spatial_shapes, R, 4, "sweep_fwd_corner")
    out = torch.empty(B * H, Q_pad, HEAD_DIM, dtype=value.dtype, device=value.device)
    entry = _entry("msda_sweep_fwd_corner", value)
    fn = getattr(build.load("msda_corner_fwd"), entry)
    fn.argtypes = _FWD_CORNER_CTYPES
    fn.restype = ctypes.c_int
    err = fn(value.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
             B, L, H, Q_pad, NL, P, msda.msda_fwd_tile(B, Q_pad, H),
             torch.cuda.current_stream(value.device).cuda_stream)
    build.check(err, entry)
    _count(sweep_fwd_corner, value)
    return out


@torch.library.custom_op("ogd_torch::sweep_fwd_corner", mutates_args=(), device_types="cuda")
def sweep_fwd_corner_op(value: torch.Tensor, spatial_shapes: List[int], idx: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """K8 as an op: on CUDA tensors the kernel, counted on
    sweep_fwd_corner.launches(_bf16).  Its gradient is K9's op on the same
    corner taps."""
    return library.kernel_output("sweep_fwd_corner", _sweep_fwd_corner_cuda, value,
                                 shape_pairs(spatial_shapes), idx, w)


def _corner_fwd_plain(value, idx, w):
    return sweep_fwd_corner_plain(value, idx, w).to(value.dtype)


@sweep_fwd_corner_op.register_kernel("cpu")
def _sweep_fwd_corner_cpu(value, spatial_shapes, idx, w):
    return library.kernel_output("sweep_fwd_corner", _corner_fwd_plain, value, idx, w)


@sweep_fwd_corner_op.register_fake
def _sweep_fwd_corner_fake(value, spatial_shapes, idx, w):
    return value.new_empty(w.shape[0], w.shape[2], value.shape[-1])


def sweep_fwd_corner(value, spatial_shapes, idx, w):
    """K8 on CUDA tensors, through its op (`_sweep_fwd_corner_cuda` has the
    operands); raises for any other device."""
    _cuda_only("sweep_fwd_corner", value, idx, w)
    return sweep_fwd_corner_op(value, flat_shapes(spatial_shapes), idx, w)


def corner_bwd_smem_bytes(smem_rows: int) -> int:
    """K9's dynamic shared memory (csrc/msda_corner_bwd.cu
    msda_corner_bwd_smem_bytes): a chunk's staged idx, w and gw (CORNER_TAPS
    rows of BWD_CHUNK + 1), smem_rows rows of HEAD_DIM f32, a flag a row."""
    return (3 * CORNER_TAPS * (BWD_CHUNK + 1) * 4 + smem_rows * HEAD_DIM * 4
            + -(-smem_rows // 16) * 16)


def rowtap_bwd_smem_bytes(smem_rows: int) -> int:
    """K10's dynamic shared memory (csrc/msda_rowtap_bwd.cu
    msda_rowtap_bwd_smem_bytes): a chunk's staged row, px, w, gw and gpx
    (ROWTAP_TAPS rows of BWD_CHUNK + 1), smem_rows rows of HEAD_DIM f32, a
    flag a row."""
    return (5 * ROWTAP_TAPS * (BWD_CHUNK + 1) * 4 + smem_rows * HEAD_DIM * 4
            + -(-smem_rows // 16) * 16)


def _bwd_plan(spatial_shapes: Shapes, B: int, Q_pad: int, H: int, smem_bytes) -> msda.BwdPlan:
    """K3's rule (ops/msda.py) with a kernel's own shared memory: a tile of
    queries a CTA (at least a staged chunk; the fewest CTAs
    msda.BWD_MIN_CTAS) and the levels whose grad_value it accumulates in
    shared memory (msda.smem_levels)."""
    tile = msda._tile(B, Q_pad, H, msda.BWD_MIN_CTAS, BWD_CHUNK)
    smem_row, used = msda.smem_levels(spatial_shapes, tile, smem_bytes)
    return msda.BwdPlan(tile, smem_row, used, smem_bytes(used))


def corner_bwd_plan(spatial_shapes: Shapes, B: int, Q_pad: int, H: int) -> msda.BwdPlan:
    """K9's launch plan (_bwd_plan with corner_bwd_smem_bytes)."""
    return _bwd_plan(spatial_shapes, B, Q_pad, H, corner_bwd_smem_bytes)


def rowtap_bwd_plan(spatial_shapes: Shapes, B: int, Q_pad: int, H: int) -> msda.BwdPlan:
    """K10's launch plan (_bwd_plan with rowtap_bwd_smem_bytes)."""
    return _bwd_plan(spatial_shapes, B, Q_pad, H, rowtap_bwd_smem_bytes)


def _plan_args(spatial_shapes, plan: msda.BwdPlan):
    """The level and plan arguments K9's and K10's C entries take."""
    NL = len(spatial_shapes)
    return (*msda._level_arrays(spatial_shapes, level_starts(spatial_shapes)), plan.tile_q,
            (ctypes.c_int * NL)(*plan.smem_row), plan.smem_rows, plan.smem_bytes)


def sweep_bwd_corner(value, spatial_shapes, idx, w, g):
    """K9 on CUDA tensors: idx int32 and w (BH, NL*P*4, Q_pad), g
    (BH, Q_pad, D) -> (grad_value (B, L, H, D), gw).  One kernel block per
    (b*h, tile of queries) gathers and scatters the rows of the live taps;
    gw is 0 for every dead tap (w == 0), which the chain rule multiplies by
    zero.  value and g both f32 or both bf16, 16-byte aligned; built for
    D = 32, P = 4, NL <= 4.  grad_value in value's dtype (bf16: summed in
    f32, rounded once), gw f32."""
    B, L, H, R, Q_pad = _check(value, idx, w, "sweep_bwd_corner", g)
    if idx.dtype != torch.int32:
        raise ValueError("sweep_bwd_corner: idx must be int32")
    NL, P = _check_gather(value, g, spatial_shapes, R, 4, "sweep_bwd_corner")
    plan = corner_bwd_plan(spatial_shapes, B, Q_pad, H)
    gv = torch.zeros(value.shape, dtype=torch.float32, device=value.device)
    gw = torch.empty_like(w)
    entry = _entry("msda_corner_bwd", value)
    fn = getattr(build.load("msda_corner_bwd"), entry)
    fn.argtypes = _CORNER_BWD_CTYPES
    fn.restype = ctypes.c_int
    err = fn(value.data_ptr(), idx.data_ptr(), w.data_ptr(), g.data_ptr(), gv.data_ptr(),
             gw.data_ptr(), B, L, H, Q_pad, NL, P, *_plan_args(spatial_shapes, plan),
             torch.cuda.current_stream(value.device).cuda_stream)
    build.check(err, entry)
    _count(sweep_bwd_corner, value)
    return gv.to(value.dtype), gw


def sweep_bwd_rowtap(value, spatial_shapes, row, px, w, g):
    """K10 on CUDA tensors: row int32, px, w (BH, NL*2*P, Q_pad), g
    (BH, Q_pad, D) -> (grad_value (B, L, H, D), gpx, gw); gpx without the
    row weight.  One kernel block per (b*h, tile of queries,
    rowtap_bwd_plan) gathers its taps' corner rows and scatters the live
    ones; gw and gpx are given on every tap, dead ones too.  value and g
    both f32 or both bf16, 16-byte aligned; built for D = 32, P = 4,
    NL <= 4.  grad_value in value's dtype (bf16: summed in f32, rounded
    once), gpx and gw f32."""
    B, L, H, R, Q_pad = _check(value, px, w, "sweep_bwd_rowtap", g, row)
    NL, P = _check_gather(value, g, spatial_shapes, R, 2, "sweep_bwd_rowtap")
    plan = rowtap_bwd_plan(spatial_shapes, B, Q_pad, H)
    gv = torch.zeros(value.shape, dtype=torch.float32, device=value.device)
    gw = torch.empty_like(w)
    gpx = torch.empty_like(w)
    entry = _entry("msda_rowtap_bwd", value)
    fn = getattr(build.load("msda_rowtap_bwd"), entry)
    fn.argtypes = _ROWTAP_BWD_CTYPES
    fn.restype = ctypes.c_int
    err = fn(value.data_ptr(), row.data_ptr(), px.data_ptr(), w.data_ptr(), g.data_ptr(),
             gv.data_ptr(), gw.data_ptr(), gpx.data_ptr(), B, L, H, Q_pad, NL, P,
             *_plan_args(spatial_shapes, plan),
             torch.cuda.current_stream(value.device).cuda_stream)
    build.check(err, entry)
    _count(sweep_bwd_rowtap, value)
    return gv.to(value.dtype), gpx, gw


# ---------------------------------------------------------------- the backward ops
@torch.library.custom_op("ogd_torch::sweep_bwd_corner", mutates_args=(), device_types="cuda")
def sweep_bwd_corner_op(value: torch.Tensor, spatial_shapes: List[int], idx: torch.Tensor,
                        w: torch.Tensor, g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9 as an op: (grad_value, gw); on CUDA tensors the kernel
    (`sweep_bwd_corner`), counted on sweep_bwd_corner.launches(_bf16)."""
    return sweep_bwd_corner(value, shape_pairs(spatial_shapes), idx, w, g)


@sweep_bwd_corner_op.register_kernel("cpu")
def _sweep_bwd_corner_cpu(value, spatial_shapes, idx, w, g):
    gv, gw = sweep_bwd_corner_plain(value, idx, w, g)
    return gv.to(value.dtype), gw


@sweep_bwd_corner_op.register_fake
def _sweep_bwd_corner_fake(value, spatial_shapes, idx, w, g):
    return torch.empty_like(value), torch.empty_like(w)


@torch.library.custom_op("ogd_torch::sweep_bwd_rowtap", mutates_args=(), device_types="cuda")
def sweep_bwd_rowtap_op(value: torch.Tensor, spatial_shapes: List[int], row: torch.Tensor,
                        px: torch.Tensor, w: torch.Tensor, g: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K10 as an op: (grad_value, gpx, gw), gpx without the row weight; on
    CUDA tensors the kernel (`sweep_bwd_rowtap`), counted on
    sweep_bwd_rowtap.launches(_bf16)."""
    return sweep_bwd_rowtap(value, shape_pairs(spatial_shapes), row, px, w, g)


@sweep_bwd_rowtap_op.register_kernel("cpu")
def _sweep_bwd_rowtap_cpu(value, spatial_shapes, row, px, w, g):
    gv, gpx, gw = sweep_bwd_rowtap_plain(value, row, px, w, g)
    return gv.to(value.dtype), gpx, gw


@sweep_bwd_rowtap_op.register_fake
def _sweep_bwd_rowtap_fake(value, spatial_shapes, row, px, w, g):
    return torch.empty_like(value), torch.empty_like(w), torch.empty_like(w)


def corner_taps_of_rows(row: torch.Tensor, px: torch.Tensor, w: torch.Tensor, L: int, NL: int):
    """The corner taps K9 takes, from row taps (BH, NL*2*P, Q): each row
    tap's two positions with weights r0 * w and r1 * w (`_rowtap_corners`),
    laid out as corner_indices_and_weights lays its taps out (level, point,
    then (x0, y0), (x1, y0), (x0, y1), (x1, y1)) -> idx int32, wc f32
    (BH, NL*P*4, Q).  Where an edge point was collapsed onto its one valid
    corner (rowtap_positions_and_weights), the other corner's weight is 0."""
    BH, R, Q = px.shape
    i0, i1, r0, r1 = _rowtap_corners(row, px, L)
    layout = lambda a, b: (torch.stack([a, b], 2).view(BH, NL, 2, R // (2 * NL), 2, Q)
                           .transpose(2, 3).reshape(BH, 2 * R, Q))
    return layout(i0, i1).to(torch.int32), layout(r0 * w, r1 * w)


def row_grads_of_corners(gwc: torch.Tensor, px: torch.Tensor, w: torch.Tensor, NL: int):
    """The row taps' gradients from K9's corner-tap gw (`corner_taps_of_rows`'
    layout): with P_c the corners' V . g, d/dw = r0 P_0 + r1 P_1 and
    d/dpx = w (P_1 - P_0).  -> (gpx, gw) (BH, NL*2*P, Q)."""
    BH, R, Q = px.shape
    g = gwc.view(BH, NL, R // (2 * NL), 2, 2, Q).transpose(2, 3).reshape(BH, R, 2, Q)
    p0 = torch.floor(px)
    r0, r1 = 1.0 - (px - p0), 1.0 - ((p0 + 1.0) - px)
    return w * (g[:, :, 1] - g[:, :, 0]), r0 * g[:, :, 0] + r1 * g[:, :, 1]


def _rowtap_setup(ctx, inputs, output):
    value, spatial_shapes, row, px, w, bwd = inputs
    if bwd not in SWEEP_BWD:
        raise ValueError(f"bwd must be one of {SWEEP_BWD}, got {bwd!r}")
    ctx.spatial_shapes, ctx.bwd = spatial_shapes, bwd
    ctx.save_for_backward(value, row, px, w)


def _rowtap_backward(ctx, grad_out):
    """The custom VJP of ms_deform_attn_pallas_t (msda_pallas.py:1415-1535)
    on the sorted row taps: K10 on them, or K9 on their corner taps with
    the corner gradients folded back onto the rows (`row_grads_of_corners`);
    autograd chains px's and w's gradients to the locations and weights
    through the expansion, as the JAX package's jax.vjp does."""
    value, row, px, w = ctx.saved_tensors
    g = kernel_rows(grad_out, value.dtype)
    if ctx.bwd == "rowtap":
        gv, gpx, gw = sweep_bwd_rowtap_op(value, ctx.spatial_shapes, row, px, w, g)
        return gv, None, None, gpx * w, gw, None
    NL = len(ctx.spatial_shapes) // 2
    idx, wc = corner_taps_of_rows(row, px, w, value.shape[1], NL)
    gv, gwc = sweep_bwd_corner_op(value, ctx.spatial_shapes, idx, wc, g)
    gpx, gw = row_grads_of_corners(gwc, px, w, NL)
    return gv, None, None, gpx, gw, None


def _corner_fwd_setup(ctx, inputs, output):
    value, spatial_shapes, idx, w = inputs
    ctx.spatial_shapes = spatial_shapes
    ctx.save_for_backward(value, idx, w)


def _corner_fwd_backward(ctx, grad_out):
    """K9 on K8's own corner taps (ms_deform_attn_pallas under
    MSDA_FWD_VARIANT=corner)."""
    value, idx, w = ctx.saved_tensors
    gv, gw = sweep_bwd_corner_op(value, ctx.spatial_shapes, idx, w,
                                 kernel_rows(grad_out, value.dtype))
    return gv, None, None, gw


for _op, _cpu in ((sweep_fwd_op, _sweep_fwd_cpu), (sweep_fwd_allq_op, _sweep_fwd_allq_cpu)):
    _op.register_kernel("cpu")(_cpu)
    _op.register_fake(_rowtap_fwd_fake)
    _op.register_autograd(_rowtap_backward, setup_context=_rowtap_setup)
sweep_fwd_corner_op.register_autograd(_corner_fwd_backward, setup_context=_corner_fwd_setup)


def _tap_flops(value, w, px, taps_per_sample: int, per_corner: int) -> int:
    """A sweep kernel's operations (library.msda_flops) on its taps: the
    corners of every live tap (w != 0; a row tap's two, one where px is an
    integer), samples counted over the padded query axis."""
    BH, R, Qp = w.shape
    samples = BH * Qp * (R // taps_per_sample)
    if not is_real(w, px):
        corners = 4 * samples
    elif px is None:
        corners = int((w != 0).sum())
    else:
        corners = int(((w != 0).int() * (1 + (px > torch.floor(px)).int())).sum())
    return msda_flops(samples, corners, value.shape[-1], per_corner)


@register_flop_formula([torch.ops.ogd_torch.sweep_fwd, torch.ops.ogd_torch.sweep_fwd_allq],
                       get_raw=True)
def _rowtap_fwd_flops(value, spatial_shapes, row, px, w, bwd="corner", out_val=None):
    return _tap_flops(value, w, px, 2, 2)


@register_flop_formula(torch.ops.ogd_torch.sweep_fwd_corner, get_raw=True)
def _corner_fwd_flops(value, spatial_shapes, idx, w, out_val=None):
    return _tap_flops(value, w, None, 4, 2)


@register_flop_formula(torch.ops.ogd_torch.sweep_bwd_corner, get_raw=True)
def _corner_bwd_flops(value, spatial_shapes, idx, w, g, out_val=None):
    return _tap_flops(value, w, None, 4, 8)


@register_flop_formula(torch.ops.ogd_torch.sweep_bwd_rowtap, get_raw=True)
def _rowtap_bwd_flops(value, spatial_shapes, row, px, w, g, out_val=None):
    return _tap_flops(value, w, px, 2, 8)


# ---------------------------------------------------------------- the model's op
def kernel_layout(locs: torch.Tensor, attn: torch.Tensor):
    """(B, Q, H, NL, P, 2) / (B, Q, H, NL, P) -> (BH, NL, P, 2, Q) /
    (BH, NL, P, Q), f32."""
    B, Q, H, NL, P, _ = locs.shape
    locs_t = locs.float().permute(0, 2, 3, 4, 5, 1).reshape(B * H, NL, P, 2, Q)
    attn_t = attn.float().permute(0, 2, 3, 4, 1).reshape(B * H, NL, P, Q)
    return locs_t, attn_t


def query_order(row: torch.Tensor, px, L: int):
    """The order the kernels see the queries in: raster for Q == L (already
    local), else sorted by the first row tap's flat position (px None: by the
    first corner tap's, `row` holding corner positions); None for raster."""
    if row.shape[-1] == L:
        return None
    key = row[:, 0, :] if px is None else row[:, 0, :] + px[:, 0, :].long()
    return torch.argsort(key, dim=1, stable=True)


def sort_and_pad(t: torch.Tensor, order, q_axis: int = -1) -> torch.Tensor:
    """Queries of t (on q_axis) in `order`, zero-padded to a QBLOCK multiple,
    contiguous."""
    q_axis %= t.dim()
    if order is not None:
        shape = [1] * t.dim()
        shape[0], shape[q_axis] = order.shape
        t = torch.gather(t, q_axis, order.view(shape).expand(
            *[t.shape[i] if i != q_axis else order.shape[1] for i in range(t.dim())]))
    Q = t.shape[q_axis]
    pad = -Q % QBLOCK
    if pad:
        widths = [0, 0] * (t.dim() - 1 - q_axis) + [0, pad]
        t = torch.nn.functional.pad(t, widths)
    return t.contiguous()


def unsort(t: torch.Tensor, order, Q: int, q_axis: int = -1) -> torch.Tensor:
    """Inverse of sort_and_pad: the first Q sorted queries back in order."""
    q_axis %= t.dim()
    t = t.narrow(q_axis, 0, Q)
    if order is None:
        return t
    shape = [1] * t.dim()
    shape[0], shape[q_axis] = order.shape
    index = order.view(shape).expand(*t.shape)
    return torch.empty_like(t).scatter_(q_axis, index, t)


def _to_reference(t_bh: torch.Tensor, B: int, H: int) -> torch.Tensor:
    """(BH, Q, D) -> (B, Q, H*D)."""
    _, Q, D = t_bh.shape
    return t_bh.view(B, H, Q, D).permute(0, 2, 1, 3).reshape(B, Q, H * D)


def _rowtap_forward(value, locs, attn, spatial_shapes, dec_fused: bool, bwd: str):
    """The row-tap forward: the expansion, the decoder's sort, K6's op, or
    K7's for a sorted set under dec_fused, and the un-sort; differentiable
    through the ops' autograd (K9 or K10 by `bwd`) and the expansion."""
    B, L, H, _ = value.shape
    row, px, w = rowtap_positions_and_weights(*kernel_layout(locs, attn), spatial_shapes)
    order = query_order(row, px.detach(), L)
    op = sweep_fwd_allq_op if (dec_fused and order is not None) else sweep_fwd_op
    out = op(value, flat_shapes(spatial_shapes), *(sort_and_pad(t, order) for t in (row, px, w)),
             bwd)
    return _to_reference(unsort(out, order, locs.shape[1], q_axis=1), B, H)


def _corner_forward(value, locs, attn, spatial_shapes):
    """The corner forward (ms_deform_attn_pallas under MSDA_FWD_VARIANT=corner):
    the corner expansion, sorted by its first corner tap, K8's op (K9 for
    its gradient), the un-sort."""
    B, L, H, _ = value.shape
    idx, w = corner_indices_and_weights(*kernel_layout(locs, attn), spatial_shapes)
    order = query_order(idx, None, L)
    out = sweep_fwd_corner_op(value, flat_shapes(spatial_shapes),
                              *(sort_and_pad(t, order) for t in (idx, w)))
    return _to_reference(unsort(out, order, locs.shape[1], q_axis=1), B, H)


def ms_deform_attn_sweep_plain(value, spatial_shapes, locs, attn, fwd="rowtap"):
    """The sweep's function without the ops: row-tap (or corner) expansion
    and sweep_fwd_plain (sweep_fwd_corner_plain), differentiable by
    autograd.  Returns (B, Q, H*D) in value's dtype."""
    B, L, H, D = value.shape
    if fwd == "corner":
        out = sweep_fwd_corner_plain(value, *corner_indices_and_weights(
            *kernel_layout(locs, attn), spatial_shapes))
    else:
        out = sweep_fwd_plain(value, *rowtap_positions_and_weights(
            *kernel_layout(locs, attn), spatial_shapes))
    return _to_reference(out, B, H).to(value.dtype)


def ms_deform_attn_sweep(value: torch.Tensor, spatial_shapes: Shapes, level_start: Sequence[int],
                         locs: torch.Tensor, attn: torch.Tensor, bwd: str = "corner",
                         dec_fused: bool = False, fwd: str = "rowtap") -> torch.Tensor:
    """ms_deform_attn's contract (ops/msda.py) through the sweep kernels:
    value (B, L, H, D), locs (B, Q, H, NL, P, 2), attn (B, Q, H, NL, P) ->
    (B, Q, H*D) in value's dtype.  On CUDA tensors (value f32 or bf16, D = 32,
    P <= 4): K6 forward, or K7 for Q != L under `dec_fused`, or K8 with
    `fwd="corner"`; K9 backward (`bwd="corner"`) or K10
    (`bwd="rowtap"`).  The corner forward is the JAX op-level path, which has
    neither a fused decoder nor the row-tap backward: with it, both raise.
    On CPU tensors the kernels' plain versions; through the ops either way.
    `level_start` is the raster offsets of the levels, checked against
    spatial_shapes."""
    if bwd not in SWEEP_BWD:
        raise ValueError(f"bwd must be one of {SWEEP_BWD}, got {bwd!r}")
    if fwd not in SWEEP_FWD:
        raise ValueError(f"fwd must be one of {SWEEP_FWD}, got {fwd!r}")
    if fwd == "corner" and (dec_fused or bwd != "corner"):
        raise ValueError("the corner forward takes the corner backward and no fused decoder")
    if tuple(level_start) != level_starts(spatial_shapes):
        raise ValueError("the sweep takes the raster level order (level_start of spatial_shapes)")
    if value.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ms_deform_attn_sweep: unsupported device {value.device}")
    shapes = tuple(map(tuple, spatial_shapes))
    if fwd == "corner":
        return _corner_forward(value, locs, attn, shapes)
    return _rowtap_forward(value, locs, attn, shapes, bool(dec_fused), bwd)


sweep_fwd.launches = sweep_fwd.launches_bf16 = 0
sweep_fwd_allq.launches = sweep_fwd_allq.launches_bf16 = 0
sweep_fwd_corner.launches = sweep_fwd_corner.launches_bf16 = 0
sweep_bwd_corner.launches = sweep_bwd_corner.launches_bf16 = 0
sweep_bwd_rowtap.launches = sweep_bwd_rowtap.launches_bf16 = 0
