"""Multi-scale deformable attention with one band sweep per sample point: K5
(csrc/msda_banded_fwd.cu), its plain PyTorch version, and its op, whose
gradient is K3's.

The port of the JAX package's ops/msda_banded.py under MSDA_BANDED_MP=0 (its
`_banded_core` with `_msda_banded_kernel`).  The function is
ms_deform_attn_xla's (ops/msda.py here), split into its separable factors:
for each sample point, the bilinear x-interpolation of a value row,
sum_x relu(1 - |px - x|) * V[y, x], is weighted by relu(1 - |py - y|) * wa
and summed over the rows of the point's band windows.  Per (batch*head,
128-query block, level, point) the windows [ylo + i*band, ylo + (i+1)*band),
i < n_it, cover the rows the block's points touch; rows at or past the
level's height read zero.  Only the two rows floor(py) and floor(py) + 1 of
a point have a non-zero weight, so the windows enumerate rows and never
change the result: K5 takes each point's (at most) four corners directly,
and `band` shapes only the plain version's loop.

Operands (kernel layout, from `banded_prep`; the TPU's (BH, H_l*D, W_l) value
layout is not ported, the kernel reads the reference (B, L, H, D) value):
  px   (BH, NL*P, Q) continuous x within the row, edge-collapsed (a point
       with one valid x corner sits on that corner's integer column, its
       partial weight folded into wa) and clipped to [0, W_l - 1]
  py   (BH, NL*P, Q) continuous y, clipped to [-1, H_l]
  wa   (BH, NL*P, Q) edge x weight * attention weight (0 kills the point)
Query sets with Q != L (the decoder) are sorted by the position of their
first finest-level point (`query_order`, ms_deform_attn_banded_sorted's
key), so that a block's points stay local, and un-sorted afterwards; the JAX
decoder's sort-once across layers is a TPU trick the port does not take.

bf16 (the JAX package's default mixed precision; value and upstream
gradient bf16, px, py, wa f32): K5 has a bf16 entry, as the TPU kernel has a
bf16 branch (msda_banded.py:175, 190, 199-204).  It reads bf16 value rows,
keeps the corner weights and every sum f32 and rounds its output to bf16
once (the TPU kernel rounds its x-tap matrix to bf16 for the MXU; the port
keeps it f32, as K1's bf16 entry does).  The backward is K3's bf16 entry,
which adds grad_value in bf16 as the JAX banded backward does
(`MSDA_BWD_GV_BF16`, msda_banded.py:693-709).

K5 is the custom op `ogd_torch::banded_fwd` (`banded_fwd_op`;
ops/library.py): on CUDA tensors the kernel, on CPU ones `banded_fwd_plain`
with band windows taken from its own operands (`tap_band_ranges`).  The op
also takes the reference operands (value, locs, attn) and the query order:
its registered autograd formula is K3's op on them (ops/msda.msda_bwd), as
the JAX custom VJP runs the native banded backward (`_banded_bwd`), and
K5's operands are made without a gradient.  `ms_deform_attn_banded` calls
the op whether or not a gradient is needed.  `banded_fwd` is K5's launcher,
through the op: CUDA tensors only, counting `banded_fwd.launches` (f32) and
`banded_fwd.launches_bf16`; nothing on the card reaches a plain version.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from . import build, library, msda
from .library import flat_shapes, is_real, kernel_rows, msda_flops, shape_pairs
from .msda import level_starts
from .msda_sweep import (HEAD_DIM, QBLOCK, _count, _cuda_only, _entry, _gather_rows, _to_reference,
                         _value_bh, kernel_layout, sort_and_pad, unsort)

Shapes = Sequence[Tuple[int, int]]

BAND = 4                   # rows a band window (the JAX package's MSDA_BAND default)


def level_bands(spatial_shapes: Shapes, band: int) -> Tuple[int, ...]:
    """Each level's window height: the band, at most the level's height."""
    return tuple(min(band, h) for h, _ in spatial_shapes)


def banded_prep(locs_t: torch.Tensor, attn_t: torch.Tensor, spatial_shapes: Shapes):
    """The kernel's separable factors (msda_banded.py::_banded_prep):
    locs_t (BH, NL, P, 2, Q), attn_t (BH, NL, P, Q), f32 -> (px, py, wa),
    each (BH, NL*P, Q) f32, differentiable in both inputs."""
    px_parts, py_parts, wa_parts = [], [], []
    for lvl, (Hl, Wl) in enumerate(spatial_shapes):
        pxc = locs_t[:, lvl, :, 0, :] * Wl - 0.5          # (BH, P, Q)
        pyc = locs_t[:, lvl, :, 1, :] * Hl - 0.5
        x0 = torch.floor(pxc)
        fx = pxc - x0
        x0i = x0.long()
        v0 = (x0i >= 0) & (x0i <= Wl - 1)
        v1 = (x0i + 1 >= 0) & (x0i + 1 <= Wl - 1)
        interior = v0 & v1
        edge_px = torch.where(v0, x0, x0 + 1.0)
        edge_wx = torch.where(v0, 1.0 - fx, torch.where(v1, fx, torch.zeros_like(fx)))
        px = torch.where(interior, pxc, edge_px).clamp(0.0, float(max(Wl - 1, 0)))
        wx = torch.where(interior, torch.ones_like(fx), edge_wx)
        px_parts.append(px)
        py_parts.append(pyc.clamp(-1.0, float(Hl)))
        wa_parts.append(wx * attn_t[:, lvl])
    BH, Q = locs_t.shape[0], locs_t.shape[-1]
    stack = lambda parts: torch.stack(parts, 1).reshape(BH, -1, Q)
    return stack(px_parts), stack(py_parts), stack(wa_parts)


def _block_ranges(y0: torch.Tensor, counted: torch.Tensor, Hl: int, band: int) -> torch.Tensor:
    """Per (bh, point, 128-query block) [ylo, n_it] of the first-corner rows
    y0 (BH, P, Q_pad) of the `counted` queries: ylo their least row, n_it =
    (yhi - ylo) // band + 1 windows to their greatest second-corner row,
    both clipped into the level; a query not counted widens nothing."""
    BH, P, Qp = y0.shape
    y_lo = torch.where(counted, y0.clamp(0, Hl - 1), Hl - 1)
    y_hi = torch.where(counted, (y0 + 1).clamp(0, Hl - 1), 0)
    lo = y_lo.view(BH, P, Qp // QBLOCK, QBLOCK).amin(3)
    hi = y_hi.view(BH, P, Qp // QBLOCK, QBLOCK).amax(3)
    return torch.stack([lo, (hi - lo) // band + 1], -1)                    # (BH, P, nqb, 2)


def _stack_ranges(parts) -> torch.Tensor:
    """Each level's (BH, P, nqb, 2) -> (BH, nqb*NL*P*2) int32."""
    ranges = torch.stack(parts, 1).movedim(3, 1)                           # (BH, nqb, NL, P, 2)
    return ranges.reshape(ranges.shape[0], -1).to(torch.int32)


def band_ranges(locs_t: torch.Tensor, spatial_shapes: Shapes, nqb: int, bands) -> torch.Tensor:
    """Per (bh, 128-query block, level, point) [ylo, n_it]
    (msda_banded.py::_band_ranges): ylo the block's least first-corner row,
    n_it = (yhi - ylo) // band + 1 windows to its greatest second-corner row,
    both clipped into the level.  Queries past Q (padding to nqb blocks)
    take ylo = H_l - 1, yhi = 0 and widen nothing.  -> (BH, nqb*NL*P*2)
    int32."""
    Q = locs_t.shape[-1]
    pad = nqb * QBLOCK - Q
    counted = torch.arange(nqb * QBLOCK, device=locs_t.device) < Q
    return _stack_ranges([
        _block_ranges(torch.nn.functional.pad(
            torch.floor(locs_t[:, lvl, :, 1, :] * Hl - 0.5).long(), (0, pad)), counted, Hl,
            bands[lvl])
        for lvl, (Hl, _) in enumerate(spatial_shapes)])


def tap_band_ranges(py: torch.Tensor, wa: torch.Tensor, spatial_shapes: Shapes,
                    bands) -> torch.Tensor:
    """band_ranges from K5's own operands (BH, NL*P, Q_pad): each live point's
    (wa != 0) first row floor(py); a dead or padded one widens nothing.  The
    windows cover the rows of every live point, which is all the plain
    version needs (the module's docstring) -> (BH, nqb*NL*P*2) int32."""
    P = py.shape[1] // len(spatial_shapes)
    return _stack_ranges([
        _block_ranges(torch.floor(py[:, lvl * P:(lvl + 1) * P]).long(),
                      wa[:, lvl * P:(lvl + 1) * P] != 0, Hl, bands[lvl])
        for lvl, (Hl, _) in enumerate(spatial_shapes)])


def query_order(locs_t: torch.Tensor, spatial_shapes: Shapes, L: int):
    """The order K5 sees the queries in: raster for Q == L (already local),
    else sorted by the (y, x) position of the first finest-level point
    (ms_deform_attn_banded_sorted's key, y * H0 * (W0 + 2) + x * W0 on
    coordinates clipped to [-0.1, 1.1]); None for raster."""
    if locs_t.shape[-1] == L:
        return None
    H0, W0 = spatial_shapes[0]
    y = locs_t[:, 0, 0, 1, :].detach().clamp(-0.1, 1.1)
    x = locs_t[:, 0, 0, 0, :].detach().clamp(-0.1, 1.1)
    return torch.argsort(y * H0 * (W0 + 2) + x * W0, dim=1, stable=True)


def _take_q(t: torch.Tensor, order) -> torch.Tensor:
    """t's queries (last axis) in `order` (BH, Q)."""
    if order is None:
        return t
    shape = (t.shape[0],) + (1,) * (t.dim() - 2) + (t.shape[-1],)
    return torch.gather(t, -1, order.view(shape).expand(t.shape))


def banded_operands(locs: torch.Tensor, attn: torch.Tensor, spatial_shapes: Shapes, L: int):
    """What K5 takes on the model path: (order, locs_t, px, py, wa) with
    locs_t (BH, NL, P, 2, Q) in the kernel's query order and px, py, wa
    from it, zero-padded to a QBLOCK multiple (a padded query has wa == 0)."""
    locs_t, attn_t = kernel_layout(locs, attn)
    order = query_order(locs_t, spatial_shapes, L)
    locs_t, attn_t = _take_q(locs_t, order), _take_q(attn_t, order)
    px, py, wa = (sort_and_pad(t, None) for t in banded_prep(locs_t, attn_t, spatial_shapes))
    return order, locs_t, px, py, wa


# ---------------------------------------------------------------- plain version
def banded_fwd_plain(value, spatial_shapes: Shapes, px, py, wa, ranges, band: int = BAND):
    """K5's function done the kernel's way: for each level, point, band
    window and row, relu(1 - |py - y|) * wa times the row's x-interpolation
    r0 * V[y, x0] + r1 * V[y, x0 + 1] (the two non-zeros of
    relu(1 - |px - x|)), accumulated in that order; rows at or past H_l read
    zero.  value (B, L, H, D); px, py, wa (BH, NL*P, Q_pad); ranges
    (BH, nqb*NL*P*2) from band_ranges -> (BH, Q_pad, D) f32.  A bf16 value
    is upcast and summed in f32: rounded to bf16 once, the result is K5's
    bf16 entry's plain version."""
    v = _value_bh(value)
    BH, R, Qp = px.shape
    NL = len(spatial_shapes)
    P = R // NL
    nqb = Qp // QBLOCK
    rng = ranges.view(BH, nqb, NL, P, 2).long().repeat_interleave(QBLOCK, dim=1)  # per query
    out = torch.zeros(BH, Qp, v.shape[-1], dtype=torch.float32, device=v.device)
    for lvl, ((Hl, Wl), start, bl) in enumerate(zip(spatial_shapes, level_starts(spatial_shapes),
                                                    level_bands(spatial_shapes, band))):
        for p in range(P):
            t = lvl * P + p
            x, y, a = px[:, t], py[:, t], wa[:, t]
            xf = torch.floor(x)
            r0 = 1.0 - (x - xf)
            r1 = 1.0 - ((xf + 1.0) - x)
            x0 = xf.long()
            x1 = (x0 + 1).clamp(max=Wl - 1)   # past the row only where r1 == 0
            lo, n_it = rng[:, :, lvl, p, 0], rng[:, :, lvl, p, 1]
            for i in range(int(n_it.max())):
                for r in range(bl):
                    yr = lo + i * bl + r
                    live = (i < n_it) & (yr < Hl)
                    wy = torch.clamp(1.0 - (y - yr.float()).abs(), min=0.0) * a
                    wy = torch.where(live, wy, torch.zeros_like(wy))
                    base = start + yr.clamp(max=Hl - 1) * Wl
                    c = (_gather_rows(v, base + x0) * r0[..., None]
                         + _gather_rows(v, base + x1) * r1[..., None])
                    out = out + wy[..., None] * c
    return out


# ---------------------------------------------------------------- K5
_FWD_CTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
               + [ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.c_int, ctypes.c_void_p])


def fwd_smem_bytes(NL: int, tile_q: int) -> int:
    """K5's dynamic shared memory (csrc/msda_banded_fwd.cu
    msda_banded_fwd_smem_bytes): each (point, query) of a tile's corner
    positions (int4) and weights (float4), a row of tile_q + 1 a point."""
    return NL * msda.POINTS * (tile_q + 1) * 32


def _banded_fwd_cuda(value, spatial_shapes: Shapes, px, py, wa):
    """K5 on CUDA tensors: one kernel block per (b*h, tile of queries), the
    tile chosen as K1's (msda.msda_fwd_tile); each live point (wa != 0)
    reads its at most four corner rows.  value (B, L, H, 32) f32 or bf16,
    16-byte aligned; px, py, wa (BH, NL*P, Q_pad) f32, contiguous ->
    (BH, Q_pad, 32) in value's dtype (bf16: f32 sums, rounded once)."""
    for name, t in (("value", value), ("px", px), ("py", py), ("wa", wa)):
        if t.device.type != "cuda":
            raise ValueError(f"banded_fwd: unsupported device {t.device} for {name}")
        if t.device != value.device or not t.is_contiguous():
            raise ValueError(f"banded_fwd: {name} must be contiguous on {value.device}")
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"banded_fwd: value must be float32 or bfloat16, got {value.dtype}")
    if any(t.dtype != torch.float32 for t in (px, py, wa)):
        raise ValueError("banded_fwd: px, py and wa must be float32")
    if value.dim() != 4 or value.data_ptr() % 16:
        raise ValueError(f"banded_fwd: value must be a 16-byte aligned (B, L, H, D), got "
                         f"{tuple(value.shape)}")
    B, L, H, D = value.shape
    BH, R, Qp = px.shape
    NL = len(spatial_shapes)
    if BH != B * H or py.shape != px.shape or wa.shape != px.shape or Qp % QBLOCK:
        raise ValueError(f"banded_fwd: px/py/wa {tuple(px.shape)} do not fit value "
                         f"{tuple(value.shape)} and {QBLOCK}-query blocks")
    if R % NL or sum(h * w for h, w in spatial_shapes) != L:
        raise ValueError(f"banded_fwd: {R} taps over levels {tuple(spatial_shapes)} do not fit "
                         f"L = {L}")
    msda.check_geometry(D, NL, R // NL)
    out = torch.empty(BH, Qp, HEAD_DIM, dtype=value.dtype, device=value.device)
    entry = _entry("msda_banded_fwd", value)
    fn = getattr(build.load("msda_banded_fwd"), entry)
    fn.argtypes = _FWD_CTYPES
    fn.restype = ctypes.c_int
    err = fn(value.data_ptr(), px.data_ptr(), py.data_ptr(), wa.data_ptr(), out.data_ptr(),
             B, L, H, Qp, NL, R // NL,
             *msda._level_arrays(spatial_shapes, level_starts(spatial_shapes)),
             msda.msda_fwd_tile(B, Qp, H), torch.cuda.current_stream(value.device).cuda_stream)
    build.check(err, entry)
    _count(banded_fwd, value)
    return out


@torch.library.custom_op("ogd_torch::banded_fwd", mutates_args=(), device_types="cuda")
def banded_fwd_op(value: torch.Tensor, spatial_shapes: List[int], px: torch.Tensor,
                  py: torch.Tensor, wa: torch.Tensor, locs: Optional[torch.Tensor] = None,
                  attn: Optional[torch.Tensor] = None, order: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """K5 as an op (`spatial_shapes` flat): on CUDA tensors the kernel,
    counted on banded_fwd.launches(_bf16).  `locs`, `attn` (the reference
    operands px, py, wa were made from) and `order` (their query order,
    None for raster) are its gradient's: K3's op on (value, locs, attn),
    the JAX custom VJP's native banded backward (`_banded_bwd`).  The
    forward reads only px, py, wa."""
    return library.kernel_output("banded_fwd", _banded_fwd_cuda, value,
                                 shape_pairs(spatial_shapes), px, py, wa)


@banded_fwd_op.register_kernel("cpu")
def _banded_fwd_cpu(value, spatial_shapes, px, py, wa, locs=None, attn=None, order=None):
    def plain(value, shapes, px, py, wa):
        ranges = tap_band_ranges(py, wa, shapes, level_bands(shapes, BAND))
        return banded_fwd_plain(value, shapes, px, py, wa, ranges).to(value.dtype)

    return library.kernel_output("banded_fwd", plain, value, shape_pairs(spatial_shapes), px, py,
                                 wa)


@banded_fwd_op.register_fake
def _banded_fwd_fake(value, spatial_shapes, px, py, wa, locs=None, attn=None, order=None):
    return value.new_empty(px.shape[0], px.shape[2], value.shape[-1])


def _banded_fwd_setup(ctx, inputs, output):
    value, spatial_shapes, px, py, wa, locs, attn, order = inputs
    if locs is None or attn is None:
        raise ValueError("banded_fwd takes its gradient only with the reference locs and attn")
    ctx.spatial_shapes = spatial_shapes
    ctx.save_for_backward(value, locs, attn, order)


def _banded_fwd_backward(ctx, grad_out):
    """K3 on the reference operands: the upstream gradient un-sorted into
    (B, Q, H*D) in value's dtype; grad_locs and grad_attn f32, px, py and
    wa none (they are made without a gradient)."""
    value, locs, attn, order = ctx.saved_tensors
    B, _, H, _ = value.shape
    g = _to_reference(unsort(grad_out, order, locs.shape[1], q_axis=1), B, H)
    shapes = shape_pairs(ctx.spatial_shapes)
    grad_value, grad_locs, grad_attn = msda.msda_bwd(
        value, ctx.spatial_shapes, list(level_starts(shapes)), locs, attn,
        kernel_rows(g, value.dtype))
    return grad_value, None, None, None, None, grad_locs, grad_attn, None


banded_fwd_op.register_autograd(_banded_fwd_backward, setup_context=_banded_fwd_setup)


@register_flop_formula(torch.ops.ogd_torch.banded_fwd, get_raw=True)
def _banded_fwd_flops(value, spatial_shapes, px, py, wa, *rest, out_val=None):
    """K5's operations: each live point's (wa != 0) in-map corners (its
    x corners by px, its rows floor(py) and floor(py) + 1 inside the level)."""
    BH, R, Qp = px.shape
    if not is_real(px, py, wa):
        return msda_flops(BH * R * Qp, 4 * BH * R * Qp, value.shape[-1], 2)
    shapes = shape_pairs(spatial_shapes)
    P = R // len(shapes)
    corners = 0
    for lvl, (Hl, _) in enumerate(shapes):
        x, y, a = (t[:, lvl * P:(lvl + 1) * P] for t in (px, py, wa))
        nx = 1 + (x > torch.floor(x)).int()
        y0 = torch.floor(y)
        ny = ((y0 >= 0) & (y0 < Hl)).int() + ((y0 + 1 >= 0) & (y0 + 1 < Hl)).int()
        corners += int((nx * ny * (a != 0).int()).sum())
    return msda_flops(BH * R * Qp, corners, value.shape[-1], 2)


def banded_fwd(value, spatial_shapes: Shapes, px, py, wa, band: int = BAND):
    """K5 on CUDA tensors, through its op (`_banded_fwd_cuda` has the
    operands); raises for any other device.  `band` does not change the
    result (the module's docstring) and is not used here."""
    _cuda_only("banded_fwd", value, px, py, wa)
    return banded_fwd_op(value, flat_shapes(spatial_shapes), px, py, wa)


def ms_deform_attn_banded_plain(value, spatial_shapes: Shapes, locs, attn, band: int = BAND):
    """The banded op's function for CPU tensors: the operands K5 takes,
    band_ranges and banded_fwd_plain, differentiable by autograd.  Returns
    (B, Q, H*D) in value's dtype: on a bf16 value, f32 sums rounded once,
    K5 bf16's plain version."""
    B, L, H, _ = value.shape
    order, locs_t, px, py, wa = banded_operands(locs, attn, spatial_shapes, L)
    ranges = band_ranges(locs_t, spatial_shapes, px.shape[-1] // QBLOCK,
                         level_bands(spatial_shapes, band))
    out = banded_fwd_plain(value, spatial_shapes, px, py, wa, ranges, band)
    return _to_reference(unsort(out, order, locs.shape[1], q_axis=1), B, H).to(value.dtype)


def ms_deform_attn_banded(value: torch.Tensor, spatial_shapes: Shapes, level_start: Sequence[int],
                          locs: torch.Tensor, attn: torch.Tensor, band: int = BAND) -> torch.Tensor:
    """ms_deform_attn's contract (ops/msda.py) through the per-point banded
    forward: value (B, L, H, D), locs (B, Q, H, NL, P, 2), attn
    (B, Q, H, NL, P) -> (B, Q, H*D) in value's dtype.  On CUDA tensors
    (value f32 or bf16, D = 32) K5 forward and K3 backward, on CPU tensors
    their plain versions, through the ops either way.  `band` is the window
    height in rows of the plain version; the result does not depend on it,
    and the ops take BAND.  `level_start` must be the raster offsets of the
    levels."""
    if tuple(level_start) != level_starts(spatial_shapes):
        raise ValueError("the banded op takes the raster level order (level_start of spatial_shapes)")
    if value.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ms_deform_attn_banded: unsupported device {value.device}")
    shapes = tuple(map(tuple, spatial_shapes))
    B, L, H, _ = value.shape
    with torch.no_grad():   # K5's operands carry no gradient: its backward is K3's
        order, _, px, py, wa = banded_operands(locs, attn, shapes, L)
    out = banded_fwd_op(value, flat_shapes(shapes), px, py, wa, locs, attn, order)
    return _to_reference(unsort(out, order, locs.shape[1], q_axis=1), B, H)


banded_fwd.launches = banded_fwd.launches_bf16 = 0
