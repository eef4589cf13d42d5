"""Multi-scale deformable attention core op: K1 (csrc/msda_fwd.cu), its
gradient K3 (csrc/msda_bwd.cu), and their plain PyTorch versions.

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

K1 is the custom op `ogd_torch::msda_fwd` (`msda_fwd`; ops/library.py) and
K3 the op `ogd_torch::msda_bwd` (`msda_bwd`): on CUDA tensors the kernels
(`_msda_fwd_cuda`, `ms_deform_attn_bwd`), on CPU ones `ms_deform_attn_plain`
and its VJP by autograd (`ms_deform_attn_bwd_plain`).  msda_fwd's registered
autograd formula calls msda_bwd, so `ms_deform_attn` calls the op whether
or not a gradient is needed, and a graph traced through it (torch.compile,
AOTAutograd, FlopCounterMode) sees K1 and K3.  `ms_deform_attn_bwd` is K3's
launcher and takes CUDA tensors only.  A CUDA tensor never reaches a plain
version; `ms_deform_attn.launches` and `ms_deform_attn_bwd.launches` count
the kernels' f32 launches, `.launches_bf16` their bf16 ones.

bf16 (the value and the upstream gradient; locations and weights stay f32):
K1 sums in f32 and rounds its output once.  K3 returns grad_value in bf16,
accumulated in bf16 as the JAX package's default MSDA_BWD_GV_BF16=1 does
(ops/msda_banded.py:693-709): the levels outside shared memory add with
bf16 atomics, the shared-memory levels sum in f32 and are rounded once;
grad_locs and grad_attn are f32.  The plain backward sums grad_value in f32 and rounds it
once, the exact result the kernel's bf16 sums are held against.

The kernels are built for the flagship's geometry (`check_geometry`: D = 32
channels a head, P = 4 points, at most 4 levels) and take a launch plan
from here: K1 the queries a CTA (`msda_fwd_tile`), K3 also which levels
accumulate grad_value in shared memory (`msda_bwd_plan`).
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from . import build, library
from .library import (flat_shapes, in_map_corners, is_real, kernel_rows, msda_flops,
                      shape_pairs, vjp_on_fresh_thread)

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
        out.add_(g.float().mul_(w_t[t][..., None]))   # in place: the same sums, fewer tensors
    return out.to(value.dtype).permute(0, 2, 1, 3).reshape(B, Q, H * D)


def ms_deform_attn_bwd_plain(value, spatial_shapes, level_start, locs, attn, grad_out):
    """(grad_value, grad_locs, grad_attn) of the plain version by autograd
    (torch.gather's backward is the scatter-add, in f32; grad_value comes
    back in value's dtype, rounded once)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (value, locs, attn)]
        out = ms_deform_attn_plain(leaves[0], spatial_shapes, level_start, leaves[1], leaves[2])
        return torch.autograd.grad(out, leaves, grad_out)


# the geometry csrc/msda_common.cuh is built for
HEAD_DIM, POINTS, MAX_LEVELS = 32, 4, 4
FWD_WARPS, BWD_WARPS = 8, 16          # warps a CTA (csrc/msda_fwd.cu, msda_bwd.cu)
TILES = (256, 128, 64, 32, 16)       # queries a CTA, largest first
# the fewest CTAs a launch should have (the 132 SMs hold 8 of K1's 8-warp
# CTAs each, 2 of K3's 16-warp ones): the least of the times measured at the
# flagship shapes (PERF.md, PR 6): small tiles for K1, where a CTA's own
# queries gain little from L1 and more CTAs balance the SMs, large ones for
# K3, which zeroes and flushes its shared-memory levels once a tile
FWD_MIN_CTAS = 64 * 132
BWD_MIN_CTAS = 4 * 132
# K3's shared memory a CTA, so that 2 CTAs share an SM's 228 KB (1 KB of it
# reserved a CTA; a CTA alone could have 232,448 B): at 1 CTA an SM K3 loses
# more to idle warps than the shared-memory levels save
BWD_SMEM_BUDGET = 233_472 // 2 - 1024
# K3's bf16 entry may take a CTA's most (1 CTA an SM): each global bf16 add
# rounds, and the levels whose rows take the most adds (at the 800x1216
# bucket level 2, ~340 a row at B = 4, and level 3) then sum in f32 and are
# rounded once
BWD_SMEM_BUDGET_BF16 = 232_448
SLOT_BYTES = 48                       # one staged sample (msda_common.cuh Slot)
SAMPLES = MAX_LEVELS * POINTS


def check_geometry(D: int, NL: int, P: int) -> None:
    """Raise ValueError unless the kernels are built for this geometry."""
    if D != HEAD_DIM or P != POINTS or not 1 <= NL <= MAX_LEVELS:
        raise ValueError(f"the MSDA kernels are built for D = {HEAD_DIM}, P = {POINTS} and "
                         f"1..{MAX_LEVELS} levels; got D = {D}, P = {P}, {NL} levels")


def _tile(B: int, Q: int, H: int, min_ctas: int, min_tile: int) -> int:
    """The largest tile of TILES that gives at least min_ctas CTAs (B*H of
    them a tile of queries), else the smallest of at least min_tile."""
    fits = [t for t in TILES if t >= min_tile]
    for t in fits:
        if B * H * -(-Q // t) >= min_ctas:
            return t
    return fits[-1]


def msda_fwd_tile(B: int, Q: int, H: int) -> int:
    """K1's queries a CTA: two for each warp at least."""
    return _tile(B, Q, H, FWD_MIN_CTAS, 2 * FWD_WARPS)


class BwdPlan(NamedTuple):
    tile_q: int                       # queries a CTA
    smem_row: Tuple[int, ...]         # first accumulator row of each level, -1: global
    smem_rows: int
    smem_bytes: int                   # dynamic shared memory of a CTA


def bwd_smem_bytes(smem_rows: int) -> int:
    """K3's dynamic shared memory (csrc/msda_bwd.cu msda_bwd_smem_bytes):
    the warps' sample slots, smem_rows rows of HEAD_DIM f32, a flag a row."""
    return BWD_WARPS * SAMPLES * SLOT_BYTES + smem_rows * HEAD_DIM * 4 + -(-smem_rows // 16) * 16


def smem_levels(spatial_shapes: Shapes, tile: int, smem_bytes,
                budget: int = BWD_SMEM_BUDGET) -> Tuple[Tuple[int, ...], int]:
    """The levels that accumulate their grad_value in shared memory at
    `tile` queries a CTA: those a tile scatters at least as many corner rows
    into as they have rows (tile * P * 4 >= h * w: zeroing and flushing them
    costs no more than the scatter would) and that fit with smem_bytes(rows)
    within `budget`, taken from the smallest up.  Returns (the first
    accumulator row of each level in level order, -1 for a level scattered
    to global memory; the rows in all)."""
    rows = [h * w for h, w in spatial_shapes]
    smem_row = [-1] * len(rows)
    used = 0
    for lvl in sorted(range(len(rows)), key=lambda i: rows[i]):
        if tile * POINTS * 4 >= rows[lvl] and smem_bytes(used + rows[lvl]) <= budget:
            smem_row[lvl] = -2                # placed below, in level order
            used += rows[lvl]
    used = 0
    for lvl, r in enumerate(rows):
        if smem_row[lvl] == -2:
            smem_row[lvl], used = used, used + r
    return tuple(smem_row), used


def msda_bwd_plan(spatial_shapes: Shapes, B: int, Q: int, H: int,
                  budget: int = BWD_SMEM_BUDGET) -> BwdPlan:
    """K3's launch plan: the tile (the fewest CTAs BWD_MIN_CTAS) and its
    shared-memory levels within `budget` (`smem_levels`; the bf16 entry's
    is BWD_SMEM_BUDGET_BF16); the other levels scatter straight to global
    memory.  The shared memory does not depend on the value's type: the
    slots and the accumulator rows are f32 either way."""
    tile = _tile(B, Q, H, BWD_MIN_CTAS, BWD_WARPS)
    smem_row, used = smem_levels(spatial_shapes, tile, bwd_smem_bytes, budget)
    return BwdPlan(tile, smem_row, used, bwd_smem_bytes(used))


_FWD_CTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
    + [ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.c_int, ctypes.c_void_p]
)
_BWD_CTYPES = (
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
    + [ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    + [ctypes.c_int] * 2 + [ctypes.c_void_p]
)
_BWD_BF16_CTYPES = [ctypes.c_void_p] + _BWD_CTYPES    # and the f32 scratch after grad_attn


def _check_operands(value, spatial_shapes, level_start, locs, attn, what: str):
    """Raise unless the operands are what the kernels take; returns
    (B, L, H, D, Q, NL, P)."""
    if value.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {value.device}")
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
    if locs.dtype != torch.float32 or attn.dtype != torch.float32:
        raise TypeError("locs and attn must be float32")
    for name, t in (("value", value), ("locs", locs), ("attn", attn)):
        if t.device != value.device:
            raise ValueError(f"{name} is on {t.device}, value on {value.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if value.data_ptr() % 16:
        raise ValueError("value must be 16-byte aligned (the kernels read rows as float4)")
    check_geometry(D, NL, P)
    return B, L, H, D, Q, NL, P


def _level_arrays(spatial_shapes, level_start):
    NL = len(spatial_shapes)
    hw = (ctypes.c_int * (2 * NL))(*[int(v) for hw_ in spatial_shapes for v in hw_])
    starts = (ctypes.c_int * NL)(*[int(s) for s in level_start])
    return hw, starts


def _msda_fwd_cuda(value, spatial_shapes, level_start, locs, attn):
    B, L, H, D, Q, NL, P = _check_operands(value, spatial_shapes, level_start, locs, attn,
                                           "ms_deform_attn")
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"value must be float32 or bfloat16, got {value.dtype}")
    out = torch.empty(B, Q, H * D, dtype=value.dtype, device=value.device)
    lib = build.load("msda_fwd")
    fn = lib.msda_fwd_f32 if value.dtype == torch.float32 else lib.msda_fwd_bf16
    fn.argtypes = _FWD_CTYPES
    fn.restype = ctypes.c_int
    err = fn(
        value.data_ptr(), locs.data_ptr(), attn.data_ptr(), out.data_ptr(),
        B, L, H, D, Q, NL, P, *_level_arrays(spatial_shapes, level_start),
        msda_fwd_tile(B, Q, H), torch.cuda.current_stream(value.device).cuda_stream,
    )
    build.check(err, "msda_fwd")
    if value.dtype == torch.bfloat16:
        ms_deform_attn.launches_bf16 += 1
    else:
        ms_deform_attn.launches += 1
    return out


def ms_deform_attn_bwd(value, spatial_shapes, level_start, locs, attn, grad_out):
    """K3 on CUDA tensors (value and grad_out both f32 or both bf16, locs and
    attn f32, all contiguous); raises for any other.  grad_out: (B, Q, H*D).
    Returns (grad_value (B, L, H, D) in value's dtype, grad_locs
    (B, Q, H, NL, P, 2), grad_attn (B, Q, H, NL, P) in f32)."""
    B, L, H, D, Q, NL, P = _check_operands(value, spatial_shapes, level_start, locs, attn,
                                           "ms_deform_attn_bwd")
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"value must be float32 or bfloat16, got {value.dtype}")
    if (tuple(grad_out.shape) != (B, Q, H * D) or grad_out.dtype != value.dtype
            or grad_out.device != value.device or not grad_out.is_contiguous()
            or grad_out.data_ptr() % 16):
        raise ValueError(f"grad_out must be contiguous, 16-byte aligned {value.dtype} "
                         f"{(B, Q, H * D)} on {value.device}")
    grad_value = torch.zeros_like(value)
    grad_locs = torch.empty_like(locs)
    grad_attn = torch.empty_like(attn)
    bf16 = value.dtype == torch.bfloat16
    plan = msda_bwd_plan(spatial_shapes, B, Q, H, BWD_SMEM_BUDGET_BF16 if bf16 else BWD_SMEM_BUDGET)
    lib = build.load("msda_bwd")
    pointers = [value.data_ptr(), locs.data_ptr(), attn.data_ptr(), grad_out.data_ptr(),
                grad_value.data_ptr(), grad_locs.data_ptr(), grad_attn.data_ptr()]
    if bf16:
        # the shared-memory levels' f32 sums, rounded into grad_value once
        scratch = torch.zeros(B * H * plan.smem_rows * D, dtype=torch.float32, device=value.device)
        fn, pointers = lib.msda_bwd_bf16, pointers + [scratch.data_ptr()]
        fn.argtypes = _BWD_BF16_CTYPES
    else:
        fn = lib.msda_bwd_f32
        fn.argtypes = _BWD_CTYPES
    fn.restype = ctypes.c_int
    err = fn(
        *pointers, B, L, H, D, Q, NL, P, *_level_arrays(spatial_shapes, level_start),
        plan.tile_q, (ctypes.c_int * NL)(*plan.smem_row), plan.smem_rows, plan.smem_bytes,
        torch.cuda.current_stream(value.device).cuda_stream,
    )
    build.check(err, "msda_bwd")
    if bf16:
        ms_deform_attn_bwd.launches_bf16 += 1
    else:
        ms_deform_attn_bwd.launches += 1
    return grad_value, grad_locs, grad_attn


@torch.library.custom_op("ogd_torch::msda_fwd", mutates_args=(), device_types="cuda")
def msda_fwd(value: torch.Tensor, spatial_shapes: List[int], level_start: List[int],
             locs: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """K1 as an op (`spatial_shapes` flat, library.flat_shapes): on CUDA
    tensors the kernel, counted on ms_deform_attn.launches(_bf16).  Its
    gradient is K3's op (`msda_bwd`)."""
    return library.kernel_output("msda_fwd", _msda_fwd_cuda, value, shape_pairs(spatial_shapes),
                                 level_start, locs, attn)


@msda_fwd.register_kernel("cpu")
def _msda_fwd_cpu(value, spatial_shapes, level_start, locs, attn):
    return library.kernel_output("msda_fwd", ms_deform_attn_plain, value,
                                 shape_pairs(spatial_shapes), level_start, locs, attn)


@msda_fwd.register_fake
def _msda_fwd_fake(value, spatial_shapes, level_start, locs, attn):
    B, _, H, D = value.shape
    return value.new_empty(B, locs.shape[1], H * D)


@torch.library.custom_op("ogd_torch::msda_bwd", mutates_args=(), device_types="cuda")
def msda_bwd(value: torch.Tensor, spatial_shapes: List[int], level_start: List[int],
             locs: torch.Tensor, attn: torch.Tensor, grad_out: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 as an op: (grad_value, grad_locs, grad_attn); on CUDA tensors the
    kernel (`ms_deform_attn_bwd`), counted on ms_deform_attn_bwd.launches(_bf16)."""
    return ms_deform_attn_bwd(value, shape_pairs(spatial_shapes), level_start, locs, attn,
                              grad_out)


@msda_bwd.register_kernel("cpu")
def _msda_bwd_cpu(value, spatial_shapes, level_start, locs, attn, grad_out):
    grads = vjp_on_fresh_thread(ms_deform_attn_bwd_plain, value, shape_pairs(spatial_shapes),
                                level_start, locs, attn, grad_out)
    return tuple(t.contiguous() for t in grads)


@msda_bwd.register_fake
def _msda_bwd_fake(value, spatial_shapes, level_start, locs, attn, grad_out):
    return torch.empty_like(value), torch.empty_like(locs), torch.empty_like(attn)


def _msda_fwd_setup(ctx, inputs, output):
    value, spatial_shapes, level_start, locs, attn = inputs
    ctx.spatial_shapes, ctx.level_start = spatial_shapes, level_start
    ctx.save_for_backward(value, locs, attn)


def _msda_fwd_backward(ctx, grad_out):
    """K3 (the JAX package's custom_vjp around the banded kernels,
    ops/msda_banded.py) on the upstream gradient in value's dtype."""
    value, locs, attn = ctx.saved_tensors
    grad_value, grad_locs, grad_attn = msda_bwd(value, ctx.spatial_shapes, ctx.level_start, locs,
                                                attn, kernel_rows(grad_out, value.dtype))
    return grad_value, None, None, grad_locs, grad_attn


msda_fwd.register_autograd(_msda_fwd_backward, setup_context=_msda_fwd_setup)


@register_flop_formula(torch.ops.ogd_torch.msda_fwd, get_raw=True)
def _msda_fwd_flops(value, spatial_shapes, level_start, locs, attn, out_val=None):
    return _msda_flops(value, spatial_shapes, locs, per_corner=2)


@register_flop_formula(torch.ops.ogd_torch.msda_bwd, get_raw=True)
def _msda_bwd_flops(value, spatial_shapes, level_start, locs, attn, grad_out, out_val=None):
    return _msda_flops(value, spatial_shapes, locs, per_corner=8)


def _msda_flops(value, spatial_shapes, locs, per_corner: int) -> int:
    """K1's (K3's) operations on these locations: every in-map corner of
    real locations, four a sample of fake ones."""
    B, Q, H, NL, P, _ = locs.shape
    samples = B * Q * H * NL * P
    corners = (in_map_corners(locs, shape_pairs(spatial_shapes)) if is_real(locs)
               else 4 * samples)
    return msda_flops(samples, corners, value.shape[-1], per_corner)


def ms_deform_attn(
    value: torch.Tensor,
    spatial_shapes: Shapes,
    level_start: Sequence[int],
    locs: torch.Tensor,
    attn: torch.Tensor,
) -> torch.Tensor:
    """K1 (K3 for its gradient) for CUDA tensors (f32 or bf16 value, f32
    locs/attn, all contiguous), the plain versions for CPU tensors; through
    the ops either way.  Returns (B, Q, H*D) in value's dtype."""
    if value.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ms_deform_attn: unsupported device {value.device}")
    return msda_fwd(value, flat_shapes(spatial_shapes), list(level_start), locs, attn)


ms_deform_attn.launches = ms_deform_attn.launches_bf16 = 0
ms_deform_attn_bwd.launches = ms_deform_attn_bwd.launches_bf16 = 0
