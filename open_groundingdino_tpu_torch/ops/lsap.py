"""The linear sum assignment problem (LSAP) on the device: the Hungarian
matcher's solver, csrc/lsap.cu, and its plain PyTorch version.

The counterpart of the JAX package's ops/hungarian.py::hungarian_device with
the defaults it runs (HUNGARIAN_RR=1: the Jonker-Volgenant row-reduction
pre-pass; HUNGARIAN_MASKED=1: the row mask in place of the u scatter): for
each of N problems, costs (Q, G) between queries and GT boxes, pick one query
for each valid GT so that the total cost is least.  Solved on the transposed
problem (rows = GT, n = G; columns = queries, m = Q), the valid rows
sorted first, with 1-indexed potentials u (n + 1), v (m + 1) and the column
assignment p (m + 1), column 0 virtual:

  1. row reduction: u[i] = the least cost of row i (0 where that is not
     finite), and each valid row claims its argmin column; where rows
     collide the lowest row wins;
  2. each unclaimed valid row, in ascending order, runs one Dijkstra of the
     shortest augmenting path (the e-maxx formulation: minv, used, way, the
     row mask of the alternating tree) and augments along it;
  3. p is inverted to a query per row and scattered back to the GT order.

Arithmetic is the JAX package's, in f32 and in its order (`cur = (c - u[i0])
- v`, the adds and subtracts of delta), and argmin takes the first minimum as
jnp.argmin does, a NaN counting as the least value (the first NaN wins), so
the kernel, the plain version and the JAX solver give the same indices on a
matrix without ties.  A Dijkstra marks one new column used an iteration
while a row can still be augmented, so m + 1 iterations bound it; a row
that reaches the bound (only a matrix with entries of 1e18 and beyond or
+/-inf, or more valid rows than columns, can) is left unassigned and its
problem's `overflow` flag is set: nothing spins.  Costs built by
models/matcher.compute_cost_matrix are finite and below 1e6, and never
reach it while an image has no more valid GT than queries.

`lsap(cost, gt_valid)` is the op `ogd_torch::lsap` (no gradient: the JAX
package stops it, models/matcher.py:113): on CUDA tensors the kernel,
counted on `lsap.launches`; on CPU tensors the plain version `lsap_plain`,
which runs the N problems in lockstep with a `done` mask as the JAX vmap of
its while loops does.  Returns (assigned (N, G) int64 query indices, the
sentinel Q on invalid slots; overflow (N,) bool).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

INF = 1e18   # the JAX solver's jnp.float32(1e18): unreached columns' minv


def first_argmin(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The index of the first minimum along `dim`, a NaN counting as less
    than any number (the first NaN wins): jnp.argmin's choice on numbers,
    made total for NaN as the kernel's reduction is."""
    nan = torch.isnan(x)
    amin = torch.argmin(torch.where(nan, torch.full_like(x, float("inf")), x), dim=dim)
    return torch.where(nan.any(dim), nan.to(torch.uint8).argmax(dim), amin)


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[b, idx[b]] for every problem b: (N, K, ...) and (N,) -> (N, ...)."""
    return t[torch.arange(t.shape[0], device=t.device), idx]


@torch.no_grad()
def lsap_plain(cost: torch.Tensor, gt_valid: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The solver above on tensors, on any device: (N, Q, G) costs, (N, G)
    bool -> (assigned (N, G) int64, overflow (N,) bool).  The problems run in
    lockstep; a finished or inactive problem's state is kept by masks."""
    N, Q, G = cost.shape
    dev = cost.device
    gt_valid = gt_valid.bool()
    n_rows = gt_valid.sum(1)
    # the rows past the most valid ones are never touched: n is that count
    n, m = (int(n_rows.max()) if N else 0), Q
    order = torch.argsort((~gt_valid).to(torch.uint8), dim=1, stable=True)   # valid first
    cost_gq = cost.float().transpose(1, 2)
    cost_sorted = torch.gather(cost_gq, 1, order[:, :n, None].expand(N, n, Q))
    cost1 = torch.nn.functional.pad(cost_sorted, (1, 0, 1, 0))            # (N, n + 1, m + 1)
    row_ids = torch.arange(n + 1, device=dev)
    col_ids = torch.arange(m + 1, device=dev)
    batch = torch.arange(N, device=dev)
    inf = torch.tensor(INF, dtype=torch.float32, device=dev)

    # 1. row reduction: u = each row's least cost (over the real columns and
    # the virtual column's INF), claims by the lowest row
    valid_row = (row_ids >= 1) & (row_ids <= n_rows[:, None])             # (N, n + 1)
    costu = torch.where(col_ids >= 1, cost1, inf)
    amin_col = first_argmin(costu, dim=2)                                  # (N, n + 1)
    u_rr = torch.gather(costu, 2, amin_col[..., None])[..., 0]
    u = torch.where(valid_row & torch.isfinite(u_rr), u_rr, torch.zeros_like(u_rr))
    v = torch.zeros(N, m + 1, dtype=torch.float32, device=dev)
    winner = torch.full((N, m + 2), n + 1, dtype=torch.long, device=dev)
    winner.scatter_reduce_(1, torch.where(valid_row, amin_col, m + 1),
                           torch.where(valid_row, row_ids, n + 1).expand(N, -1), "amin")
    claim = valid_row & (torch.gather(winner, 1, amin_col) == row_ids)
    p = torch.zeros(N, m + 2, dtype=torch.long, device=dev)
    p.scatter_(1, torch.where(claim, amin_col, m + 1),
               torch.where(claim, row_ids, 0).expand(N, -1))
    p = p[:, :m + 1].contiguous()
    free_mask = valid_row & ~claim
    free_rows = torch.sort(torch.where(free_mask, row_ids, n + 1), dim=1).values
    n_free = free_mask.sum(1)
    overflow = torch.zeros(N, dtype=torch.bool, device=dev)

    # 2. one Dijkstra and augmentation for each free row, in lockstep
    for k in range(int(n_free.max()) if N else 0):
        active = k < n_free
        i = free_rows[:, k].clamp(max=n)
        p[:, 0] = torch.where(active, i, p[:, 0])
        minv = torch.full((N, m + 1), INF, dtype=torch.float32, device=dev)
        used = torch.zeros(N, m + 1, dtype=torch.bool, device=dev)
        way = torch.zeros(N, m + 1, dtype=torch.long, device=dev)
        rowmask = torch.zeros(N, n + 1, dtype=torch.bool, device=dev)
        j0 = torch.zeros(N, dtype=torch.long, device=dev)
        done = ~active
        for _ in range(m + 1):
            if bool(done.all()):
                break
            go = ~done
            used_n = used.clone()
            used_n[batch, j0] = True
            i0 = _rows(p, j0)
            cur = (_rows(cost1, i0) - _rows(u, i0)[:, None]) - v
            better = (cur < minv) & ~used_n & (col_ids > 0)
            minv_n = torch.where(better, cur, minv)
            way_n = torch.where(better, j0[:, None], way)
            cand = torch.where(used_n | (col_ids == 0), inf, minv_n)
            j1 = first_argmin(cand, dim=1)
            delta = _rows(cand, j1)[:, None]
            rowmask_n = rowmask.clone()
            rowmask_n[batch, i0] = True
            u_n = torch.where(rowmask_n, u + delta, u)
            v_n = torch.where(used_n, v - delta, v)
            minv_n = torch.where(used_n, minv_n, minv_n - delta)
            keep = go[:, None]
            used = torch.where(keep, used_n, used)
            minv = torch.where(keep, minv_n, minv)
            way = torch.where(keep, way_n, way)
            rowmask = torch.where(keep, rowmask_n, rowmask)
            u = torch.where(keep, u_n, u)
            v = torch.where(keep, v_n, v)
            j0 = torch.where(go, j1, j0)
            done = done | (go & (_rows(p, j0) == 0))
        # a row that reached the bound is left unassigned
        overflow |= ~done
        j0 = torch.where(done, j0, torch.zeros_like(j0))
        for _ in range(m + 1):
            go = j0 != 0
            if not bool(go.any()):
                break
            j1 = _rows(way, j0)
            p[batch, j0] = torch.where(go, _rows(p, j1), _rows(p, j0))
            j0 = torch.where(go, j1, j0)

    # 3. p inverted (rows 1..n; a free column writes row 0, dropped), then
    # scattered back to the GT order
    row_to_col = torch.full((N, G + 1), m, dtype=torch.long, device=dev)
    row_to_col.scatter_(1, p[:, 1:], torch.arange(m, device=dev).expand(N, -1))
    assigned = torch.empty(N, G, dtype=torch.long, device=dev)
    assigned.scatter_(1, order, row_to_col[:, 1:])
    sentinel = torch.full_like(assigned, Q)
    return torch.where(gt_valid, assigned.clamp(max=Q), sentinel), overflow


_CTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _lsap_cuda(cost: torch.Tensor, gt_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors: one CTA a problem on the costs transposed
    to (N, G, Q) rows, so that each Dijkstra iteration reads one cost row
    coalesced."""
    if cost.dim() != 3 or tuple(gt_valid.shape) != (cost.shape[0], cost.shape[2]):
        raise ValueError(f"lsap takes (N, Q, G) costs and (N, G) gt_valid, got "
                         f"{tuple(cost.shape)} and {tuple(gt_valid.shape)}")
    if cost.device.type != "cuda" or gt_valid.device != cost.device:
        raise ValueError(f"lsap: cost on {cost.device}, gt_valid on {gt_valid.device}")
    N, Q, G = cost.shape
    cost_gq = cost.float().transpose(1, 2).contiguous()
    valid = gt_valid.to(torch.uint8).contiguous()
    assigned = torch.empty(N, G, dtype=torch.long, device=cost.device)
    overflow = torch.empty(N, dtype=torch.bool, device=cost.device)
    if N == 0:
        return assigned, overflow
    fn = build.load("lsap").lsap_f32
    fn.argtypes = _CTYPES
    fn.restype = ctypes.c_int
    err = fn(cost_gq.data_ptr(), valid.data_ptr(), assigned.data_ptr(), overflow.data_ptr(),
             N, G, Q, torch.cuda.current_stream(cost.device).cuda_stream)
    build.check(err, "lsap")
    lsap.launches += 1
    return assigned, overflow


@torch.library.custom_op("ogd_torch::lsap", mutates_args=(), device_types="cuda")
def lsap_op(cost: torch.Tensor, gt_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LSAP kernel as an op: (assigned (N, G) int64, overflow (N,)
    bool); on CUDA tensors the kernel, counted on lsap.launches."""
    return _lsap_cuda(cost, gt_valid)


@lsap_op.register_kernel("cpu")
def _lsap_cpu(cost, gt_valid):
    return lsap_plain(cost, gt_valid)


@lsap_op.register_fake
def _lsap_fake(cost, gt_valid):
    N, _, G = cost.shape
    return (cost.new_empty(N, G, dtype=torch.long),
            cost.new_empty(N, dtype=torch.bool))


def lsap(cost: torch.Tensor, gt_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel for CUDA tensors, the plain version for CPU tensors,
    through the op either way: (N, Q, G) costs (detached: no gradient) and
    (N, G) validity -> (assigned (N, G) int64, overflow (N,) bool)."""
    if cost.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lsap: unsupported device {cost.device}")
    return lsap_op(cost.detach(), gt_valid.bool())


lsap.launches = 0
