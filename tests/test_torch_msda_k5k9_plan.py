"""K5's and K9's loops (csrc/msda_banded_fwd.cu, csrc/msda_corner_bwd.cu)
mirrored on the CPU, their launch plans, and their arithmetic emulated in
f32 against the plain versions.

The kernels run only on the card (chip_smoke.py holds them to their plain
versions there); what decides their work is reachable here:
  - the loops: each CTA takes a tile of consecutive queries of one b*h; its
    threads stage every (tap, query) pair of the tile (K9: of each chunk of
    32 queries) once, and its warps take the queries in turns (K5 two at a
    time, q and q + 8); every query and every live tap is visited once;
  - K5 takes each live point's (at most) four corners directly, where the
    TPU kernel and `banded_fwd_plain` walk band windows: the two forms
    agree to 1e-6 for any band, on points below the first row, on the last
    row and column, dead points and padded queries;
  - K9 gathers and scatters its live taps' rows, grad_value accumulated in
    shared memory for the levels its plan admits and flushed once a tile:
    emulated in f32 with tiles that split the queries unevenly, it equals
    `sweep_bwd_corner_plain` to 1e-6 of the largest |grad_value|, and gw on
    live taps exactly (0 on dead ones);
  - the plans fit Hopper's shared memory.
"""
import numpy as np
import pytest
import torch

from open_groundingdino_tpu_torch.ops import msda
from open_groundingdino_tpu_torch.ops import msda_banded as mb
from open_groundingdino_tpu_torch.ops import msda_sweep as sw

FLAGSHIP = ((100, 152), (50, 76), (25, 38), (13, 19))   # the 800x1216 bucket
NANO = ((8, 12), (4, 6), (2, 3), (1, 2))
MIXED = ((40, 60), (20, 30), (10, 15), (5, 8))
SMEM_MAX = 232_448              # a CTA's most shared memory on Hopper
K5_WARPS, THREADS = 8, 256      # csrc/msda_banded_fwd.cu
K9_THREADS = 32 * sw.BWD_WARPS


def _L(shapes):
    return sum(h * w for h, w in shapes)


def _pad(Q):
    return -(-Q // sw.QBLOCK) * sw.QBLOCK


# ---------------------------------------------------------------- loops
def _k5_visits(Qp, tile, R):
    """K5's two loops for every tile: the staged (tap, query) pairs and the
    (query, tap) pairs the warps read (warp w: queries q and q + 8 for q in
    w, w + 16, ...; lane group g of level i: tap i * 4 + g)."""
    staged, read = [], []
    for q0 in range(0, Qp, tile):
        nq = min(tile, Qp - q0)
        for tid in range(THREADS):
            for i in range(tid, R * tile, THREADS):
                t, qq = divmod(i, tile)
                if qq < nq:
                    staged.append((t, q0 + qq))
        for w in range(K5_WARPS):
            for qq in range(w, nq, 2 * K5_WARPS):
                for qj in (qq, qq + K5_WARPS):
                    if qj < nq:
                        read += [(q0 + qj, lvl * 4 + g) for lvl in range(R // 4)
                                 for g in range(4)]
    return staged, read


def _k9_visits(Qp, tile, T):
    """K9's loops for every tile and chunk of 32 queries: staged (tap, query)
    pairs, the queries the warps take (warp w: w, w + 16) and the written gw
    pairs."""
    chunk = sw.BWD_CHUNK
    staged, taken, written = [], [], []
    for t0 in range(0, Qp, tile):
        q_end = min(Qp, t0 + tile)
        for c0 in range(t0, q_end, chunk):
            nq = min(chunk, q_end - c0)
            for tid in range(K9_THREADS):
                for i in range(tid, T * chunk, K9_THREADS):
                    t, qq = divmod(i, chunk)
                    if qq < nq:
                        staged.append((t, c0 + qq))
                        written.append((t, c0 + qq))
            for w in range(sw.BWD_WARPS):
                taken += [c0 + qq for qq in range(w, nq, sw.BWD_WARPS)]
    return staged, taken, written


@pytest.mark.parametrize("shapes,B,Q", [
    (FLAGSHIP, 1, _L(FLAGSHIP)), (FLAGSHIP, 4, _L(FLAGSHIP)), (FLAGSHIP, 1, 900),
    (FLAGSHIP, 4, 900), (NANO, 2, _L(NANO)), (NANO, 2, 23), (MIXED, 3, 300)],
    ids=["B1-encoder", "B4-encoder", "B1-decoder", "B4-decoder", "nano-encoder", "nano-23",
         "mixed-300"])
def test_loops_visit_once_and_plans_fit(shapes, B, Q):
    H, NL = 8, len(shapes)
    Qp = _pad(Q)
    R = NL * msda.POINTS
    tile = msda.msda_fwd_tile(B, Qp, H)
    assert mb.fwd_smem_bytes(NL, tile) <= SMEM_MAX
    staged, read = _k5_visits(Qp, tile, R)
    every = sorted((t, q) for t in range(R) for q in range(Qp))
    assert sorted(staged) == every
    assert sorted((t, q) for q, t in read) == every

    plan = sw.corner_bwd_plan(shapes, B, Qp, H)
    assert plan.tile_q in msda.TILES and plan.tile_q >= sw.BWD_CHUNK
    assert plan.smem_bytes == sw.corner_bwd_smem_bytes(plan.smem_rows)
    assert plan.smem_bytes <= msda.BWD_SMEM_BUDGET <= SMEM_MAX
    rows = [h * w for h, w in shapes]
    inside = [lvl for lvl, r0 in enumerate(plan.smem_row) if r0 >= 0]
    spans = sorted((plan.smem_row[lvl], plan.smem_row[lvl] + rows[lvl]) for lvl in inside)
    assert [a for a, _ in spans] == [0] + [b for _, b in spans[:-1]]
    assert plan.smem_rows == sum(rows[lvl] for lvl in inside)
    if shapes is FLAGSHIP and B == 4:   # training: level 3 (13x19) in shared memory
        assert plan.smem_row == (-1, -1, -1, 0), plan
    T = R * 4
    for t_split in {plan.tile_q, 80}:
        staged, taken, written = _k9_visits(Qp, t_split, T)
        every = sorted((t, q) for t in range(T) for q in range(Qp))
        assert sorted(staged) == every and sorted(written) == every
        assert sorted(taken) == list(range(Qp))


# ---------------------------------------------------------------- K5
def _k5_points(shapes, B, H, Q, seed):
    """Locations and weights whose K5 operands hold every edge case: y in
    [-1, 0), y = H_l - 1 exactly, y clipped to H_l, x on the last column,
    dead points (attention weight 0) and, with Q not a multiple of 128,
    padded queries.  Level sizes are powers of two where exactness matters."""
    NL, P = len(shapes), msda.POINTS
    rng = np.random.RandomState(seed)
    locs = rng.uniform(-0.15, 1.15, (B, Q, H, NL, P, 2)).astype(np.float32)
    attn = rng.uniform(0, 1, (B, Q, H, NL, P)).astype(np.float32)
    hs = np.asarray([h for h, _ in shapes], np.float32)
    ws = np.asarray([w for _, w in shapes], np.float32)
    locs[:, 0::5, :, :, 0, 1] = (0.25 / hs)[None, None, :]              # y = -0.25
    locs[:, 1::5, :, :, 1, 1] = ((hs - 0.5) / hs)[None, None, :]        # y = H_l - 1
    locs[:, 2::5, :, :, 2, 0] = ((ws - 0.5) / ws + 1e-3)[None, None, :]  # x past the last centre
    locs[:, 3::5, :, :, 3, 1] = ((hs + 0.75) / hs)[None, None, :]       # y clipped to H_l
    attn[:, 4::5, :, :, 1] = 0.0                                        # dead points
    attn /= attn.sum((3, 4), keepdims=True)   # the model's weights sum to 1 (a softmax)
    return torch.from_numpy(locs), torch.from_numpy(attn)


def _k5_emulate(value, shapes, px, py, wa):
    """K5's arithmetic: each point's corners as the staging computes them
    (-1 where the weight is zero or the corner is outside the map), weights
    folded, each lane group's sum over its points (level i, point g) and
    corners in order, then the groups' sums in the shuffles' order."""
    v = value.permute(0, 2, 1, 3).reshape(-1, value.shape[1], value.shape[3])   # (BH, L, D)
    BH, R, Qp = px.shape
    starts = msda.level_starts(shapes)
    pos, wts = [], []
    for t in range(R):
        lvl = t // msda.POINTS
        (Hl, Wl), start = shapes[lvl], starts[lvl]
        x, y, a = px[:, t], py[:, t], wa[:, t]
        xf, yf = torch.floor(x), torch.floor(y)
        x0, y0 = xf.long(), yf.long()
        r0, r1 = 1.0 - (x - xf), 1.0 - ((xf + 1.0) - x)
        wy0 = torch.clamp(1.0 - (y - yf).abs(), min=0.0) * a
        wy1 = torch.clamp(1.0 - (y - (yf + 1.0)).abs(), min=0.0) * a
        c0, c1 = r0 != 0, (x0 + 1 < Wl) & (r1 != 0)
        row0 = (y0 >= 0) & (y0 < Hl) & (wy0 != 0) & (a != 0)
        row1 = (y0 + 1 >= 0) & (y0 + 1 < Hl) & (wy1 != 0) & (a != 0)
        p00 = start + y0 * Wl + x0
        pc = [(row0 & c0, p00), (row0 & c1, p00 + 1), (row1 & c0, p00 + Wl),
              (row1 & c1, p00 + Wl + 1)]
        pos.append(torch.stack([torch.where(m, p, torch.full_like(p, -1)) for m, p in pc], -1))
        wts.append(torch.stack([wy0 * r0, wy0 * r1, wy1 * r0, wy1 * r1], -1))
    groups = []
    for g in range(4):
        acc = torch.zeros(BH, Qp, v.shape[-1])
        for lvl in range(len(shapes)):
            t = lvl * msda.POINTS + g
            for c in range(4):
                p = pos[t][..., c]
                rows = torch.gather(v, 1, p.clamp(min=0)[..., None].expand(-1, -1, v.shape[-1]))
                acc = torch.where((p >= 0)[..., None], acc + wts[t][..., c][..., None] * rows, acc)
        groups.append(acc)
    return (groups[0] + groups[1]) + (groups[2] + groups[3])


@pytest.mark.parametrize("shapes,Q", [(NANO, 37), (((8, 16), (4, 8), (2, 4), (1, 2)), 100),
                                      (MIXED, _L(MIXED))],
                         ids=["nano-37", "pow2-100", "mixed-encoder"])
@pytest.mark.parametrize("band", [1, 4, 8])
def test_k5_direct_corners_match_band_windows(shapes, Q, band):
    B, H, D = 2, 2, 32
    locs, attn = _k5_points(shapes, B, H, Q, seed=Q)
    L = _L(shapes)
    value = torch.from_numpy(np.random.RandomState(1).randn(B, L, H, D).astype(np.float32))
    _, locs_t, px, py, wa = mb.banded_operands(locs, attn, shapes, L)
    hs = torch.tensor([h for h, _ in shapes], dtype=torch.float32).repeat_interleave(4)
    ws = torch.tensor([w for _, w in shapes], dtype=torch.float32).repeat_interleave(4)
    live = wa != 0
    # the edge cases are there
    assert ((py < 0) & (py >= -1) & live).any()
    assert ((py == (hs - 1)[None, :, None]) & live).any()
    assert ((py == hs[None, :, None]) & live).any()
    assert ((px == (ws - 1)[None, :, None]) & live).any()
    assert (~live[..., :Q]).any()
    if Q % sw.QBLOCK:
        assert not live[..., Q:].any()
    ranges = mb.band_ranges(locs_t, shapes, px.shape[-1] // sw.QBLOCK,
                            mb.level_bands(shapes, band))
    ref = mb.banded_fwd_plain(value, shapes, px, py, wa, ranges, band)
    got = _k5_emulate(value, shapes, px, py, wa)
    err = float((got - ref).abs().max())
    assert err <= 1e-6, err


# ---------------------------------------------------------------- K9
def _k9_emulate(value, shapes, idx, w, g, tile, plan):
    """K9 on the CPU: for each b*h and tile, gw = V[idx] . g on live taps
    (0 on dead ones) and grad_value: the plan's shared-memory levels summed
    into a zeroed accumulator, flushed once a tile at the touched rows, the
    other levels added straight."""
    B, L, H, D = value.shape
    BH, T, Qp = idx.shape
    v = value.permute(0, 2, 1, 3).reshape(BH, L, D)
    starts = msda.level_starts(shapes)
    rows = [h * wd for h, wd in shapes]
    gv = torch.zeros(BH, L, D)
    gw = torch.full((BH, T, Qp), float("nan"))
    for bh in range(BH):
        for q0 in range(0, Qp, tile):
            q1 = min(Qp, q0 + tile)
            acc = torch.zeros(plan.smem_rows, D)
            touched = torch.zeros(plan.smem_rows, dtype=torch.bool)
            for t in range(T):
                lvl = t // (msda.POINTS * 4)
                p, k, gq = idx[bh, t, q0:q1].long(), w[bh, t, q0:q1], g[bh, q0:q1]
                live = k != 0
                dots = (v[bh, p] * gq).sum(-1)
                gw[bh, t, q0:q1] = torch.where(live, dots, torch.zeros_like(dots))
                p, add = p[live], k[live][:, None] * gq[live]
                r = p - starts[lvl]
                assert ((r >= 0) & (r < rows[lvl])).all()
                if plan.smem_row[lvl] >= 0:
                    acc.index_add_(0, plan.smem_row[lvl] + r, add)
                    touched[plan.smem_row[lvl] + r] = True
                else:
                    gv[bh].index_add_(0, p, add)
            for lvl in range(len(shapes)):
                r0 = plan.smem_row[lvl]
                if r0 >= 0:
                    r = torch.arange(r0, r0 + rows[lvl])
                    r = r[touched[r]]
                    gv[bh].index_add_(0, r - r0 + starts[lvl], acc[r])
    return gv.view(B, H, L, D).permute(0, 2, 1, 3), gw


@pytest.mark.parametrize("shapes,Q", [(NANO, 37), (NANO, 300), (MIXED, 53)],
                         ids=["nano-37", "nano-300", "mixed-levels-53"])
def test_k9_gather_scatter_matches_plain(shapes, Q):
    B, H, D = 2, 2, 32
    rng = np.random.RandomState(Q)
    L = _L(shapes)
    value = torch.from_numpy(rng.randn(B, L, H, D).astype(np.float32))
    locs = torch.from_numpy(rng.uniform(-0.1, 1.1, (B, Q, H, len(shapes), 4, 2))
                            .astype(np.float32))
    attn = torch.from_numpy(rng.uniform(0, 1, (B, Q, H, len(shapes), 4)).astype(np.float32))
    grad_out = torch.from_numpy(rng.randn(B, Q, H * D).astype(np.float32))
    locs_t, attn_t = sw.kernel_layout(locs, attn)
    idx, w = sw.corner_indices_and_weights(locs_t, attn_t, shapes)
    # a tap's flat position lies in its own level, dead taps too
    starts = torch.tensor(msda.level_starts(shapes))
    lvl_of_idx = torch.bucketize(idx.long(), starts, right=True) - 1
    assert (lvl_of_idx == (torch.arange(idx.shape[1]) // 16)[None, :, None]).all()
    order = sw.query_order(idx, None, L)
    g = grad_out.view(B, Q, H, D).permute(0, 2, 1, 3).reshape(B * H, Q, D)
    idx, w, g = sw.sort_and_pad(idx, order), sw.sort_and_pad(w, order), sw.sort_and_pad(g, order, 1)
    Qp = idx.shape[-1]
    plan = sw.corner_bwd_plan(shapes, B, Qp, H)
    inside = [r >= 0 for r in plan.smem_row]
    assert inside == ([False, False, True, True] if shapes is MIXED else [True] * 4), plan
    ref_gv, ref_gw = sw.sweep_bwd_corner_plain(value, idx, w, g)
    for tile in (plan.tile_q, 80):     # 80: tiles and chunks that split the queries unevenly
        gv, gw = _k9_emulate(value, shapes, idx, w, g, tile, plan)
        err = float((gv - ref_gv).abs().max()) / float(ref_gv.abs().max())
        assert err <= 1e-6, (tile, err)
        live = w != 0
        assert torch.equal(gw[live], ref_gw[live])
        assert (gw[~live] == 0).all()
