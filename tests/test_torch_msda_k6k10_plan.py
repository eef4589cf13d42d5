"""K6's and K10's loops (csrc/msda_rowtap_fwd.cu, csrc/msda_rowtap_bwd.cu)
mirrored on the CPU, their launch plans, and their arithmetic emulated in
f32 against the plain versions.

The kernels run only on the card (chip_smoke.py holds them to their plain
versions there); what decides their work is reachable here:
  - the loops: each CTA takes a tile of consecutive queries of one b*h; its
    threads stage every (point, query) pair of the tile once (K6, reading
    the point's two row taps) or every (tap, query) pair of each chunk of 32
    queries once (K10, whose gw and gpx go back the same way), and its
    warps take the queries in turns; every query and every tap is visited
    once;
  - K6 takes each live tap's (at most) two corners directly and drops a
    corner of zero weight before its row is read: emulated in f32, it
    equals `sweep_fwd_plain` to 1e-6 on rows y0 = -1 and y0 + 1 = H_l,
    integer px on the first and last columns, dead taps and padded queries,
    and every corner it reads lies in its tap's row;
  - K10 gathers its taps' corner rows and scatters the live ones, grad_value
    accumulated in shared memory for the levels its plan admits and flushed
    once a tile: emulated in f32 with tiles that split the queries unevenly,
    it equals `sweep_bwd_rowtap_plain` to 1e-6 of the largest |grad_value|,
    and gw and gpx on every tap, dead ones (a row weight zero on the pixel
    lattice) included, to 1e-6 of their largest |reference|;
  - the plans fit Hopper's shared memory, K10's at 2 CTAs an SM.
"""
import numpy as np
import pytest
import torch

from open_groundingdino_tpu_torch.ops import msda
from open_groundingdino_tpu_torch.ops import msda_sweep as sw

FLAGSHIP = ((100, 152), (50, 76), (25, 38), (13, 19))   # the 800x1216 bucket
NANO = ((8, 12), (4, 6), (2, 3), (1, 2))
MIXED = ((40, 60), (20, 30), (10, 15), (5, 8))
POW2 = ((8, 16), (4, 8), (2, 4), (1, 2))
SMEM_MAX = 232_448              # a CTA's most shared memory on Hopper
K6_WARPS, K6_THREADS = 8, 256   # csrc/msda_rowtap_fwd.cu
K10_THREADS = 32 * sw.BWD_WARPS
P = msda.POINTS


def _L(shapes):
    return sum(h * w for h, w in shapes)


def _pad(Q):
    return -(-Q // sw.QBLOCK) * sw.QBLOCK


def _taps(lvl, p):
    """Point p of level lvl's row taps: its y0 row, then its y0 + 1 row."""
    return (lvl * 2 * P + p, lvl * 2 * P + P + p)


# ---------------------------------------------------------------- loops and plans
def _k6_visits(Qp, tile, NL):
    """K6's two loops for every tile, vectorised: the (tap, query) pairs the
    staging reads (thread i of the tile's (point, query) pairs: point
    i // tile, both its taps) and the (query, tap) pairs the warps read
    (warp w: queries q and q + 8 for q in w, w + 16, ...; lane group g of
    level i: point i * P + g)."""
    staged, read = [], []
    for q0 in range(0, Qp, tile):
        nq = min(tile, Qp - q0)
        i = np.arange(NL * P * tile)
        t, qq = np.divmod(i, tile)
        keep = qq < nq
        for k in range(2):
            tap = (t // P) * 2 * P + k * P + t % P
            staged.append(np.stack([tap[keep], q0 + qq[keep]], 1))
        for w in range(K6_WARPS):
            for qq0 in range(w, nq, 2 * K6_WARPS):
                for qj in (qq0, qq0 + K6_WARPS):
                    if qj < nq:
                        read += [(tap, q0 + qj) for lvl in range(NL) for g in range(P)
                                 for tap in _taps(lvl, g)]
    return np.concatenate(staged), np.asarray(read)


def _k10_visits(Qp, tile, T):
    """K10's loops for every tile and chunk of 32 queries: the staged and
    written (tap, query) pairs and the queries the warps take (warp w: w,
    w + 16)."""
    chunk = sw.BWD_CHUNK
    pairs, taken = [], []
    for t0 in range(0, Qp, tile):
        q_end = min(Qp, t0 + tile)
        for c0 in range(t0, q_end, chunk):
            nq = min(chunk, q_end - c0)
            t, qq = np.divmod(np.arange(T * chunk), chunk)
            keep = qq < nq
            pairs.append(np.stack([t[keep], c0 + qq[keep]], 1))
            for w in range(sw.BWD_WARPS):
                taken += [c0 + qq for qq in range(w, nq, sw.BWD_WARPS)]
    return np.concatenate(pairs), sorted(taken)


def _every(R, Qp):
    return sorted((t, q) for t in range(R) for q in range(Qp))


@pytest.mark.parametrize("shapes,B,Q", [
    (FLAGSHIP, 1, _L(FLAGSHIP)), (FLAGSHIP, 4, _L(FLAGSHIP)), (FLAGSHIP, 1, 900),
    (FLAGSHIP, 4, 900), (NANO, 2, 23), (MIXED, 3, 300)],
    ids=["B1-encoder", "B4-encoder", "B1-decoder", "B4-decoder", "nano-23", "mixed-300"])
def test_plans_fit_and_loops_visit_once(shapes, B, Q):
    H, NL = 8, len(shapes)
    Qp = _pad(Q)
    R = NL * 2 * P
    tile = msda.msda_fwd_tile(B, Qp, H)
    assert sw.rowtap_fwd_smem_bytes(NL, tile) <= SMEM_MAX
    plan = sw.rowtap_bwd_plan(shapes, B, Qp, H)
    assert plan.tile_q in msda.TILES and plan.tile_q >= sw.BWD_CHUNK
    assert plan.smem_bytes == sw.rowtap_bwd_smem_bytes(plan.smem_rows)
    assert plan.smem_bytes <= msda.BWD_SMEM_BUDGET <= SMEM_MAX // 2
    rows = [h * w for h, w in shapes]
    inside = [lvl for lvl, r0 in enumerate(plan.smem_row) if r0 >= 0]
    spans = sorted((plan.smem_row[lvl], plan.smem_row[lvl] + rows[lvl]) for lvl in inside)
    assert [a for a, _ in spans] == [0] + [b for _, b in spans[:-1]]
    assert plan.smem_rows == sum(rows[lvl] for lvl in inside)
    if shapes is FLAGSHIP and B == 4:   # training: level 3 (13x19) in shared memory, as K9
        assert plan.smem_row == (-1, -1, -1, 0), plan
        assert plan == sw.corner_bwd_plan(shapes, B, Qp, H)._replace(
            smem_bytes=plan.smem_bytes)
    if Qp > 2048:                       # the encoders: the plans alone
        return
    staged, read = _k6_visits(Qp, tile, NL)
    every = _every(R, Qp)
    assert sorted(map(tuple, staged.tolist())) == every
    assert sorted(map(tuple, read.tolist())) == every
    for t_split in {plan.tile_q, 80}:
        pairs, taken = _k10_visits(Qp, t_split, R)
        assert sorted(map(tuple, pairs.tolist())) == every
        assert taken == list(range(Qp))


# ---------------------------------------------------------------- operands
def _rowtap_case(shapes, Q, seed, B=2, H=2, D=32):
    """Row taps in the kernels' order (sorted, padded) with every edge case:
    y0 = -1 (its first row dead), y0 + 1 = H_l (its second row dead), y
    past H_l (both dead), y on the pixel lattice (the second row's weight
    zero by value), x past the first and last pixel centres (an integer px
    at column 0 and W_l - 1), dead points (attention weight 0) and, with Q
    not a multiple of 128, padded queries.  Level sizes are powers of two
    where exactness matters."""
    NL = len(shapes)
    rng = np.random.RandomState(seed)
    locs = rng.uniform(-0.15, 1.15, (B, Q, H, NL, P, 2)).astype(np.float32)
    attn = rng.uniform(0, 1, (B, Q, H, NL, P)).astype(np.float32)
    hs = np.asarray([h for h, _ in shapes], np.float32)
    ws = np.asarray([w for _, w in shapes], np.float32)
    locs[:, 0::6, :, :, 0, 1] = (0.25 / hs)[None, None, :]                 # y0 = -1
    locs[:, 1::6, :, :, 1, 1] = ((hs - 0.5) / hs)[None, None, :]           # y = H_l - 1
    locs[:, 2::6, :, :, 2, 0] = ((ws - 0.5) / ws + 1e-3)[None, None, :]    # px = W_l - 1
    locs[:, 3::6, :, :, 3, 1] = ((hs + 0.75) / hs)[None, None, :]          # y past H_l
    locs[:, 4::6, :, :, 0, 1] = ((hs // 2 + 0.5) / hs)[None, None, :]      # y on the lattice
    locs[:, 5::6, :, :, 2, 0] = -0.2 / ws[None, None, :]                   # px = 0
    attn[:, 4::6, :, :, 1] = 0.0                                           # dead points
    attn /= attn.sum((3, 4), keepdims=True)
    L = _L(shapes)
    value = torch.from_numpy(rng.randn(B, L, H, D).astype(np.float32))
    grad_out = torch.from_numpy(rng.randn(B, Q, H * D).astype(np.float32))
    locs_t, attn_t = sw.kernel_layout(torch.from_numpy(locs), torch.from_numpy(attn))
    row, px, w = sw.rowtap_positions_and_weights(locs_t, attn_t, shapes)
    order = sw.query_order(row, px, L)
    g = grad_out.view(B, Q, H, D).permute(0, 2, 1, 3).reshape(B * H, Q, D)
    row, px, w = (sw.sort_and_pad(t, order) for t in (row, px, w))
    return value, row, px, w, sw.sort_and_pad(g, order, 1)


def _check_edge_cases(shapes, row, px, w, Q):
    ws = torch.tensor([wd for _, wd in shapes], dtype=torch.float32).repeat_interleave(2 * P)
    live = w != 0
    assert ((px == (ws - 1)[None, :, None]) & live).any()          # integer px, last column
    assert ((px == 0) & live).any()
    assert (~live[..., :Q]).any()                                   # dead taps
    if Q % sw.QBLOCK:
        assert not live[..., Q:].any()


def _corners(shapes, row, px, w, Q):
    """Each tap's two corners as the kernels compute them: (i0, i0 + 1,
    r0, r1, frac) with r0 = 1 - (px - floor(px)), r1 = 1 - ((floor(px) + 1)
    - px) and frac = px > floor(px); asserts that i0 lies in the tap's level
    (a padded query's taps, past Q, at position 0) and i0 + 1 in the same
    row wherever the kernels read it."""
    xf = torch.floor(px)
    i0 = row.long() + xf.long()
    starts = torch.tensor(msda.level_starts(shapes))
    ws = torch.tensor([wd for _, wd in shapes]).repeat_interleave(2 * P)[None, :, None]
    lvl = torch.arange(row.shape[1]) // (2 * P)
    col = i0 - starts[lvl][None, :, None]
    rows_of_level = torch.tensor([h * wd for h, wd in shapes])[lvl][None, :, None]
    assert ((col >= 0) & (col < rows_of_level))[..., :Q].all()      # every tap, dead ones too
    assert (i0[..., Q:] == 0).all()
    frac = px > xf
    assert (col % ws + 1 < ws)[frac].all()                          # i0 + 1 in the same row
    return i0, i0 + 1, 1.0 - (px - xf), 1.0 - ((xf + 1.0) - px), frac


# ---------------------------------------------------------------- K6
def _k6_emulate(value, shapes, row, px, w, Q):
    """K6's arithmetic: each point's four corners as the staging computes
    them (-1 where the weight r * w is zero), each lane group's sum over its
    points (level i, point g) and corners in order, then the groups' sums in
    the shuffles' order."""
    v = value.permute(0, 2, 1, 3).reshape(-1, value.shape[1], value.shape[3])   # (BH, L, D)
    i0, i1, r0, r1, _ = _corners(shapes, row, px, w, Q)
    wc = (r0 * w, r1 * w)
    groups = []
    for g in range(P):
        acc = torch.zeros(v.shape[0], px.shape[-1], v.shape[-1])
        for lvl in range(len(shapes)):
            for t in _taps(lvl, g):
                for pos, k in ((i0[:, t], wc[0][:, t]), (i1[:, t], wc[1][:, t])):
                    live = k != 0
                    assert ((pos < v.shape[1]) | ~live).all()
                    rows = torch.gather(v, 1, torch.where(live, pos, 0)[..., None]
                                        .expand(-1, -1, v.shape[-1]))
                    acc = torch.where(live[..., None], acc + k[..., None] * rows, acc)
        groups.append(acc)
    return (groups[0] + groups[1]) + (groups[2] + groups[3])


@pytest.mark.parametrize("shapes,Q", [(NANO, 37), (POW2, 100), (MIXED, _L(MIXED))],
                         ids=["nano-37", "pow2-100", "mixed-encoder"])
def test_k6_direct_corners_match_plain(shapes, Q):
    value, row, px, w, _ = _rowtap_case(shapes, Q, seed=Q)
    _check_edge_cases(shapes, row, px, w, Q)
    assert ((px == torch.floor(px)) & (w != 0)).any()               # r1 == 0 on live taps
    ref = sw.sweep_fwd_plain(value, row, px, w)
    err = float((_k6_emulate(value, shapes, row, px, w, Q) - ref).abs().max())
    assert err <= 1e-6, err


# ---------------------------------------------------------------- K10
def _k10_emulate(value, shapes, row, px, w, g, Q, tile, plan):
    """K10 on the CPU: for each b*h and tile, gw and gpx on every tap from
    the dot products of its corner rows (i0 + 1 read only where px has a
    fraction), and grad_value: (r * w) * g of each corner with a non-zero
    weight, the plan's shared-memory levels summed into a zeroed
    accumulator, flushed once a tile at the touched rows, the other levels
    added straight."""
    B, L, H, D = value.shape
    BH, T, Qp = row.shape
    v = value.permute(0, 2, 1, 3).reshape(BH, L, D)
    i0, i1, r0, r1, frac = _corners(shapes, row, px, w, Q)
    starts = msda.level_starts(shapes)
    rows = [h * wd for h, wd in shapes]
    gv = torch.zeros(BH, L, D)
    gw = torch.full((BH, T, Qp), float("nan"))
    gpx = torch.full((BH, T, Qp), float("nan"))
    for bh in range(BH):
        for q0 in range(0, Qp, tile):
            q = slice(q0, min(Qp, q0 + tile))
            gq = g[bh, q]
            acc = torch.zeros(plan.smem_rows, D)
            touched = torch.zeros(plan.smem_rows, dtype=torch.bool)
            for t in range(T):
                lvl = t // (2 * P)
                f = frac[bh, t, q]
                p0 = (v[bh, i0[bh, t, q]] * gq).sum(-1)
                p1 = torch.where(f, (v[bh, torch.where(f, i1[bh, t, q], 0)] * gq).sum(-1), 0.0)
                gw[bh, t, q] = r0[bh, t, q] * p0 + r1[bh, t, q] * p1
                gpx[bh, t, q] = torch.where(f, p1 - p0, 0.0)
                for pos, r in ((i0[bh, t, q], r0[bh, t, q]), (i1[bh, t, q], r1[bh, t, q])):
                    k = r * w[bh, t, q]
                    live = k != 0
                    pos, add = pos[live], k[live][:, None] * gq[live]
                    if plan.smem_row[lvl] >= 0:
                        r_s = plan.smem_row[lvl] + pos - starts[lvl]
                        acc.index_add_(0, r_s, add)
                        touched[r_s] = True
                    else:
                        gv[bh].index_add_(0, pos, add)
            for lvl in range(len(shapes)):
                s0 = plan.smem_row[lvl]
                if s0 >= 0:
                    r_s = torch.arange(s0, s0 + rows[lvl])
                    r_s = r_s[touched[r_s]]
                    gv[bh].index_add_(0, r_s - s0 + starts[lvl], acc[r_s])
    return gv.view(B, H, L, D).permute(0, 2, 1, 3), gpx, gw


@pytest.mark.parametrize("shapes,Q", [(NANO, 37), (POW2, 300), (MIXED, 53)],
                         ids=["nano-37", "pow2-300", "mixed-levels-53"])
def test_k10_gather_scatter_matches_plain(shapes, Q):
    value, row, px, w, g = _rowtap_case(shapes, Q, seed=Q + 1)
    _check_edge_cases(shapes, row, px, w, Q)
    B, _, H, _ = value.shape
    plan = sw.rowtap_bwd_plan(shapes, B, px.shape[-1], H)
    inside = [r >= 0 for r in plan.smem_row]
    assert inside == ([False, False, True, True] if shapes is MIXED else [True] * 4), plan
    ref = dict(zip(("gv", "gpx", "gw"), sw.sweep_bwd_rowtap_plain(value, row, px, w, g)))
    dead = w == 0
    assert (ref["gw"][dead] != 0).any() and (ref["gpx"][dead] != 0).any()   # they still count
    for tile in (plan.tile_q, 80):     # 80: tiles and chunks that split the queries unevenly
        got = dict(zip(("gv", "gpx", "gw"), _k10_emulate(value, shapes, row, px, w, g, Q,
                                                          tile, plan)))
        for key in ref:                # every tap, dead ones too
            err = float((got[key] - ref[key]).abs().max()) / float(ref[key].abs().max())
            assert err <= 1e-6, (tile, key, err)
