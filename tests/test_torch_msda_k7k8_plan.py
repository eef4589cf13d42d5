"""K7's and K8's loops (csrc/msda_rowtap_fwd.cu allq_fwd_kernel,
csrc/msda_corner_fwd.cu corner_fwd_kernel) mirrored on the CPU, their
launch plans, and their arithmetic emulated in f32 against the plain
versions.

The kernels run only on the card (chip_smoke.py holds them to their plain
versions there); what decides their work is reachable here:
  - the loops: each CTA takes a tile of consecutive queries of one b*h
    (K1's tile rule); its threads stage every (point, query) pair of the
    tile once (K7 reading the point's two row taps, K8 its four corner taps)
    and its warps take the queries two at a time.  Every tap is staged once
    and every query read and written once, across tiles;
  - the plans fit Hopper's shared memory at 5 CTAs an SM;
  - K8's staging reads each corner tap directly and drops a tap of zero
    weight before its row is read: emulated in f32 with the shared gather
    (lane group g on point g of each level, the groups' sums meeting in
    shuffles), it equals `sweep_fwd_corner_plain` to 1e-6 with dead taps,
    padded queries and dead taps' idx clamped into their level;
  - K7's staging is K6's on the decoder's sorted query set: emulated the
    same way, it equals `sweep_fwd_plain` to 1e-6 on rows y0 = -1 and
    y0 + 1 = H_l and integer px on the first and last columns.
"""
import numpy as np
import pytest
import torch

from open_groundingdino_tpu_torch.ops import msda
from open_groundingdino_tpu_torch.ops import msda_sweep as sw

FLAGSHIP = ((100, 152), (50, 76), (25, 38), (13, 19))   # the 800x1216 bucket
NANO = ((8, 12), (4, 6), (2, 3), (1, 2))
MIXED = ((40, 60), (20, 30), (10, 15), (5, 8))
SMEM_SM = 233_472               # Hopper's shared memory an SM, 1 KB of it reserved a CTA
WARPS = 8                       # csrc/msda_rowtap_fwd.cu, msda_corner_fwd.cu
P = msda.POINTS


def _L(shapes):
    return sum(h * w for h, w in shapes)


def _pad(Q):
    return -(-Q // sw.QBLOCK) * sw.QBLOCK


# ---------------------------------------------------------------- loops and plans
def _tile_visits(q0, nq, tile, NL, per_point):
    """One tile's loops: the (tap, query) pairs the staging reads (thread i
    of the tile's (point, query) pairs: point i // tile, its per_point
    taps) and the (point, query) pairs the warps read (warp w: queries q and
    q + 8 for q in w, w + 16, ...; lane group g of level i: point i * P + g)."""
    t, qq = np.divmod(np.arange(NL * P * tile), tile)
    keep = qq < nq
    if per_point == 2:      # row taps: the point's y0 row, then its y0 + 1 row
        taps = [(t // P) * 2 * P + k * P + t % P for k in range(2)]
    else:                   # corner taps: 4t .. 4t + 3
        taps = [4 * t + c for c in range(4)]
    staged = np.concatenate([np.stack([tap[keep], q0 + qq[keep]], 1) for tap in taps])
    read = [(lvl * P + g, q0 + qj) for w in range(WARPS) for qq0 in range(w, nq, 2 * WARPS)
            for qj in (qq0, qq0 + WARPS) if qj < nq for lvl in range(NL) for g in range(P)]
    return staged, read


def _visits(BH, Qp, tile, NL, per_point):
    """One CTA a (b*h, tile): every CTA's staged (bh, tap, query) triples and
    read (bh, point, query) ones."""
    staged, read = [], []
    n_tiles = -(-Qp // tile)
    for cta in range(BH * n_tiles):
        bh, q0 = cta // n_tiles, (cta % n_tiles) * tile
        s, r = _tile_visits(q0, min(tile, Qp - q0), tile, NL, per_point)
        staged.append(np.concatenate([np.full((len(s), 1), bh), s], 1))
        read += [(bh, *x) for x in r]
    return np.concatenate(staged), read


def _every(BH, n, Qp):
    return sorted((bh, t, q) for bh in range(BH) for t in range(n) for q in range(Qp))


@pytest.mark.parametrize("kernel,shapes,B,Q", [
    ("K7", FLAGSHIP, 1, 900), ("K7", FLAGSHIP, 4, 900), ("K7", NANO, 2, 23),
    ("K7", MIXED, 3, 300),
    ("K8", FLAGSHIP, 1, _L(FLAGSHIP)), ("K8", FLAGSHIP, 4, _L(FLAGSHIP)),
    ("K8", FLAGSHIP, 1, 900), ("K8", FLAGSHIP, 4, 900), ("K8", NANO, 2, 23),
    ("K8", MIXED, 3, 300)],
    ids=["K7-B1-decoder", "K7-B4-decoder", "K7-nano-23", "K7-mixed-300", "K8-B1-encoder",
         "K8-B4-encoder", "K8-B1-decoder", "K8-B4-decoder", "K8-nano-23", "K8-mixed-300"])
def test_plans_fit_and_loops_visit_once(kernel, shapes, B, Q):
    H, NL = 8, len(shapes)
    Qp = _pad(Q)
    tile = msda.msda_fwd_tile(B, Qp, H)
    smem = (sw.rowtap_fwd_smem_bytes if kernel == "K7" else sw.corner_fwd_smem_bytes)(NL, tile)
    assert 5 * (smem + 1024) <= SMEM_SM     # __launch_bounds__(256, 5): 5 CTAs an SM
    if shapes is FLAGSHIP:
        assert tile == (16 if Q == 900 else 64 if B == 4 else 16), tile
    if Qp > 2048:                           # the encoders: the plan alone
        return
    per_point = 2 if kernel == "K7" else 4
    BH = 2 if shapes is FLAGSHIP else B * H   # the loops repeat for every b*h
    staged, read = _visits(BH, Qp, tile, NL, per_point)
    assert sorted(map(tuple, staged.tolist())) == _every(BH, NL * per_point * P, Qp)
    assert sorted(read) == _every(BH, NL * P, Qp)


# ---------------------------------------------------------------- operands
def _case(shapes, Q, seed, B=2, H=2, D=32):
    """Sampling points with every edge case, in the model's layout: y0 = -1
    (the first row dead), y = H_l - 1 (y0 + 1 = H_l, the second row dead), y
    past H_l (both dead), y on the pixel lattice, x past the first and last
    pixel centres (an integer px at column 0 and W_l - 1) and dead points
    (attention weight 0); Q not a multiple of 128 pads queries."""
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
    value = torch.from_numpy(rng.randn(B, _L(shapes), H, D).astype(np.float32))
    return value, sw.kernel_layout(torch.from_numpy(locs), torch.from_numpy(attn))


def _gather_emulate(value, pos, wts):
    """msda_common.cuh gather_staged_corners in f32: pos / wts (BH, NL*P, 4,
    Qp) the staged corners (-1: no load); lane group g sums its points
    (level i, point g) and their corners in order, then the groups' sums
    meet as the shuffles add them."""
    v = value.permute(0, 2, 1, 3).reshape(-1, value.shape[1], value.shape[3])   # (BH, L, D)
    NL = pos.shape[1] // P
    groups = []
    for g in range(P):
        acc = torch.zeros(v.shape[0], pos.shape[-1], v.shape[-1])
        for lvl in range(NL):
            for c in range(4):
                p, k = pos[:, lvl * P + g, c], wts[:, lvl * P + g, c]
                live = p >= 0
                assert ((p < v.shape[1]) | ~live).all()
                rows = torch.gather(v, 1, torch.where(live, p, 0)[..., None]
                                    .expand(-1, -1, v.shape[-1]))
                acc = torch.where(live[..., None], acc + k[..., None] * rows, acc)
        groups.append(acc)
    return (groups[0] + groups[1]) + (groups[2] + groups[3])


# ---------------------------------------------------------------- K8
@pytest.mark.parametrize("shapes,Q", [(NANO, 37), (MIXED, 300), (MIXED, _L(MIXED))],
                         ids=["nano-37", "mixed-300", "mixed-encoder"])
def test_k8_direct_corners_match_plain(shapes, Q):
    value, (locs_t, attn_t) = _case(shapes, Q, seed=Q)
    L = value.shape[1]
    idx, w = sw.corner_indices_and_weights(locs_t, attn_t, shapes)
    order = sw.query_order(idx, None, L)
    assert (order is None) == (Q == L)
    idx, w = sw.sort_and_pad(idx, order), sw.sort_and_pad(w, order)
    # dead taps' idx lie in their level, padded queries' are 0 and dead
    starts = torch.tensor(msda.level_starts(shapes) + (L,))
    lvl = torch.arange(idx.shape[1]) // (4 * P)
    assert ((idx >= starts[lvl][None, :, None]) & (idx < starts[lvl + 1][None, :, None]))[
        ..., :Q].all()
    dead = w == 0
    assert dead[..., :Q].any() and dead[..., Q:].all() and (idx[..., Q:] == 0).all()
    # the staging: a point's four corner taps, position -1 where w == 0
    BH, T, Qp = idx.shape
    pos = torch.where(dead, -1, idx.long()).view(BH, T // 4, 4, Qp)
    ref = sw.sweep_fwd_corner_plain(value, idx, w)
    err = float((_gather_emulate(value, pos, w.view(BH, T // 4, 4, Qp)) - ref).abs().max())
    assert err <= 1e-6, err


# ---------------------------------------------------------------- K7
@pytest.mark.parametrize("shapes,Q", [(NANO, 37), (MIXED, 300), (FLAGSHIP, 90)],
                         ids=["nano-37", "mixed-300", "flagship-90"])
def test_k7_direct_corners_match_plain(shapes, Q):
    value, (locs_t, attn_t) = _case(shapes, Q, seed=Q + 1)
    L = value.shape[1]
    row, px, w = sw.rowtap_positions_and_weights(locs_t, attn_t, shapes)
    order = sw.query_order(row, px, L)
    row, px, w = (sw.sort_and_pad(t, order) for t in (row, px, w))
    live = w != 0
    key = row[:, 0, :Q] + px[:, 0, :Q].long()                  # the decoder's sorted set
    assert (key[:, 1:] >= key[:, :-1]).all()
    ws = torch.tensor([wd for _, wd in shapes], dtype=torch.float32).repeat_interleave(2 * P)
    assert ((px == (ws - 1)[None, :, None]) & live).any()      # integer px, last column
    assert ((px == 0) & live).any()
    assert (~live[..., :Q]).any() and not live[..., Q:].any()
    # rows y0 = -1 and y0 + 1 = H_l: a point with one row of the pair dead
    y0_row, y1_row = live.view(w.shape[0], -1, 2, P, w.shape[-1]).unbind(2)
    assert (~y0_row & y1_row).any() and (y0_row & ~y1_row).any()
    # the staging: each live tap's i0 and i0 + 1, -1 where r * w == 0
    xf = torch.floor(px)
    i0 = row.long() + xf.long()
    w0, w1 = (1.0 - (px - xf)) * w, (1.0 - ((xf + 1.0) - px)) * w
    BH, R, Qp = row.shape
    pos, wts = [], []
    for k in range(2):                           # the point's y0 tap, then its y0 + 1 tap
        for wc, ic in ((w0, i0), (w1, i0 + 1)):
            sel = (torch.arange(R) // P) % 2 == k
            pos.append(torch.where(wc[:, sel] != 0, ic[:, sel], -1))
            wts.append(wc[:, sel])
    pos, wts = torch.stack(pos, 2), torch.stack(wts, 2)        # (BH, NL*P, 4, Qp)
    integer = (px == xf) & live                                 # i0 + 1 weighs 0: dropped
    assert integer.any() and (w1[integer] == 0).all()
    ref = sw.sweep_fwd_plain(value, row, px, w)
    err = float((_gather_emulate(value, pos, wts) - ref).abs().max())
    assert err <= 1e-6, err
