"""The launch plans of the MSDA kernels K1 and K3 (ops/msda.py), their
geometry check, and K3's two-stage grad_value emulated on the CPU.

The kernels run only on the card (chip_smoke.py holds them to their plain
versions there); what decides their work is Python the CPU reaches:
  - the query tiles: each CTA takes a tile of consecutive queries of one
    (b, h) and its warps take the tile's queries in turns (K1 two at a time,
    q and q + warps); the loops are mirrored here and must visit every query
    of [0, Q) exactly once;
  - K3's shared-memory levels: exactly the levels the plan's rule admits,
    within the shared memory a CTA can have;
  - K3's grad_value: per-tile partial sums for the shared-memory levels,
    flushed once a tile, and the direct scatter for the others.  Emulated in
    f32 with tiles that split Q unevenly, it must equal
    `ms_deform_attn_bwd_plain` (held to jax.grad of ms_deform_attn_xla by
    tests/test_torch_msda_grad.py) to 1e-6 of the largest |grad_value|: only
    the order of the f32 sums differs (a coarse row sums ~10^3 terms).
"""
import numpy as np
import pytest
import torch

from open_groundingdino_tpu_torch.ops import msda

FLAGSHIP = ((100, 152), (50, 76), (25, 38), (13, 19))   # the 800x1216 bucket
NANO = ((8, 12), (4, 6), (2, 3), (1, 2))
# levels 0 and 1 too large for a tile of 16 queries to be worth accumulating
MIXED = ((40, 60), (20, 30), (10, 15), (5, 8))
H = 8


def _L(shapes):
    return sum(h * w for h, w in shapes)


def _visits_fwd(Q, tile):
    """K1's loop (csrc/msda_fwd.cu): warp w of a tile starts at q0 + w and
    takes q and q + warps at a time."""
    W = msda.FWD_WARPS
    seen = []
    for t in range(-(-Q // tile)):
        q_end = min(Q, (t + 1) * tile)
        for w in range(W):
            for q in range(t * tile + w, q_end, 2 * W):
                seen.append(q)
                if q + W < q_end:
                    seen.append(q + W)
    return seen


def _visits_bwd(Q, tile):
    """K3's loop (csrc/msda_bwd.cu): warp w of a tile takes q0 + w + k * warps."""
    W = msda.BWD_WARPS
    return [q for t in range(-(-Q // tile))
            for w in range(W) for q in range(t * tile + w, min(Q, (t + 1) * tile), W)]


@pytest.mark.parametrize("shapes,B,Q", [
    (FLAGSHIP, 1, _L(FLAGSHIP)), (FLAGSHIP, 4, _L(FLAGSHIP)), (FLAGSHIP, 1, 900),
    (FLAGSHIP, 4, 900), (NANO, 2, _L(NANO)), (NANO, 2, 23)],
    ids=["B1-encoder", "B4-encoder", "B1-decoder", "B4-decoder", "nano-encoder", "nano-23"])
def test_plans_cover_queries_and_fit(shapes, B, Q):
    tile = msda.msda_fwd_tile(B, Q, H)
    assert tile in msda.TILES and tile >= 2 * msda.FWD_WARPS
    assert sorted(_visits_fwd(Q, tile)) == list(range(Q))

    plan = msda.msda_bwd_plan(shapes, B, Q, H)
    assert plan.tile_q in msda.TILES and plan.tile_q >= msda.BWD_WARPS
    assert sorted(_visits_bwd(Q, plan.tile_q)) == list(range(Q))

    rows = [h * w for h, w in shapes]
    inside = [lvl for lvl, r0 in enumerate(plan.smem_row) if r0 >= 0]
    # the accumulator rows of the shared-memory levels tile [0, smem_rows)
    spans = sorted((plan.smem_row[lvl], plan.smem_row[lvl] + rows[lvl]) for lvl in inside)
    assert [a for a, _ in spans] == [0] + [b for _, b in spans[:-1]]
    assert plan.smem_rows == sum(rows[lvl] for lvl in inside)
    assert plan.smem_bytes == msda.bwd_smem_bytes(plan.smem_rows)
    assert plan.smem_bytes <= msda.BWD_SMEM_BUDGET <= 232_448   # a CTA's most on Hopper
    # exactly the levels that are worth it and fit, taken from the smallest
    used = 0
    for lvl in sorted(range(len(rows)), key=lambda i: rows[i]):
        admit = (plan.tile_q * msda.POINTS * 4 >= rows[lvl]
                 and msda.bwd_smem_bytes(used + rows[lvl]) <= msda.BWD_SMEM_BUDGET)
        assert (lvl in inside) == admit, (lvl, plan)
        used += rows[lvl] if admit else 0


def test_flagship_plans():
    """At the 800x1216 bucket level 3 (13x19) goes to shared memory, in
    training's B = 4 encoder and decoder; level 2 (25x38, 121.6 KB) does not
    fit beside it at two CTAs an SM."""
    for Q in (_L(FLAGSHIP), 900):
        plan = msda.msda_bwd_plan(FLAGSHIP, 4, Q, H)
        assert plan.smem_row == (-1, -1, -1, 0) and plan.smem_rows == 13 * 19, plan
    assert msda.msda_bwd_plan(NANO, 2, 23, 4).smem_row == (0, 96, 120, 126)


@pytest.mark.parametrize("D,NL,P", [(16, 4, 4), (64, 4, 4), (32, 4, 3), (32, 4, 8),
                                    (32, 5, 4), (32, 0, 4)])
def test_geometry_check_refuses(D, NL, P):
    with pytest.raises(ValueError, match="built for"):
        msda.check_geometry(D, NL, P)


@pytest.mark.parametrize("NL", [1, 2, 3, 4])
def test_geometry_check_accepts(NL):
    msda.check_geometry(32, NL, 4)


def _corners(shapes, locs):
    """Per sample: the 4 corner positions in L (-1 outside the map) and
    bilinear weights, as csrc/msda_common.cuh stage_sample computes them."""
    pos, wts = [], []
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        x = locs[:, :, :, lvl, :, 0] * w - 0.5
        y = locs[:, :, :, lvl, :, 1] * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        x0, y0 = x0.long(), y0.long()
        p, c = [], []
        for dy, dx, wt in ((0, 0, (1 - fx) * (1 - fy)), (0, 1, fx * (1 - fy)),
                           (1, 0, (1 - fx) * fy), (1, 1, fx * fy)):
            xx, yy = x0 + dx, y0 + dy
            inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
            p.append(torch.where(inside, start + yy * w + xx, torch.full_like(xx, -1)))
            c.append(wt)
        pos.append(torch.stack(p, -1))
        wts.append(torch.stack(c, -1))
        start += h * w
    return torch.stack(pos, 3), torch.stack(wts, 3)       # (B, Q, H, NL, P, 4)


def _emulate_grad_value(value, shapes, locs, attn, grad_out, plan):
    """K3's grad_value: for each (b, h) and query tile, the shared-memory
    levels' contributions summed into a zeroed accumulator and flushed into
    grad_value once, at the touched rows; the other levels added straight."""
    B, L, Hh, D = value.shape
    Q = locs.shape[1]
    pos, cw = _corners(shapes, locs)
    contrib_w = cw * attn[..., None]                        # a * w_c
    g = grad_out.view(B, Q, Hh, D)
    starts = msda.level_starts(shapes)
    rows = [h * w for h, w in shapes]
    grad_value = torch.zeros_like(value)
    for b in range(B):
        for h in range(Hh):
            for t in range(-(-Q // plan.tile_q)):
                q0, q1 = t * plan.tile_q, min(Q, (t + 1) * plan.tile_q)
                acc = torch.zeros(plan.smem_rows, D)
                touched = torch.zeros(plan.smem_rows, dtype=torch.bool)
                for lvl in range(len(shapes)):
                    p = pos[b, q0:q1, h, lvl].reshape(q1 - q0, -1)          # (q, P*4)
                    k = contrib_w[b, q0:q1, h, lvl].reshape(q1 - q0, -1)
                    add = k[..., None] * g[b, q0:q1, h][:, None, :]          # (q, P*4, D)
                    live = p >= 0
                    p, add = p[live], add[live]
                    if plan.smem_row[lvl] >= 0:
                        r = plan.smem_row[lvl] + p - starts[lvl]
                        acc.index_add_(0, r, add)
                        touched[r] = True
                    else:
                        grad_value[b, :, h].index_add_(0, p, add)
                for lvl in range(len(shapes)):
                    r0 = plan.smem_row[lvl]
                    if r0 < 0:
                        continue
                    r = torch.arange(r0, r0 + rows[lvl])
                    r = r[touched[r]]
                    grad_value[b, :, h].index_add_(0, r - r0 + starts[lvl], acc[r])
    return grad_value


@pytest.mark.parametrize("shapes,Q", [(NANO, 37), (NANO, 100), (MIXED, 53)],
                         ids=["nano-37", "nano-100", "mixed-levels-53"])
def test_two_stage_grad_value_matches_plain(shapes, Q):
    B, Hh, D, P = 2, 2, 32, 4
    rng = np.random.RandomState(Q)
    L = _L(shapes)
    value = torch.from_numpy(rng.randn(B, L, Hh, D).astype(np.float32))
    locs = torch.from_numpy(rng.uniform(-0.1, 1.1, (B, Q, Hh, len(shapes), P, 2))
                            .astype(np.float32))
    attn = torch.from_numpy(rng.uniform(0, 1, (B, Q, Hh, len(shapes), P)).astype(np.float32))
    grad_out = torch.from_numpy(rng.randn(B, Q, Hh * D).astype(np.float32))
    plan = msda.msda_bwd_plan(shapes, B, Q, Hh)
    assert Q % plan.tile_q, "the tiles must split the queries unevenly"
    inside = [r >= 0 for r in plan.smem_row]
    if shapes is MIXED:
        assert inside == [False, False, True, True], plan
    else:
        assert all(inside), plan
    got = _emulate_grad_value(value, shapes, locs, attn, grad_out, plan)
    ref = msda.ms_deform_attn_bwd_plain(value, shapes, msda.level_starts(shapes), locs, attn,
                                        grad_out)[0]
    err = float((got - ref).abs().max()) / float(ref.abs().max())
    assert err <= 1e-6, err
