"""The port's sweep MSDA (ops/msda_sweep.py) against the JAX package's Pallas
sweep (ops/msda_pallas.py, interpret mode on the CPU, as
tests/test_msda_pallas.py runs it), at that file's tiny shapes.

  * The two expansions against `_rowtap_positions_and_weights_t` and
    `_corner_indices_and_weights_t`, points outside the map included: corner
    indices exact, positions and weights within 1e-6.  The port splits a row
    tap's flat position into the row's start and the position within the
    row (ops/msda_sweep.py); their sum rounded to f32 is the JAX package's,
    and the TPU kernels' flat operands split back exactly (_split_rows).
  * Each kernel's plain version against its TPU kernel on the same expanded
    operands at 1e-5 (f32; only the order of the sums differs): K6 and K7's
    `sweep_fwd_plain` through `_msda_pallas_fwd_rowtap_call` and
    `_msda_pallas_fwd_rowtap_allq_call`, K8's `sweep_fwd_corner_plain`
    through `_msda_pallas_fwd_call` (on corner taps sorted by the first, as
    msda_pallas.py:937-943 sorts them), K9's through `_msda_pallas_bwd_call`,
    K10's through `_msda_rowtap_bwd_call`.  Tap gradients are compared where
    the tap is live (w != 0): a dead tap's gradient depends on the sweep's
    ranges in both packages and the chain rule multiplies it by zero.
  * The decoder path's sort, pad and un-sort, and the launchers' refusal of
    CPU tensors.
The op as a whole, with its gradient, is tests/test_torch_sweep_grad.py.
Sampling points are continuous random draws, off the pixel lattice.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open_groundingdino_tpu.ops import msda_pallas as mp
from open_groundingdino_tpu_torch.ops import msda_sweep as sw

SHAPES = ((12, 16), (6, 8), (3, 4))
B, H, D, P = 2, 2, 8, 4
NL = len(SHAPES)
L = sum(h * w for h, w in SHAPES)
STARTS = (0, 192, 240)
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=2e-4)


def _inputs(Q, seed):
    """Reference-layout value (B, L, H, D), locs (B, Q, H, NL, P, 2), attn,
    and an upstream gradient (B, Q, H*D), f32 numpy."""
    rng = np.random.RandomState(seed)
    value = rng.randn(B, L, H, D).astype(np.float32)
    locs = rng.uniform(-0.1, 1.1, size=(B, Q, H, NL, P, 2)).astype(np.float32)
    attn = rng.uniform(size=(B, Q, H, NL, P)).astype(np.float32)
    attn /= attn.reshape(B, Q, H, -1).sum(-1).reshape(B, Q, H, 1, 1)
    grad = rng.randn(B, Q, H * D).astype(np.float32)
    return value, locs, attn, grad


def _t_layout(value, locs, attn):
    """The JAX transposed entry's layouts: value_t (BH, D, L), locs_t
    (BH, NL, P, 2, Q), attn_t (BH, NL, P, Q)."""
    Q = locs.shape[1]
    value_t = value.transpose(0, 2, 3, 1).reshape(B * H, D, L)
    locs_t = locs.transpose(0, 2, 3, 4, 5, 1).reshape(B * H, NL, P, 2, Q)
    attn_t = attn.transpose(0, 2, 3, 4, 1).reshape(B * H, NL, P, Q)
    return value_t, locs_t, attn_t


def _pad_q(x, mult):
    pad = -x.shape[-1] % mult
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])


def _pad_l(value_t, tile):
    return jnp.asarray(np.pad(value_t, ((0, 0), (0, 0), (0, -L % tile))))


def _expanded(Q, seed):
    """value (B, L, H, D), and value_t, locs_t, attn_t in the JAX layouts."""
    value, locs, attn, _ = _inputs(Q, seed)
    return (value, *_t_layout(value, locs, attn))


def test_rowtap_expansion_matches_jax():
    _, _, locs_t, attn_t = _expanded(57, 0)
    px_j, w_j = mp._rowtap_positions_and_weights_t(jnp.asarray(locs_t), jnp.asarray(attn_t),
                                                   SHAPES)
    row, px, w = sw.rowtap_positions_and_weights(torch.from_numpy(locs_t),
                                                 torch.from_numpy(attn_t), SHAPES)
    assert (np.asarray(w_j) == 0).any()                 # dead taps are in the draw
    np.testing.assert_array_equal(row.numpy(), _split_rows(np.asarray(px_j))[0])
    # the JAX package's flat position is row + px rounded to f32
    flat = (row.numpy() + px.numpy().astype(np.float64)).astype(np.float32)
    np.testing.assert_allclose(flat, np.asarray(px_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=0, atol=1e-6)


def test_corner_expansion_matches_jax():
    _, _, locs_t, attn_t = _expanded(57, 1)
    idx_j, w_j = mp._corner_indices_and_weights_t(jnp.asarray(locs_t), jnp.asarray(attn_t),
                                                  SHAPES)
    idx, w = sw.corner_indices_and_weights(torch.from_numpy(locs_t), torch.from_numpy(attn_t),
                                           SHAPES)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=0, atol=1e-6)


def _split_rows(px_flat):
    """The TPU kernels' flat f32 row-tap positions (BH, NL*2*P, Q) as the
    port's (row start int32, position within the row): a row tap's flat
    position lies in [row, row + W - 1] of its level, and the subtraction is
    exact."""
    level = np.arange(px_flat.shape[1]) // (2 * P)
    start = np.asarray(STARTS)[level][None, :, None]
    width = np.asarray([w for _, w in SHAPES])[level][None, :, None]
    row = start + (np.floor(px_flat).astype(np.int64) - start) // width * width
    return row.astype(np.int32), (px_flat - row).astype(np.float32)


def _rowtap_operands(Q, seed, sort):
    """Expanded row taps (the JAX expansion, optionally sorted as the decoder
    path sorts them), padded to the TPU block, with the value both ways."""
    value, value_t, locs_t, attn_t = _expanded(Q, seed)
    px, w = (np.asarray(a) for a in mp._rowtap_positions_and_weights_t(
        jnp.asarray(locs_t), jnp.asarray(attn_t), SHAPES))
    if sort:
        order = np.argsort(px[:, 0, :], axis=1, kind="stable")
        px = np.take_along_axis(px, order[:, None, :], 2)
        w = np.take_along_axis(w, order[:, None, :], 2)
    px, w = _pad_q(px, mp.QBLOCK), _pad_q(w, mp.QBLOCK)
    return value, value_t, px, w


def _corner_operands(Q, seed):
    """Expanded corner taps (the JAX expansion), sorted by the first tap as
    the op-level path sorts a Q != L query set, padded to the TPU block."""
    value, value_t, locs_t, attn_t = _expanded(Q, seed)
    idx, w = (np.asarray(a) for a in mp._corner_indices_and_weights_t(
        jnp.asarray(locs_t), jnp.asarray(attn_t), SHAPES))
    order = np.argsort(idx[:, 0, :], axis=1, kind="stable")
    idx, w = (np.take_along_axis(a, order[:, None, :], 2) for a in (idx, w))
    return value, value_t, _pad_q(idx, mp.QBLOCK), _pad_q(w, mp.QBLOCK)


@pytest.mark.parametrize("kernel", ["K6", "K7", "K8"])
def test_sweep_fwd_plain_matches_tpu_kernel(kernel):
    Q = 173
    if kernel == "K8":
        value, value_t, idx, w = _corner_operands(Q, 2)
        ranges = mp._tile_ranges(jnp.asarray(idx), jnp.asarray(w),
                                 idx.shape[-1] // mp.QBLOCK).reshape(-1)
        ref = mp._msda_pallas_fwd_call(_pad_l(value_t, mp.TILE), jnp.asarray(idx),
                                       jnp.asarray(w), ranges)
        got = sw.sweep_fwd_corner_plain(torch.from_numpy(value), torch.from_numpy(idx),
                                        torch.from_numpy(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        return
    value, value_t, px, w = _rowtap_operands(Q, 2, sort=kernel == "K7")
    row, px_row = _split_rows(px)
    nqb = px.shape[-1] // mp.QBLOCK
    ranges = mp._rowtap_tile_ranges(jnp.asarray(px), jnp.asarray(w), nqb).reshape(-1)
    if kernel == "K6":
        ref = mp._msda_pallas_fwd_rowtap_call(_pad_l(value_t, mp.RT_TILE), jnp.asarray(px),
                                              jnp.asarray(w), ranges, mp.RT_TILE)
    else:
        ref = mp._msda_pallas_fwd_rowtap_allq_call(_pad_l(value_t, mp.DEC_TILE), jnp.asarray(px),
                                                   jnp.asarray(w), ranges, mp.DEC_TILE)
    got = sw.sweep_fwd_plain(torch.from_numpy(value), torch.from_numpy(row),
                             torch.from_numpy(px_row), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _gv_ref(gv_t):
    """(BH, D, L_pad) -> (B, L, H, D)."""
    return np.asarray(gv_t)[:, :, :L].reshape(B, H, D, L).transpose(0, 3, 1, 2)


def test_sweep_bwd_corner_plain_matches_tpu_kernel():
    Q = 173
    value, value_t, locs_t, attn_t = _expanded(Q, 3)
    idx, w = (np.asarray(a) for a in mp._corner_indices_and_weights_t(
        jnp.asarray(locs_t), jnp.asarray(attn_t), SHAPES))
    idx, w = _pad_q(idx, mp.QBLOCK), _pad_q(w, mp.QBLOCK)
    g = np.random.RandomState(4).randn(B * H, idx.shape[-1], D).astype(np.float32)
    ranges = mp._tile_ranges(jnp.asarray(idx), jnp.asarray(w), idx.shape[-1] // mp.QBLOCK).reshape(-1)
    gv_j, gw_j = mp._msda_pallas_bwd_call(_pad_l(value_t, mp.BWD_TILE), jnp.asarray(idx),
                                          jnp.asarray(w), jnp.asarray(g), ranges)
    gv, gw = sw.sweep_bwd_corner_plain(torch.from_numpy(value), torch.from_numpy(idx),
                                       torch.from_numpy(w), torch.from_numpy(g))
    np.testing.assert_allclose(gv.numpy(), _gv_ref(gv_j), **TOL)
    live = w != 0
    np.testing.assert_allclose(gw.numpy()[live], np.asarray(gw_j)[live], **TOL)


def test_sweep_bwd_rowtap_plain_matches_tpu_kernel():
    Q = 173
    value, value_t, px, w = _rowtap_operands(Q, 5, sort=True)
    g = np.random.RandomState(6).randn(B * H, px.shape[-1], D).astype(np.float32)
    ranges = mp._rowtap_tile_ranges(jnp.asarray(px), jnp.asarray(w),
                                    px.shape[-1] // mp.QBLOCK).reshape(-1)
    gv_j, gpx_j, gw_j = mp._msda_rowtap_bwd_call(_pad_l(value_t, mp.RT_BWD_TILE), jnp.asarray(px),
                                                 jnp.asarray(w), jnp.asarray(g), ranges)
    row, px_row = _split_rows(px)
    gv, gpx, gw = sw.sweep_bwd_rowtap_plain(torch.from_numpy(value), torch.from_numpy(row),
                                            torch.from_numpy(px_row), torch.from_numpy(w),
                                            torch.from_numpy(g))
    np.testing.assert_allclose(gv.numpy(), _gv_ref(gv_j), **TOL)
    live = w != 0
    np.testing.assert_allclose(gw.numpy()[live], np.asarray(gw_j)[live], **TOL)
    np.testing.assert_allclose(gpx.numpy()[live], np.asarray(gpx_j)[live], **TOL)


def test_sort_and_pad_round_trip():
    """The decoder path's query order: sorted by the first row tap, padded
    to the block with dead queries, and un-sorted back exactly."""
    rng = np.random.RandomState(8)
    row = torch.from_numpy(rng.randint(0, 16, (3, 6, 50)).astype(np.int32) * 16)
    px = torch.from_numpy(rng.uniform(0, 15, (3, 6, 50)).astype(np.float32))
    order = sw.query_order(row, px, L)
    s = sw.sort_and_pad(px, order)
    assert s.shape == (3, 6, sw.QBLOCK) and (s[..., 50:] == 0).all()
    key = sw.sort_and_pad(row, order)[:, 0, :50] + s[:, 0, :50].long()
    assert (key[:, 1:] >= key[:, :-1]).all()
    torch.testing.assert_close(sw.unsort(s, order, 50), px, rtol=0, atol=0)
    g = torch.from_numpy(rng.randn(3, 50, 4).astype(np.float32))
    torch.testing.assert_close(sw.unsort(sw.sort_and_pad(g, order, 1), order, 50, 1), g,
                               rtol=0, atol=0)
    assert sw.query_order(row[..., :1], px[..., :1], 1) is None   # Q == L: raster order
    corner = sw.sort_and_pad(row, sw.query_order(row, None, L))    # corner taps: by the first
    assert (corner[:, 0, 1:50] >= corner[:, 0, :49]).all()


def test_kernel_wrappers_take_cuda_tensors_only():
    """Each launcher refuses CPU tensors (a CUDA tensor never reaches a plain
    version, and a CPU one never a kernel); the op refuses an unknown
    backward and a level order other than the raster one."""
    value = torch.zeros(1, L, 1, 32)
    taps, rows = torch.zeros(1, 8 * NL, 128), torch.zeros(1, 8 * NL, 128, dtype=torch.int32)
    for launch, args in ((sw.sweep_fwd, (value, SHAPES, rows, taps, taps)),
                         (sw.sweep_fwd_corner, (value, SHAPES, rows, taps)),
                         (sw.sweep_fwd_allq, (value, SHAPES, rows, taps, taps)),
                         (sw.sweep_bwd_rowtap, (value, SHAPES, rows, taps, taps,
                                                torch.zeros(1, 128, 32))),
                         (sw.sweep_bwd_corner, (value, SHAPES, taps.int(), taps,
                                                torch.zeros(1, 128, 32)))):
        with pytest.raises(ValueError, match="unsupported device"):
            launch(*args)
        assert launch.launches == 0
    value, locs, attn, _ = (torch.from_numpy(a) for a in _inputs(5, 9))
    with pytest.raises(ValueError, match="bwd must be"):
        sw.ms_deform_attn_sweep(value, SHAPES, STARTS, locs, attn, bwd="banded")
    with pytest.raises(ValueError, match="raster level order"):
        sw.ms_deform_attn_sweep(value, SHAPES, (0, 1, 2), locs, attn)
    with pytest.raises(ValueError, match="fwd must be"):
        sw.ms_deform_attn_sweep(value, SHAPES, STARTS, locs, attn, fwd="banded")
    for kw in (dict(dec_fused=True), dict(bwd="rowtap")):   # not on the JAX op-level path
        with pytest.raises(ValueError, match="corner forward"):
            sw.ms_deform_attn_sweep(value, SHAPES, STARTS, locs, attn, fwd="corner", **kw)
