"""The port's LSAP solver (ops/lsap.py, the plain version the CPU runs; the
CUDA kernel csrc/lsap.cu takes its steps on the card) against the JAX
package's on-device Jonker-Volgenant solver, ops/hungarian.py::
hungarian_device, with its defaults (row reduction, masked u), and scipy.

* Seeded tie-free matrices of a few (N, Q, G) shapes, Q = 900 and G = 128
  with few valid rows among them, n_rows 0 and G in one batch: the indices
  equal the JAX solver's, and the total cost equals scipy's within 1e-5
  relative.
* All-equal rows, heavy integer ties and one column that is every row's
  argmin: optimal (scipy's cost) and injective.
* +/-inf entries (the JAX package's own degenerate matrix): injective and in
  range, no overflow; a row whose Dijkstra would spin ends at its bound of
  m + 1 iterations, unassigned, and sets its problem's overflow flag.
"""
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import jax
import jax.numpy as jnp

from open_groundingdino_tpu.ops.hungarian import hungarian_device
from open_groundingdino_tpu_torch.models import matcher
from open_groundingdino_tpu_torch.ops import lsap as L


def _scipy_cost(cost, valid):
    """The optimal total cost of each problem over its valid GT."""
    out = []
    for c, v in zip(cost, valid):
        cols = np.nonzero(v)[0]
        if len(cols) == 0:
            out.append(0.0)
            continue
        rows, cidx = linear_sum_assignment(c[:, cols].astype(np.float64))
        out.append(float(c[:, cols][rows, cidx].astype(np.float64).sum()))
    return np.asarray(out)


def _total(cost, assigned, valid):
    Q = cost.shape[1]
    out = []
    for c, a, v in zip(cost, assigned, valid):
        out.append(sum(float(c[a[g], g]) for g in np.nonzero(v)[0] if a[g] < Q))
    return np.asarray(out)


def _check_assignment(cost, valid, got, optimal=True):
    """Sentinel Q on invalid slots, injective and in range on the valid ones,
    and (optimal) scipy's total cost within 1e-5 relative."""
    N, Q, G = cost.shape
    assert got.shape == (N, G) and got.dtype == np.int64
    assert (got[~valid] == Q).all()
    for n in range(N):
        live = got[n][valid[n]]
        assert ((live >= 0) & (live < Q)).all(), live
        assert len(set(live.tolist())) == len(live)
    if optimal:
        ref = _scipy_cost(cost, valid)
        np.testing.assert_allclose(_total(cost, got, valid), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


def _port(cost, valid):
    assigned, overflow = L.lsap(torch.from_numpy(cost), torch.from_numpy(valid))
    return assigned.numpy(), overflow.numpy()


def _jax(cost, valid):
    return np.asarray(jax.jit(hungarian_device)(jnp.asarray(cost), jnp.asarray(valid)))


@pytest.mark.parametrize("shape,valid_share", [((4, 40, 7), 0.6), ((3, 900, 128), 0.15)],
                         ids=["40x7", "900x128"])
def test_tie_free_matrices_match_jax_and_scipy(shape, valid_share):
    rng = np.random.RandomState(shape[1])
    N, Q, G = shape
    cost = (rng.randn(N, Q, G) * 10).astype(np.float32)
    valid = rng.rand(N, G) < valid_share
    valid[0] = False          # n_rows 0
    valid[1] = True           # n_rows G
    got, overflow = _port(cost, valid)
    assert not overflow.any()
    np.testing.assert_array_equal(got, _jax(cost, valid).astype(np.int64))
    _check_assignment(cost, valid, got)


def test_flagship_costs_match_jax():
    """Costs of the matcher's own build at the flagship's Q = 900 and G =
    128 with 24 valid GT an image (tools/matcher_microbench.py's seeded
    inputs, two output sets, B = 2)."""
    from open_groundingdino_tpu_torch.tools.matcher_microbench import build_costs, seeded_inputs

    S, B, Q, G, T = 2, 2, 900, 128, 64
    logits, boxes, gt_boxes, pos, gt_valid = (torch.from_numpy(a) for a in seeded_inputs(
        S, B, Q, G, T, 24))
    cost = build_costs(logits, boxes, gt_boxes, pos, gt_valid).reshape(S * B, Q, G).numpy()
    valid = gt_valid.repeat(S, 1).numpy()
    got, overflow = _port(cost, valid)
    assert not overflow.any()
    np.testing.assert_array_equal(got, _jax(cost, valid).astype(np.int64))
    _check_assignment(cost, valid, got)


def test_ties_and_collisions_stay_optimal():
    rng = np.random.RandomState(13)
    cases = [np.zeros((2, 12, 6), np.float32),                        # all-equal rows
             rng.randint(0, 3, (2, 15, 8)).astype(np.float32)]        # heavy integer ties
    one_column = np.full((1, 10, 5), 7.0, np.float32)                 # every argmin one column
    one_column[0, 3, :] = -50.0
    cases.append(one_column + rng.rand(1, 10, 5).astype(np.float32))
    for cost in cases:
        valid = np.ones(cost.shape[::2], bool)
        got, overflow = _port(cost, valid)
        assert not overflow.any()
        _check_assignment(cost, valid, got)


def test_infinite_entries_are_injective_in_range():
    """The JAX package's degenerate matrix (tests/test_matcher_criterion.py:
    a query of +inf costs, a GT of -inf ones) and a sparser mix."""
    rng = np.random.RandomState(3)
    cost = rng.randn(2, 10, 5).astype(np.float32)
    cost[0, 2, :] = np.inf
    cost[0, :, 3] = -np.inf
    cost[1][rng.rand(10, 5) < 0.2] = np.inf
    cost[1][rng.rand(10, 5) < 0.1] = -np.inf
    valid = np.ones((2, 5), bool)
    got, overflow = _port(cost, valid)
    assert not overflow.any()
    _check_assignment(cost, valid, got, optimal=False)
    np.testing.assert_array_equal(got[:1], _jax(cost[:1], valid[:1]).astype(np.int64))


def test_a_spinning_row_ends_at_the_bound():
    """GT 0 costs -inf at query 0 and +inf elsewhere, GT 1 -inf at query 0
    and finite elsewhere: GT 0 claims query 0, GT 1's Dijkstra finds every
    other query at +inf and returns to the virtual column without end (the
    JAX solver spins here).  It ends at m + 1 iterations with GT 1
    unassigned, and the overflow flag is set on that problem alone."""
    rng = np.random.RandomState(4)
    cost = (rng.rand(2, 8, 2) * 10).astype(np.float32)
    cost[0, :, 0] = np.inf
    cost[0, 0, :] = -np.inf
    valid = np.ones((2, 2), bool)
    got, overflow = _port(cost, valid)
    assert overflow.tolist() == [True, False]
    assert got[0].tolist() == [0, 8]
    _check_assignment(cost[1:], valid[1:], got[1:])


def test_first_argmin_and_the_matcher_methods():
    x = torch.tensor([[3.0, 1.0, 1.0, 2.0], [1.0, float("nan"), 0.0, float("nan")],
                      [float("inf"), float("inf"), -0.0, 0.0]])
    assert L.first_argmin(x, 1).tolist() == [1, 1, 2]
    rng = np.random.RandomState(5)
    cost = rng.randn(3, 20, 6).astype(np.float32)
    valid = rng.rand(3, 6) > 0.3
    t_cost, t_valid = torch.from_numpy(cost), torch.from_numpy(valid)
    device = matcher.hungarian_assign(t_cost, t_valid)
    np.testing.assert_array_equal(device.numpy(), _port(cost, valid)[0])
    host = matcher.hungarian_assign(t_cost, t_valid, method="callback")
    np.testing.assert_allclose(_total(cost, device.numpy(), valid),
                               _total(cost, host.numpy(), valid), rtol=1e-6)
    with pytest.raises(ValueError, match="method"):
        matcher.hungarian_assign(t_cost, t_valid, method="scipy")
    # more valid GT than queries: the rows that find no free query reach the
    # bound unassigned (scipy assigns min(Q, G) of them)
    wide = rng.randn(1, 3, 5).astype(np.float32)
    got, overflow = _port(wide, np.ones((1, 5), bool))
    assert overflow.tolist() == [True] and sorted(got[0][got[0] < 3].tolist()) == [0, 1, 2]
