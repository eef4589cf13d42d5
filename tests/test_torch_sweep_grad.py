"""The port's sweep MSDA op and its gradient against the JAX package's
`ms_deform_attn_pallas_t` (ops/msda_pallas.py:1352) and its custom VJP, run
in interpret mode on the CPU, at tests/test_msda_pallas.py's tiny shapes
(the inputs of tests/test_torch_msda_sweep.py).

`ms_deform_attn_sweep` on CPU tensors (the plain version under autograd)
and `MSDASweepFunction` (the CUDA path's plumbing: expansion, sort, pad,
un-sort, the chain rule through the expansion, with its four launchers
replaced by the plain versions) must both match the forward and the
gradients of value, locations and weights, for Q == L and Q != L, with each
DEC_FUSED and each BWD_VARIANT, at rtol 1e-4 / atol 2e-4
(tests/test_msda_pallas.py:84-89: the row-tap forward's rounding reaches the
location gradients through the W scale).  DEC_FUSED has no effect where
Q == L (nothing is sorted), so that case runs once per backward.  Sampling
points are continuous random draws, off the pixel lattice, where the
row-tap and corner derivatives agree.

The corner forward (`fwd="corner"`, K8 with the K9 backward) is held against
the op-level `ms_deform_attn_pallas` with FWD_VARIANT="corner" and its VJP
at the nano model's four levels, at the same tolerances, on the CPU path and
through the Function, whose K8 and K9 launchers must receive the corner taps
in the query order the op documents.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open_groundingdino_tpu.ops import msda_pallas as mp
from open_groundingdino_tpu_torch.ops import msda_sweep as sw
from test_torch_msda_sweep import B, D, GRAD_TOL, H, L, NL, P, SHAPES, STARTS, _inputs, _t_layout


def _jax_sweep(value, locs, attn, grad):
    """ms_deform_attn_pallas_t and its VJP, in the reference layouts."""
    Q = locs.shape[1]
    value_t, locs_t, attn_t = (jnp.asarray(a) for a in _t_layout(value, locs, attn))
    g_t = jnp.asarray(grad.reshape(B, Q, H, D).transpose(0, 2, 1, 3).reshape(B * H, Q, D))

    @jax.jit   # one compile of forward and backward (traced anew: the switches are read then)
    def fwd_bwd(v, l, a, g):
        out, vjp = jax.vjp(lambda v, l, a: mp.ms_deform_attn_pallas_t(v, SHAPES, l, a), v, l, a)
        return out, vjp(g)

    out, grads = fwd_bwd(value_t, locs_t, attn_t, g_t)
    gv_t, gl_t, ga_t = (np.asarray(x) for x in grads)
    out = np.asarray(out).reshape(B, H, Q, D).transpose(0, 2, 1, 3).reshape(B, Q, H * D)
    return out, (gv_t.reshape(B, H, D, L).transpose(0, 3, 1, 2),
                 gl_t.reshape(B, H, NL, P, 2, Q).transpose(0, 5, 1, 2, 3, 4),
                 ga_t.reshape(B, H, NL, P, Q).transpose(0, 4, 1, 2, 3))


def _plain_launchers(monkeypatch):
    """Replace the four CUDA launchers by their plain versions; returns the
    list of the launchers called."""
    called = []

    def fwd(name):
        def launch(value, shapes, row, px, w):
            called.append(name)
            return sw.sweep_fwd_plain(value, row, px, w)
        return launch

    def corner_fwd(value, shapes, idx, w):
        called.append(("K8", idx, w))
        return sw.sweep_fwd_corner_plain(value, idx, w)

    def corner(value, shapes, idx, w, g):
        called.append(("K9", idx, w, g))
        return sw.sweep_bwd_corner_plain(value, idx, w, g)

    def rowtap(value, shapes, row, px, w, g):
        called.append("K10")
        return sw.sweep_bwd_rowtap_plain(value, row, px, w, g)

    monkeypatch.setattr(sw, "sweep_fwd", fwd("K6"))
    monkeypatch.setattr(sw, "sweep_fwd_allq", fwd("K7"))
    monkeypatch.setattr(sw, "sweep_fwd_corner", corner_fwd)
    monkeypatch.setattr(sw, "sweep_bwd_corner", corner)
    monkeypatch.setattr(sw, "sweep_bwd_rowtap", rowtap)
    return called


@pytest.mark.parametrize("Q,dec_fused,bwd", [
    (L, 0, "corner"), (L, 0, "rowtap"), (173, 0, "corner"), (173, 1, "rowtap"),
], ids=["Q=L-corner", "Q=L-rowtap", "Q!=L-corner", "Q!=L-fused-rowtap"])
def test_sweep_matches_pallas_t(monkeypatch, Q, dec_fused, bwd):
    monkeypatch.setattr(mp, "DEC_FUSED", dec_fused)
    monkeypatch.setattr(mp, "BWD_VARIANT", bwd)
    value, locs, attn, grad = _inputs(Q, 7)
    ref_out, ref_grads = _jax_sweep(value, locs, attn, grad)

    def run(fn):
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in (value, locs, attn)]
        out = fn(*leaves)
        out.backward(torch.from_numpy(grad))
        np.testing.assert_allclose(out.detach().numpy(), ref_out, **GRAD_TOL)
        for name, t, r in zip(("value", "locs", "attn"), leaves, ref_grads):
            np.testing.assert_allclose(t.grad.numpy(), r, **GRAD_TOL, err_msg=name)

    # the CPU path: the plain version, differentiated by autograd
    run(lambda v, l, a: sw.ms_deform_attn_sweep(v, SHAPES, STARTS, l, a, bwd, dec_fused))
    # the CUDA path's Function with its launchers on the plain versions
    called = _plain_launchers(monkeypatch)
    run(lambda v, l, a: sw.MSDASweepFunction.apply(v, l, a, SHAPES, bwd, bool(dec_fused)))
    fwd = "K7" if dec_fused and Q != L else "K6"
    assert _names(called) == [fwd, "K9" if bwd == "corner" else "K10"]


def _names(called):
    return [c if isinstance(c, str) else c[0] for c in called]


SHAPES4 = ((8, 12), (4, 6), (2, 3), (1, 2))
L4 = sum(h * w for h, w in SHAPES4)
STARTS4 = (0, 96, 120, 126)


def _inputs4(Q, seed):
    rng = np.random.RandomState(seed)
    value = rng.randn(B, L4, H, D).astype(np.float32)
    locs = rng.uniform(-0.1, 1.1, size=(B, Q, H, 4, P, 2)).astype(np.float32)
    attn = rng.uniform(size=(B, Q, H, 4, P)).astype(np.float32)
    attn /= attn.reshape(B, Q, H, -1).sum(-1).reshape(B, Q, H, 1, 1)
    return value, locs, attn, rng.randn(B, Q, H * D).astype(np.float32)


def test_corner_sweep_matches_pallas(monkeypatch):
    """A decoder-style query set (Q != L, sorted): the path that differs from
    the raster one only by its sort and un-sort."""
    Q = 150
    monkeypatch.setattr(mp, "FWD_VARIANT", "corner")
    value, locs, attn, grad = _inputs4(Q, 11)

    @jax.jit   # traced anew: FWD_VARIANT is read then
    def fwd_bwd(v, l, a, g):
        out, vjp = jax.vjp(lambda v, l, a: mp.ms_deform_attn_pallas(v, SHAPES4, l, a), v, l, a)
        return out, vjp(g)

    ref_out, ref_grads = fwd_bwd(*(jnp.asarray(a) for a in (value, locs, attn, grad)))

    def run(fn):
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in (value, locs, attn)]
        out = fn(*leaves)
        out.backward(torch.from_numpy(grad))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), **GRAD_TOL)
        for name, t, r in zip(("value", "locs", "attn"), leaves, ref_grads):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), **GRAD_TOL, err_msg=name)

    run(lambda v, l, a: sw.ms_deform_attn_sweep(v, SHAPES4, STARTS4, l, a, fwd="corner"))
    called = _plain_launchers(monkeypatch)
    run(lambda v, l, a: sw.MSDASweepFunction.apply(v, l, a, SHAPES4, "corner", False, "corner"))
    assert _names(called) == ["K8", "K9"]
    idx, w = sw.corner_indices_and_weights(*sw.kernel_layout(*(torch.from_numpy(a)
                                                               for a in (locs, attn))), SHAPES4)
    order = sw.query_order(idx, None, L4)
    assert order is not None
    torch.testing.assert_close(called[0][1], sw.sort_and_pad(idx, order), rtol=0, atol=0)
    torch.testing.assert_close(called[0][2], sw.sort_and_pad(w, order), rtol=0, atol=0)
    # the backward's K9: the same taps and the upstream gradient, in the row
    # taps' query order (any order is exact; the backward sorts as the model path does)
    row, px, _ = sw.rowtap_positions_and_weights(*sw.kernel_layout(
        *(torch.from_numpy(a) for a in (locs, attn))), SHAPES4)
    order = sw.query_order(row, px, L4)
    g = torch.from_numpy(grad).view(B, Q, H, D).permute(0, 2, 1, 3).reshape(B * H, Q, D)
    for got, want in zip(called[1][1:], (sw.sort_and_pad(idx, order), sw.sort_and_pad(w, order),
                                          sw.sort_and_pad(g, order, 1))):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
