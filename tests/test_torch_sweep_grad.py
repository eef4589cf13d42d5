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

    def corner(value, shapes, idx, w, g):
        called.append("K9")
        return sw.sweep_bwd_corner_plain(value, idx, w, g)

    def rowtap(value, shapes, row, px, w, g):
        called.append("K10")
        return sw.sweep_bwd_rowtap_plain(value, row, px, w, g)

    monkeypatch.setattr(sw, "sweep_fwd", fwd("K6"))
    monkeypatch.setattr(sw, "sweep_fwd_allq", fwd("K7"))
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
    assert called == [fwd, "K9" if bwd == "corner" else "K10"]
