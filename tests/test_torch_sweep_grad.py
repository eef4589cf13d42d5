"""The port's sweep MSDA op and its gradient against the JAX package's
`ms_deform_attn_pallas_t` (ops/msda_pallas.py:1352) and its custom VJP, run
in interpret mode on the CPU, at tests/test_msda_pallas.py's tiny shapes
(the inputs of tests/test_torch_msda_sweep.py).

`ms_deform_attn_sweep` on CPU tensors (the ops with their plain versions and
registered autograd, the CUDA path's plumbing: expansion, sort, pad,
un-sort, K9's corner taps of the row taps or K10's row taps, the chain rule
through the expansion; the ops it dispatches recorded) must match the
forward and the gradients of value, locations and weights, for Q == L and
Q != L, with each DEC_FUSED and each BWD_VARIANT, at rtol 1e-4 / atol 2e-4
(tests/test_msda_pallas.py:84-89: the row-tap forward's rounding reaches the
location gradients through the W scale).  DEC_FUSED has no effect where
Q == L (nothing is sorted), so that case runs once per backward.  Sampling
points are continuous random draws, off the pixel lattice, where the
row-tap and corner derivatives agree.

The corner forward (`fwd="corner"`, K8 with the K9 backward) is held against
the op-level `ms_deform_attn_pallas` with FWD_VARIANT="corner" and its VJP
at the nano model's four levels, at the same tolerances; K8's and K9's ops
must receive the corner taps in the query order the op documents.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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


class Record(TorchDispatchMode):
    """The ogd_torch ops dispatched under it, (name, args) in order."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "ogd_torch":
            self.calls.append((func.__name__.split(".")[0], args))
        return func(*args, **(kwargs or {}))


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

    # the ops on CPU tensors: their plain versions under their registered autograd
    with Record() as rec:
        run(lambda v, l, a: sw.ms_deform_attn_sweep(v, SHAPES, STARTS, l, a, bwd, dec_fused))
    fwd = "sweep_fwd_allq" if dec_fused and Q != L else "sweep_fwd"
    assert [c[0] for c in rec.calls] == [fwd, f"sweep_bwd_{bwd}"]


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

    with Record() as rec:
        run(lambda v, l, a: sw.ms_deform_attn_sweep(v, SHAPES4, STARTS4, l, a, fwd="corner"))
    assert [c[0] for c in rec.calls] == ["sweep_fwd_corner", "sweep_bwd_corner"]
    idx, w = sw.corner_indices_and_weights(*sw.kernel_layout(*(torch.from_numpy(a)
                                                               for a in (locs, attn))), SHAPES4)
    order = sw.query_order(idx, None, L4)
    assert order is not None
    k8, k9 = rec.calls[0][1], rec.calls[1][1]
    torch.testing.assert_close(k8[2], sw.sort_and_pad(idx, order), rtol=0, atol=0)
    torch.testing.assert_close(k8[3], sw.sort_and_pad(w, order), rtol=0, atol=0)
    # the backward's K9: K8's taps and the upstream gradient, in their query order
    g = torch.from_numpy(grad).view(B, Q, H, D).permute(0, 2, 1, 3).reshape(B * H, Q, D)
    for got, want in zip(k9[2:], (sw.sort_and_pad(idx, order), sw.sort_and_pad(w, order),
                                  sw.sort_and_pad(g, order, 1))):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
