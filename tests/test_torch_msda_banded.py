"""The port's per-point banded MSDA (ops/msda_banded.py: K5's operands, its
plain version, the op and its gradient) against the JAX package's
ops/msda_banded.py under MSDA_BANDED_MP=0 (`_msda_banded_kernel`), run in
interpret mode on the CPU as tests/test_msda_banded.py runs it, at the nano
model's level shapes.

  * `banded_prep` and `band_ranges` against `_banded_prep` and `_band_ranges`:
    ranges exactly, factors within 1e-6, points outside the map included.
  * `banded_fwd_plain` against `_banded_core` on the same operands, with a
    padding mask and Q not a multiple of 128, within 1e-5 (f32; the TPU's
    dot sums the zero columns too).
  * The op on CPU tensors (the plain version; for Q != L sorted as
    `ms_deform_attn_banded_sorted` sorts) against `ms_deform_attn_banded` /
    `_sorted`, forward and gradients of value, locations and weights, at
    rtol 1e-4 / atol 2e-4 (tests/test_msda_pallas.py:84-89; sampling points
    are continuous draws, off the pixel lattice).
  * The registered autograd of K5's op (the CUDA path's too): the forward
    reaches K5's op with the operands `banded_operands` makes, the backward
    reaches K3's op with the reference operands and the upstream gradient.
The module and the nano model on this path are
tests/test_torch_banded_model.py.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from open_groundingdino_tpu.ops import msda_banded as jb
from open_groundingdino_tpu_torch.ops import msda, msda_banded as mb
from open_groundingdino_tpu_torch.ops.msda_sweep import QBLOCK, kernel_layout, sort_and_pad

SHAPES = ((8, 12), (4, 6), (2, 3), (1, 2))
B, H, D, P = 2, 2, 8, 4
NL = len(SHAPES)
L = sum(h * w for h, w in SHAPES)
STARTS = msda.level_starts(SHAPES)
BAND = 4
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=2e-4)


@pytest.fixture
def per_point(monkeypatch):
    """The JAX package's per-point banded forward (read at trace time)."""
    monkeypatch.setenv("MSDA_BANDED_MP", "0")


def _inputs(Q, seed):
    """value (B, L, H, D) zeroed at padded positions (image 1's right half
    of every level), locs (B, Q, H, NL, P, 2), attn, upstream gradient."""
    rng = np.random.RandomState(seed)
    value = rng.randn(B, L, H, D).astype(np.float32)
    for (h, w), s in zip(SHAPES, STARTS):
        cols = np.arange(h * w) % w
        value[1, s + np.flatnonzero(cols >= (w + 1) // 2)] = 0.0
    locs = rng.uniform(-0.1, 1.1, (B, Q, H, NL, P, 2)).astype(np.float32)
    attn = rng.uniform(size=(B, Q, H, NL, P)).astype(np.float32)
    attn /= attn.reshape(B, Q, H, -1).sum(-1).reshape(B, Q, H, 1, 1)
    grad = rng.randn(B, Q, H * D).astype(np.float32)
    return value, locs, attn, grad


def _banded_values(value):
    """(B, L, H, D) -> the TPU's per-level (BH, H_l*D, W_l) layout."""
    out = []
    for (h, w), s in zip(SHAPES, STARTS):
        vl = value[:, s:s + h * w].reshape(B, h, w, H, D)
        out.append(jnp.asarray(np.ascontiguousarray(
            vl.transpose(0, 3, 1, 4, 2).reshape(B * H, h * D, w))))
    return tuple(out)


def _from_banded(gvs):
    """Per-level (BH, H_l*D, W_l) gradients -> (B, L, H, D)."""
    parts = [np.asarray(g).reshape(B, H, h, D, w).transpose(0, 2, 4, 1, 3).reshape(B, h * w, H, D)
             for g, (h, w) in zip(gvs, SHAPES)]
    return np.concatenate(parts, 1)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _kernel_layout(locs, attn):
    return [t.numpy() for t in kernel_layout(*_t(locs, attn))]


def test_prep_and_ranges_match_jax(monkeypatch):
    monkeypatch.setattr(jb, "QBLOCK", QBLOCK)      # the TPU's ranges at the port's 128-query block
    _, locs, attn, _ = _inputs(173, 0)
    locs_t, attn_t = _kernel_layout(locs, attn)
    nqb = -(-173 // QBLOCK)
    bands = mb.level_bands(SHAPES, BAND)
    assert bands == (4, 4, 2, 1)
    ref = jb._banded_prep(jnp.asarray(locs_t), jnp.asarray(attn_t), SHAPES)
    got = mb.banded_prep(*_t(locs_t, attn_t), SHAPES)
    for name, g, r in zip(("px", "py", "wa"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-6, err_msg=name)
    assert (np.asarray(ref[2]) == 0).any()          # points wholly outside the map
    ranges = mb.band_ranges(torch.from_numpy(locs_t), SHAPES, nqb, bands)
    assert ranges.dtype == torch.int32
    np.testing.assert_array_equal(
        ranges.numpy(), np.asarray(jb._band_ranges(jnp.asarray(locs_t), SHAPES, nqb, bands)))


def test_banded_fwd_plain_matches_tpu_kernel(per_point):
    Q = 173
    value, locs, attn, _ = _inputs(Q, 1)
    locs_t, attn_t = _kernel_layout(locs, attn)
    ref = jb._banded_core(_banded_values(value), SHAPES, jnp.asarray(locs_t),
                          jnp.asarray(attn_t), P, BAND)                       # (BH, D, Q)
    px, py, wa = (sort_and_pad(t, None) for t in mb.banded_prep(*_t(locs_t, attn_t), SHAPES))
    assert px.shape == (B * H, NL * P, 2 * QBLOCK)
    ranges = mb.band_ranges(torch.from_numpy(locs_t), SHAPES, 2, mb.level_bands(SHAPES, BAND))
    got = mb.banded_fwd_plain(torch.from_numpy(value), SHAPES, px, py, wa, ranges, BAND)
    np.testing.assert_allclose(got[:, :Q].numpy(), np.asarray(ref).transpose(0, 2, 1), **TOL)


def _jax_op(value, locs, attn, grad, sort):
    """ms_deform_attn_banded (or _sorted) and its VJP, in the reference
    layouts."""
    Q = locs.shape[1]
    fn = jb.ms_deform_attn_banded_sorted if sort else jb.ms_deform_attn_banded
    locs_t, attn_t = _kernel_layout(locs, attn)
    g = jnp.asarray(grad.reshape(B, Q, H, D).transpose(0, 2, 3, 1).reshape(B * H, D, Q))

    @jax.jit
    def fwd_bwd(v, l, a):
        out, vjp = jax.vjp(lambda v, l, a: fn(v, SHAPES, l, a, P, BAND), v, l, a)
        return out, vjp(g)

    out, (gv, gl, ga) = fwd_bwd(_banded_values(value), jnp.asarray(locs_t), jnp.asarray(attn_t))
    out = np.asarray(out).reshape(B, H, D, Q).transpose(0, 3, 1, 2).reshape(B, Q, H * D)
    return out, (_from_banded(gv),
                 np.asarray(gl).reshape(B, H, NL, P, 2, Q).transpose(0, 5, 1, 2, 3, 4),
                 np.asarray(ga).reshape(B, H, NL, P, Q).transpose(0, 4, 1, 2, 3))


@pytest.mark.parametrize("Q", [L, 150], ids=["Q=L", "Q!=L-sorted"])
def test_op_and_gradient_match_jax(per_point, Q):
    value, locs, attn, grad = _inputs(Q, 2 + Q)
    ref_out, ref_grads = _jax_op(value, locs, attn, grad, sort=Q != L)
    leaves = [t.requires_grad_(True) for t in _t(value, locs, attn)]
    out = mb.ms_deform_attn_banded(leaves[0], SHAPES, STARTS, leaves[1], leaves[2], BAND)
    out.backward(torch.from_numpy(grad))
    np.testing.assert_allclose(out.detach().numpy(), ref_out, **GRAD_TOL)
    for name, t, r in zip(("value", "locs", "attn"), leaves, ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), r, **GRAD_TOL, err_msg=name)


def test_function_reaches_k5_and_k3():
    """The op's autograd plumbing, recorded at the dispatcher: the decoder's
    sorted, padded operands into K5's op, the output un-sorted, and K3's op
    given the reference operands and the upstream gradient."""
    Q = 150
    value, locs, attn, grad = _t(*_inputs(Q, 3))
    calls = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "ogd_torch":
                calls.append((func.__name__.split(".")[0],) + tuple(args))
            return func(*args, **(kwargs or {}))

    order, lt, px, py, wa = mb.banded_operands(locs, attn, SHAPES, L)
    assert order is not None and (wa[..., Q:] == 0).all()
    leaves = [t.clone().requires_grad_(True) for t in (value, locs, attn)]
    with Record():
        out = mb.ms_deform_attn_banded(*leaves[:1], SHAPES, STARTS, *leaves[1:], BAND)
        out.backward(grad)
    assert [c[0] for c in calls] == ["banded_fwd", "msda_bwd"]
    for got, want in zip(calls[0][3:6], (px, py, wa)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    _, v3, shapes3, starts3, l3, a3, g3 = calls[1]
    assert (shapes3, starts3) == ([v for hw in SHAPES for v in hw], list(STARTS))
    for got, want in zip((v3, l3, a3, g3), (value, locs, attn, grad)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    with torch.no_grad():
        ref = mb.ms_deform_attn_banded(value, SHAPES, STARTS, locs, attn, BAND)
    torch.testing.assert_close(out.detach(), ref, rtol=0, atol=0)
    ref_grads = msda.ms_deform_attn_bwd_plain(value, SHAPES, STARTS, locs, attn, grad)
    for t, r in zip(leaves, ref_grads):
        torch.testing.assert_close(t.grad, r, rtol=0, atol=0)


def test_launcher_takes_cuda_tensors_only():
    """K5's launcher refuses CPU tensors (a CUDA tensor never reaches the
    plain version, and a CPU one never the kernel); the op refuses a level
    order other than the raster one."""
    value = torch.zeros(1, L, 1, 32)
    taps = torch.zeros(1, NL * P, QBLOCK)
    with pytest.raises(ValueError, match="unsupported device"):
        mb.banded_fwd(value, SHAPES, taps, taps, taps)
    assert mb.banded_fwd.launches == 0
    value, locs, attn, _ = _t(*_inputs(5, 4))
    with pytest.raises(ValueError, match="raster level order"):
        mb.ms_deform_attn_banded(value, SHAPES, (0, 1, 2, 3), locs, attn)
