"""The gradient of the port's multi-scale deformable attention against the
JAX package.

K3's reference (`ms_deform_attn_bwd_plain`, which the chip smoke holds the
kernel to) and autograd through `ms_deform_attn` on CPU tensors both
differentiate the plain version; both must equal `jax.vjp` of
`ms_deform_attn_xla` for value, locations and weights, with the same
upstream gradient, at abs 1e-5 / rel 1e-5 (f32; the scatter-adds sum in
another order).  Sampling locations are continuous random draws, so no point
sits on the pixel lattice, where the one-sided derivative of floor makes
the JAX package's own jitted and eager gradients differ (ROADMAP section 3).

The registered autograd of K1's op, which the CUDA path takes too, is
checked for its plumbing on the CPU: its backward dispatches K3's op
(`ogd_torch::msda_bwd`) once, on the saved operands, whose CPU
implementation is the plain VJP; the kernels themselves run only on the
card (chip_smoke.py), and the K3 wrapper raises for any tensor not on the
card.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from open_groundingdino_tpu.ops.msda import ms_deform_attn_xla
from open_groundingdino_tpu_torch.ops import msda

SHAPES = ((8, 12), (4, 6), (2, 3), (1, 2))
B, Q, H, D, P = 2, 23, 4, 8, 3
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    L = sum(h * w for h, w in SHAPES)
    value = rng.randn(B, L, H, D).astype(np.float32)
    # some points outside the map too: their outer corners contribute nothing
    locs = rng.uniform(-0.15, 1.15, (B, Q, H, len(SHAPES), P, 2)).astype(np.float32)
    logits = rng.randn(B, Q, H, len(SHAPES) * P)
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    attn = attn.reshape(B, Q, H, len(SHAPES), P).astype(np.float32)
    grad_out = rng.randn(B, Q, H * D).astype(np.float32)
    return value, locs, attn, grad_out


def _jax_grads(value, locs, attn, grad_out):
    _, vjp = jax.vjp(lambda v, l, a: ms_deform_attn_xla(v, SHAPES, l, a),
                     jnp.asarray(value), jnp.asarray(locs), jnp.asarray(attn))
    return [np.asarray(g) for g in vjp(jnp.asarray(grad_out))]


@pytest.mark.parametrize("seed", [0, 1])
def test_bwd_wrapper_matches_jax_grad(seed):
    value, locs, attn, grad_out = _inputs(seed)
    ref = _jax_grads(value, locs, attn, grad_out)
    got = msda.ms_deform_attn_bwd_plain(*map(torch.from_numpy, (value,)), SHAPES,
                                        msda.level_starts(SHAPES), torch.from_numpy(locs),
                                        torch.from_numpy(attn), torch.from_numpy(grad_out))
    for name, g, r in zip(("value", "locs", "attn"), got, ref):
        np.testing.assert_allclose(g.numpy(), r, **TOL, err_msg=name)


def test_autograd_through_wrapper_matches_jax_grad():
    value, locs, attn, grad_out = _inputs(2)
    ref = _jax_grads(value, locs, attn, grad_out)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (value, locs, attn)]
    out = msda.ms_deform_attn(leaves[0], SHAPES, msda.level_starts(SHAPES), leaves[1], leaves[2])
    out.backward(torch.from_numpy(grad_out))
    for name, t, r in zip(("value", "locs", "attn"), leaves, ref):
        np.testing.assert_allclose(t.grad.numpy(), r, **TOL, err_msg=name)


def test_function_plumbing():
    """K1's op hands each input its own gradient through K3's op."""
    value, locs, attn, grad_out = _inputs(3)
    ref = _jax_grads(value, locs, attn, grad_out)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (value, locs, attn)]
    out = msda.msda_fwd(leaves[0], [v for hw in SHAPES for v in hw],
                        list(msda.level_starts(SHAPES)), leaves[1], leaves[2])
    calls = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            calls.append(func._overloadpacket)
            return func(*args, **(kwargs or {}))

    with Record():
        out.backward(torch.from_numpy(grad_out))
    assert calls.count(torch.ops.ogd_torch.msda_bwd) == 1
    for name, t, r in zip(("value", "locs", "attn"), leaves, ref):
        np.testing.assert_allclose(t.grad.numpy(), r, **TOL, err_msg=name)


def test_bwd_wrapper_raises_off_the_cpu():
    """The K3 wrapper takes CUDA tensors only: CPU and meta tensors raise."""
    for device in ("cpu", "meta"):
        value, locs, attn, grad_out = (torch.from_numpy(a).to(device) for a in _inputs(4))
        with pytest.raises(ValueError, match="unsupported device"):
            msda.ms_deform_attn_bwd(value, SHAPES, msda.level_starts(SHAPES), locs, attn,
                                    grad_out)
