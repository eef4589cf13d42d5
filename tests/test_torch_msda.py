"""The port's multi-scale deformable attention against the JAX package.

`ms_deform_attn_plain` (the CPU side of K1) against `ms_deform_attn_xla` and
against the Pallas banded kernel in interpret mode; the port's MSDeformAttn
module against the JAX MSDeformAttn(impl='xla') on the same weights, with
2-d (encoder) and 4-d (decoder) reference points and a padding mask.
Inputs come from numpy with a seed.  Tolerance abs 1e-5: both sides sum the
same 64 taps in f32, in the same order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open_groundingdino_tpu.models.deformable import MSDeformAttn as JMSDeformAttn
from open_groundingdino_tpu.ops.msda import ms_deform_attn_xla
from open_groundingdino_tpu.ops.msda_banded import ms_deform_attn_banded
from open_groundingdino_tpu_torch.models.deformable import MSDeformAttn
from open_groundingdino_tpu_torch.ops.msda import (
    level_starts,
    ms_deform_attn,
    ms_deform_attn_plain,
)

SHAPES = ((8, 12), (4, 6), (2, 3), (1, 2))
L = sum(h * w for h, w in SHAPES)
NL, P = 4, 4
TOL = 1e-5


def _core_inputs(rng, B, Q, H, D, lo=-0.1, hi=1.1):
    value = rng.randn(B, L, H, D).astype(np.float32)
    locs = rng.uniform(lo, hi, (B, Q, H, NL, P, 2)).astype(np.float32)
    attn = rng.uniform(0, 1, (B, Q, H, NL, P)).astype(np.float32)
    return value, locs, attn


def _plain(value, locs, attn):
    return ms_deform_attn_plain(torch.from_numpy(value), SHAPES, level_starts(SHAPES),
                                torch.from_numpy(locs), torch.from_numpy(attn)).numpy()


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.3, 1.3)], ids=["inside", "zero-padded"])
def test_plain_matches_xla(lo, hi):
    value, locs, attn = _core_inputs(np.random.RandomState(0), B=2, Q=37, H=3, D=8, lo=lo, hi=hi)
    ref = jax.jit(lambda v, l, a: ms_deform_attn_xla(v, SHAPES, l, a))(value, locs, attn)
    np.testing.assert_allclose(_plain(value, locs, attn), np.asarray(ref), rtol=0, atol=TOL)


def test_plain_matches_banded_kernel_interpret():
    """The TPU kernel K1 (interpret mode), called as tests/test_msda_banded.py
    calls it: per-level (B*H, h*D, w) values, (B*H, NL, P, 2, Q) locations."""
    B, H, D = 1, 2, 8
    value, locs, attn = _core_inputs(np.random.RandomState(1), B=B, Q=L, H=H, D=D)
    values, start = [], 0
    for h, w in SHAPES:
        vl = value[:, start:start + h * w].reshape(B, h, w, H, D)
        values.append(np.ascontiguousarray(vl.transpose(0, 3, 1, 4, 2).reshape(B * H, h * D, w)))
        start += h * w
    locs_t = np.ascontiguousarray(locs.transpose(0, 2, 3, 4, 5, 1).reshape(B * H, NL, P, 2, L))
    attn_t = np.ascontiguousarray(attn.transpose(0, 2, 3, 4, 1).reshape(B * H, NL, P, L))
    out = jax.jit(lambda vs, l, a: ms_deform_attn_banded(vs, SHAPES, l, a, P))(
        tuple(values), locs_t, attn_t)                       # (B*H, D, Q)
    out = np.asarray(out).reshape(B, H, D, L).transpose(0, 3, 1, 2).reshape(B, L, H * D)
    np.testing.assert_allclose(_plain(value, locs, attn), out, rtol=0, atol=TOL)


@pytest.mark.parametrize("ref_dim", [2, 4], ids=["encoder-2d-refs", "decoder-4d-refs"])
def test_module_matches_jax(ref_dim):
    B, C, H = 2, 32, 4
    Q = L if ref_dim == 2 else 30
    rng = np.random.RandomState(ref_dim)
    query = rng.randn(B, Q, C).astype(np.float32)
    value = rng.randn(B, L, C).astype(np.float32)
    if ref_dim == 2:
        refs = rng.uniform(0.05, 0.95, (B, Q, NL, 2)).astype(np.float32)
    else:
        refs = np.concatenate([rng.uniform(0.1, 0.9, (B, Q, NL, 2)),
                               rng.uniform(0.05, 0.4, (B, Q, NL, 2))], -1).astype(np.float32)
    pad = np.zeros((B, L), bool)
    pad[1, 80:96] = True          # sample 1: the last rows of level 0 are padding

    jmod = JMSDeformAttn(C, H, NL, P, impl="xla")
    args = (jnp.asarray(query), jnp.asarray(value), jnp.asarray(refs), SHAPES, jnp.asarray(pad))
    params = jax.device_get(jax.jit(jmod.init, static_argnums=4)(
        jax.random.PRNGKey(0), *args[:3], SHAPES, args[4])["params"])
    # the reference init has zero offset / weight kernels; make every sampling
    # point depend on its query, as in a trained model
    for name in ("sampling_offsets", "attention_weights"):
        k = params[name]["kernel"]
        params[name]["kernel"] = (k + 0.05 * rng.randn(*k.shape)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, q, v, r, m: jmod.apply({"params": p}, q, v, r, SHAPES, m))(
        params, *(args[i] for i in (0, 1, 2, 4))))

    mod = MSDeformAttn(C, H, NL, P)
    mod.load_state_dict({f"{n}.{t}": torch.from_numpy(np.array(
        params[n]["kernel"].T if t == "weight" else params[n]["bias"]))
        for n in ("value_proj", "sampling_offsets", "attention_weights", "output_proj")
        for t in ("weight", "bias")})
    with torch.no_grad():
        out = mod(torch.from_numpy(query), torch.from_numpy(value), torch.from_numpy(refs),
                  SHAPES, torch.from_numpy(pad)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)


def test_init_matches_jax_rotated_grid():
    """The reference init: zero offset kernel, rotated-grid offset bias, zero
    attention-weight projection."""
    jmod = JMSDeformAttn(16, 4, NL, P, impl="xla")
    x = jnp.zeros((1, L, 16))
    params = jax.jit(jmod.init, static_argnums=4)(
        jax.random.PRNGKey(0), x, x, jnp.full((1, L, NL, 2), 0.5), SHAPES)["params"]
    mod = MSDeformAttn(16, 4, NL, P)
    mod.init_weights_(torch.Generator().manual_seed(0))
    for name in ("sampling_offsets", "attention_weights"):
        lin = getattr(mod, name)
        np.testing.assert_array_equal(lin.bias.detach().numpy(), np.asarray(params[name]["bias"]))
        assert not lin.weight.detach().any()


def test_wrapper_takes_plain_version_only_for_cpu_tensors():
    """A CPU tensor takes the plain version (no launch counted); a tensor on
    another non-CUDA device is refused rather than computed elsewhere."""
    value, locs, attn = (torch.from_numpy(a) for a in
                         _core_inputs(np.random.RandomState(2), B=1, Q=5, H=2, D=4))
    before = ms_deform_attn.launches
    out = ms_deform_attn(value, SHAPES, level_starts(SHAPES), locs, attn)
    assert out.shape == (1, 5, 8) and ms_deform_attn.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        ms_deform_attn(value.to("meta"), SHAPES, level_starts(SHAPES), locs.to("meta"),
                       attn.to("meta"))
