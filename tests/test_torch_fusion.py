"""The port's image<->text fusion attention against the JAX package.

The plain version of K2 (`fused_bi_attention_plain`, what the wrapper runs on
CPU tensors) and the port's BiMultiHeadAttention / BiAttentionBlock against
the JAX BiMultiHeadAttention(impl='xla') on the same weights, and against
the Pallas fusion kernel in interpret mode.  The kernel leaves padded text
rows of out_l near-uniform (ops/fusion_pallas.py:123-130) where the literal
formulation computes them, so against the kernel out_l is compared on live
text tokens only.  Tolerance abs 1e-5 / rel 1e-4 (f32, softmax sums in a
different order in the kernel).
"""
import numpy as np
import pytest
import torch

import jax

from open_groundingdino_tpu.models.layers import BiAttentionBlock as JBiAttentionBlock
from open_groundingdino_tpu.models.layers import BiMultiHeadAttention as JBiMultiHeadAttention
from open_groundingdino_tpu.ops.fusion_pallas import fused_bi_attention as pallas_bi_attention
from open_groundingdino_tpu_torch.models.layers import BiAttentionBlock, BiMultiHeadAttention
from open_groundingdino_tpu_torch.ops.fusion import (
    fused_bi_attention,
    fused_bi_attention_plain,
)

B, NV, NL, V_DIM, L_DIM, E, H = 2, 150, 16, 24, 20, 32, 4
ATOL, RTOL = 1e-5, 1e-4
PROJS = ("v_proj", "l_proj", "values_v_proj", "values_l_proj", "out_v_proj", "out_l_proj")


def _inputs(seed):
    rng = np.random.RandomState(seed)
    v = rng.randn(B, NV, V_DIM).astype(np.float32)
    l = rng.randn(B, NL, L_DIM).astype(np.float32)
    mask_v = np.zeros((B, NV), bool)
    mask_v[0, -17:] = True
    mask_l = np.zeros((B, NL), bool)
    mask_l[1, -5:] = True
    return v, l, mask_v, mask_l


def _linear_sd(tree, prefix=""):
    return {**{f"{prefix}{n}.weight": torch.from_numpy(np.array(tree[n]["kernel"]).T)
               for n in PROJS},
            **{f"{prefix}{n}.bias": torch.from_numpy(np.array(tree[n]["bias"])) for n in PROJS}}


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_bi_multihead_attention_matches_jax():
    v, l, mask_v, mask_l = _inputs(0)
    jmod = JBiMultiHeadAttention(V_DIM, L_DIM, E, H, impl="xla")
    params = jax.device_get(
        jax.jit(jmod.init)(jax.random.PRNGKey(0), v, l, mask_v, mask_l)["params"])
    ref_v, ref_l = jax.jit(lambda p, *a: jmod.apply({"params": p}, *a))(
        params, v, l, mask_v, mask_l)

    mod = BiMultiHeadAttention(V_DIM, L_DIM, E, H)
    mod.load_state_dict(_linear_sd(params))
    with torch.no_grad():
        out_v, out_l = mod(*_t(v, l, mask_v, mask_l))
    # the same literal formulation on both sides: every row agrees
    np.testing.assert_allclose(out_v.numpy(), np.asarray(ref_v), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out_l.numpy(), np.asarray(ref_l), rtol=RTOL, atol=ATOL)


def test_bi_attention_block_matches_jax():
    v, l, mask_v, mask_l = _inputs(1)
    jmod = JBiAttentionBlock(V_DIM, L_DIM, E, H, fusion_impl="xla")
    params = jax.device_get(
        jax.jit(jmod.init)(jax.random.PRNGKey(1), v, l, mask_v, mask_l)["params"])
    rng = np.random.RandomState(1)
    for name in ("gamma_v", "gamma_l"):   # non-trivial layer scales
        params[name] = rng.uniform(0.5, 1.5, params[name].shape).astype(np.float32)
    ref_v, ref_l = jax.jit(lambda p, *a: jmod.apply({"params": p}, *a))(
        params, v, l, mask_v, mask_l)

    mod = BiAttentionBlock(V_DIM, L_DIM, E, H)
    sd = _linear_sd(params["attn"], "attn.")
    for n in ("layer_norm_v", "layer_norm_l"):
        sd[f"{n}.weight"] = torch.from_numpy(np.array(params[n]["scale"]))
        sd[f"{n}.bias"] = torch.from_numpy(np.array(params[n]["bias"]))
    sd["gamma_v"], sd["gamma_l"] = _t(params["gamma_v"], params["gamma_l"])
    mod.load_state_dict(sd)
    with torch.no_grad():
        out_v, out_l = mod(*_t(v, l, mask_v, mask_l))
    np.testing.assert_allclose(out_v.numpy(), np.asarray(ref_v), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out_l.numpy(), np.asarray(ref_l), rtol=RTOL, atol=ATOL)


def test_plain_matches_fusion_kernel_interpret():
    """The TPU kernel K2 (interpret mode) on the raw (B, N, E) projections,
    q pre-scaled, with image and text padding and Nv not a multiple of the
    kernel's 128-token block."""
    rng = np.random.RandomState(7)
    q = (rng.randn(B, NV, E) * (E // H) ** -0.5).astype(np.float32)
    k, val_l = (rng.randn(B, NL, E).astype(np.float32) for _ in range(2))
    val_v = rng.randn(B, NV, E).astype(np.float32)
    _, _, mask_v, mask_l = _inputs(7)
    ref_v, ref_l = jax.jit(lambda *a: pallas_bi_attention(*a, num_heads=H))(
        q, k, val_v, val_l, mask_v, mask_l)
    out_v, out_l = fused_bi_attention_plain(*_t(q, k, val_v, val_l, mask_v, mask_l), H)
    np.testing.assert_allclose(out_v.numpy(), np.asarray(ref_v), rtol=RTOL, atol=ATOL)
    live_l = ~mask_l
    np.testing.assert_allclose(out_l.numpy()[live_l], np.asarray(ref_l)[live_l],
                               rtol=RTOL, atol=ATOL)


def test_wrapper_takes_plain_version_only_for_cpu_tensors():
    rng = np.random.RandomState(3)
    q, val_v = (torch.from_numpy(rng.randn(1, 9, E).astype(np.float32)) for _ in range(2))
    k, val_l = (torch.from_numpy(rng.randn(1, 4, E).astype(np.float32)) for _ in range(2))
    mask_v, mask_l = torch.zeros(1, 9, dtype=torch.bool), torch.zeros(1, 4, dtype=torch.bool)
    before = fused_bi_attention.launches
    out_v, out_l = fused_bi_attention(q, k, val_v, val_l, mask_v, mask_l, H)
    assert out_v.shape == (1, 9, E) and out_l.shape == (1, 4, E)
    assert fused_bi_attention.launches == before
    meta = [t.to("meta") for t in (q, k, val_v, val_l, mask_v, mask_l)]
    with pytest.raises(ValueError, match="unsupported device"):
        fused_bi_attention(*meta, H)
