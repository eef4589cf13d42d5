"""The gradient of the port's image<->text fusion attention against the JAX
package.

The port's BiMultiHeadAttention (its core on CPU tensors is the plain
version, differentiated by autograd) against `jax.grad` of the JAX
BiMultiHeadAttention(impl='xla') on the same weights: gradients of the
inputs and of every projection, at abs 1e-5 / rel 1e-4 (f32, sums in
another order).  One case makes the +-50000 clamps bind, where the plain
version's max shifts must be constants to autograd, as `stop_gradient`
makes them in the JAX package.

The registered autograd of K2's op is checked too: its backward dispatches
K4's op (`ogd_torch::fusion_bwd`) on K2's outputs and statistics, whose CPU
implementation is the plain backward; the kernels themselves run only on
the card (chip_smoke.py), and the K4 wrapper raises for any tensor not on
the card.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax

from open_groundingdino_tpu.models.layers import BiMultiHeadAttention as JBiMultiHeadAttention
from open_groundingdino_tpu_torch.models.layers import BiMultiHeadAttention
from open_groundingdino_tpu_torch.ops import fusion

B, NV, NL, V_DIM, L_DIM, E, H = 2, 70, 12, 24, 20, 32, 4
TOL = dict(rtol=1e-4, atol=1e-5)
PROJS = ("v_proj", "l_proj", "values_v_proj", "values_l_proj", "out_v_proj", "out_l_proj")


def _inputs(seed):
    rng = np.random.RandomState(seed)
    v = rng.randn(B, NV, V_DIM).astype(np.float32)
    l = rng.randn(B, NL, L_DIM).astype(np.float32)
    mask_v = np.zeros((B, NV), bool)
    mask_v[0, -9:] = True
    mask_l = np.zeros((B, NL), bool)
    mask_l[1, -4:] = True
    g_v = rng.randn(B, NV, V_DIM).astype(np.float32)
    g_l = rng.randn(B, NL, L_DIM).astype(np.float32)
    return v, l, mask_v, mask_l, g_v, g_l


def _port_module(params):
    mod = BiMultiHeadAttention(V_DIM, L_DIM, E, H)
    sd = {}
    for n in PROJS:
        sd[f"{n}.weight"] = torch.from_numpy(np.array(params[n]["kernel"]).T)
        sd[f"{n}.bias"] = torch.from_numpy(np.array(params[n]["bias"]))
    mod.load_state_dict(sd)
    return mod


def _compare(params, v, l, mask_v, mask_l, g_v, g_l):
    jmod = JBiMultiHeadAttention(V_DIM, L_DIM, E, H, impl="xla")

    def scalar(p, v_, l_):
        ov, ol = jmod.apply({"params": p}, v_, l_, mask_v, mask_l)
        return (ov * g_v).sum() + (ol * g_l).sum()

    gp, gv, gl = jax.jit(jax.grad(scalar, argnums=(0, 1, 2)))(params, v, l)
    mod = _port_module(params)
    tv, tl = (torch.from_numpy(a).requires_grad_(True) for a in (v, l))
    ov, ol = mod(tv, tl, torch.from_numpy(mask_v), torch.from_numpy(mask_l))
    ((ov * torch.from_numpy(g_v)).sum() + (ol * torch.from_numpy(g_l)).sum()).backward()
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(gv), **TOL, err_msg="v")
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(gl), **TOL, err_msg="l")
    for n in PROJS:
        lin = getattr(mod, n)
        np.testing.assert_allclose(lin.weight.grad.numpy().T, np.asarray(gp[n]["kernel"]),
                                   **TOL, err_msg=n)
        np.testing.assert_allclose(lin.bias.grad.numpy(), np.asarray(gp[n]["bias"]), **TOL,
                                   err_msg=n)


def test_grad_matches_jax():
    v, l, mask_v, mask_l, g_v, g_l = _inputs(0)
    jmod = JBiMultiHeadAttention(V_DIM, L_DIM, E, H, impl="xla")
    params = jax.device_get(jax.jit(jmod.init)(jax.random.PRNGKey(0), v, l, mask_v, mask_l)["params"])
    _compare(params, v, l, mask_v, mask_l, g_v, g_l)


def test_grad_matches_jax_where_the_clamps_bind():
    """Logits spread over ~1e6: after the global-max shift many fall below
    -50000 and are clamped.  The gradient must not flow through the max
    shifts (with them differentiable, this case fails at 1e-4)."""
    v, l, mask_v, mask_l, g_v, g_l = _inputs(1)
    jmod = JBiMultiHeadAttention(V_DIM, L_DIM, E, H, impl="xla")
    params = jax.device_get(jax.jit(jmod.init)(jax.random.PRNGKey(1), v, l, mask_v, mask_l)["params"])
    rng = np.random.RandomState(2)
    params["v_proj"]["kernel"] = (params["v_proj"]["kernel"] * 5e4).astype(np.float32)
    v = (v * rng.uniform(0.2, 1.2, (B, NV, 1))).astype(np.float32)
    mod = _port_module(params)
    with torch.no_grad():
        q = mod.v_proj(torch.from_numpy(v)) * mod.scale
        k = mod.l_proj(torch.from_numpy(l))
        logits = torch.einsum("bvhd,blhd->bhvl", q.view(B, NV, H, -1), k.view(B, NL, H, -1))
    shifted = logits - logits.max()
    assert (shifted < -5e4).any() and (shifted > -5e4).any()   # the clamp binds, not everywhere
    _compare(params, v, l, mask_v, mask_l, g_v, g_l)


def test_bwd_wrapper_cpu_path_and_function_plumbing():
    rng = np.random.RandomState(3)
    q = torch.from_numpy((rng.randn(B, NV, E) * (E // H) ** -0.5).astype(np.float32))
    k, val_l = (torch.from_numpy(rng.randn(B, NL, E).astype(np.float32)) for _ in range(2))
    val_v = torch.from_numpy(rng.randn(B, NV, E).astype(np.float32))
    _, _, mask_v, mask_l, _, _ = _inputs(3)
    mask_v, mask_l = torch.from_numpy(mask_v), torch.from_numpy(mask_l)
    g_ov = torch.from_numpy(rng.randn(B, NV, E).astype(np.float32))
    g_ol = torch.from_numpy(rng.randn(B, NL, E).astype(np.float32))
    ref = fusion.fused_bi_attention_bwd_plain(q, k, val_v, val_l, mask_v, mask_l, g_ov, g_ol, H)

    with pytest.raises(ValueError, match="unsupported device"):   # CUDA tensors only
        fusion.fused_bi_attention_bwd(q, k, val_v, val_l, mask_v, mask_l, q, k, None, None,
                                      g_ov, g_ol, H)

    calls = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._overloadpacket == torch.ops.ogd_torch.fusion_bwd:
                calls.append(args)
            return func(*args, **(kwargs or {}))

    leaves = [t.clone().requires_grad_(True) for t in (q, k, val_v, val_l)]
    out_v, out_l = fusion.fused_bi_attention(*leaves, mask_v, mask_l, H)
    with Record():
        torch.autograd.backward((out_v, out_l), (g_ov, g_ol))
    assert len(calls) == 1
    saved = calls[0]
    assert saved[6].shape == q.shape and saved[9].shape == (B, H, NL)   # what K2 saved
    torch.testing.assert_close(saved[6], out_v.detach(), rtol=0, atol=0)
    for t, r in zip(leaves, ref):
        torch.testing.assert_close(t.grad, r, rtol=0, atol=0)


def test_bwd_wrapper_raises_off_the_cpu():
    meta = [torch.zeros(1, 4, 1024, device="meta")] * 4
    masks = [torch.zeros(1, 4, dtype=torch.bool, device="meta")] * 2
    with pytest.raises(ValueError, match="unsupported device"):
        fusion.fused_bi_attention_bwd(*meta, *masks, *meta, *meta[:2], 4)
