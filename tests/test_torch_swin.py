"""The port's Swin backbone against the JAX package's, on the same weights
(JAX init, or seeded values on the JAX tree -> swin_state_dict_from_jax_params
-> load_state_dict(strict=True)).  The nano model of tests/test_torch_model.py
has one block per stage, so it never shifts its windows; this file covers
shifted and padded windows at window 7 (Swin-T) and window 12 (Swin-B/L-384),
the latter with recompute under use_checkpoint on and off."""
import numpy as np
import pytest
import torch

import jax

from open_groundingdino_tpu.models.swin import SwinConfig as JSwinConfig
from open_groundingdino_tpu.models.swin import SwinTransformer as JSwinTransformer
from open_groundingdino_tpu_torch.models.swin import SwinConfig, SwinTransformer
from open_groundingdino_tpu_torch.utils.convert import swin_state_dict_from_jax_params

IMG_H, IMG_W = 64, 96


def test_swin_shifted_padded_windows_match_jax():
    """Swin with two blocks per stage (shifted windows) and window 7 on a
    16x24-token map: every stage pads its windows, as the flagship's 200x304
    map does."""
    cfg = dict(embed_dim=8, depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4), window_size=7,
               out_indices=(1, 2, 3))
    images = np.random.RandomState(2).randn(1, IMG_H, IMG_W, 3).astype(np.float32)
    jswin = JSwinTransformer(JSwinConfig(**cfg))
    params = jax.device_get(jax.jit(jswin.init)(jax.random.PRNGKey(3), images)["params"])
    ref = jax.jit(lambda p, x: jswin.apply({"params": p}, x))(params, images)
    swin = SwinTransformer(SwinConfig(**cfg))
    swin.load_state_dict(swin_state_dict_from_jax_params(params), strict=True)
    with torch.no_grad():
        outs = swin(torch.from_numpy(images))
    assert len(outs) == len(ref) == 3
    for out, r in zip(outs, ref):
        np.testing.assert_allclose(out.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)


# ---- window 12 (Swin-B/L-384) -----------------------------------------------
SWIN12 = dict(embed_dim=8, depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4), window_size=12,
              out_indices=(1, 2, 3))
SWIN_H, SWIN_W = 160, 224       # stage maps 40x56, 20x28, 10x14, 5x7: all pad to 12s


def _seeded_params(shapes, seed):
    """Seeded random values on a flax param tree's shapes: kernels N(0, 1/fan_in),
    norm scales near 1, biases and bias tables N(0, 0.02)."""
    rng = np.random.RandomState(seed)

    def draw(path, x):
        name = jax.tree_util.keystr(path).split("'")[-2]
        n = rng.randn(*x.shape).astype(np.float32)
        if name == "kernel":
            return n / np.sqrt(np.prod(x.shape[:-1]))
        return (1.0 + 0.1 * n) if name == "scale" else 0.02 * n

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def swin12():
    """The JAX SwinTransformer's outputs and the gradient of a scalar loss
    sum_i <out_i, w_i> on seeded weights (one compile for both cases)."""
    images = np.random.RandomState(2).randn(1, SWIN_H, SWIN_W, 3).astype(np.float32)
    jswin = JSwinTransformer(JSwinConfig(**SWIN12))
    params = _seeded_params(jax.eval_shape(jswin.init, jax.random.PRNGKey(3), images)["params"],
                            3)

    def forward(p):
        return jswin.apply({"params": p}, images)

    rng = np.random.RandomState(4)
    w = [rng.randn(*o.shape).astype(np.float32) for o in jax.eval_shape(forward, params)]
    ref, grads = jax.device_get(jax.jit(
        lambda p: (lambda out, vjp: (out, vjp(w)[0]))(*jax.vjp(forward, p)))(params))
    return images, params, w, ref, swin_state_dict_from_jax_params(grads)


@pytest.mark.parametrize("use_checkpoint", [False, True])
def test_swin_window12_padded_matches_jax(swin12, use_checkpoint):
    images, params, w, ref, jgrads = swin12
    def build(remat):
        swin = SwinTransformer(SwinConfig(**SWIN12, use_checkpoint=remat)).train()
        swin.load_state_dict(swin_state_dict_from_jax_params(params), strict=True)
        return swin

    def forward_saving(swin):
        """The outputs, and the elements autograd keeps for the backward."""
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.numel()) or t,
                                                      lambda t: t):
            return swin(torch.from_numpy(images)), sum(saved)

    swin = build(use_checkpoint)
    outs, saved = forward_saving(swin)
    if use_checkpoint:   # only each block's input stays: a fraction of the plain forward's
        assert saved < forward_saving(build(False))[1] / 4
    assert len(outs) == len(ref) == 3
    for out, r in zip(outs, ref):
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(r), rtol=0,
                                   atol=1e-5 * np.abs(r).max())
    sum(torch.sum(o * torch.from_numpy(wi)) for o, wi in zip(outs, w)).backward()
    grads = {n: p.grad for n, p in swin.named_parameters()}
    assert grads.keys() == jgrads.keys()
    for name, g in grads.items():
        ref_g = jgrads[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref_g, rtol=0,
                                   atol=1e-4 * np.abs(ref_g).max(), err_msg=name)
