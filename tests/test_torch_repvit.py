"""The port's RepViT + Semantic-FPN car segmentor (pave/repvit_seg.py)
against the JAX package's, on the same weights.

A nano_test segmentor with seeded weights on the JAX package's parameter
tree (jax.eval_shape of its init_segmentor_params: kernels N(0, 1/fan_in),
FrozenBN and GroupNorm scales near 1, biases N(0, 0.1), so no term sits at
its init's identity or zero) is carried across by
utils/convert.repvit_state_dict_from_jax_params: backbone features and
logits within 1e-4 at 64x96 and at 76x100, whose level sizes (19x25 ->
10x13 -> 5x7 -> 3x4) take the nearest resize's rounding rule and the
capped bilinear upsample; derive_car_bbox on a 90x160 frame at
infer_size=(64, 128), where the input resize antialiases; the .pth round
trip; and the M1.1 state dict against the JAX M1.1 tree.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open_groundingdino_tpu.pave import repvit_seg as jseg
from open_groundingdino_tpu_torch.pave import repvit_seg as seg
from open_groundingdino_tpu_torch.utils.convert import repvit_state_dict_from_jax_params

NANO = "nano_test"
TOL = 1e-4


@pytest.fixture(scope="module")
def nano():
    """(JAX params, the port's segmentor) on the same weights."""
    shapes = jax.eval_shape(lambda: jseg.init_segmentor_params(jseg.RepViTConfig.from_name(NANO)))
    rng = np.random.RandomState(3)

    def draw(path, x):
        name = jax.tree_util.keystr(path).split("'")[-2]
        n = rng.randn(*x.shape).astype(np.float32)
        if name == "kernel":
            return n / np.sqrt(np.prod(x.shape[:-1]))
        return (1.0 + 0.2 * n) if name == "scale" else 0.1 * n

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    model = seg.RepViTSegmentor(seg.RepViTConfig.from_name(NANO)).eval()
    model.load_state_dict(repvit_state_dict_from_jax_params(params), strict=True)
    return params, model


def _image(h, w, seed):
    return np.random.RandomState(seed).randn(1, h, w, 3).astype(np.float32)


@pytest.mark.parametrize("hw", [(64, 96), (76, 100)])
def test_features_and_logits_match_jax(nano, hw):
    params, model = nano
    cfg = jseg.RepViTConfig.from_name(NANO)
    x = _image(*hw, seed=hw[0])
    logits_j, state = jax.jit(lambda p, x: jseg.RepViTSegmentor(cfg).apply(
        p, x, capture_intermediates=lambda mdl, _: isinstance(mdl, jseg.RepViTBackbone)))(
        params, jnp.asarray(x))
    feats_j = state["intermediates"]["backbone"]["__call__"][0]
    logits_j = np.asarray(logits_j)
    with torch.no_grad():
        feats_t = model.backbone(torch.from_numpy(x))
        logits_t = model(torch.from_numpy(x)).numpy()
    assert [tuple(f.shape) for f in feats_t] == [f.shape for f in feats_j]
    for f_t, f_j in zip(feats_t, feats_j):
        f_j = np.asarray(f_j)
        np.testing.assert_allclose(f_t.numpy(), f_j, rtol=TOL, atol=TOL * np.abs(f_j).max())
    assert logits_t.shape == logits_j.shape == (1, *hw, 2)
    np.testing.assert_allclose(logits_t, logits_j, rtol=TOL, atol=TOL)
    # the mask (jseg.segment_car_mask's argmax) where the JAX margin is clear
    # of the tolerance
    margin = np.abs(logits_j[..., 1] - logits_j[..., 0])
    mask_t = seg.segment_car_mask(model, x).numpy()
    mask_j = np.argmax(logits_j, -1) == cfg.car_class
    clear = margin > 4 * TOL
    assert clear.mean() > 0.9 and 0.05 < mask_j.mean() < 0.95
    np.testing.assert_array_equal(mask_t[clear], mask_j[clear])


def test_resizes_match_jax():
    """The two resizes against jax.image.resize: nearest at FPN upsamples
    (n -> 2n - 1, 2n) where F.interpolate's "nearest-exact" picks another
    pixel (42 -> 83, 80 -> 159, 90 -> 179: 15 such sizes below 400) or the
    exact quotient does (50 -> 99, 58 -> 115, 92 -> 183: 22), and at other
    sizes; bilinear where it shrinks (antialiased), grows, and both."""
    sizes = [(42, 83), (80, 159), (90, 179), (50, 99), (58, 115), (92, 183), (10, 19),
             (4, 7), (2, 3), (19, 38), (76, 82), (76, 94), (78, 121), (20, 25), (13, 13)]
    for m, n in sizes:
        ref = jax.image.resize(jnp.arange(m, dtype=jnp.float32), (n,), "nearest")
        np.testing.assert_array_equal(seg.nearest_index(m, n), np.asarray(ref).astype(np.int64))
    rng = np.random.RandomState(5)
    x = rng.randn(1, 3, 19, 76).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (1, 3, 38, 83), "nearest")
    np.testing.assert_array_equal(seg.resize_nearest(torch.from_numpy(x), (38, 83)).numpy(),
                                  np.asarray(ref))
    for hw in ((10, 40), (38, 100), (12, 160)):
        ref = jax.image.resize(jnp.asarray(x), (1, 3, *hw), "bilinear")
        np.testing.assert_allclose(seg.resize_bilinear(torch.from_numpy(x), hw).numpy(),
                                   np.asarray(ref), atol=1e-5)


def test_derive_car_bbox_matches_jax(nano):
    params, model = nano
    cfg = jseg.RepViTConfig.from_name(NANO)
    frame = np.random.RandomState(7).randint(0, 256, (90, 160, 3)).astype(np.uint8)
    x_t = seg.frame_input(frame, (64, 128), "cpu").numpy()
    x_j = jax.image.resize(jnp.asarray(frame, jnp.float32)[None] / 255.0, (1, 64, 128, 3),
                           method="bilinear")
    x_j = np.asarray((x_j - jnp.asarray(seg.IMAGENET_MEAN)) / jnp.asarray(seg.IMAGENET_STD))
    np.testing.assert_allclose(x_t, x_j, atol=1e-5)
    bbox_t = seg.derive_car_bbox(model, frame, infer_size=(64, 128))
    bbox_j = jseg.derive_car_bbox(params, frame, cfg, infer_size=(64, 128))
    assert bbox_t is not None and bbox_t == bbox_j
    # an empty mask gives no box, as in the JAX package
    with torch.no_grad():
        model.head.cls.bias.copy_(torch.tensor([1e4, -1e4]))
    try:
        assert seg.derive_car_bbox(model, frame, infer_size=(64, 128)) is None
    finally:
        model.load_state_dict(repvit_state_dict_from_jax_params(params), strict=True)


def test_mask_to_bbox_and_config():
    mask = np.zeros((40, 60), bool)
    mask[10:25, 7:31] = True
    mask[5, 50] = True
    assert seg.car_mask_to_bbox(mask) == jseg.car_mask_to_bbox(mask) == (7.0, 5.0, 50.0, 24.0)
    assert seg.car_mask_to_bbox(torch.from_numpy(mask)) == (7.0, 5.0, 50.0, 24.0)
    assert seg.car_mask_to_bbox(np.zeros((4, 4), bool)) is None
    for name in ("m0_9", "repvit_m0_9", "m1_1", "repvit_m1_1", "m1_5", "repvit_m1_5", "m2_3",
                 "repvit_m2_3", "nano_test"):
        j, t = jseg.RepViTConfig.from_name(name), seg.RepViTConfig.from_name(name)
        assert (t.widths, t.depths, t.num_classes, t.car_class, t.fpn_dim) == (
            j.widths, j.depths, j.num_classes, j.car_class, j.fpn_dim)
    with pytest.raises(ValueError):
        seg.RepViTConfig.from_name("m9")


def test_save_load_roundtrip(nano, tmp_path):
    _, model = nano
    path = str(tmp_path / "seg.pth")
    seg.save_segmentor(model, path)
    loaded = seg.load_segmentor(path, seg.RepViTConfig.from_name(NANO), device="cpu")
    for (k, a), (k2, b) in zip(model.state_dict().items(), loaded.state_dict().items()):
        assert k == k2 and torch.equal(a, b)
    x = torch.from_numpy(_image(64, 64, 1))
    with torch.no_grad():
        assert torch.equal(model(x), loaded(x))
    with pytest.raises(RuntimeError):   # another variant's shapes
        seg.load_segmentor(path, seg.RepViTConfig(widths=(8, 16, 24, 40), depths=(1, 1, 2, 1),
                                                  fpn_dim=16), device="cpu")


def test_fold_torch_bn():
    rng = np.random.RandomState(2)
    sd = {f"bn.{k}": torch.from_numpy(rng.rand(6).astype(np.float32) + 0.5)
          for k in ("weight", "bias", "running_mean", "running_var")}
    got = seg.fold_torch_bn(sd, "bn")
    ref = jseg.fold_torch_bn({k: v.numpy() for k, v in sd.items()}, "bn")
    for k in ("scale", "bias"):
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-6)
    bn = torch.nn.BatchNorm2d(6).eval()
    bn.load_state_dict({k[3:]: v for k, v in sd.items()}, strict=False)
    frozen = seg.FrozenBN(6)
    frozen.load_state_dict(got)
    x = torch.from_numpy(rng.randn(2, 6, 3, 4).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(frozen(x), bn(x), rtol=1e-5, atol=1e-5)


def test_m1_1_state_dict_matches_jax_tree():
    """The M1.1 segmentor's keys and shapes against the JAX package's
    init_segmentor_params at the default config (shapes only)."""
    shapes = jax.eval_shape(lambda: jseg.init_segmentor_params())
    converted = repvit_state_dict_from_jax_params(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes))
    port = seg.RepViTSegmentor().state_dict()
    assert set(converted) == set(port)
    assert len(port) == len(jax.tree_util.tree_leaves(shapes))
    for k, v in port.items():
        assert tuple(converted[k].shape) == tuple(v.shape), k
    assert seg.RepViTSegmentor().backbone.stage2_block0.mixer.dw3.conv.groups == 256
