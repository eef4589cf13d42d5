"""The port's ResNet backbone against the JAX package's, on the same weights
(JAX init, FrozenBN statistics drawn at random, -> the port's converter ->
load_state_dict(strict=True)): the forward within 1e-5 of the largest
|reference| and the gradient of a scalar loss within 1e-4, with and without
last-stage dilation and for both return_interm_indices of the configs;
per-bottleneck recompute under use_checkpoint; the freeze policy against the
JAX package's frozen_param_keys through its make_optimizer; and the converter
against the JAX package's own."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open_groundingdino_tpu.models.resnet import ResNet as JResNet
from open_groundingdino_tpu.models.resnet import ResNetConfig as JResNetConfig
from open_groundingdino_tpu.models.resnet import frozen_param_keys as jfrozen_param_keys
from open_groundingdino_tpu.parallel.optim import make_optimizer as jmake_optimizer
from open_groundingdino_tpu.utils import torch_convert as tc
from open_groundingdino_tpu_torch.models.resnet import ResNet, ResNetConfig, frozen_param_keys
from open_groundingdino_tpu_torch.parallel.optim import make_optimizer
from open_groundingdino_tpu_torch.utils.convert import resnet_state_dict_from_jax_params

NAME = "resnet_nano_test"
IMG_H, IMG_W = 72, 100          # odd stage maps: 18x25, 9x13, 5x7, 3x4
FWD_RTOL, GRAD_RTOL = 1e-5, 1e-4


def _images(seed=0):
    return np.random.RandomState(seed).randn(2, IMG_H, IMG_W, 3).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    """One JAX init shared by the file (out_indices and dilation change no
    parameter), with FrozenBN statistics away from the identity, so that the
    fold is exercised."""
    params = jax.device_get(jax.jit(JResNet(JResNetConfig(name=NAME)).init)(
        jax.random.PRNGKey(0), _images())["params"])
    rng = np.random.RandomState(1)

    def draw(path, x):
        key = jax.tree_util.keystr(path)
        if "frozen_bn" not in key:
            return x
        name = key.split("'")[-2]
        if name == "running_var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        base = 1.0 if name == "weight" else 0.0
        return (base + 0.1 * rng.randn(*x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def _port(cfg_kw, params, use_checkpoint=False):
    model = ResNet(ResNetConfig(name=NAME, use_checkpoint=use_checkpoint, **cfg_kw))
    model.load_state_dict(resnet_state_dict_from_jax_params(params), strict=True)
    return model


def _weights(shapes, seed=5):
    """Fixed random weights of the scalar loss sum_i <out_i, w_i>."""
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for shape in shapes]


@pytest.mark.parametrize("dilation", [False, True])
@pytest.mark.parametrize("out_indices", [(1, 2, 3), (0, 1, 2, 3)])
def test_resnet_matches_jax(params, dilation, out_indices):
    cfg_kw = dict(out_indices=out_indices, dilation=dilation)
    images = _images()
    jmodel = JResNet(JResNetConfig(name=NAME, **cfg_kw))

    def forward(p):
        return jmodel.apply({"params": p}, images)

    # the outputs and the gradient of the scalar loss sum_i <out_i, w_i>
    w = _weights([o.shape for o in jax.eval_shape(forward, params)])
    ref, jgrads = jax.device_get(jax.jit(
        lambda p: (lambda out, vjp: (out, vjp(w)[0]))(*jax.vjp(forward, p)))(params))
    jgrads = resnet_state_dict_from_jax_params(jgrads)
    model = _port(cfg_kw, params).train()
    outs = model(torch.from_numpy(images))
    assert len(outs) == len(ref) == len(out_indices)
    strides = [model.cfg.strides[i] for i in out_indices]
    for out, r, s in zip(outs, ref, strides):
        r = np.asarray(r)
        assert out.shape == r.shape and out.shape[1] == -(-IMG_H // s)
        np.testing.assert_allclose(out.detach().numpy(), r, rtol=0,
                                   atol=FWD_RTOL * np.abs(r).max())
    assert dilation == (strides[-1] == 16)

    sum(torch.sum(o * torch.from_numpy(wi)) for o, wi in zip(outs, w)).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    # the JAX package's FrozenBN parameters are the port's buffers
    assert set(grads) == set(jgrads) - {n for n, _ in model.named_buffers()}
    for name, g in grads.items():
        ref_g = jgrads[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref_g, rtol=0,
                                   atol=GRAD_RTOL * np.abs(ref_g).max(), err_msg=name)


@pytest.mark.parametrize("dilation", [False, True])
def test_resnet_recompute_same_gradients_fewer_saved(params, dilation):
    """use_checkpoint: each bottleneck recomputed in the backward; gradients
    bit-identical, fewer tensors kept for the backward; eval and no-grad
    forwards are unchanged."""
    cfg_kw = dict(out_indices=(1, 2, 3), dilation=dilation)
    x = torch.from_numpy(_images(1))
    runs = {}
    for remat in (False, True):
        model = _port(cfg_kw, params, use_checkpoint=remat).train()
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.numel()) or t,
                                                      lambda t: t):
            outs = model(x)
        w = _weights([o.shape for o in outs])
        sum(torch.sum(o * torch.from_numpy(wi)) for o, wi in zip(outs, w)).backward()
        runs[remat] = ({n: p.grad for n, p in model.named_parameters()},
                       [o.detach() for o in outs], sum(saved))
        with torch.no_grad():
            plain = model.eval()(x)
        for a, b in zip(plain, runs[remat][1]):
            assert torch.equal(a, b)
    (g0, o0, n0), (g1, o1, n1) = runs[False], runs[True]
    assert all(torch.equal(a, b) for a, b in zip(o0, o1))
    assert g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k]) for k in g0)
    assert n1 < n0 / 2, (n1, n0)


@pytest.mark.parametrize("train_backbone", [True, False])
def test_freeze_policy_matches_jax(params, train_backbone):
    """After one optimizer step on all-ones gradients the port leaves
    unchanged exactly the parameters whose JAX counterparts the JAX
    make_optimizer with its frozen_param_keys leaves unchanged; of those the
    JAX package's FrozenBN parameters are the port's buffers."""
    tree = {"backbone": params}
    tx = jmake_optimizer(tree, lr=1e-4, lr_backbone=1e-5,
                         frozen_keys=jfrozen_param_keys(train_backbone))
    updates, _ = jax.jit(tx.update)(jax.tree_util.tree_map(jnp.ones_like, tree),
                                    tx.init(tree), tree)
    # each leaf's "changed" flag, carried through the converter to its torch key
    changed = jax.tree_util.tree_map(lambda u: np.full(u.shape, np.any(np.asarray(u) != 0),
                                                       np.float32), updates)
    flags = {k: bool(v.all()) for k, v in
             resnet_state_dict_from_jax_params(changed["backbone"]).items()}
    model = torch.nn.Module()
    model.backbone = torch.nn.ModuleList([_port({}, params)])
    before = {n: t.clone() for n, t in model.state_dict().items()}
    opt = make_optimizer(model, lr=1e-4, base_lr=1e-4, lr_backbone=1e-5,
                         frozen_keys=frozen_param_keys(train_backbone))
    opt.step([torch.ones_like(p) for p in opt.params], norm=1.0, finite=True)
    after = model.state_dict()
    moved = {n[len("backbone.0."):]: not torch.equal(before[n], after[n]) for n in before}
    buffers = {n[len("backbone.0."):] for n, _ in model.named_buffers()}
    assert moved.keys() == flags.keys()
    assert not any(moved[k] for k in buffers) and not any(flags[k] for k in buffers)
    assert {k for k in moved if k not in buffers and moved[k]} == \
        {k for k in flags if k not in buffers and flags[k]}
    assert any(moved.values()) == train_backbone


def test_converter_round_trip_exact(params):
    """The JAX tree through the port's converter and back through the JAX
    package's convert_resnet_state_dict is the same tree, leaf for leaf."""
    sd = {k[len("body."):]: v.numpy() for k, v in resnet_state_dict_from_jax_params(params).items()}
    back = jax.device_get(tc.convert_resnet_state_dict(sd, JResNetConfig(name=NAME).depths))
    ref_leaves, ref_def = jax.tree_util.tree_flatten(params)
    got_leaves, got_def = jax.tree_util.tree_flatten(back)
    assert ref_def == got_def
    for a, b in zip(ref_leaves, got_leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert set(ResNet(ResNetConfig(name=NAME)).state_dict()) == {"body." + k for k in sd}


NANO_MAIN_CFG = """
_base_ = {base!r}
backbone = "resnet_nano_test"
hidden_dim = 32
nheads = 4
enc_layers = 2
dec_layers = 2
dim_feedforward = 64
num_queries = 30
max_text_len = 32
bert_vocab_size = 200
bert_hidden_size = 32
bert_layers = 1
bert_heads = 4
bert_intermediate = 32
bert_max_position = 64
image_buckets = [(96, 128), (128, 96), (128, 128)]
data_aug_scales = [96]
data_aug_max_size = 128
data_aug_scales2_resize = [96]
data_aug_scales2_crop = [64, 96]
max_gt_boxes = 8
"""


def test_main_freezes_what_jax_names(tmp_path):
    """The port's main on a nano ResNet model: the optimizer freezes the
    stem and layer1 (the parameters test_freeze_policy_matches_jax holds
    against the JAX package's frozen_param_keys(True)); after a training
    step they and every FrozenBN buffer are bit-exact, and every other trunk
    parameter has moved."""
    import os

    import chip_smoke
    from open_groundingdino_tpu_torch import main as port_main

    base = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "open_groundingdino_tpu_torch", "config", "cfg_base.py")
    cfg, vocab, ckpt = (str(tmp_path / n) for n in ("cfg.py", "vocab.txt", "ckpt.pth"))
    with open(cfg, "w") as f:
        f.write(NANO_MAIN_CFG.format(base=base))
    chip_smoke.write_vocab(vocab, 200)
    chip_smoke.write_checkpoint(cfg, ckpt, random_biases=True)
    manifest = chip_smoke.write_odvg(str(tmp_path))
    cli = port_main.get_args_parser().parse_args([
        "-c", cfg, "--datasets", manifest, "--output_dir", str(tmp_path / "out"),
        "--vocab", vocab, "--pretrain_model_path", ckpt, "--device", "cpu",
        "--num_workers", "0", "--max_steps", "1", "--print_freq", "100",
        "--options", "epochs=1", "batch_size=4", "compute_dtype=float32"])
    state = port_main.main(cli)["state"]
    before = torch.load(ckpt, weights_only=True)["model"]
    after = state.model.state_dict()
    trunk = {k: not torch.equal(before[k], after[k]) for k in after
             if k.startswith("backbone.0.body.")}
    buffers = {n for n, _ in state.model.named_buffers()}
    frozen = {n for n, label in state.optimizer.labels.items() if label == "frozen"}
    assert frozen == {k for k in trunk if k not in buffers and k.startswith(
        ("backbone.0.body.conv1.", "backbone.0.body.layer1."))}
    assert all(not moved for k, moved in trunk.items() if k in frozen or k in buffers)
    assert all(moved for k, moved in trunk.items() if k not in frozen and k not in buffers)
