"""The port's training step against the JAX package's make_train_step.

A nano GroundingDINO (1 + 1 layers) from the port's seeded init (sampling
offsets perturbed off the pixel lattice, ROADMAP section 3), carried into the
JAX tree by the JAX package's reference-checkpoint converter (no JAX init to
compile), goes into both packages (the port with checkpointing on; fusion
droppath 0, f32).  Both take two steps on the same batch with the same
AdamW settings:
  * the losses agree at rel 1e-5;
  * the first step's gradients, the JAX tree carried through the same
    converter, agree key by key within 1e-4 of each tensor's largest |grad|
    plus 1e-6 of the model's largest |grad| (f32 sums in another order
    through ~30 layers; a few gradients are exactly zero and rounding on
    both sides: the attention key biases, since softmax ignores a per-row
    constant, and at this width the biases ahead of a GroupNorm with one
    channel per group);
  * the parameters after two steps agree at abs 2e-6: each Adam step moves a
    parameter by at most lr = 1e-4, and g / (|g| + eps) magnifies the
    gradients' rounding where |g| is small.
Then, on the port alone: a non-finite batch changes nothing, float16 and
bf16 on the sweep MSDA kernels raise, the fusion
block's stochastic depth keeps samples at rate 1 - p scaled by 1 / (1 - p)
in training mode only, checkpointing gives the same
gradients with stochastic depth active, and a training forward may follow a
serving one in the same process.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from open_groundingdino_tpu.models.bert import BertConfig as JBertConfig
from open_groundingdino_tpu.models.criterion import SetCriterion as JSetCriterion
from open_groundingdino_tpu.models.groundingdino import GroundingDINO as JGroundingDINO
from open_groundingdino_tpu.models.swin import SwinConfig as JSwinConfig
from open_groundingdino_tpu.parallel.optim import make_optimizer as jmake_optimizer
from open_groundingdino_tpu.parallel.train_state import TrainState as JTrainState
from open_groundingdino_tpu.parallel.train_state import make_train_step as jmake_train_step
from open_groundingdino_tpu.utils.checkpoint import convert_groundingdino_checkpoint
from open_groundingdino_tpu_torch.models.bert import BertConfig
from open_groundingdino_tpu_torch.models.criterion import SetCriterion
from open_groundingdino_tpu_torch.models.groundingdino import GroundingDINO, init_weights_
from open_groundingdino_tpu_torch.models.layers import BiAttentionBlock
from open_groundingdino_tpu_torch.models.swin import SwinConfig
from open_groundingdino_tpu_torch.parallel import optim
from open_groundingdino_tpu_torch.parallel.train_state import TrainState, make_train_step
from open_groundingdino_tpu_torch.utils.convert import state_dict_from_jax_params

# 96x96: the fourth level is 2x2; at 1x1 its GroupNorm (one value per group)
# turns rounding into noise x 1/sqrt(eps), and the packages part at 1e-3
B, T, QN, G, IMG = 2, 16, 12, 3, 96
SWIN = dict(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 4), window_size=4,
            out_indices=(1, 2, 3))
BERT = dict(vocab_size=40, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
            intermediate_size=32, max_position_embeddings=32)
TOP = dict(hidden_dim=32, num_queries=QN, nheads=4, num_feature_levels=4, enc_layers=2,
           dec_layers=2, dim_feedforward=64, max_text_len=T)
# the comparison with the JAX package runs at 1 + 1 layers: XLA's compile of
# the JAX train step grows with depth (about 50 s at 1 + 1 on a CPU core)
JAX_TOP = dict(TOP, enc_layers=1, dec_layers=1)
OPT = dict(lr=1e-4, lr_backbone=1e-5, lr_linear_proj_mult=0.1, weight_decay=1e-4,
           clip_max_norm=0.1)
INPUT_KEYS = ("images", "image_sizes", "input_ids", "text_token_mask", "position_ids",
              "text_self_attention_masks")


def _batch(seed=0):
    """Two images (one padded: valid 80x72), a two-phrase caption with 10
    live tokens, three GT slots of which the second image uses one."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, 40, size=(B, T)).astype(np.int32)
    ids[:, 0], ids[:, 9] = 2, 3
    sam = np.tile(np.eye(T, dtype=bool)[None], (B, 1, 1))
    sam[:, 1:5, 1:5] = True
    sam[:, 5:9, 5:9] = True
    pos = np.zeros((B, T), np.int32)
    pos[:, 1:5] = np.arange(4)
    pos[:, 5:9] = np.arange(4)
    pos_maps = np.zeros((B, G, T), np.float32)
    pos_maps[:, 0, 1:3] = 1.0
    pos_maps[:, 1, 5:7] = 1.0
    pos_maps[:, 2, 3:5] = 1.0
    gt_valid = np.ones((B, G), bool)
    gt_valid[1, 1:] = False
    return {
        "images": rng.randint(0, 256, (B, IMG, IMG, 3)).astype(np.uint8),
        "image_sizes": np.asarray([[IMG, IMG], [80, 72]], np.int32),
        "input_ids": ids,
        "text_token_mask": np.tile(np.arange(T)[None] < 10, (B, 1)),
        "position_ids": pos,
        "text_self_attention_masks": sam,
        "gt_boxes": (rng.uniform(0.3, 0.7, (B, G, 4)) * [1, 1, 0.4, 0.4]).astype(np.float32),
        "gt_pos_maps": pos_maps,
        "gt_valid": gt_valid,
    }


def _port_model(sd=None, top=TOP, swin=SWIN, **kw):
    model = GroundingDINO(SwinConfig(**swin), BertConfig(**BERT), **top, **kw)
    if sd is None:
        return init_weights_(model, 0)
    model.load_state_dict(sd, strict=True)
    return model


def _port_state(model, **kw):
    opt = optim.make_optimizer(model, base_lr=OPT["lr"], **OPT, **kw)
    return TrainState.create(model, opt, seed=0, use_ema=True)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package: init and two train steps; the first step's gradients
    are kept by a pass-through transform ahead of the optimizer."""
    model = JGroundingDINO(
        swin_cfg=JSwinConfig(**SWIN),
        bert_cfg=JBertConfig(**BERT, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0),
        msda_impl="xla", **JAX_TOP)
    batch = _batch()
    rng = np.random.RandomState(1)
    sd = {}
    for name, t in _port_model(None, JAX_TOP).state_dict().items():
        x = t.numpy()
        if ("sampling_offsets" in name or "attention_weights" in name) and "weight" in name:
            x = (x + 0.05 * rng.randn(*x.shape)).astype(np.float32)
        if "text_layers.0.norm2" in name:
            # token logits up to ~17 at this init saturate the f32 sigmoid;
            # there XLA's jit of the JAX matching cost reassociates
            # (1 - p) + 1e-8 to 0, takes log(0) and drops the class term
            # (ROADMAP section 3).  Smaller text features (the text
            # enhancer's last LayerNorm) keep the logits small.
            x = x * np.float32(0.3)
        sd[name] = x
    params = convert_groundingdino_checkpoint(
        sd, swin_depths=SWIN["depths"], out_indices=SWIN["out_indices"],
        num_feature_levels=JAX_TOP["num_feature_levels"], enc_layers=JAX_TOP["enc_layers"],
        dec_layers=JAX_TOP["dec_layers"], bert_layers=BERT["num_hidden_layers"])
    crit = JSetCriterion(num_queries=QN)
    keep_grads = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))
    state = JTrainState.create(params, optax.chain(keep_grads, jmake_optimizer(params, **OPT)))
    step = jax.jit(jmake_train_step(model, crit))
    losses, grads = [], None
    for _ in range(2):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        grads = grads if grads is not None else jax.device_get(state.opt_state[0])
    return dict(params=params, state=state, losses=losses, grads=grads, batch=batch)


def test_two_steps_match_jax(jax_run):
    model = _port_model(state_dict_from_jax_params(jax_run["params"]), JAX_TOP,
                        use_checkpoint=True, use_transformer_ckpt=True)
    state = _port_state(model)
    captured = []
    step_fn = state.optimizer.step

    def spy(grads, norm, finite):
        captured.append([g.clone() for g in grads])
        step_fn(grads, norm, finite)

    state.optimizer.step = spy
    train_step = make_train_step(SetCriterion(num_queries=QN))
    losses = [train_step(state, jax_run["batch"])["loss"] for _ in range(2)]
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-5)

    ref = state_dict_from_jax_params(jax.device_get(jax_run["state"].params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=0, atol=2e-6,
                                   err_msg=name)
    assert state.optimizer.count == 2 and state.nonfinite_count == 0
    assert len(captured) == 2


def test_first_step_gradients_match_jax(jax_run):
    model = _port_model(state_dict_from_jax_params(jax_run["params"]), JAX_TOP)
    jgrads = state_dict_from_jax_params(jax_run["grads"])
    state = _port_state(model)
    captured = []
    state.optimizer.step = lambda grads, norm, finite: captured.append(grads)
    make_train_step(SetCriterion(num_queries=QN))(state, jax_run["batch"])
    floor = 1e-6 * max(float(jgrads[n].abs().max()) for n in state.optimizer.names)
    bad = []
    for name, g in zip(state.optimizer.names, captured[0]):
        ref = jgrads[name].numpy()
        err, scale = float(np.abs(g.numpy() - ref).max()), float(np.abs(ref).max())
        if not err <= 1e-4 * scale + floor:
            bad.append((name, err, scale))
    assert not bad, bad


def test_nonfinite_batch_changes_nothing():
    model = _port_model()
    state = _port_state(model)
    train_step = make_train_step(SetCriterion(num_queries=QN), ema_decay=0.9)
    train_step(state, _batch(1))                      # one good step: nonzero moments
    opt = state.optimizer
    before = [t.clone() for t in list(model.parameters()) + opt.m + opt.v + state.ema]
    bad = _batch(2)
    bad["gt_boxes"][0, 0, 0] = np.nan
    metrics = train_step(state, bad)
    assert not np.isfinite(metrics["loss"])
    after = list(model.parameters()) + opt.m + opt.v + state.ema
    for a, b in zip(after, before):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=0)
    assert state.optimizer.count == 1
    assert state.nonfinite_count == metrics["nonfinite_count"] == 1
    assert state.step == 2


def test_unsupported_compute_dtypes_raise():
    """float16 is no compute dtype of the port; bf16 runs every MSDA path,
    banded_point (K5 and K3 bf16) included: its step is finite and moves
    the deformable attentions' parameters."""
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        make_train_step(SetCriterion(num_queries=QN), compute_dtype="float16")
    model = _port_model(msda={"kernel": "banded_point"})
    state = _port_state(model)
    before = model.transformer.encoder.layers[0].self_attn.sampling_offsets.weight.detach().clone()
    step = make_train_step(SetCriterion(num_queries=QN), compute_dtype="bfloat16")
    metrics = step(state, _batch())
    assert np.isfinite(metrics["loss"]) and state.nonfinite_count == 0
    after = model.transformer.encoder.layers[0].self_attn.sampling_offsets.weight
    assert after.dtype == torch.float32 and not torch.equal(after.detach(), before)


def test_drop_path_keeps_rows_at_rate():
    """BiAttentionBlock in training mode: two per-sample factor draws, each
    0 or 1 / (1 - p) with P(keep) = 1 - p, and its residual branches scaled
    by them sample by sample; no draw in eval mode or at rate 0."""
    block = BiAttentionBlock(8, 6, 16, 2, init_values=0.5, droppath=0.3)
    g_init = torch.Generator().manual_seed(1)
    for m in block.modules():
        if isinstance(m, torch.nn.Linear):
            m.weight.data.normal_(0.0, 0.3, generator=g_init)
    block.init_weights_(g_init)
    g = torch.Generator().manual_seed(0)
    block.train()
    for scale in block.draw_drop_scales(20000, g, "cpu"):
        kept = scale != 0
        assert torch.all(~kept | torch.isclose(scale, torch.tensor(1 / 0.7)))
        assert abs(float(kept.float().mean()) - 0.7) < 0.015  # 4.6 sigma

    rng = np.random.RandomState(0)
    v = torch.from_numpy(rng.randn(6, 5, 8).astype(np.float32))
    l = torch.from_numpy(rng.randn(6, 3, 6).astype(np.float32))
    sv, sl = torch.tensor([0, 1 / 0.7] * 3), torch.tensor([1 / 0.7, 1 / 0.7, 0] * 2)
    out_v, out_l = block(v, l, drop_scales=(sv, sl))
    base_v, base_l = block(v, l)                           # no factors: the whole branch
    vn, ln = block.layer_norm_v(v), block.layer_norm_l(l)
    torch.testing.assert_close(out_v, vn + (base_v - vn) * sv.view(-1, 1, 1))
    torch.testing.assert_close(out_l, ln + (base_l - ln) * sl.view(-1, 1, 1))
    assert not torch.allclose(base_v, vn)                  # the branch is not negligible

    assert block.eval().draw_drop_scales(4, g, "cpu") is None
    block.train().droppath = 0.0
    assert block.draw_drop_scales(4, g, "cpu") is None


def test_checkpointing_gives_the_same_gradients_with_droppath():
    batch = _batch(3)
    grads, outs = {}, {}
    for ckpt in (False, True):
        model = _port_model(fusion_droppath=0.5, use_checkpoint=ckpt, use_transformer_ckpt=ckpt)
        state = _port_state(model)
        state.optimizer.step = lambda g, n, f, ckpt=ckpt: grads.__setitem__(ckpt, [x.clone() for x in g])
        outs[ckpt] = make_train_step(SetCriterion(num_queries=QN))(state, batch)["loss"]
    assert outs[False] == outs[True]
    for a, b in zip(grads[False], grads[True]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    # stochastic depth was active: without it the loss differs
    model = _port_model(use_checkpoint=True, use_transformer_ckpt=True)
    state = _port_state(model)
    state.optimizer.step = lambda g, n, f: None
    assert make_train_step(SetCriterion(num_queries=QN))(state, batch)["loss"] != outs[True]


def test_training_after_serving_in_one_process():
    """The Swin index and mask constants are cached per shape; one first made
    under inference_mode must still be usable by a training forward."""
    model = _port_model(use_checkpoint=True, use_transformer_ckpt=True)
    batch = _batch(4)
    with torch.inference_mode():
        inputs = {k: torch.from_numpy(np.asarray(batch[k])) for k in INPUT_KEYS}
        inputs["images"] = inputs["images"].float()
        inputs = {k: (v.long() if v.dtype == torch.int32 else v) for k, v in inputs.items()}
        model.eval()(**inputs)
    metrics = make_train_step(SetCriterion(num_queries=QN))(_port_state(model), batch)
    assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["grad_norm"])
