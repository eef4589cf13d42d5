"""The port's optimizer, schedules and EMA against the JAX package (optax).

* Parameter groups: `label_params` over the port's parameter names against
  the JAX package's `label_params` over its param tree, carried through the
  same converter the model tests use (`state_dict_from_jax_params`).
* Five steps of overflow-safe clip + grouped AdamW + OneCycle schedule on the
  same gradients, frozen keys included: parameters agree at abs 1e-6 / rel
  1e-6 after every step (f32; both sides do optax's arithmetic).
* The frozen parameters' gradients count in the clip norm and the
  parameters never change.
* Schedules and `ema_update` agree at rel 1e-6.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from open_groundingdino_tpu.models.bert import BertConfig as JBertConfig
from open_groundingdino_tpu.models.groundingdino import GroundingDINO as JGroundingDINO
from open_groundingdino_tpu.models.swin import SwinConfig as JSwinConfig
from open_groundingdino_tpu.parallel import optim as joptim
from open_groundingdino_tpu.utils.ema import ema_update as jema_update
from open_groundingdino_tpu_torch.models.bert import BertConfig
from open_groundingdino_tpu_torch.models.groundingdino import GroundingDINO
from open_groundingdino_tpu_torch.models.swin import SwinConfig
from open_groundingdino_tpu_torch.parallel import optim
from open_groundingdino_tpu_torch.utils.convert import state_dict_from_jax_params
from open_groundingdino_tpu_torch.utils.ema import ema_update

T = 16
SWIN = dict(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 4), window_size=4,
            out_indices=(1, 2, 3))
BERT = dict(vocab_size=40, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
            intermediate_size=32, max_position_embeddings=32)
TOP = dict(hidden_dim=32, num_queries=12, nheads=4, num_feature_levels=4, enc_layers=1,
           dec_layers=2, dim_feedforward=64, max_text_len=T)
CODES = {"base": 0.0, "backbone": 1.0, "linear_proj": 2.0}
TOL = dict(rtol=1e-6, atol=1e-6)


def test_param_groups_match_label_params():
    jmodel = JGroundingDINO(swin_cfg=JSwinConfig(**SWIN), bert_cfg=JBertConfig(**BERT),
                            msda_impl="xla", **TOP)
    inputs = dict(images=jnp.zeros((1, 64, 64, 3)), image_sizes=jnp.full((1, 2), 64),
                  input_ids=jnp.zeros((1, T), jnp.int32), text_token_mask=jnp.ones((1, T), bool),
                  position_ids=jnp.zeros((1, T), jnp.int32),
                  text_self_attention_masks=jnp.ones((1, T, T), bool))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), **inputs)["params"]
    labels = joptim.label_params(shapes)
    coded = jax.tree_util.tree_map(lambda s, lbl: np.full(s.shape, CODES[lbl], np.float32),
                                   shapes, labels)
    ref = state_dict_from_jax_params(coded)
    model = GroundingDINO(SwinConfig(**SWIN), BertConfig(**BERT), **TOP)
    ours = optim.label_params(model.named_parameters())
    assert set(ours) <= set(ref)
    assert set(ours.values()) == set(CODES)
    for name, lbl in ours.items():
        assert np.all(ref[name].numpy() == CODES[lbl]), (name, lbl)


NAMES = ("backbone.0.patch_embed.proj.weight", "bert.encoder.layer.0.attention.self.query.weight",
         "transformer.decoder.ref_point_head.layers.0.weight",
         "transformer.encoder.layers.0.self_attn.sampling_offsets.bias",
         "transformer.enc_output.weight", "feat_map.weight")
SHAPES = ((4, 3, 2, 2), (6, 6), (5, 7), (16,), (8, 8), (6, 4))
FROZEN = ("feat_map",)


def _args(**kw):
    base = dict(lr=1e-3, epochs=2, lr_drop=1, onecyclelr=False, multi_step_lr=False,
                lr_drop_list=[1, 2])
    return SimpleNamespace(**{**base, **kw})


def test_adamw_clip_schedule_frozen_match_optax():
    rng = np.random.RandomState(0)
    params = {n: rng.randn(*s).astype(np.float32) for n, s in zip(NAMES, SHAPES)}
    args = _args(onecyclelr=True)
    steps_per_epoch = 5
    tx = joptim.make_optimizer(params, lr=joptim.make_lr_schedule(args, steps_per_epoch),
                               base_lr=args.lr, lr_backbone=1e-4, lr_linear_proj_mult=0.1,
                               weight_decay=1e-4, clip_max_norm=0.1, frozen_keys=FROZEN)
    jstate = tx.init(params)
    jparams = params
    tparams = [torch.nn.Parameter(torch.from_numpy(params[n].copy())) for n in NAMES]
    opt = optim.GroupedAdamW(zip(NAMES, tparams), optim.make_lr_schedule(args, steps_per_epoch),
                             base_lr=args.lr, lr_backbone=1e-4, lr_linear_proj_mult=0.1,
                             weight_decay=1e-4, clip_max_norm=0.1, frozen_keys=FROZEN)
    assert opt.labels["feat_map.weight"] == "frozen"
    for step in range(5):
        grads = {n: (rng.randn(*s) * (10.0 ** rng.randint(-3, 4))).astype(np.float32)
                 for n, s in zip(NAMES, SHAPES)}
        grads["feat_map.weight"] *= 1e6   # the frozen gradient dominates the clip norm
        updates, jstate = tx.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tgrads = [torch.from_numpy(grads[n]) for n in NAMES]
        norm = float(optim.safe_global_norm(tgrads))
        np.testing.assert_allclose(norm, float(joptim.safe_global_norm(grads)), rtol=1e-6)
        opt.step(tgrads, norm, True)
        for n, p in zip(NAMES, tparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[n]), **TOL,
                                       err_msg=f"step {step} {n}")
        np.testing.assert_array_equal(tparams[-1].detach().numpy(), params["feat_map.weight"])
    assert opt.count == 5
    # without the frozen gradient in the norm the clip would scale differently
    live = [torch.from_numpy(grads[n]) for n in NAMES[:-1]]
    assert optim.clip_scale(float(optim.safe_global_norm(live)), 0.1) > 2 * optim.clip_scale(
        norm, 0.1)


def test_safe_global_norm_survives_overflow():
    grads = [torch.full((1000,), 3e19), torch.tensor([1e-3, -2.0])]
    ours = float(optim.safe_global_norm(grads))
    ref = float(joptim.safe_global_norm([np.asarray(g) for g in grads]))
    assert np.isfinite(ours) and np.isfinite(ref)
    np.testing.assert_allclose(ours, ref, rtol=1e-6)


@pytest.mark.parametrize("kind", ["step", "multi_step", "onecycle"])
def test_schedules_match_optax(kind):
    args = _args(lr=2e-4, epochs=12, lr_drop=11, lr_drop_list=[4, 9],
                 onecyclelr=kind == "onecycle", multi_step_lr=kind == "multi_step")
    ours = optim.make_lr_schedule(args, 7)
    ref = joptim.make_lr_schedule(args, 7)
    for count in (0, 1, 5, 16, 27, 28, 29, 62, 63, 77, 83, 84, 90, 200):
        np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-6, atol=1e-12,
                                   err_msg=f"count {count}")


def test_ema_matches_jax():
    rng = np.random.RandomState(1)
    ema = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(np.float32)]
    new = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(np.float32)]
    ref = jema_update(ema, new, 0.9997)
    ours = [torch.from_numpy(e.copy()) for e in ema]
    ema_update(ours, [torch.from_numpy(p) for p in new], 0.9997)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7)
