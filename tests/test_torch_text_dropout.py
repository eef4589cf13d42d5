"""The port's text dropout (the config's text_dropout in models/bert.py)
against the JAX package's BertModel.

In eval mode, and in training mode at rate 0, the port's tower equals the
JAX tower run with deterministic=True within 1e-5 (the JAX weights exported
to HuggingFace keys by the JAX package's export_bert_state_dict, loaded
strictly).  In training mode at p > 0, at each of the four sites (the
embeddings, the attention probabilities, the attention output and the FFN
output): the share of dropped elements within 4 sigma of p, the kept ones
scaled by exactly 1/(1 - p), the global RNG untouched, the same generator
seed giving the same output and another seed another.  A nano train step
with text_dropout 0.1 and fusion droppath gives the same gradients with and
without recompute at one seed.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open_groundingdino_tpu.models.bert import BertConfig as JBertConfig
from open_groundingdino_tpu.models.bert import BertModel as JBertModel
from open_groundingdino_tpu.utils.torch_convert import export_bert_state_dict
from open_groundingdino_tpu_torch.models.bert import BertConfig, BertModel, TextDropout
from open_groundingdino_tpu_torch.models.criterion import SetCriterion
from open_groundingdino_tpu_torch.models.groundingdino import GroundingDINO, init_weights_
from open_groundingdino_tpu_torch.models.swin import SwinConfig
from open_groundingdino_tpu_torch.parallel import optim
from open_groundingdino_tpu_torch.parallel.train_state import TrainState, make_train_step

P = 0.1
B, T = 8, 32
TOWER = dict(vocab_size=60, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=96, max_position_embeddings=40, type_vocab_size=1)
SITES = ("embeddings.dropout", "encoder.layer.0.attention.self.dropout",
         "encoder.layer.0.attention.output.dropout", "encoder.layer.0.output.dropout")


def _text(seed=0):
    """Token ids with [CLS]-like 0 and '.'-delimited phrases: block-diagonal
    masks and per-phrase positions, as generate_masks_with_special_tokens
    gives them, and a padded tail."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, TOWER["vocab_size"], (B, T)).astype(np.int32)
    mask = np.zeros((B, T, T), bool)
    pos = np.zeros((B, T), np.int32)
    for b in range(B):
        live = 12 + 2 * b
        inner = sorted(rng.choice(np.arange(3, live - 1), 3, replace=False).tolist())
        cuts = [0, 1] + inner + [live]
        for a, e in zip(cuts, cuts[1:]):
            mask[b, a:e, a:e] = True
            pos[b, a:e] = np.arange(e - a)
        mask[b, np.arange(live, T), np.arange(live, T)] = True
    return ids, mask, pos


@pytest.fixture(scope="module")
def towers():
    """The JAX tower (rate P, a seeded init) and the port's on its weights."""
    ids, mask, pos = _text()
    jcfg = JBertConfig(**TOWER, hidden_dropout_prob=P, attention_probs_dropout_prob=P)
    jmodel = JBertModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask),
                         position_ids=jnp.asarray(pos))["params"]
    port = BertModel(BertConfig(**TOWER, hidden_dropout_prob=P, attention_probs_dropout_prob=P))
    port.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in export_bert_state_dict(params).items()}, strict=True)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                                   position_ids=jnp.asarray(pos), deterministic=True))
    return port, want


def _port_inputs(seed=0):
    ids, mask, pos = _text(seed)
    return torch.from_numpy(ids).long(), torch.from_numpy(mask), torch.from_numpy(pos).long()


def test_eval_mode_and_rate_zero_match_jax_deterministic(towers):
    port, want = towers
    with torch.no_grad():
        got = port.eval()(*_port_inputs())
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        zero = BertModel(BertConfig(**TOWER))
        zero.load_state_dict(port.state_dict(), strict=True)
        got = zero.train()(*_port_inputs())          # training mode at rate 0: no generator
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert zero.embeddings.dropout.p == 0.0


def _hooked_forward(model, seed):
    """One training-mode forward with a generator seeded `seed`: the output
    and each site's (input, output)."""
    seen, hooks = {}, []
    modules = dict(model.named_modules())
    for name in SITES:
        def hook(mod, inp, out, name=name):
            seen[name] = (inp[0].detach().clone(), out.detach().clone())
        hooks.append(modules[name].register_forward_hook(hook))
    try:
        with torch.no_grad():
            out = model.train()(*_port_inputs(), generator=torch.Generator().manual_seed(seed))
    finally:
        for h in hooks:
            h.remove()
    return out, seen


@pytest.mark.parametrize("site", SITES)
def test_training_dropout_at_each_site(towers, site):
    port, _ = towers
    rng_state = torch.get_rng_state()
    out, seen = _hooked_forward(port, 7)
    assert torch.equal(torch.get_rng_state(), rng_state)      # the global RNG is untouched
    x, y = seen[site]
    live = x != 0                                              # masked attention is 0 already
    dropped = (y == 0) & live
    n = int(live.sum())
    share = float(dropped.sum()) / n
    assert abs(share - P) < 4 * (P * (1 - P) / n) ** 0.5, (site, share, n)
    kept = y != 0
    assert torch.equal(y[kept], x[kept] / (1 - P))            # the 1/(1 - p) scale
    assert torch.equal(y[~live], x[~live])

    again, seen_again = _hooked_forward(port, 7)
    assert torch.equal(again, out) and torch.equal(seen_again[site][1], y)
    other, seen_other = _hooked_forward(port, 8)
    assert not torch.equal(seen_other[site][1], y) and not torch.equal(other, out)


def test_training_dropout_needs_a_generator(towers):
    port, _ = towers
    with pytest.raises(ValueError):
        port.train()(*_port_inputs())
    drop = TextDropout(P)
    x = torch.ones(4, 5)
    assert drop.eval()(x) is x


# ---- a nano train step ----------------------------------------------------------
SWIN = dict(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 4), window_size=4,
            out_indices=(1, 2, 3))
BERT = dict(vocab_size=40, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=32, max_position_embeddings=32, type_vocab_size=1)
TOP = dict(hidden_dim=32, num_queries=12, nheads=4, num_feature_levels=4, enc_layers=2,
           dec_layers=2, dim_feedforward=64, max_text_len=16)


def _batch(seed=3):
    """Two 96x96 images (one padded), a two-phrase caption, three GT slots
    (tests/test_torch_train_step.py's)."""
    rng = np.random.RandomState(seed)
    b, t, g = 2, 16, 3
    ids = rng.randint(5, 40, size=(b, t)).astype(np.int32)
    ids[:, 0], ids[:, 9] = 2, 3
    sam = np.tile(np.eye(t, dtype=bool)[None], (b, 1, 1))
    sam[:, 1:5, 1:5] = True
    sam[:, 5:9, 5:9] = True
    pos = np.zeros((b, t), np.int32)
    pos[:, 1:5] = np.arange(4)
    pos[:, 5:9] = np.arange(4)
    pos_maps = np.zeros((b, g, t), np.float32)
    pos_maps[:, 0, 1:3], pos_maps[:, 1, 5:7], pos_maps[:, 2, 3:5] = 1.0, 1.0, 1.0
    gt_valid = np.ones((b, g), bool)
    gt_valid[1, 1:] = False
    return {"images": rng.randint(0, 256, (b, 96, 96, 3)).astype(np.uint8),
            "image_sizes": np.asarray([[96, 96], [80, 72]], np.int32), "input_ids": ids,
            "text_token_mask": np.tile(np.arange(t)[None] < 10, (b, 1)), "position_ids": pos,
            "text_self_attention_masks": sam,
            "gt_boxes": (rng.uniform(0.3, 0.7, (b, g, 4)) * [1, 1, 0.4, 0.4]).astype(np.float32),
            "gt_pos_maps": pos_maps, "gt_valid": gt_valid}


def _step(dropout: float, ckpt: bool):
    """One f32 train step of the nano model at seed 0: (loss, gradients)."""
    model = GroundingDINO(SwinConfig(**SWIN), BertConfig(**BERT, hidden_dropout_prob=dropout,
                                                         attention_probs_dropout_prob=dropout),
                          **TOP, fusion_droppath=0.3, use_checkpoint=ckpt,
                          use_transformer_ckpt=ckpt)
    init_weights_(model, 0)
    opt = optim.make_optimizer(model, lr=1e-4, base_lr=1e-4, lr_backbone=1e-5,
                               lr_linear_proj_mult=0.1, weight_decay=1e-4, clip_max_norm=0.1)
    state = TrainState.create(model, opt, seed=0)
    grads = []
    state.optimizer.step = lambda g, n, f: grads.extend(x.clone() for x in g)
    loss = make_train_step(SetCriterion(num_queries=12))(state, _batch())["loss"]
    return loss, grads


def test_train_step_recompute_gives_the_same_gradients_with_text_dropout():
    """The text tower's masks are drawn once a forward from the step's
    generator, before the fusion blocks' droppath draws: recomputing the
    Swin blocks and the fusion and encoder layers changes neither."""
    loss, grads = _step(P, False)
    loss_ckpt, grads_ckpt = _step(P, True)
    assert np.isfinite(loss) and loss == loss_ckpt
    for a, b in zip(grads, grads_ckpt):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    # the text dropout was active: at rate 0 the same step gives another loss
    assert _step(0.0, True)[0] != loss
