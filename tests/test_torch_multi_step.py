"""The device-resident training step at nano width, f32, on the CPU: N steps
a call (parallel/train_state.make_multi_train_step), the non-finite guard on
the device, and the training loop that reads the device at its cadence
(engine.train_one_epoch).

* Two calls of steps_per_call = 2 against four single steps on the same
  batches from the same seed (stochastic depth and text dropout on, so each
  step's draws from the state's generator count): parameters, both moments,
  the EMA and the count within 1e-6, the metrics equal.
* A non-finite batch inside a call changes nothing (parameters, moments,
  EMA, count as after the good step alone) and adds one to the device
  nonfinite_count; the metrics come back stacked, (steps_per_call,).
* train_one_epoch reads the device at its print_freq cadence only: a bad
  step between two reads aborts the run at the next read, after the steps
  in between ran (their updates guarded).
* With steps_per_call = 2 a partial chunk (the epoch's tail, a bucket
  switch, the steps left under max_steps) falls back to single steps, and
  the epoch's state equals single steps' on the same batches.
"""
import numpy as np
import pytest
import torch

from open_groundingdino_tpu_torch import engine
from open_groundingdino_tpu_torch.models.bert import BertConfig
from open_groundingdino_tpu_torch.models.criterion import SetCriterion
from open_groundingdino_tpu_torch.models.groundingdino import GroundingDINO, init_weights_
from open_groundingdino_tpu_torch.models.swin import SwinConfig
from open_groundingdino_tpu_torch.parallel import optim
from open_groundingdino_tpu_torch.parallel.train_state import (TrainState, make_multi_train_step,
                                                               make_train_step)

B, T, QN, G = 2, 16, 12, 3
SWIN = dict(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 4), window_size=4,
            out_indices=(1, 2, 3))
BERT = dict(vocab_size=40, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
            intermediate_size=32, max_position_embeddings=32, hidden_dropout_prob=0.1,
            attention_probs_dropout_prob=0.1)
TOP = dict(hidden_dim=32, num_queries=QN, nheads=4, num_feature_levels=4, enc_layers=1,
           dec_layers=1, dim_feedforward=64, max_text_len=T, fusion_droppath=0.3)
OPT = dict(lr=1e-4, base_lr=1e-4, lr_backbone=1e-5, lr_linear_proj_mult=0.1,
           weight_decay=1e-4, clip_max_norm=0.1)
EMA = 0.9
TOL = dict(rtol=1e-6, atol=1e-6)


def _batch(seed, size=64):
    """B images of size x size (the second padded), a caption of 10 live
    tokens, three GT slots of which the second image uses one."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, 40, size=(B, T)).astype(np.int64)
    ids[:, 0], ids[:, 9] = 2, 3
    pos_maps = np.zeros((B, G, T), np.float32)
    pos_maps[:, 0, 1:3] = pos_maps[:, 1, 5:7] = pos_maps[:, 2, 3:5] = 1.0
    gt_valid = np.ones((B, G), bool)
    gt_valid[1, 1:] = False
    return {
        "images": rng.randint(0, 256, (B, size, size, 3)).astype(np.uint8),
        "image_sizes": np.asarray([[size, size], [size - 16, size - 8]], np.int64),
        "input_ids": ids,
        "text_token_mask": np.tile(np.arange(T)[None] < 10, (B, 1)),
        "position_ids": np.tile(np.arange(T)[None], (B, 1)),
        "text_self_attention_masks": np.ones((B, T, T), bool),
        "gt_boxes": (rng.uniform(0.3, 0.7, (B, G, 4)) * [1, 1, 0.4, 0.4]).astype(np.float32),
        "gt_pos_maps": pos_maps,
        "gt_valid": gt_valid,
        "image_ids": np.arange(B),
    }


def _state():
    model = init_weights_(GroundingDINO(SwinConfig(**SWIN), BertConfig(**BERT), **TOP), 0)
    opt = optim.make_optimizer(model, **OPT)
    return TrainState.create(model, opt, seed=7, use_ema=True)


def _steps(spc=1):
    kw = dict(ema_decay=EMA)
    crit = SetCriterion(num_queries=QN)
    return make_train_step(crit, **kw), make_multi_train_step(crit, spc, **kw) if spc > 1 else None


def _leaves(state):
    opt = state.optimizer
    return [t.detach() for t in list(state.model.parameters()) + opt.m + opt.v + state.ema]


def _assert_same_state(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        torch.testing.assert_close(x, y, **TOL)
    assert int(a.optimizer.count) == int(b.optimizer.count)
    assert int(a.nonfinite_count) == int(b.nonfinite_count)
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.fixture(scope="module")
def batches():
    return [_batch(s) for s in range(4)]


def test_two_chunks_match_four_single_steps(batches):
    single, (step, _) = _state(), _steps()
    ref = [step(single, b) for b in batches]
    multi, (_, chunk) = _state(), _steps(2)
    got = [chunk(multi, engine.stack_batches(batches[i:i + 2])) for i in (0, 2)]
    _assert_same_state(multi, single)
    assert int(multi.optimizer.count) == 4
    for k in ref[0]:
        want = torch.stack([m[k] for m in ref])
        assert torch.equal(torch.cat([g[k] for g in got]), want), k


def test_nonfinite_step_in_a_chunk_changes_nothing(batches):
    good, (step, _) = _state(), _steps()
    step(good, batches[0])
    bad = dict(batches[1], gt_boxes=batches[1]["gt_boxes"].copy())
    bad["gt_boxes"][0, 0, 0] = np.nan
    multi, (_, chunk) = _state(), _steps(2)
    metrics = chunk(multi, engine.stack_batches([batches[0], bad]))
    assert {tuple(v.shape) for v in metrics.values()} == {(2,)}
    assert metrics["nonfinite_count"].tolist() == [0, 1]
    assert torch.isfinite(metrics["loss"][0]) and not torch.isfinite(metrics["loss"][1])
    assert isinstance(multi.nonfinite_count, torch.Tensor) and int(multi.nonfinite_count) == 1
    for x, y in zip(_leaves(multi), _leaves(good)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert int(multi.optimizer.count) == int(good.optimizer.count) == 1


class _Loader(list):
    """A loader: the batches in order, len() its batches."""


def _counted(fn):
    def wrapped(*a, **k):
        wrapped.calls += 1
        return fn(*a, **k)
    wrapped.calls = 0
    return wrapped


def test_epoch_aborts_at_the_cadence(batches):
    bad = dict(batches[1], gt_boxes=batches[1]["gt_boxes"].copy())
    bad["gt_boxes"][0, 0, 0] = np.nan
    state, (step, _) = _state(), _steps()
    step = _counted(step)
    records = []
    with pytest.raises(SystemExit):
        engine.train_one_epoch(step, state, _Loader([batches[0], bad, batches[2], batches[3]]),
                               0, print_freq=2, step_records=records)
    # reads after steps 0 and 2: the bad step 1 is seen at the second read
    assert step.calls == 3 and state.step == 3 and int(state.nonfinite_count) == 1
    assert [r["nonfinite_count"] for r in records] == [0]
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


def test_partial_chunks_fall_back_to_single_steps(batches):
    small = _batch(9, size=48)   # another bucket: it flushes the chunk before it
    loader = _Loader([batches[0], batches[1], batches[2], small, batches[3]])
    single, (step, _) = _state(), _steps()
    records_ref = []
    _, stats_ref = engine.train_one_epoch(step, single, loader, 0, print_freq=1,
                                          step_records=records_ref)
    state, (step, chunk) = _state(), _steps(2)
    step, chunk = _counted(step), _counted(chunk)
    records = []
    _, stats = engine.train_one_epoch(step, state, loader, 0, print_freq=1, step_records=records,
                                      multi_step=chunk, steps_per_call=2)
    # chunks [0, 1] (a call), [2] (a bucket switch), [small], [3] (the tail)
    assert (chunk.calls, step.calls) == (1, 3)
    _assert_same_state(state, single)
    assert [r["loss"] for r in records] == [r["loss"] for r in records_ref]
    assert stats == pytest.approx(stats_ref, rel=1e-6)
    # max_steps counts optimizer steps: 3 steps are one call and one single step
    state, (step, chunk) = _state(), _steps(2)
    step, chunk = _counted(step), _counted(chunk)
    engine.train_one_epoch(step, state, _Loader(batches), 0, print_freq=50, max_steps=3,
                           multi_step=chunk, steps_per_call=2)
    assert (chunk.calls, step.calls, state.step) == (1, 1, 3)
