"""Checkpoints in the port's trainer, at nano size on the CPU: resume,
--finetune_ignore, --frozen_weights, and the saved file's way back into the
JAX package.

A run of 2 epochs resumed to 3 ends in the state of 3 continuous epochs
(parameters, AdamW moments and count, EMA to 1e-6); --finetune_ignore keeps
the fresh init exactly where a key holds an ignored keyword and loads the
checkpoint everywhere else; --frozen_weights leaves the backbone, BERT, the
transformer, feat_map and input_proj unchanged by a step; a checkpoint the
port saves from JAX-exported weights goes back through the JAX package's
load_torch_state_dict + convert_groundingdino_checkpoint to the same params.
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke
import jax
from open_groundingdino_tpu.utils.checkpoint import (convert_groundingdino_checkpoint,
                                                     load_torch_state_dict)
from open_groundingdino_tpu_torch import main as port_main
from open_groundingdino_tpu_torch.config import SLConfig
from open_groundingdino_tpu_torch.models.groundingdino import build_groundingdino, init_weights_
from open_groundingdino_tpu_torch.parallel import optim
from open_groundingdino_tpu_torch.parallel.train_state import TrainState
from open_groundingdino_tpu_torch.utils import checkpoint as ckpt
from open_groundingdino_tpu_torch.utils.convert import state_dict_from_jax_params
from test_torch_evaluate import VAL_IMAGES, nano_workspace, run_main
from test_torch_train_step import BERT, SWIN, TOP, _port_model


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    return nano_workspace(tmp_path_factory.mktemp("nano"))


def _final(out_dir, epoch):
    return ckpt.restore_checkpoint(os.path.join(out_dir, f"checkpoint_{epoch}.pth"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resume_equals_continuous(ws, tmp_path, dtype):
    opts = ("use_ema=True", f"compute_dtype={dtype}")
    flags = ("--pretrain_model_path", ws["ckpt"], "--max_steps", "1")
    run_main(ws, tmp_path / "cont", *flags, options=("epochs=3", *opts))
    run_main(ws, tmp_path / "split", *flags, options=("epochs=2", *opts))
    assert ckpt.latest_checkpoint(str(tmp_path / "split")).endswith("checkpoint_1.pth")
    run = run_main(ws, tmp_path / "split", *flags, options=("epochs=3", *opts))
    assert run["state"].step == 1 + _final(tmp_path / "split", 1)["step"] == 3
    a, b = _final(tmp_path / "cont", 2), _final(tmp_path / "split", 2)
    assert (a["epoch"], a["step"], a["optimizer"]["count"]) == (b["epoch"], b["step"],
                                                                b["optimizer"]["count"]) == (2, 3, 3)
    assert a["nonfinite_count"] == b["nonfinite_count"] == 0
    assert torch.equal(a["generator"], b["generator"])
    for part, x, y in (("model", a["model"], b["model"]), ("m", a["optimizer"]["m"],
                                                           b["optimizer"]["m"]),
                       ("v", a["optimizer"]["v"], b["optimizer"]["v"]), ("ema", a["ema"], b["ema"])):
        assert x.keys() == y.keys(), part
        for k in x:
            torch.testing.assert_close(x[k], y[k], rtol=0, atol=1e-6, msg=f"{part} {k}")
    init = ckpt.restore_checkpoint(ws["ckpt"])["model"]
    moved = [k for k in init if not torch.equal(init[k], a["model"][k])]
    assert len(moved) > len(init) // 2


def test_finetune_ignore_keeps_exactly_the_ignored_keys_fresh(ws, tmp_path):
    ignore = ("feat_map", "input_proj.1", "enc_out_bbox_embed")
    manifest = chip_smoke.write_coco_val(ws["work"], VAL_IMAGES, name="four")
    run = run_main(ws, tmp_path / "out", "--eval", "--pretrain_model_path", ws["ckpt"],
                   "--finetune_ignore", *ignore, manifest=manifest)
    got = run["model"].state_dict()
    fresh = init_weights_(build_groundingdino(SLConfig.fromfile(ws["cfg"]), device="cpu"),
                          3).state_dict()   # run_main's --seed
    loaded = ckpt.restore_checkpoint(ws["ckpt"])["model"]
    ignored = [k for k in got if any(kw in k for kw in ignore)]
    assert len(ignored) >= 6
    for k, v in got.items():
        assert torch.equal(v, fresh[k] if k in ignored else loaded[k]), k
    # where the checkpoint and the fresh init differ (not the norms' ones)
    assert sum(not torch.equal(fresh[k], loaded[k]) for k in ignored) >= 4


def test_frozen_weights_leave_those_parts_unchanged(ws, tmp_path):
    run = run_main(ws, tmp_path / "out", "--frozen_weights", ws["ckpt"], "--max_steps", "1",
                   options=("epochs=1",))
    assert run["state"].step == 1
    before = ckpt.restore_checkpoint(ws["ckpt"])["model"]
    after = _final(tmp_path / "out", 0)["model"]
    model = run["state"].model
    frozen, trained = [], []
    for name, _ in model.named_parameters():
        same = torch.equal(before[name], after[name])
        if any(kw in name for kw in port_main.FROZEN_WEIGHTS_KEYS):
            frozen.append(name)
            assert same, name
        else:
            trained.append(same)
    assert len(frozen) > 100 and trained and not all(trained)


def _convert(sd):
    return convert_groundingdino_checkpoint(
        sd, swin_depths=SWIN["depths"], out_indices=SWIN["out_indices"],
        num_feature_levels=TOP["num_feature_levels"], enc_layers=TOP["enc_layers"],
        dec_layers=TOP["dec_layers"], bert_layers=BERT["num_hidden_layers"])


def test_saved_checkpoint_goes_back_into_the_jax_params(tmp_path):
    params = _convert({k: v.numpy() for k, v in _port_model(None).state_dict().items()})
    model = _port_model(state_dict_from_jax_params(params))
    opt = optim.make_optimizer(model, lr=1e-4, base_lr=1e-4, lr_backbone=1e-5)
    state = TrainState.create(model, opt, seed=0, use_ema=True)
    path = ckpt.save_checkpoint(str(tmp_path), 4, {**state.state_dict(), "epoch": 4})
    assert path == ckpt.latest_checkpoint(str(tmp_path)) and path.endswith("checkpoint_4.pth")
    back = _convert(load_torch_state_dict(path))
    flat, tree = jax.tree_util.tree_flatten_with_path(params)
    flat_back, tree_back = jax.tree_util.tree_flatten_with_path(back)
    assert tree == tree_back
    for (key, a), (_, b) in zip(flat, flat_back):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=jax.tree_util.keystr(key))


def test_latest_checkpoint_and_state_round_trip(tmp_path):
    model = _port_model(None)
    opt = optim.make_optimizer(model, lr=1e-4, base_lr=1e-4, lr_backbone=1e-5)
    for m in opt.m:
        m.normal_()
    opt.count = 7
    state = TrainState.create(model, opt, seed=5, use_ema=True)
    state.step, state.nonfinite_count = 9, 2
    torch.rand(3, generator=state.generator)
    for epoch in (0, 11, 2):
        ckpt.save_checkpoint(str(tmp_path), epoch, {**state.state_dict(), "epoch": epoch})
    (tmp_path / "checkpoint_99.pth.tmp123").write_bytes(b"")   # a write cut short
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("checkpoint_11.pth")
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None
    fresh = _port_model(None)
    other = TrainState.create(fresh, optim.make_optimizer(fresh, lr=1e-4, base_lr=1e-4,
                                                          lr_backbone=1e-5), use_ema=True)
    other.load_state_dict(ckpt.restore_checkpoint(ckpt.latest_checkpoint(str(tmp_path))))
    assert (other.step, other.nonfinite_count, other.optimizer.count) == (9, 2, 7)
    assert torch.equal(torch.rand(3, generator=other.generator),
                       torch.rand(3, generator=state.generator))
    for a, b in zip(other.optimizer.m, opt.m):
        assert torch.equal(a, b)
    no_ema = TrainState.create(fresh, other.optimizer)
    with pytest.raises(ValueError):   # the run keeps no EMA, the checkpoint does
        no_ema.load_state_dict(state.state_dict())
