"""Training's checkpointed encoder blocks keep the kernels' outputs
(`remat_save_kernels`, the JAX package's REMAT_SAVE_KERNELS=1 policy
`save_only_these_names("msda_out", "fusion_attn_out")`).

On a nano port model (2 encoder + 2 decoder layers, f32, fusion droppath
0.5), for each MSDA path (gather, sweep, sweep with msda_dec_fused,
banded_point):
  * the loss and every gradient of one training step with the kernels'
    outputs saved, with plain checkpointing (every op recomputed) and with
    checkpointing off agree at rel 1e-6 (the same forward; the recompute
    gives the same values);
  * the forward kernels one forward + backward runs, counted where each
    op's implementation reaches its kernel (`library.kernel_output`; an
    output handed back to a recompute runs none): ENC + DEC MSDA forwards
    and ENC fusion forwards with the outputs saved or no checkpointing,
    2 ENC + DEC and 2 ENC under plain checkpointing;
  * a recompute handed back a scaled fusion output moves the gradients: the
    kept tensors are what the backward reads.
`library.KernelOutputs` hands its outputs back in order, and raises where a
recompute reaches another op or a kept output was changed in place.  The
config key defaults to True, as the JAX package's switch.
"""
import collections
import contextlib

import numpy as np
import pytest
import torch

from open_groundingdino_tpu_torch.config import SLConfig
from open_groundingdino_tpu_torch.models.bert import BertConfig
from open_groundingdino_tpu_torch.models.criterion import SetCriterion
from open_groundingdino_tpu_torch.models.groundingdino import GroundingDINO, init_weights_
from open_groundingdino_tpu_torch.models.swin import SwinConfig
from open_groundingdino_tpu_torch.ops import library
from open_groundingdino_tpu_torch.parallel import optim
from open_groundingdino_tpu_torch.parallel.train_state import TrainState, make_train_step

B, T, QN, G, IMG = 2, 16, 12, 3, 96
ENC = DEC = 2
SWIN = dict(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 4), window_size=4,
            out_indices=(1, 2, 3))
BERT = dict(vocab_size=40, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
            intermediate_size=32, max_position_embeddings=32)
TOP = dict(hidden_dim=32, num_queries=QN, nheads=4, num_feature_levels=4, enc_layers=ENC,
           dec_layers=DEC, dim_feedforward=64, max_text_len=T, fusion_droppath=0.5)
MSDA_FWD = {"gather": "msda_fwd", "sweep": "sweep_fwd", "banded_point": "banded_fwd"}
PATHS = {"gather": {}, "sweep": {"kernel": "sweep"},
         "sweep-dec-fused": {"kernel": "sweep", "dec_fused": True},
         "banded_point": {"kernel": "banded_point"}}
ARMS = {"save": dict(checkpoint=True, save=True), "replay": dict(checkpoint=True, save=False),
        "off": dict(checkpoint=False, save=True)}


def _batch(seed=3):
    """Two images (one padded), a two-phrase caption, three GT slots."""
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
        "input_ids": ids, "text_token_mask": np.tile(np.arange(T)[None] < 10, (B, 1)),
        "position_ids": pos, "text_self_attention_masks": sam,
        "gt_boxes": (rng.uniform(0.3, 0.7, (B, G, 4)) * [1, 1, 0.4, 0.4]).astype(np.float32),
        "gt_pos_maps": pos_maps, "gt_valid": gt_valid,
    }


@contextlib.contextmanager
def kernel_runs():
    """Counts, by op name, the forward kernels run within the block: the
    implementations that library.kernel_output calls (not an output it
    hands back to a recompute)."""
    runs = collections.Counter()
    real = library.kernel_output

    def counted(name, impl, *args):
        def run(*a):
            runs[name] += 1
            return impl(*a)
        return real(name, run, *args)

    library.kernel_output = counted
    try:
        yield runs
    finally:
        library.kernel_output = real


def _step(msda, checkpoint, save):
    """(loss, the gradients, the forward kernels' runs) of one f32 training
    step from the seeded init."""
    model = init_weights_(GroundingDINO(
        SwinConfig(**SWIN), BertConfig(**BERT), **TOP, msda=msda or None,
        use_checkpoint=checkpoint, use_transformer_ckpt=checkpoint, remat_save_kernels=save), 0)
    opt = optim.make_optimizer(model, lr=1e-4, base_lr=1e-4, lr_backbone=1e-5)
    state = TrainState.create(model, opt, seed=0)
    captured = []
    opt.step = lambda grads, norm, finite: captured.append([g.clone() for g in grads])
    with kernel_runs() as runs:
        loss = make_train_step(SetCriterion(num_queries=QN))(state, _batch())["loss"]
    return float(loss), captured[0], runs


def _worst_rel(got, ref):
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(got, ref))


@pytest.mark.parametrize("path", sorted(PATHS))
def test_saved_kernel_outputs_match_replay_and_launch_once(path):
    msda = PATHS[path]
    runs = {arm: _step(msda, **kw) for arm, kw in ARMS.items()}
    loss, grads, _ = runs["save"]
    for arm in ("replay", "off"):
        np.testing.assert_allclose(runs[arm][0], loss, rtol=1e-6, err_msg=arm)
        assert _worst_rel(grads, runs[arm][1]) <= 1e-6, arm
    fwd = MSDA_FWD[msda.get("kernel", "gather")]
    # under dec_fused the decoder's sorted query sets go to sweep_fwd_allq
    dec = "sweep_fwd_allq" if msda.get("dec_fused") else fwd
    for arm, replays in (("save", 0), ("off", 0), ("replay", ENC)):
        calls = runs[arm][2]
        msda_fwd = calls[fwd] + (calls[dec] if dec != fwd else 0)
        assert (msda_fwd, calls["fusion_fwd"]) == (ENC + DEC + replays, ENC + replays), \
            (arm, dict(calls))
        if dec != fwd:
            assert calls[dec] == DEC, (arm, dict(calls))


class ScaledFusion(library.KernelOutputs):
    """KernelOutputs whose recompute hands back fusion_fwd's kept out_v
    scaled by 1.01."""

    def run(self, name, impl, args):
        out = super().run(name, impl, args)
        if self.at is not None and name == "fusion_fwd":
            out = (out[0] * 1.01, *out[1:])
        return out


def _scaled_fusion_cache():
    return ScaledFusion().contexts()


def test_the_backward_reads_the_saved_outputs(monkeypatch):
    loss, grads, _ = _step({}, checkpoint=True, save=True)
    monkeypatch.setattr(library, "saving_checkpoint_contexts", _scaled_fusion_cache)
    bad_loss, bad_grads, _ = _step({}, checkpoint=True, save=True)
    assert bad_loss == loss   # the forward is the same
    assert _worst_rel(bad_grads, grads) > 1e-3


def test_kernel_outputs_and_config_default():
    assert set(library.SAVED_OPS) <= set(library.custom_ops())
    x = torch.arange(4.0)
    calls = []

    def double(t):
        calls.append(1)
        return t * 2

    assert torch.equal(library.kernel_output("msda_fwd", double, x), x * 2)   # no checkpoint
    kept = library.KernelOutputs()
    forward, recompute = kept.contexts()
    with forward:
        out = library.kernel_output("msda_fwd", double, x)
        pair = library.kernel_output("fusion_fwd", lambda t: (t + 1, t - 1), x)
    assert len(calls) == 2
    for _ in range(2):   # a recompute may run more than once
        with recompute:
            again = library.kernel_output("msda_fwd", double, x + 5)
            pair2 = library.kernel_output("fusion_fwd", lambda t: (t, t), x)
        assert len(calls) == 2 and torch.equal(again, out) and again is not out
        assert all(torch.equal(a, b) for a, b in zip(pair2, pair))
    with recompute, pytest.raises(RuntimeError, match="reached fusion_fwd where its forward ran"):
        library.kernel_output("fusion_fwd", double, x)
    out.add_(1)
    with recompute, pytest.raises(RuntimeError, match="changed in place"):
        library.kernel_output("msda_fwd", double, x)
    assert not getattr(library._kept, "stack", [])
    cfg = SLConfig.fromfile(library.__file__.replace("ops/library.py", "config/cfg_coco.py"))
    assert cfg.remat_save_kernels is True
