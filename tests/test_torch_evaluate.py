"""The port's evaluation loop and its `main --eval` / per-epoch eval, at nano
size on the CPU.

`engine.evaluate_coco` is held against the JAX package's on the same fixed
predictions: a stub eval_step gives both loops the same logits and boxes for
each batch (JAX on a one-device CPU mesh), over a COCO val split whose last
batch is short, and the 12 stats must be equal.  Then the port's `main`
evaluates (--eval writes eval_stats.json) and trains two epochs with the EMA
against a val split whose ground truth is the initial weights' own
detections: the EMA, which stays at those weights, scores best, so best/ and
best_ema/ are both written, and log.txt carries the JAX package's keys.
"""
import json
import math
import os

import numpy as np
import pytest
import torch

import chip_smoke
import jax
from open_groundingdino_tpu import engine as jengine
from open_groundingdino_tpu.data import coco as jcoco
from open_groundingdino_tpu.data import loader as jloader
from open_groundingdino_tpu.data import transforms as jtransforms
from open_groundingdino_tpu.data.tokenization import build_tokenizer as jbuild_tokenizer
from open_groundingdino_tpu.models import postprocess as jpost
from open_groundingdino_tpu.parallel.mesh import make_mesh
from open_groundingdino_tpu_torch import engine, main as port_main
from open_groundingdino_tpu_torch.config import SLConfig
from open_groundingdino_tpu_torch.data import coco, loader, transforms
from open_groundingdino_tpu_torch.data.tokenization import build_tokenizer
from open_groundingdino_tpu_torch.inference import load_reference_state_dict
from open_groundingdino_tpu_torch.models.groundingdino import build_groundingdino
from open_groundingdino_tpu_torch.models.postprocess import PostProcess
from open_groundingdino_tpu_torch.parallel.train_state import make_eval_step

PORT_BASE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "open_groundingdino_tpu_torch", "config", "cfg_base.py")
# the verify skill's nano geometry, at images of at most 96 x 128
NANO_CFG = f"""
_base_ = {PORT_BASE!r}
backbone = "swin_nano_test"
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
eval_shortest_edge = 96
eval_max_size = 128
use_checkpoint = False
use_transformer_ckpt = False
num_select = 50
max_gt_boxes = 8
"""
VAL_IMAGES = (0, 2, 4, 6)   # landscape: one bucket at B = 4


def nano_workspace(root) -> dict:
    """Nano config, 200-entry vocab, seeded checkpoint (random biases) and
    the smoke's 8-image ODVG set with its datasets.json under `root`."""
    work = str(root)
    files = {"cfg": os.path.join(work, "cfg.py"), "vocab": os.path.join(work, "vocab.txt"),
             "ckpt": os.path.join(work, "ckpt.pth"), "work": work}
    with open(files["cfg"], "w") as f:
        f.write(NANO_CFG)
    chip_smoke.write_vocab(files["vocab"], 200)
    chip_smoke.write_checkpoint(files["cfg"], files["ckpt"], random_biases=True)
    files["train_manifest"] = chip_smoke.write_odvg(work)
    return files


def run_main(ws, out_dir, *flags, manifest=None, options=()):
    cli = port_main.get_args_parser().parse_args([
        "-c", ws["cfg"], "--datasets", manifest or ws["train_manifest"], "--output_dir",
        str(out_dir), "--vocab", ws["vocab"], "--device", "cpu", "--num_workers", "0",
        "--seed", "3", "--print_freq", "100", *flags, "--options", "batch_size=4", *options])
    return port_main.main(cli)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    return nano_workspace(tmp_path_factory.mktemp("nano"))


def _stub_outputs(i, gt_boxes, gt_pos_maps):
    """Batch i's fixed predictions: one query per GT box, near it, with
    logits on its label's tokens, and 30 - G queries at random."""
    rng = np.random.RandomState(100 + i)
    B, G, T = gt_pos_maps.shape
    logits = rng.randn(B, 30, T).astype(np.float32) - 3.0
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (B, 30, 2)), rng.uniform(0.05, 0.4, (B, 30, 2))],
                           -1).astype(np.float32)
    logits[:, :G] += 6.0 * gt_pos_maps * rng.uniform(0.3, 1.0, (B, G, 1))
    boxes[:, :G] = gt_boxes + rng.uniform(-0.03, 0.03, gt_boxes.shape)
    return logits, boxes


def test_evaluate_coco_matches_jax(ws):
    work = ws["work"]
    manifest = chip_smoke.write_coco_val(work, (0, 1, 2, 4, 6), name="five")
    with open(manifest) as f:
        anno = json.load(f)["val"][0]["anno"]
    root = os.path.join(work, "odvg")
    cfg = SLConfig.fromfile(ws["cfg"])
    kw = dict(num_select=50, max_text_len=32, nms_iou_threshold=0.7)

    ds = coco.CocoDetection(root, anno, transform=transforms.EvalTransform(96, 128))
    port_loader = loader.DataLoader(
        ds, loader.Collator(build_tokenizer(ws["vocab"]), cfg.image_buckets, 32, 8), batch_size=2)
    post = PostProcess(build_tokenizer(ws["vocab"]), ds.cat_list, **kw)
    calls = []

    def port_step(batch, params):
        logits, boxes = _stub_outputs(len(calls), batch["gt_boxes"], batch["gt_pos_maps"])
        calls.append(batch["n_real"])
        return {"pred_logits": torch.from_numpy(logits), "pred_boxes": torch.from_numpy(boxes),
                "loss": torch.tensor(float(len(calls)))}

    got = engine.evaluate_coco(port_step, {}, port_loader, post, ds.coco,
                               ds.contiguous_to_catid)
    assert calls == [2, 2, 1]     # the last batch is short: one real image

    jds = jcoco.CocoDetection(root, anno, transform=jtransforms.EvalTransform(96, 128))
    jl = jloader.DataLoader(
        jds, jloader.Collator(jbuild_tokenizer(ws["vocab"]), cfg.image_buckets, 32, 8),
        batch_size=2, num_threads=1)
    jcalls = []

    def jax_step(params, sharded):
        logits, boxes = _stub_outputs(len(jcalls), np.asarray(sharded["gt_boxes"]),
                                      np.asarray(sharded["gt_pos_maps"]))
        jcalls.append(1)
        return {"pred_logits": jax.numpy.asarray(logits), "pred_boxes": jax.numpy.asarray(boxes),
                "loss": float(len(jcalls))}

    want = jengine.evaluate_coco(jax_step, {}, jl, make_mesh(jax.devices()[:1]),
                                 jpost.PostProcess(jbuild_tokenizer(ws["vocab"]), jds.cat_list,
                                                   **kw),
                                 jds.coco, jds.contiguous_to_catid)
    assert len(jcalls) == 3
    assert list(got) == list(want)
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])
    assert got["AP"] > 0.2


def test_main_eval_writes_stats(ws, tmp_path):
    manifest = chip_smoke.write_coco_val(ws["work"], VAL_IMAGES, name="four")
    run = run_main(ws, tmp_path / "out", "--eval", "--pretrain_model_path", ws["ckpt"],
                   manifest=manifest)
    with open(tmp_path / "out" / "eval_stats.json") as f:
        stats = json.load(f)
    assert list(stats) == list(chip_smoke.STAT_KEYS) and stats == run["stats"]
    assert all(math.isfinite(v) for v in stats.values())


def _pseudo_gt_manifest(ws) -> str:
    """VAL_IMAGES with the checkpoint's own f32 detections (after NMS) as
    their ground truth (chip_smoke.pseudo_ground_truth)."""
    cfg = SLConfig.fromfile(ws["cfg"])
    manifest = chip_smoke.write_coco_val(ws["work"], VAL_IMAGES, name="four")
    with open(manifest) as f:
        anno = json.load(f)["val"][0]["anno"]
    ds = coco.CocoDetection(os.path.join(ws["work"], "odvg"), anno,
                            transform=transforms.EvalTransform(96, 128))
    tok = build_tokenizer(ws["vocab"])
    batch = loader.Collator(tok, cfg.image_buckets, 32, 8, u8_images=True)(
        [ds[i] for i in range(len(ds))])
    model = build_groundingdino(cfg, device="cpu")
    load_reference_state_dict(model, ws["ckpt"])
    post = PostProcess(tok, ds.cat_list, num_select=50, max_text_len=32,
                       nms_iou_threshold=chip_smoke.PSEUDO_GT_NMS)
    results = post(make_eval_step(model)(batch), batch["orig_sizes"])
    pseudo = chip_smoke.pseudo_ground_truth(results, batch["image_ids"].tolist(),
                                            ds.contiguous_to_catid)
    return chip_smoke.write_coco_val(ws["work"], VAL_IMAGES, annotations=pseudo, name="pseudo")


def test_main_trains_with_eval_ema_and_best(ws, tmp_path):
    out = tmp_path / "out"
    run = run_main(ws, out, "--pretrain_model_path", ws["ckpt"], "--max_steps", "1",
                   manifest=_pseudo_gt_manifest(ws),
                   options=("epochs=2", "use_ema=True", "compute_dtype=float32", "lr=5e-3",
                            f"nms_iou_threshold={chip_smoke.PSEUDO_GT_NMS}"))
    with open(out / "log.txt") as f:
        lines = [json.loads(line) for line in f]
    assert [r["epoch"] for r in lines] == [0, 1]
    for r in lines:
        assert set(chip_smoke.LOG_KEYS) <= set(r), sorted(set(chip_smoke.LOG_KEYS) - set(r))
    # the EMA stays within ~1e-6 of the initial weights, whose detections
    # are the ground truth (at random weights near-tied scores reorder even
    # so); the model's 5e-3 step moves it far off them
    assert lines[0]["ema_AP"] > lines[0]["AP"]
    assert lines[-1]["best_AP"] == max(max(r["AP"], r["ema_AP"]) for r in lines)
    for d in ("best", "best_ema"):
        assert (out / d / "checkpoint_0.pth").exists()
    assert sorted(os.listdir(out)) == sorted(["best", "best_ema", "checkpoint_0.pth",
                                              "checkpoint_1.pth", "config_cfg.py", "info.txt",
                                              "log.txt"])
    assert run["best"]["best_ema"] == max(r["ema_AP"] for r in lines)
