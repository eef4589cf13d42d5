"""The PAVE pipeline of the port through a nano detector, against the JAX
package on the same weights.

A nano GroundingDINO (tests/test_torch_model.py's widths, one encoder,
decoder and BERT layer: the JAX compiles set this file's time) with the port's
seeded reference init, the deformable offsets perturbed off the pixel
lattice as tests/test_torch_model.py does, goes to both packages through one
reference-keyed .pth (the JAX package reads it with its own loader); both
read one config with one image bucket, 800x800, which holds a 512x512 crop
and the tools' square images at predict's default size alike, so the JAX
side compiles its forward once for predict and once for make_eval_step.  A
frame's crop batch from `crops_to_samples` goes through each package's
Collator (equal batches) and `make_eval_step` (f32), flip-aware with
test_torch_model.py's limits; the port's tools/inference_pave.py (--device
cpu --car_bbox ...) against the JAX pipeline (JAX predict per crop, its
merge_crop_predictions) on the same .pth: boxes and scores within 1e-4,
phrases equal; and the port's inference_from_csv and inference_a_folder
against the JAX package's tools of the same names run on the same manifest,
folder, .pth and thresholds: equal files, rows, phrases, sizes and sentinel
rows, boxes and scores within 1e-4.
"""
import csv
import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from open_groundingdino_tpu import inference as jax_inference
from open_groundingdino_tpu.data.loader import Collator as JCollator
from open_groundingdino_tpu.data.tokenization import build_tokenizer as jbuild_tokenizer
from open_groundingdino_tpu.parallel.train_state import make_eval_step as jmake_eval_step
from open_groundingdino_tpu.pave import crop_utils as jcrop
from open_groundingdino_tpu.pave import engine as jengine
from open_groundingdino_tpu_torch.data.loader import Collator
from open_groundingdino_tpu_torch.data.tokenization import build_tokenizer
from open_groundingdino_tpu_torch.config import SLConfig
from open_groundingdino_tpu_torch.models.deformable import MSDeformAttn
from open_groundingdino_tpu_torch.models.groundingdino import build_groundingdino, init_weights_
from open_groundingdino_tpu_torch.parallel.train_state import make_eval_step
from open_groundingdino_tpu_torch.pave import engine
from open_groundingdino_tpu_torch.tools import (inference_a_folder, inference_from_csv,
                                                inference_pave)

T, QN = 16, 12
VOCAB = "[PAD] [UNK] [CLS] [SEP] [MASK] . ? dog cat bird dent scratch".split()
LABELS = ["dent", "scratch"]
CAPTION = "dent . scratch ."
BUCKETS = [(800, 800)]
REPO = Path(__file__).resolve().parents[1]
NANO_CFG = """
_base_ = "{base}"
backbone = "swin_nano_test"
hidden_dim = 32
nheads = 4
enc_layers = 1
dec_layers = 1
dim_feedforward = 64
num_queries = 12
max_text_len = 16
bert_vocab_size = 40
bert_hidden_size = 32
bert_layers = 1
bert_heads = 4
bert_intermediate = 32
bert_max_position = 32
image_buckets = {buckets}
use_checkpoint = False
use_transformer_ckpt = False
"""
# a frame and a car box whose padded box (50, 20, 650, 520) gives 3 crops
FRAME_HW = (600, 1000)
CAR_BBOX = (150, 120, 550, 420)


@pytest.fixture(scope="module")
def nano(tmp_path_factory):
    """The nano detector with the port's seeded reference init
    (init_weights_), its deformable offset and weight projections perturbed
    off the pixel lattice, as a reference-keyed .pth; both packages'
    configs; the JAX package's params through its own .pth loader; a frame."""
    import open_groundingdino_tpu
    import open_groundingdino_tpu_torch

    tmp = tmp_path_factory.mktemp("pave_nano")
    (tmp / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    for name, pkg in (("jax", open_groundingdino_tpu), ("port", open_groundingdino_tpu_torch)):
        base = f"{pkg.__path__[0]}/config/cfg_base.py"
        (tmp / f"cfg_{name}.py").write_text(NANO_CFG.format(base=base, buckets=BUCKETS))
    files = {name: (str(tmp / f"cfg_{name}.py"), str(tmp / "ckpt.pth"), str(tmp / "vocab.txt"))
             for name in ("jax", "port")}
    model = init_weights_(build_groundingdino(SLConfig.fromfile(files["port"][0]), device="cpu"),
                          0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MSDeformAttn):
                for lin in (m.sampling_offsets, m.attention_weights):
                    lin.weight.add_(0.05 * torch.randn(lin.weight.shape, generator=g))
    torch.save({"model": model.state_dict()}, files["port"][1])
    jim = jax_inference.load_model(*files["jax"])
    frame = np.random.RandomState(3).randint(0, 256, (*FRAME_HW, 3)).astype(np.uint8)
    Image.fromarray(frame).save(str(tmp / "frame.png"))
    return dict(tmp=tmp, jim=jim, model=model.eval(), files=files, frame=frame)


def _flip_aware(lg_t, bx_t, lg_j, bx_j):
    """tests/test_torch_model.py's limits: < 10% of the queries flipped, the
    rest |dlogit| < 1e-3, |dbox| < 1e-4."""
    assert lg_t.shape == lg_j.shape and bx_t.shape == bx_j.shape
    flip = np.max(np.abs(bx_t - bx_j), axis=-1) > 1e-2
    keep = ~flip
    assert flip.mean() < 0.10, f"{flip.mean():.1%} of queries flipped"
    fin = np.isfinite(lg_j) & keep[..., None]
    assert np.array_equal(np.isfinite(lg_t), np.isfinite(lg_j))
    assert np.max(np.abs(lg_t[fin] - lg_j[fin])) < 1e-3
    assert np.max(np.abs(bx_t[keep] - bx_j[keep])) < 1e-4


def test_crop_batch_eval_step_matches_jax(nano):
    """A frame's three crops (GT translated in, empty crops kept) as one
    batch: equal Collator batches, then make_eval_step in f32 in both."""
    rng = np.random.RandomState(4)
    gt = np.asarray([[300, 200, 360, 250], [500, 300, 600, 420], [100, 50, 140, 90]], np.float32)
    labels = rng.randint(0, 2, len(gt))
    samples, crop_boxes = engine.crops_to_samples(nano["frame"], CAR_BBOX, gt, labels, CAPTION,
                                                  LABELS, keep_empty=True)
    jsamples, jcrop_boxes = jengine.crops_to_samples(nano["frame"], CAR_BBOX, gt, labels,
                                                     CAPTION, LABELS, keep_empty=True)
    assert crop_boxes == jcrop_boxes and len(crop_boxes) == 3
    vocab = nano["files"]["port"][2]
    batch = Collator(build_tokenizer(vocab), BUCKETS, T, 8)(samples)
    jbatch = JCollator(jbuild_tokenizer(vocab), BUCKETS, T, 8)(jsamples)
    common = ("images", "image_sizes", "input_ids", "text_token_mask", "position_ids",
              "text_self_attention_masks", "gt_boxes", "gt_pos_maps", "gt_valid")
    for k in common:
        np.testing.assert_array_equal(np.asarray(batch[k]), np.asarray(jbatch[k]), err_msg=k)
    assert batch["images"].shape == (3, 800, 800, 3)
    assert batch["image_sizes"].tolist() == [[512, 512]] * 3 and batch["gt_valid"].any()
    out = make_eval_step(nano["model"])(batch)
    jin = {k: jnp.asarray(jbatch[k]) for k in common[:6]}
    jout = jax.jit(jmake_eval_step(nano["jim"].model))(nano["jim"].params, jin)
    _flip_aware(out["pred_logits"].numpy(), out["pred_boxes"].numpy(),
                np.asarray(jout["pred_logits"]), np.asarray(jout["pred_boxes"]))


def test_inference_pave_tool_matches_jax_pipeline(nano):
    """The port's tool on the CPU against JAX predict per crop and the JAX
    merge, the same .pth; boxes scaled by the crop's size in both."""
    tmp = nano["tmp"]
    cfg, ckpt, vocab = nano["files"]["port"]
    out_dir = tmp / "pave_out"
    kw = dict(box_threshold=0.0, text_threshold=0.05)
    pred = inference_pave.main(inference_pave.get_args_parser().parse_args([
        "-c", cfg, "-p", ckpt, "--vocab", vocab, "-i", str(tmp / "frame.png"),
        "--car_bbox", ",".join(str(v) for v in CAR_BBOX), "-t", CAPTION, "-o", str(out_dir),
        "--box_threshold", "0.0", "--text_threshold", "0.05", "--device", "cpu"]))
    with open(out_dir / "pred.json") as f:
        assert json.load(f) == pred
    assert Image.open(out_dir / "pred.jpg").size == FRAME_HW[::-1]

    jim = nano["jim"]
    crop_boxes = jcrop.create_crop_boxes(FRAME_HW, CAR_BBOX)
    results = []
    for cb in crop_boxes:
        crop = jcrop.crop_image(nano["frame"], cb)
        boxes, scores, phrases = jax_inference.predict(jim, Image.fromarray(crop), CAPTION,
                                                       size=512, max_size=512, **kw)
        b = np.asarray(boxes) * np.asarray([crop.shape[1], crop.shape[0]] * 2, np.float32)
        xyxy = np.concatenate([b[:, :2] - b[:, 2:] / 2, b[:, :2] + b[:, 2:] / 2], 1)
        results.append({"scores": scores, "boxes": xyxy, "phrases": phrases})
    ref = jengine.merge_crop_predictions(results, crop_boxes)
    assert pred["n_crops"] == len(crop_boxes) == 3
    assert len(pred["boxes_xyxy"]) == len(ref["boxes"]) > QN
    np.testing.assert_allclose(pred["boxes_xyxy"], ref["boxes"], atol=1e-4 * max(FRAME_HW))
    np.testing.assert_allclose(pred["scores"], ref["scores"], atol=1e-4)
    assert pred["phrases"] == ref["phrases"]


def test_inference_pave_tool_with_segmentor(nano):
    """--car_seg_checkpoint: the segmentor's bbox seeds the grid (a nano
    segmentor whose classifier calls every pixel a car: the whole frame)."""
    from open_groundingdino_tpu_torch.pave import repvit_seg

    tmp = nano["tmp"]
    seg = repvit_seg.init_segmentor(repvit_seg.RepViTConfig.from_name("nano_test"), seed=1,
                                    device="cpu")
    with torch.no_grad():
        seg.head.cls.bias.copy_(torch.tensor([-1e3, 1e3]))
    repvit_seg.save_segmentor(seg, str(tmp / "seg.pth"))
    cfg, ckpt, vocab = nano["files"]["port"]
    args = inference_pave.get_args_parser().parse_args([
        "-c", cfg, "-p", ckpt, "--vocab", vocab, "-i", str(tmp / "frame.png"),
        "--car_seg_checkpoint", str(tmp / "seg.pth"), "--car_seg_variant", "nano_test",
        "--car_seg_infer_size", "64,96", "-o", str(tmp / "seg_out"), "--device", "cpu"])
    car = inference_pave.car_bbox_from_args(args, nano["frame"])
    h, w = FRAME_HW
    assert car == pytest.approx([0.0, 0.0, 95 * w / 96, 63 * h / 64])
    pred = inference_pave.main(args)
    assert pred["n_crops"] == len(jcrop.create_crop_boxes(FRAME_HW, car)) == 8
    with torch.no_grad():
        seg.head.cls.bias.copy_(torch.tensor([1e3, -1e3]))
    repvit_seg.save_segmentor(seg, str(tmp / "seg.pth"))
    with pytest.raises(SystemExit):
        inference_pave.car_bbox_from_args(args, nano["frame"])


def _run_jax_tool(monkeypatch, nano, name, argv):
    """The JAX package's tools/<name>.py as a script on `argv`; its
    load_model (the nano .pth through the JAX loader) hands back the
    fixture's model, loaded by that loader from the same files, so the
    tools share its compiled forward."""
    def load_model(*files):
        assert files == nano["files"]["jax"]
        return nano["jim"]

    monkeypatch.setattr(jax_inference, "load_model", load_model)
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(sys, "argv", [name, *argv])
    runpy.run_path(str(REPO / "tools" / f"{name}.py"), run_name="__main__")


def test_csv_and_folder_tools(nano, monkeypatch):
    """inference_from_csv and inference_a_folder on the CPU against the JAX
    package's tools on the same manifest, folder, .pth and thresholds: equal
    predictions.json keys and phrases, equal CSV columns, inputs, sizes,
    labels and sentinel rows, boxes and scores within 1e-4; a missing file
    is skipped and an image without detections gets the sentinel row in
    both."""
    tmp = nano["tmp"]
    files = {"port": nano["files"]["port"], "jax": nano["files"]["jax"]}
    folder = tmp / "images"
    folder.mkdir()
    for i in range(2):
        Image.fromarray(np.random.RandomState(30 + i).randint(0, 256, (60, 60, 3)).astype(
            np.uint8)).save(folder / f"im{i}.png")
    thresholds = ["--box_threshold", "0.0", "--text_threshold", "0.05"]

    res = {}
    for pkg, (cfg, ckpt, vocab) in files.items():
        argv = ["-c", cfg, "-p", ckpt, "--vocab", vocab, "-i", str(folder), "-t", "dog . cat .",
                "-o", str(tmp / f"folder_{pkg}"), *thresholds]
        if pkg == "port":
            ret = inference_a_folder.main(inference_a_folder.get_args_parser().parse_args(
                argv + ["--device", "cpu"]))
        else:
            _run_jax_tool(monkeypatch, nano, "inference_a_folder", argv)
        with open(tmp / f"folder_{pkg}" / "predictions.json") as f:
            res[pkg] = json.load(f)
    assert res["port"] == ret
    assert sorted(res["port"]) == sorted(res["jax"]) == ["im0.png", "im1.png"]
    for name, ref in res["jax"].items():
        got = res["port"][name]
        assert set(got) == set(ref) == {"boxes_cxcywh_norm", "scores", "phrases"}
        assert got["phrases"] == ref["phrases"] and len(ref["phrases"]) == QN
        np.testing.assert_allclose(got["boxes_cxcywh_norm"], ref["boxes_cxcywh_norm"], atol=1e-4)
        np.testing.assert_allclose(got["scores"], ref["scores"], atol=1e-4)

    with open(tmp / "manifest.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["input"])
        w.writerows([[str(folder / "im0.png")], [str(folder / "missing.png")],
                     [str(folder / "im1.png")]])
    for box_threshold in ("0.0", "1.0"):
        written = {}
        for pkg, (cfg, ckpt, vocab) in files.items():
            out = tmp / f"results_{box_threshold}_{pkg}.csv"
            argv = ["-c", cfg, "-p", ckpt, "--vocab", vocab, "--csv", str(tmp / "manifest.csv"),
                    "-t", "dog . cat .", "-o", str(out), "--box_threshold", box_threshold,
                    "--text_threshold", "0.05", "--draw_dir", str(tmp / f"drawn_{pkg}")]
            if pkg == "port":
                rows = inference_from_csv.main(inference_from_csv.get_args_parser().parse_args(
                    argv + ["--device", "cpu"]))
            else:
                _run_jax_tool(monkeypatch, nano, "inference_from_csv", argv)
            with open(out, newline="") as f:
                written[pkg] = list(csv.DictReader(f))
        assert written["port"] == [{k: str(v) for k, v in r.items()} for r in rows]
        assert len(written["jax"]) == 2 and list(written["jax"][0]) == list(written["port"][0])
        for got, ref in zip(written["port"], written["jax"]):
            assert {k: got[k] for k in ("input", "size", "labels")} == {
                k: ref[k] for k in ("input", "size", "labels")}
            if box_threshold == "1.0":   # the sentinel row, text for text
                assert got == ref and json.loads(ref["labels"]) == ["-17"]
                continue
            assert len(json.loads(ref["labels"])) == QN
            for k in ("bbox", "all_boxes"):   # pixels of a 60x60 image
                np.testing.assert_allclose(json.loads(got[k]), json.loads(ref[k]), atol=1e-4 * 60)
            np.testing.assert_allclose(json.loads(got["all_scores"]), json.loads(ref["all_scores"]),
                                       atol=1e-4)
    assert (sorted(p.name for p in (tmp / "drawn_port").iterdir())
            == sorted(p.name for p in (tmp / "drawn_jax").iterdir()) == ["pred0.jpg", "pred2.jpg"])
