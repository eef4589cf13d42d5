"""The port's PAVE host modules (pave/crop_utils, metrics, engine,
dmg_dataset, infer_utils, batch_eval and tools/get_metrics) against the JAX
package's, on the same seeded numpy inputs: every list, array, dict and CSV
text must be equal.  No model: run_batch_eval takes one seeded numpy
forward function in both packages."""
import contextlib
import csv
import importlib.util
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from open_groundingdino_tpu.data.loader import Collator as JCollator
from open_groundingdino_tpu.data.tokenization import build_tokenizer as jbuild_tokenizer
from open_groundingdino_tpu.pave import batch_eval as jbatch_eval
from open_groundingdino_tpu.pave import crop_utils as jcrop
from open_groundingdino_tpu.pave import dmg_dataset as jdmg
from open_groundingdino_tpu.pave import engine as jengine
from open_groundingdino_tpu.pave import infer_utils as jinfer
from open_groundingdino_tpu.pave import metrics as jmetrics
from open_groundingdino_tpu_torch.data.loader import Collator
from open_groundingdino_tpu_torch.data.tokenization import build_tokenizer
from open_groundingdino_tpu_torch.pave import (batch_eval, crop_utils, dmg_dataset, engine,
                                               infer_utils, metrics)
from open_groundingdino_tpu_torch.tools import get_metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABELS = ["dent", "scratch", "broken"]
VOCAB = "[PAD] [UNK] [CLS] [SEP] [MASK] . dent scratch broken".split()

# (frame (h, w), car box): inside, against each edge, wider and taller than
# the frame, a frame smaller than a crop, a box smaller than a stride and a
# padded box under one stride tall
CLAMP_CASES = [
    ((1080, 1920), (200, 150, 1700, 950)),
    ((1080, 1920), (30, 20, 900, 700)),
    ((1080, 1920), (1100, 500, 1900, 1075)),
    ((1080, 1920), (-50, -40, 2100, 1200)),
    ((400, 300), (50, 60, 250, 350)),
    ((720, 1280), (600, 300, 650, 340)),
    ((720, 1280), (300, 300, 900, 350)),
]


def _equal_crops(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.keys() == r.keys() and g["crop_box"] == r["crop_box"]
        for k in ("image", "boxes", "labels"):
            assert g[k].dtype == r[k].dtype
            np.testing.assert_array_equal(g[k], r[k])


def _frame(h, w, seed):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


def _gt(rng, hw, n):
    h, w = hw
    xy = rng.uniform(0, 1, (n, 2)) * [w - 80, h - 80]
    wh = rng.uniform(10, 80, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("hw,car", CLAMP_CASES)
def test_create_crop_boxes_and_translations(hw, car):
    got = crop_utils.create_crop_boxes(hw, car)
    assert got == jcrop.create_crop_boxes(hw, car)
    assert got == crop_utils.create_crop_boxes(hw, car, 100, (512, 512), (256, 256))
    kw = dict(padding=40, crop_size=(384, 256), stride=(192, 128))
    assert crop_utils.create_crop_boxes(hw, car, **kw) == jcrop.create_crop_boxes(hw, car, **kw)
    frame = _frame(*hw, seed=1)
    box = (10.5, 20.0, 60.0, 90.25)
    for cb in got[:3]:
        np.testing.assert_array_equal(crop_utils.crop_image(frame, cb), jcrop.crop_image(frame, cb))
        assert crop_utils.is_inside(box, cb) == jcrop.is_inside(box, cb)
        assert crop_utils.translate_box_to_crop(box, cb) == jcrop.translate_box_to_crop(box, cb)
        assert crop_utils.translate_box_to_image(box, cb) == jcrop.translate_box_to_image(box, cb)


@pytest.mark.parametrize("keep_empty,max_crops,seeded", [(False, 64, False), (True, 64, False),
                                                         (True, 5, False), (True, 5, True),
                                                         (False, 3, False)])
def test_crops_with_boxes(keep_empty, max_crops, seeded):
    hw, car = CLAMP_CASES[0]
    frame = _frame(*hw, seed=2)
    rng = np.random.RandomState(4)
    gt = _gt(rng, hw, 12)
    labels = rng.randint(0, 3, 12)
    kw = dict(keep_empty=keep_empty, max_crops=max_crops)
    got = crop_utils.crops_with_boxes(frame, car, gt, labels, **kw,
                                      rng=np.random.RandomState(9) if seeded else None)
    ref = jcrop.crops_with_boxes(frame, car, gt, labels, **kw,
                                 rng=np.random.RandomState(9) if seeded else None)
    _equal_crops(got, ref)
    assert len(got) == min(max_crops, 21 if keep_empty else len(got))


def test_crops_to_samples_and_merge():
    hw, car = CLAMP_CASES[0]
    frame = _frame(*hw, seed=3)
    rng = np.random.RandomState(5)
    gt = _gt(rng, hw, 8)
    labels = rng.randint(0, 3, 8)
    caption = "dent . scratch . broken ."
    got = engine.crops_to_samples(frame, car, gt, labels, caption, LABELS, image_id=7,
                                  keep_empty=True, max_crops=16)
    ref = jengine.crops_to_samples(frame, car, gt, labels, caption, LABELS, image_id=7,
                                   keep_empty=True, max_crops=16)
    assert got[1] == ref[1] and len(got[0]) == len(ref[0]) == 16
    for s, r in zip(got[0], ref[0]):
        np.testing.assert_array_equal(np.asarray(s.image), np.asarray(r.image))
        np.testing.assert_array_equal(s.boxes, r.boxes)
        np.testing.assert_array_equal(s.labels, r.labels)
        assert (s.image_id, tuple(s.orig_size), s.caption, s.cap_list) == (
            r.image_id, tuple(r.orig_size), r.caption, r.cap_list)
    crop_boxes = got[1]
    results = []
    for i in range(len(crop_boxes)):   # overlapping detections across crops
        n = i % 4
        xy = rng.uniform(0, 400, (n, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(20, 100, (n, 2))], 1).astype(np.float32)
        results.append({"scores": rng.uniform(0, 1, n).astype(np.float32), "boxes": boxes,
                        "phrases": [LABELS[j % 3] for j in range(n)]})
    for nms in (0.5, 0.1):
        m_got = engine.merge_crop_predictions(results, crop_boxes, nms)
        m_ref = jengine.merge_crop_predictions(results, crop_boxes, nms)
        for k in ("boxes", "scores"):
            np.testing.assert_array_equal(m_got[k], m_ref[k])
        assert m_got["phrases"] == m_ref["phrases"] and len(m_got["boxes"]) > 3
    empty = [{"scores": np.zeros(0), "boxes": np.zeros((0, 4))}] * 2
    got_e = engine.merge_crop_predictions(empty, crop_boxes[:2])
    ref_e = jengine.merge_crop_predictions(empty, crop_boxes[:2])
    assert got_e["phrases"] == ref_e["phrases"] == []
    for k in ("boxes", "scores"):
        assert got_e[k].shape == ref_e[k].shape and got_e[k].dtype == ref_e[k].dtype


def test_metrics():
    rng = np.random.RandomState(6)
    hw = (1080, 1920)
    frames = [(_gt(rng, hw, n_pred), _gt(rng, hw, n_gt))
              for n_pred, n_gt in ((5, 3), (0, 2), (4, 0), (0, 0), (7, 7), (1, 1))]
    frames[-1] = (frames[-1][1] + 3.0, frames[-1][1])   # a near-perfect hit
    records, ref_records = [], []
    for pred, gt in frames:
        np.testing.assert_array_equal(metrics.iou_xyxy(pred, gt), jmetrics.iou_xyxy(pred, gt))
        np.testing.assert_array_equal(metrics.center_dist(pred, gt), jmetrics.center_dist(pred, gt))
        records.append(metrics.per_image_records(pred, gt))
        ref_records.append(jmetrics.per_image_records(pred, gt))
        assert records[-1] == ref_records[-1]
        for it, dt in ((0.5, 400.0), (0.1, 50.0)):
            assert metrics.count_tp_fp_fn(*records[-1], it, dt) == jmetrics.count_tp_fp_fn(
                *ref_records[-1], it, dt)
    for args in ((), (0.3, 100.0), (0.7, 200.0, 4)):
        assert metrics.summarize(records, *args) == jmetrics.summarize(ref_records, *args)
    assert metrics.summarize([]) == jmetrics.summarize([])
    assert metrics.threshold_sweep(records) == jmetrics.threshold_sweep(ref_records)
    kw = dict(iou_threshs=(0.2,), dist_threshs=(10, 1000))
    assert metrics.threshold_sweep(records, **kw) == jmetrics.threshold_sweep(ref_records, **kw)
    preds, gts = [p for p, _ in frames], [g for _, g in frames]
    assert engine.evaluate_frames(preds, gts) == jengine.evaluate_frames(preds, gts)
    assert engine.evaluate_frames(preds, gts, 0.3, 80.0) == jengine.evaluate_frames(
        preds, gts, 0.3, 80.0)


def test_dmg_dataset(tmp_path):
    names = ["MINOR_DENT", "MAJOR_SCRATCH", "MEDIUM_BROKEN_LAMP", "missing part",
             "SCRAPED_MEDIUM", "rust"]
    for n in names:
        assert dmg_dataset.damage_name_to_category(n) == jdmg.damage_name_to_category(n)
    for dmg in ("small", "medium", "large", "huge"):
        assert (dmg_dataset.get_coco_bbox([0.31, 0.77], 1080, 1920, dmg)
                == jdmg.get_coco_bbox([0.31, 0.77], 1080, 1920, dmg))
    assert dmg_dataset.DAMAGE_CATEGORIES == jdmg.DAMAGE_CATEGORIES
    for i in range(2):
        Image.fromarray(_frame(90 + 10 * i, 160, seed=10 + i)).save(tmp_path / f"f{i}.png")
    with open(tmp_path / "dmg.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["file_name", "dmg_count", "dmg_kpts", "car_bbox",
                                          "dmg_names"])
        w.writeheader()
        w.writerow(dict(file_name="f0.png", dmg_count="2", dmg_kpts="[[0.2, 0.3], [0.5, 0.6]]",
                        car_bbox="[10, 80, 20, 150]",
                        dmg_names='["MAJOR_DENT", "MINOR_SCRATCH"]'))
        w.writerow(dict(file_name="f1.png", dmg_count="0", dmg_kpts="[]",
                        car_bbox="[0, 1, 2, 3]", dmg_names=""))
        w.writerow(dict(file_name="f1.png", dmg_count="1.0", dmg_kpts="[[0.9, 0.1]]",
                        car_bbox="[5, 95, 7, 140]", dmg_names=""))
    got, ref = dmg_dataset.DmgDataset(str(tmp_path / "dmg.csv")), jdmg.DmgDataset(
        str(tmp_path / "dmg.csv"))
    assert len(got) == len(ref) == 2
    for i in range(2):
        g, r = got[i], ref[i]
        assert g.keys() == r.keys()
        for k, v in g.items():
            if isinstance(v, np.ndarray):
                assert v.dtype == r[k].dtype
                np.testing.assert_array_equal(v, r[k])
            else:
                assert v == r[k]


def test_get_img(tmp_path):
    Image.fromarray(_frame(100, 150, seed=12)).save(tmp_path / "a.png")
    for size in ((1920, 1080), (150, 100), None):
        got = infer_utils.get_img(str(tmp_path / "a.png"), size)
        ref = jinfer.get_img(str(tmp_path / "a.png"), size)
        assert got.size == ref.size
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def _manifest(tmp_path):
    """Two frames with a few GT boxes each, as batch_eval's CSV manifest."""
    rng = np.random.RandomState(13)
    rows = []
    for i, (hw, car) in enumerate((((700, 1100), (150, 120, 950, 600)),
                                   ((620, 900), (100, 50, 800, 560)))):
        path = tmp_path / f"frame{i}.png"
        Image.fromarray(_frame(*hw, seed=20 + i)).save(path)
        gt = _gt(rng, hw, 3 + i)
        rows.append(dict(image_path=str(path), car_bbox=",".join(str(v) for v in car),
                         gt_boxes=";".join(",".join(f"{v:.2f}" for v in b) for b in gt),
                         gt_labels=";".join(LABELS[j % 3] for j in range(len(gt)))))
    with open(tmp_path / "manifest.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return str(tmp_path / "manifest.csv")


class SeededForward:
    """A seeded numpy detector: per crop K boxes in crop pixels and scores
    that depend on the crop's pixels (so both packages must collate the
    same batch), the rest drawn from one RandomState."""

    def __init__(self, seed, k=6):
        self.rng, self.k = np.random.RandomState(seed), k

    def __call__(self, batch):
        B = len(batch["images"])
        content = np.asarray(batch["images"], np.float64).mean(axis=(1, 2, 3))
        xy = self.rng.uniform(0, 440, (B, self.k, 2))
        boxes = np.concatenate([xy, xy + self.rng.uniform(10, 70, (B, self.k, 2))], -1)
        scores = np.clip(self.rng.uniform(0, 1, (B, self.k)) + 0.05 * np.tanh(content)[:, None],
                         0, 1)
        return {"scores": scores.astype(np.float32), "boxes": boxes.astype(np.float32)}


def test_run_batch_eval_and_get_metrics(tmp_path):
    path = _manifest(tmp_path)
    rows, ref_rows = batch_eval.parse_manifest(path), jbatch_eval.parse_manifest(path)
    assert len(rows) == len(ref_rows) == 2
    for r, j in zip(rows, ref_rows):
        np.testing.assert_array_equal(r["gt_boxes"], j["gt_boxes"])
        assert (r["image_path"], r["car_bbox"], r["gt_labels"]) == (
            j["image_path"], j["car_bbox"], j["gt_labels"])
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    buckets = [(512, 512)]
    collator = Collator(build_tokenizer(str(tmp_path / "vocab.txt")), buckets, 16, 8)
    jcollator = JCollator(jbuild_tokenizer(str(tmp_path / "vocab.txt")), buckets, 16, 8)
    got = batch_eval.run_batch_eval(SeededForward(0), collator, rows, LABELS,
                                    out_csv=str(tmp_path / "port.csv"), batch_size=4)
    ref = jbatch_eval.run_batch_eval(SeededForward(0), jcollator, ref_rows, LABELS,
                                     out_csv=str(tmp_path / "jax.csv"), batch_size=4)
    assert got == ref and got["n_frames"] == 2
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()
    assert any(json.loads(r["pred_boxes"]) for r in csv.DictReader(open(tmp_path / "port.csv")))

    ab = batch_eval.run_ab_eval({"a": SeededForward(1), "b": SeededForward(2, k=3)}, collator,
                                rows, LABELS, out_dir=str(tmp_path / "ab_port"), batch_size=16)
    ab_ref = jbatch_eval.run_ab_eval({"a": SeededForward(1), "b": SeededForward(2, k=3)},
                                     jcollator, ref_rows, LABELS,
                                     out_dir=str(tmp_path / "ab_jax"), batch_size=16)
    assert ab == ab_ref and ab["a"] != ab["b"]
    for tag in ("a", "b"):
        assert ((tmp_path / "ab_port" / f"{tag}.csv").read_text()
                == (tmp_path / "ab_jax" / f"{tag}.csv").read_text())

    # the port's get_metrics against the JAX package's tool on that CSV
    spec = importlib.util.spec_from_file_location("jax_get_metrics",
                                                  os.path.join(ROOT, "tools", "get_metrics.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    csv_path = str(tmp_path / "port.csv")
    assert get_metrics.load_records(csv_path) == jtool.load_records(csv_path)
    for argv in ([csv_path], [csv_path, "--iou", "0.3", "--dist", "150"]):
        out_port, out_jax = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out_port):
            res = get_metrics.main(get_metrics.get_args_parser().parse_args(argv))
        with contextlib.redirect_stdout(out_jax), pytest.MonkeyPatch.context() as mp:
            mp.setattr("sys.argv", ["get_metrics.py", *argv])
            jtool.main()
        assert out_port.getvalue() == out_jax.getvalue()
    assert res["n_frames"] == 2 and res["sweep"] == got["sweep"]
    assert get_metrics.main(get_metrics.get_args_parser().parse_args([csv_path]))[
        "summary"] == got["summary"]
