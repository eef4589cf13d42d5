"""The port's eval pieces against the JAX package's: PostProcess and
nms_numpy (models/postprocess.py), the numpy COCO evaluator
(eval/coco_eval.py), the COCO dataset (data/coco.py) and the Collator's
orig_sizes (data/loader.py).

Seeded inputs go through both; PostProcess's scores agree to 1e-6 (the same
f32 sigmoid and product) with labels and boxes equal except at exact score
ties, NMS keeps the same boxes, the evaluator's 12 COCO stats agree to 1e-12
with the JAX evaluator, each on its numpy matcher and on its C++ one, and the
datasets and Collator give the same samples and sizes.
"""
import json

import numpy as np
import pytest
import torch

import chip_smoke
from open_groundingdino_tpu.data import coco as jcoco
from open_groundingdino_tpu.data import loader as jloader
from open_groundingdino_tpu.data import transforms as jtransforms
from open_groundingdino_tpu.data.tokenization import build_tokenizer as jbuild_tokenizer
from open_groundingdino_tpu.eval import coco_eval as jcoco_eval
from open_groundingdino_tpu.models import postprocess as jpost
from open_groundingdino_tpu_torch.data import coco, loader, transforms
from open_groundingdino_tpu_torch.data.tokenization import build_tokenizer
from open_groundingdino_tpu_torch.eval import coco_eval
from open_groundingdino_tpu_torch.models import postprocess

CATS = list(chip_smoke.CATEGORIES)
B, Q, T = 2, 900, 256


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vocab") / "vocab.txt")
    chip_smoke.write_vocab(path, 400)
    return path


def _outputs(seed=0):
    """Seeded (B, 900, 256) logits, -inf past the caption's tokens as the
    model gives them, and cxcywh boxes; each image's (h, w)."""
    rng = np.random.RandomState(seed)
    logits = (2.0 * rng.randn(B, Q, T)).astype(np.float32)
    logits[:, :, 40:] = -np.inf
    boxes = np.concatenate([rng.uniform(0.1, 0.9, (B, Q, 2)), rng.uniform(0.02, 0.5, (B, Q, 2))],
                           -1).astype(np.float32)
    sizes = np.asarray([[480, 640], [800, 1200]], np.int64)
    return logits, boxes, sizes


def _untied(scores):
    """Positions whose score equals no other score of its image."""
    ok = np.ones(scores.shape, bool)
    for b, s in enumerate(scores):
        vals, counts = np.unique(s, return_counts=True)
        ok[b] = np.isin(s, vals[counts == 1])
    return ok


@pytest.mark.parametrize("coco_id_remap", [False, True])
@pytest.mark.parametrize("nms", [-1.0, 0.5])
def test_postprocess_matches_jax(vocab, coco_id_remap, nms):
    kw = dict(num_select=300, max_text_len=T, nms_iou_threshold=nms, coco_id_remap=coco_id_remap)
    port = postprocess.PostProcess(build_tokenizer(vocab), CATS, **kw)
    ref = jpost.PostProcess(jbuild_tokenizer(vocab), CATS, **kw)
    np.testing.assert_array_equal(port.pos_map, ref.pos_map)
    assert port.emits_coco_ids == ref.emits_coco_ids == coco_id_remap
    logits, boxes, sizes = _outputs()
    got = port({"pred_logits": torch.from_numpy(logits), "pred_boxes": torch.from_numpy(boxes)},
               sizes)
    want = ref({"pred_logits": logits, "pred_boxes": boxes}, sizes)
    for g, w in zip(got, want):
        assert len(g["scores"]) == len(w["scores"]) and len(g["scores"]) > 0
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=1e-6)
        ok = _untied(w["scores"][None])[0]
        assert ok.mean() > 0.9
        np.testing.assert_array_equal(g["labels"][ok], w["labels"][ok])
        np.testing.assert_allclose(g["boxes"][ok], w["boxes"][ok], rtol=1e-6, atol=1e-4)
        if coco_id_remap:
            assert set(g["labels"].tolist()) <= set(postprocess.COCO_ID_MAP.values())


def test_postprocess_device_half_is_packed(vocab):
    """device() gives one (B, K, 6) tensor on the logits' device; host()
    takes it, or the copy copy_to_host started (a CPU tensor stays as it
    is), to the same results."""
    port = postprocess.PostProcess(build_tokenizer(vocab), CATS, num_select=50, max_text_len=T)
    logits, boxes, sizes = _outputs(1)
    out = {"pred_logits": torch.from_numpy(logits), "pred_boxes": torch.from_numpy(boxes)}
    packed = port.device(out, sizes)
    assert tuple(packed.shape) == (B, 50, 6) and packed.dtype == torch.float32
    assert port.copy_to_host(packed) is packed
    scores, labels, xyxy = postprocess.postprocess(out["pred_logits"], out["pred_boxes"],
                                                   torch.from_numpy(port.pos_map).float(),
                                                   torch.from_numpy(sizes), 50)
    res = port.host(packed)
    for b in range(B):
        np.testing.assert_array_equal(res[b]["scores"], scores[b].numpy())
        np.testing.assert_array_equal(res[b]["labels"], labels[b].numpy())
        np.testing.assert_array_equal(res[b]["boxes"], xyxy[b].numpy())
    assert (np.diff(res[0]["scores"]) <= 0).all()


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
def test_nms_numpy_matches_jax(thr):
    rng = np.random.RandomState(int(thr * 10))
    xy = rng.uniform(0, 200, (300, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 80, (300, 2))], -1).astype(np.float32)
    scores = rng.uniform(0, 1, 300).astype(np.float32)
    keep = postprocess.nms_numpy(boxes, scores, thr)
    np.testing.assert_array_equal(keep, jpost.nms_numpy(boxes, scores, thr))
    assert 0 < len(keep) < 300


def _coco_gt(seed=0):
    """A synthetic COCO ground truth: 7 images (one without annotations),
    5 categories (one without any), small, medium and large boxes, crowd
    instances."""
    rng = np.random.RandomState(seed)
    images = [{"id": 10 + i, "file_name": f"im{i}.jpg", "height": 480, "width": 640}
              for i in range(7)]
    cats = [{"id": c, "name": n} for c, n in zip((1, 3, 5, 7, 9), CATS[:5])]
    anns = []
    for im in images[:-1]:
        # a small, a medium and a large instance, then any
        for k in range(3 + rng.randint(0, 5)):
            side = (20.0, 60.0, 200.0)[k] if k < 3 else rng.choice([12.0, 50.0, 80.0, 300.0])
            w, h = side * rng.uniform(0.7, 1.3), side * rng.uniform(0.7, 1.3)
            x, y = rng.uniform(0, 640 - w), rng.uniform(0, 480 - h)
            anns.append({"id": len(anns) + 1, "image_id": im["id"],
                         "category_id": int(rng.choice([1, 3, 5, 7])), "bbox": [x, y, w, h],
                         "area": w * h, "iscrowd": int(k >= 3 and rng.uniform() < 0.3)})
    return {"images": images, "annotations": anns, "categories": cats}


def _predictions(gt, seed=1):
    """Jittered GT boxes with random scores and labels (some wrong), plus
    random false positives; image 10 gets none."""
    rng = np.random.RandomState(seed)
    preds = {}
    for im in gt["images"][1:]:
        anns = [a for a in gt["annotations"] if a["image_id"] == im["id"]]
        boxes, labels = [], []
        for a in anns:
            x, y, w, h = a["bbox"]
            j = rng.uniform(-0.15, 0.15, 4) * [w, h, w, h]
            boxes.append([x + j[0], y + j[1], x + w + j[2], y + h + j[3]])
            labels.append(a["category_id"] if rng.uniform() < 0.8 else int(rng.choice([1, 3, 9])))
        for _ in range(rng.randint(0, 12)):
            x, y = rng.uniform(0, 500), rng.uniform(0, 380)
            boxes.append([x, y, x + rng.uniform(5, 140), y + rng.uniform(5, 100)])
            labels.append(int(rng.choice([1, 3, 5, 7, 9])))
        preds[im["id"]] = {"boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
                           "scores": rng.uniform(0.05, 1.0, len(boxes)).astype(np.float32),
                           "labels": np.asarray(labels, np.int64)}
    return preds


def _port_stats(gt, preds, use_native=True):
    ev = coco_eval.CocoBboxEvaluator(coco.CocoIndex(dataset=gt), use_native=use_native)
    ev.update(preds)
    ev.accumulate()
    return ev.summarize()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("use_native", [False, True])
def test_coco_evaluator_matches_jax(seed, use_native):
    gt = _coco_gt(seed)
    preds = _predictions(gt, seed + 10)
    ref = jcoco_eval.CocoBboxEvaluator(jcoco.CocoIndex(dataset=gt), use_native=use_native)
    ref.update(preds)
    ref.accumulate()
    want = ref.summarize()
    got = _port_stats(gt, preds, use_native)
    assert list(got) == list(want) and len(got) == 12
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])
    assert 0.0 < got["AP"] < 1.0 and got["APs"] > -1 and got["APm"] > -1 and got["APl"] > -1


def test_ground_truth_as_predictions_scores_one():
    gt = _coco_gt(3)
    preds = {im["id"]: {"boxes": [], "scores": [], "labels": []} for im in gt["images"]}
    for a in gt["annotations"]:
        if a["iscrowd"]:
            continue
        x, y, w, h = a["bbox"]
        p = preds[a["image_id"]]
        p["boxes"].append([x, y, x + w, y + h])
        p["scores"].append(1.0 - 1e-3 * a["id"])
        p["labels"].append(a["category_id"])
    stats = _port_stats(gt, preds)
    for k in ("AP", "AP50", "AP75", "AR100"):
        assert stats[k] == 1.0, (k, stats)
    assert all(stats[k] in (1.0, -1.0) for k in ("APs", "APm", "APl"))


@pytest.fixture(scope="module")
def coco_files(tmp_path_factory):
    """3 JPEGs and an annotation file with a crowd box, a box past the image
    edge (clamped) and a degenerate box (dropped)."""
    root = tmp_path_factory.mktemp("coco")
    sizes = ((120, 160), (90, 200), (150, 100))
    images, anns = [], []
    for i, (h, w) in enumerate(sizes):
        chip_smoke.synthetic_image(h, w, 30 + i).save(str(root / f"im{i}.jpg"), quality=90)
        images.append({"id": 5 + 2 * i, "file_name": f"im{i}.jpg", "height": h, "width": w})
        for j, (bbox, crowd) in enumerate((([10, 12, 40, 30], 0), ([w - 20, 5, 50, 20], 0),
                                           ([30, 30, 0, 10], 0), ([5, 5, 20, 20], 1))):
            anns.append({"id": len(anns) + 1, "image_id": 5 + 2 * i, "bbox": bbox,
                         "category_id": (2, 4, 6)[(i + j) % 3], "iscrowd": crowd,
                         "area": bbox[2] * bbox[3]})
    cats = [{"id": c, "name": n} for c, n in zip((2, 4, 6), ("dog", "cat", "traffic light"))]
    anno = root / "val.json"
    anno.write_text(json.dumps({"images": images, "annotations": anns, "categories": cats}))
    return str(root), str(anno)


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_coco_detection_matches_jax(coco_files, idx):
    root, anno = coco_files
    port = coco.CocoDetection(root, anno, transform=transforms.EvalTransform(64, 96))
    ref = jcoco.CocoDetection(root, anno, transform=jtransforms.EvalTransform(64, 96))
    assert port.contiguous_to_catid == ref.contiguous_to_catid == {0: 2, 1: 4, 2: 6}
    assert port.cat_list == ref.cat_list
    got, want = port[idx], ref[idx]
    np.testing.assert_array_equal(np.asarray(got.image), np.asarray(want.image))
    np.testing.assert_array_equal(got.boxes, want.boxes)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert len(got.boxes) == 2   # the degenerate and the crowd box dropped
    assert (got.image_id, got.orig_size, got.caption, got.cap_list) == \
        (want.image_id, want.orig_size, want.caption, want.cap_list)


def test_collator_orig_sizes_match_jax(coco_files, vocab):
    root, anno = coco_files
    port = coco.CocoDetection(root, anno, transform=transforms.EvalTransform(64, 96))
    ref = jcoco.CocoDetection(root, anno, transform=jtransforms.EvalTransform(64, 96))
    buckets = [(64, 96), (96, 64), (96, 96)]
    got = loader.Collator(build_tokenizer(vocab), buckets, 32, 8)([port[i] for i in range(3)])
    want = jloader.Collator(jbuild_tokenizer(vocab), buckets, 32, 8)([ref[i] for i in range(3)])
    assert got["orig_sizes"].dtype == want["orig_sizes"].dtype == np.int64
    np.testing.assert_array_equal(got["orig_sizes"], want["orig_sizes"])
    np.testing.assert_array_equal(got["orig_sizes"], [[120, 160], [90, 200], [150, 100]])
    for k in ("images", "image_sizes", "input_ids", "gt_boxes", "image_ids"):
        np.testing.assert_array_equal(got[k], want[k])
