"""The port's training data pipeline against the JAX package's.

A synthetic ODVG set (OD mode with a label map, and VG mode) on disk; the
same `random.Random` seeds drive both packages' TrainTransform through
ODVGDataset, so every sample must come out identical: image size and pixels,
boxes (abs 1e-4 px, f32), labels, caption.  The Collator then gives equal
padded uint8 images, token ids, masks, GT boxes, `gt_pos_maps` and
`gt_valid`; and the DataLoader visits the same indices per epoch, in the
calling thread and with loader threads.
"""
import json

import numpy as np
import pytest
from PIL import Image

from open_groundingdino_tpu.data import loader as jloader
from open_groundingdino_tpu.data import odvg as jodvg
from open_groundingdino_tpu.data import tokenization as jtok
from open_groundingdino_tpu.data import transforms as jtf
from open_groundingdino_tpu_torch.data import loader, odvg, tokenization, transforms

VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] . , cat dog person bicycle car traffic light "
         "bird chair table red ##s").split()
CATS = ("cat", "dog", "person", "bicycle", "car", "traffic light", "bird", "chair")
SIZES = ((300, 400), (520, 380), (640, 900), (350, 350))   # (h, w)
BUCKETS = [(480, 736), (736, 480), (608, 928), (928, 608), (800, 1216), (1216, 800),
           (800, 1344), (1344, 800), (1024, 1024)]
TRAIN = dict(scales=[480, 512, 544, 576, 608], max_size=1000, scales2_resize=[400, 500, 600],
             scales2_crop=[384, 600])


@pytest.fixture(scope="module")
def odvg_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("odvg")
    rng = np.random.RandomState(0)
    od, vg = [], []
    for i, (h, w) in enumerate(SIZES):
        name = f"img{i}.jpg"
        Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(root / name)
        boxes = []
        for _ in range(rng.randint(1, 6)):
            bw, bh = rng.uniform(0.1, 0.6) * w, rng.uniform(0.1, 0.6) * h
            x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            boxes.append([float(x0), float(y0), float(x0 + bw), float(y0 + bh)])
        od.append({"filename": name, "height": h, "width": w, "detection": {"instances": [
            {"bbox": b, "label": int(rng.randint(len(CATS)))} for b in boxes]}})
        vg.append({"filename": name, "height": h, "width": w, "grounding": {"regions": [
            {"bbox": b, "phrase": ["red cats", "a dog", "traffic light"][j % 3]}
            for j, b in enumerate(boxes)]}})
    for fname, metas in (("od.jsonl", od), ("vg.jsonl", vg)):
        (root / fname).write_text("\n".join(json.dumps(m) for m in metas) + "\n")
    (root / "label_map.json").write_text(json.dumps({str(i): c for i, c in enumerate(CATS)}))
    (root / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    return root


def _datasets(root, mode, seed):
    label_map = str(root / "label_map.json") if mode == "od" else None
    anno = str(root / f"{mode}.jsonl")
    j = jodvg.ODVGDataset(str(root), anno, label_map, max_labels=5,
                          transform=jtf.TrainTransform(**TRAIN), seed=seed)
    t = odvg.ODVGDataset(str(root), anno, label_map, max_labels=5,
                         transform=transforms.TrainTransform(**TRAIN), seed=seed)
    return j, t


@pytest.mark.parametrize("mode", ["od", "vg"])
@pytest.mark.parametrize("seed", [0, 7])
def test_dataset_and_transform_match_jax(odvg_files, mode, seed):
    j, t = _datasets(odvg_files, mode, seed)
    assert len(j) == len(t) == len(SIZES)
    for i in range(len(j)):
        a, b = j[i], t[i]
        assert a.image.size == b.image.size
        assert np.array_equal(np.asarray(a.image), np.asarray(b.image))
        np.testing.assert_allclose(b.boxes, a.boxes, atol=1e-4)
        assert np.array_equal(a.labels, b.labels)
        assert (a.caption, a.cap_list, a.orig_size) == (b.caption, b.cap_list, b.orig_size)


def test_transform_pieces_match_jax():
    rng = np.random.RandomState(3)
    img = Image.fromarray(rng.randint(0, 256, (200, 300, 3), np.uint8))
    boxes = np.asarray([[10, 20, 150, 180], [200, 5, 290, 60], [0, 0, 40, 40]], np.float32)
    labels = np.arange(3)
    js = jtf.Sample(img, boxes, labels)
    ts = transforms.Sample(img, boxes, labels)
    for jout, tout in ((jtf.hflip(js), transforms.hflip(ts)),
                       (jtf.crop(js, (15, 30, 120, 200)), transforms.crop(ts, (15, 30, 120, 200)))):
        assert jout.image.size == tout.image.size
        np.testing.assert_array_equal(tout.boxes, jout.boxes)
        np.testing.assert_array_equal(tout.labels, jout.labels)
    import random
    a = jtf.random_size_crop(js, 50, 150, random.Random(5))
    b = transforms.random_size_crop(ts, 50, 150, random.Random(5))
    np.testing.assert_array_equal(b.boxes, a.boxes)
    np.testing.assert_array_equal(transforms.boxes_to_cxcywh_norm(boxes, 200, 300),
                                  jtf.boxes_to_cxcywh_norm(boxes, 200, 300))


@pytest.mark.parametrize("mode", ["od", "vg"])
def test_collator_matches_jax(odvg_files, mode):
    j, t = _datasets(odvg_files, mode, 1)
    jcol = jloader.Collator(jtok.build_tokenizer(str(odvg_files / "vocab.txt")), BUCKETS, 32, 8,
                            u8_images=True)
    tcol = loader.Collator(tokenization.build_tokenizer(str(odvg_files / "vocab.txt")), BUCKETS, 32,
                           8, u8_images=True)
    a = jcol([j[i] for i in range(len(j))])
    b = tcol([t[i] for i in range(len(t))])
    for key in ("images", "image_sizes", "input_ids", "text_token_mask", "position_ids",
                "text_self_attention_masks", "gt_pos_maps", "gt_valid", "image_ids"):
        assert b[key].dtype == a[key].dtype, key
        np.testing.assert_array_equal(b[key], a[key], err_msg=key)
    np.testing.assert_allclose(b["gt_boxes"], a["gt_boxes"], atol=1e-6)
    assert b["gt_pos_maps"].sum() > 0 and b["gt_valid"].sum() > 0
    caps = [s.caption for s in (t[i] for i in range(len(t)))]
    tok = tcol.tokenizer(caps, padding=32)
    jtk = jcol.tokenizer(caps, padding=32)
    for bi, s in enumerate(t[i] for i in range(len(t))):
        np.testing.assert_array_equal(
            tokenization.create_positive_map(tok, bi, [0], s.cap_list, s.caption, 32),
            jtok.create_positive_map(jtk, bi, [0], s.cap_list, s.caption, 32))
    assert tokenization.build_caption(CATS[:3]) == jtok.build_caption(CATS[:3])


def test_loader_order_matches_jax(odvg_files):
    j, t = _datasets(odvg_files, "od", 2)
    jcol = jloader.Collator(jtok.build_tokenizer(str(odvg_files / "vocab.txt")), BUCKETS, 32, 8)
    tcol = loader.Collator(tokenization.build_tokenizer(str(odvg_files / "vocab.txt")), BUCKETS, 32, 8)
    jl = jloader.DataLoader(j, jcol, batch_size=3, shuffle=True, seed=4, num_threads=2)
    for threads in (0, 2):
        tl = loader.DataLoader(t, tcol, batch_size=3, shuffle=True, seed=4, num_threads=threads)
        assert len(tl) == len(jl)
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            tl.set_epoch(epoch)
            ja = [(b["image_ids"].tolist(), b["n_real"]) for b in jl]
            ta = [(b["image_ids"].tolist(), b["n_real"]) for b in tl]
            assert ta == ja, (threads, epoch)
