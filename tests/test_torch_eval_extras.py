"""The rest of the port's zero-shot eval surface against the JAX package, on
the CPU: the C++ greedy COCO matcher (utils/native.py), dataset staging
(data/staging.py), the strong augmentations (data/strong_aug.py), and
`main --debug` / `--stage_dir` and tools/zero_shot_eval.py at nano size,
and the small utilities utils/slio.py and utils/time_counter.py.

The port's native matcher is held against its numpy matcher and against the
JAX package's native matcher on seeded IoU matrices with crowd and ignored
ground truth, and with no detection or no ground truth (skipped only where
g++ is missing, as tests/test_native_match.py); a library that cannot be
built warns once and leaves the numpy matcher.  Staging a directory, a file
and a zip gives the JAX package's manifest and copies, twice, and cleans up
as it does.  Each strong augmentation gives the JAX package's image, boxes
and labels from equal seeds.  `main --debug --stage_dir` stops a 16-batch
epoch and its 16-batch evaluation at 15 and removes its staged copies; the
zero-shot tool on a nano .pth prints the 12 numbers that the port's `main
--eval` writes to eval_stats.json.  slio writes and reads back what the JAX
package's does, each reading the other's files, and raises on the same
extensions; time_counter's meters average the same sections.
"""
import json
import os
import random
import shutil
import warnings
import zipfile

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from open_groundingdino_tpu.data import staging as jstaging
from open_groundingdino_tpu.data import strong_aug as jaug
from open_groundingdino_tpu.data.transforms import Sample as JSample
from open_groundingdino_tpu.utils import native as jnative
from open_groundingdino_tpu.utils import slio as jslio
from open_groundingdino_tpu.utils import time_counter as jtime_counter
from open_groundingdino_tpu_torch import main as port_main
from open_groundingdino_tpu_torch.data import coco, staging
from open_groundingdino_tpu_torch.data import strong_aug as aug
from open_groundingdino_tpu_torch.data.transforms import Sample
from open_groundingdino_tpu_torch.eval import coco_eval
from open_groundingdino_tpu_torch.tools import zero_shot_eval
from open_groundingdino_tpu_torch.utils import native, slio, time_counter

THRS = np.linspace(0.5, 0.95, 10)
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ toolchain")


def _match_case(D, G, seed):
    """Seeded IoUs (D, G), ignored GT sorted last, a crowd GT among them."""
    rng = np.random.RandomState(seed)
    ious = rng.rand(D, G)
    ignore = np.zeros(G, bool)
    ignore[G - G // 3:] = True
    crowd = np.zeros(G, bool)
    if G:
        crowd[G - 1] = True
    return ious, ignore, crowd


def _numpy_match(ious, ignore, crowd):
    ev = coco_eval.CocoBboxEvaluator(coco.CocoIndex(dataset={"images": [], "categories": []}),
                                     use_native=False)
    return ev._match(ious, ignore, crowd, *ious.shape)


@needs_gxx
@pytest.mark.parametrize("D,G,seed", [(20, 6, 0), (40, 9, 1), (7, 3, 2), (0, 5, 3), (6, 0, 4)])
def test_native_matcher_matches_numpy_and_jax(D, G, seed):
    ious, ignore, crowd = _match_case(D, G, seed)
    calls = native.coco_greedy_match.calls
    got = native.coco_greedy_match(ious, ignore, crowd, THRS)
    assert got is not None and native.coco_greedy_match.calls == calls + 1
    assert os.path.exists(native.lib_path("coco_match"))
    want = jnative.coco_greedy_match(ious, ignore, crowd, THRS)
    ref = _numpy_match(ious, ignore, crowd)
    for a, b, c in zip(got, want, ref):
        assert a.shape == b.shape == c.shape and a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    if D and G:
        assert (got[0] >= 0).any() and got[2].any()   # real and ignored matches both occur


def test_native_build_failure_warns_once(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "NATIVE_DIR", str(tmp_path))
    with pytest.warns(RuntimeWarning, match="numpy version runs instead"):
        assert native.build_and_load("no_such_matcher") is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert native.build_and_load("no_such_matcher") is None
    native._libs.pop("no_such_matcher")


# ---- staging --------------------------------------------------------------------
def _tree(root: str) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _relative(manifest: dict, stage_dir: str) -> dict:
    return {split: [{k: os.path.relpath(v, stage_dir) if k in ("root", "anno", "label_map") else v
                     for k, v in e.items()} for e in entries]
            for split, entries in manifest.items()}


def test_staging_matches_jax(tmp_path):
    """A directory, a file, a zip and a second source with the same basename:
    the staged manifests and copies equal the JAX package's, a second
    staging copies nothing more, and cleanup leaves what the JAX one does."""
    src = tmp_path / "src"
    (src / "images" / "sub").mkdir(parents=True)
    (src / "images" / "a.jpg").write_bytes(b"\xff\xd8 a")
    (src / "images" / "sub" / "b.jpg").write_bytes(b"\xff\xd8 b")
    (src / "train.jsonl").write_text('{"filename": "a.jpg"}\n')
    (src / "other").mkdir()
    (src / "other" / "train.jsonl").write_text('{"filename": "b.jpg"}\n')
    with zipfile.ZipFile(src / "val.zip", "w") as zf:
        zf.writestr("val/im0.jpg", b"\xff\xd8 z")
    (src / "label_map.json").write_text('{"0": "cat"}')
    manifest = {
        "train": [{"root": str(src / "images"), "anno": str(src / "train.jsonl"),
                   "label_map": str(src / "label_map.json"), "dataset_mode": "odvg"},
                  {"root": str(src / "images"), "anno": str(src / "other" / "train.jsonl"),
                   "dataset_mode": "odvg"}],
        "val": [{"root": str(src / "val.zip"), "anno": str(src / "train.jsonl"),
                 "dataset_mode": "coco"}],
    }
    runs = {}
    for name, mod in (("port", staging), ("jax", jstaging)):
        stage = str(tmp_path / f"stage_{name}")
        first, copies = mod.stage_datasets(manifest, stage)
        tree = _tree(stage)
        again, more = mod.stage_datasets(manifest, stage)
        assert again == first and more == []
        mod.cleanup_staged(copies)
        runs[name] = (_relative(first, stage), sorted(os.path.relpath(p, stage) for p in copies),
                      tree, _tree(stage))
    assert runs["port"] == runs["jax"]
    staged, copies, tree, left = runs["port"]
    assert staged["val"][0]["root"] == "val" and "val/val/im0.jpg" in tree
    assert staged["train"][1]["anno"] != "train.jsonl"       # the basename collision
    assert left == {} and len(copies) == 6


# ---- strong augmentation -----------------------------------------------------------
def _samples(seed):
    rng = np.random.RandomState(seed)
    arr = rng.randint(0, 255, (120, 160, 3), np.uint8)
    boxes = np.asarray([[20, 30, 80, 90], [100, 40, 150, 110], [5, 5, 40, 25]], np.float32)
    labels = np.asarray([0, 1, 2])
    return (Sample(Image.fromarray(arr), boxes.copy(), labels.copy(), 7, (120, 160), "c", ["a"]),
            JSample(Image.fromarray(arr), boxes.copy(), labels.copy(), 7, (120, 160), "c", ["a"]))


AUGS = {
    "contrast": lambda m, s: m.AdjustContrast(0.5, rng=random.Random(s)),
    "brightness": lambda m, s: m.AdjustBrightness(0.5, rng=random.Random(s)),
    "lighting": lambda m, s: m.LightingNoise(0.1, rng=np.random.RandomState(s)),
    "rotate": lambda m, s: m.Rotate(rng=random.Random(s)),
    "crop_keep_box": lambda m, s: m.RandomCropKeepBox(rng=random.Random(s)),
    "iou_crop": lambda m, s: m.IoUCrop(rng=np.random.RandomState(s)),
    "select": lambda m, s: m.RandomSelectMulti(
        [m.AdjustContrast(rng=random.Random(s + 1)), m.Rotate(rng=random.Random(s + 2)),
         m.RandomCropKeepBox(rng=random.Random(s + 3))], rng=random.Random(s)),
}


@pytest.mark.parametrize("name", sorted(AUGS))
def test_strong_aug_matches_jax(name):
    """Three seeds, four draws each from one transform (its generator runs
    on): the same images, boxes and labels as the JAX package's."""
    for seed in range(3):
        port_t, jax_t = AUGS[name](aug, seed), AUGS[name](jaug, seed)
        for draw in range(4):
            s, js = _samples(10 * seed + draw)
            got, want = port_t(s), jax_t(js)
            np.testing.assert_array_equal(np.asarray(got.image), np.asarray(want.image))
            np.testing.assert_array_equal(got.boxes, want.boxes)
            np.testing.assert_array_equal(got.labels, want.labels)
            assert (got.image_id, got.caption) == (want.image_id, want.caption)


def test_strong_aug_leaves_the_global_generators():
    random.seed(5)
    np.random.seed(5)
    state, np_state = random.getstate(), np.random.get_state()
    s, _ = _samples(0)
    for make in AUGS.values():
        make(aug, 0)(s)
    for cls in (aug.AdjustContrast, aug.Rotate, aug.IoUCrop, aug.LightingNoise):
        cls()(s)   # seeded 0 by default
    assert random.getstate() == state
    assert all(np.array_equal(a, b) for a, b in zip(np.random.get_state()[1:2], np_state[1:2]))


# ---- main --debug / --stage_dir and the zero-shot tool ------------------------------
PORT_BASE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "open_groundingdino_tpu_torch", "config", "cfg_base.py")
NANO_CFG = f"""
_base_ = {PORT_BASE!r}
backbone = "swin_nano_test"
hidden_dim = 32
nheads = 4
enc_layers = 1
dec_layers = 1
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


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """Nano config, vocab, seeded checkpoint and the smoke's 8-image ODVG
    set with its COCO val split."""
    work = str(tmp_path_factory.mktemp("extras"))
    files = {"cfg": os.path.join(work, "cfg.py"), "vocab": os.path.join(work, "vocab.txt"),
             "ckpt": os.path.join(work, "ckpt.pth"), "work": work}
    with open(files["cfg"], "w") as f:
        f.write(NANO_CFG)
    chip_smoke.write_vocab(files["vocab"], 200)
    chip_smoke.write_checkpoint(files["cfg"], files["ckpt"], random_biases=True)
    chip_smoke.write_odvg(work)
    files["manifest"] = chip_smoke.write_coco_val(work)
    return files


def _main(ws, out_dir, manifest, *flags, options=()):
    cli = port_main.get_args_parser().parse_args([
        "-c", ws["cfg"], "--datasets", manifest, "--output_dir", str(out_dir), "--vocab",
        ws["vocab"], "--pretrain_model_path", ws["ckpt"], "--device", "cpu", "--num_workers",
        "0", "--seed", "3", "--print_freq", "1", *flags, "--options", *options])
    return port_main.main(cli)


def test_main_debug_and_stage_dir(ws, tmp_path):
    """16 training batches and 16 eval batches (B = 1, each ODVG image twice):
    --debug stops both at 15, on the copies --stage_dir made, which are gone
    when main returns."""
    with open(ws["manifest"]) as f:
        manifest = json.load(f)
    with open(manifest["val"][0]["anno"]) as f:
        anno = json.load(f)
    anno["images"] += [dict(im, id=im["id"] + 100) for im in anno["images"]]
    anno["annotations"] += [dict(a, id=a["id"] + 1000, image_id=a["image_id"] + 100)
                            for a in anno["annotations"]]
    val = tmp_path / "val16.json"
    val.write_text(json.dumps(anno))
    manifest["train"] = manifest["train"] * 2
    manifest["val"] = [dict(manifest["val"][0], anno=str(val))]
    path = tmp_path / "datasets16.json"
    path.write_text(json.dumps(manifest))
    stage = tmp_path / "stage"
    run = _main(ws, tmp_path / "out", str(path), "--debug", "--stage_dir", str(stage),
                options=("batch_size=1", "epochs=1"))
    assert len(run["records"]) == port_main.DEBUG_STEPS == 15
    assert all(np.isfinite(r["loss"]) for r in run["records"])
    info = (tmp_path / "out" / "info.txt").read_text()
    assert "Epoch [0] [14/16]" in info and "Epoch [0] [15/16]" not in info
    assert "Eval [14/16]" in info and "Eval [15/16]" not in info
    assert "staged 4 dataset paths" in info
    assert [p.name for p in stage.iterdir()] == []          # cleaned up
    with open(tmp_path / "out" / "log.txt") as f:
        assert np.isfinite(json.loads(f.readline())["loss"])


def test_zero_shot_eval_tool_equals_main_eval(ws, tmp_path, capsys):
    """The tool on the CPU (its manifest, main --eval, the 12 rows and the
    JSON line) against the port's main --eval on the same split."""
    with open(ws["manifest"]) as f:
        val = json.load(f)["val"][0]
    calls = native.coco_greedy_match.calls
    stats = zero_shot_eval.main([
        "--checkpoint", ws["ckpt"], "--vocab", ws["vocab"], "--images", val["root"],
        "--annotations", val["anno"], "--config", ws["cfg"], "--output_dir",
        str(tmp_path / "zs"), "--num_workers", "0", "--device", "cpu", "--options",
        "batch_size=4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == stats
    rows = [l for l in lines if l.startswith(" Average ")]
    assert len(rows) == 12 and rows[0].endswith(f"= {stats['AP']:.3f}")
    if shutil.which("g++"):
        assert native.coco_greedy_match.calls > calls
    _main(ws, tmp_path / "main", ws["manifest"], "--eval", options=("batch_size=4",))
    with open(tmp_path / "main" / "eval_stats.json") as f:
        want = json.load(f)
    assert stats == want and len(stats) == 12
    with open(tmp_path / "zs" / "datasets_val.json") as f:
        assert json.load(f)["val"][0]["anno"] == os.path.abspath(val["anno"])


@pytest.mark.parametrize("ext", [".json", ".yaml", ".pkl"])
def test_slio_matches_jax(tmp_path, ext):
    obj = {"a": [1, 2.5, "x"], "b": {"c": None, "d": True}}
    ours, theirs = str(tmp_path / f"ours{ext}"), str(tmp_path / f"theirs{ext}")
    slio.sldump(obj, ours)
    jslio.sldump(obj, theirs)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    assert slio.slload(theirs) == jslio.slload(ours) == obj
    for mod in (slio, jslio):
        with pytest.raises(ValueError):
            mod.sldump(obj, str(tmp_path / "x.txt"))
        with pytest.raises(ValueError):
            mod.slload(str(tmp_path / "x.txt"))


def test_time_counter_matches_jax(monkeypatch):
    """The same fake clock through both packages' TimeHolder sections."""
    ticks = iter(np.cumsum([0.0, 1.5, 0.25, 2.0, 0.5, 3.0, 0.125, 0.75]).tolist() * 2)
    monkeypatch.setattr(time_counter.time, "perf_counter", lambda: next(ticks))
    summaries = []
    for mod in (time_counter, jtime_counter):
        holder = mod.TimeHolder()
        for name in ("load", "step", "load", "step"):
            with holder.section(name):
                pass
        meter = mod.AverageMeter()
        meter.update(2.0, n=3)
        meter.update(4.0)
        summaries.append((holder.summary(), meter.avg))
    assert summaries[0] == summaries[1]
    assert summaries[0][1] == 2.5
