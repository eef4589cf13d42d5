"""The port's ResNet detector and its Model API against the JAX package, at
nano size (the window-12 Swin of Swin-B/L is tests/test_torch_swin.py's).

A nano GroundingDINO with the ResNet backbone, seeded weights on the JAX
package's parameter tree (FrozenBN statistics away from the identity, the
deformable offsets off the pixel lattice), exported to a reference-layout
.pth by the JAX package's exporter (plus torchvision's num_batches_tracked
counters): the port's forward against the JAX eval forward, flip-aware;
`Model.predict_with_caption` / `predict_with_classes` of both packages on
that .pth (equal counts and class ids, boxes within 1e-4, thresholds in gaps
of the scores); `post_process_result`, `phrases2classes` and `annotate`
against the JAX ones; the port's inference_on_a_image tool.  One JAX forward
compile serves the file: the forward comparison calls the JAX Model's own
jitted forward.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open_groundingdino_tpu import inference as jax_inference
from open_groundingdino_tpu.models.bert import BertConfig as JBertConfig
from open_groundingdino_tpu.models.groundingdino import GroundingDINO as JGroundingDINO
from open_groundingdino_tpu.models.resnet import ResNetConfig as JResNetConfig
from open_groundingdino_tpu.utils.checkpoint import export_groundingdino_checkpoint
from open_groundingdino_tpu_torch import inference as port_inference
from open_groundingdino_tpu_torch.tools import inference_on_a_image


def _seeded_params(shapes, seed):
    """Seeded random values on a flax param tree's shapes: kernels N(0, 1/fan_in),
    norm scales near 1, everything else N(0, 0.02)."""
    rng = np.random.RandomState(seed)

    def draw(path, x):
        name = jax.tree_util.keystr(path).split("'")[-2]
        n = rng.randn(*x.shape).astype(np.float32)
        if name == "kernel":
            return n / np.sqrt(np.prod(x.shape[:-1]))
        return (1.0 + 0.1 * n) if name == "scale" else 0.02 * n

    return jax.tree_util.tree_map_with_path(draw, shapes)

# ---- nano ResNet detector ------------------------------------------------------
T, QN, C, NHEAD, FFN = 16, 12, 32, 4, 64
BERT = dict(vocab_size=40, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=32, max_position_embeddings=32)
TOP = dict(hidden_dim=C, num_queries=QN, nheads=NHEAD, num_feature_levels=4,
           enc_layers=2, dec_layers=2, dim_feedforward=FFN, max_text_len=T)
VOCAB = "[PAD] [UNK] [CLS] [SEP] [MASK] . ? dog cat bird".split()
CLASSES = ["dog", "cat"]
NANO_CFG = """
_base_ = "{base}"
backbone = "resnet_nano_test"
hidden_dim = 32
nheads = 4
enc_layers = 2
dec_layers = 2
dim_feedforward = 64
num_queries = 12
max_text_len = 16
bert_vocab_size = 40
bert_hidden_size = 32
bert_layers = 2
bert_heads = 4
bert_intermediate = 32
bert_max_position = 32
use_checkpoint = False
use_transformer_ckpt = False
"""
# resized to 800x1067 for serving: the 800x1216 bucket of cfg_base's lattice
IMAGE_HW = (120, 160)


@pytest.fixture(scope="module")
def nano(tmp_path_factory):
    """The seeded nano ResNet detector as a reference-layout .pth,
    the two packages' configs, a vocab, an image, and both packages' Model
    on it (the port's on the CPU)."""
    import open_groundingdino_tpu
    import open_groundingdino_tpu_torch

    tmp = tmp_path_factory.mktemp("resnet_nano")
    model = JGroundingDINO(
        swin_cfg=None, resnet_cfg=JResNetConfig(name="resnet_nano_test"),
        bert_cfg=JBertConfig(**BERT, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0),
        msda_impl="xla", **TOP)
    ids = np.asarray([[2, 7, 5, 8, 5, 3] + [0] * (T - 6)], np.int32)
    init_inputs = dict(images=np.zeros((1, 128, 128, 3), np.float32),
                       image_sizes=np.asarray([[128, 128]], np.int32), input_ids=ids,
                       text_token_mask=ids > 0, position_ids=np.zeros((1, T), np.int32),
                       text_self_attention_masks=np.ones((1, T, T), bool))
    params = _seeded_params(jax.eval_shape(model.init, jax.random.PRNGKey(0), **{
        k: jnp.asarray(v) for k, v in init_inputs.items()})["params"], 0)
    rng = np.random.RandomState(1)

    def perturb(path, x):
        """Offsets and weights off the pixel lattice (tests/test_torch_model.py),
        FrozenBN statistics away from the identity."""
        key = jax.tree_util.keystr(path)
        if ("sampling_offsets" in key or "attention_weights" in key) and "kernel" in key:
            return (x + 0.05 * rng.randn(*x.shape)).astype(np.float32)
        if "frozen_bn" in key:
            name = key.split("'")[-2]
            if name == "running_var":
                return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
            return ((1.0 if name == "weight" else 0.0) + 0.1 * rng.randn(*x.shape)).astype(
                np.float32)
        return x

    params = jax.tree_util.tree_map_with_path(perturb, params)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in export_groundingdino_checkpoint(
        params).items()}
    sd.update({k.replace(".running_mean", ".num_batches_tracked"): torch.tensor(0)
               for k in list(sd) if k.endswith(".running_mean")})
    torch.save({"model": sd}, str(tmp / "ckpt.pth"))
    (tmp / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    for name, pkg in (("jax", open_groundingdino_tpu), ("port", open_groundingdino_tpu_torch)):
        base = f"{pkg.__path__[0]}/config/cfg_base.py"
        (tmp / f"cfg_{name}.py").write_text(NANO_CFG.format(base=base))
    files = {name: (str(tmp / f"cfg_{name}.py"), str(tmp / "ckpt.pth"), str(tmp / "vocab.txt"))
             for name in ("jax", "port")}
    image = np.random.RandomState(5).randint(0, 255, (*IMAGE_HW, 3), np.uint8)
    return dict(tmp=tmp, files=files, image=image,
                jax=jax_inference.Model(*files["jax"]),
                port=port_inference.Model(*files["port"], device="cpu"))


def _port_probs(nano, caption):
    """The port's (sigmoid token probabilities, boxes) of the Model's request."""
    from PIL import Image

    im = nano["port"].im
    caption = port_inference.preprocess_caption(caption)
    inputs, tok = port_inference.prepare_inputs(im, Image.fromarray(nano["image"]), caption)
    probs, boxes = port_inference.forward(im, inputs)
    return probs, boxes, inputs, tok


def _gap_threshold(values, lo, hi):
    """The middle of the widest gap between sorted values[lo:hi] (descending)."""
    v = np.sort(np.asarray(values).ravel())[::-1][lo:hi]
    i = int(np.argmax(v[:-1] - v[1:]))
    return float((v[i] + v[i + 1]) / 2)


def test_resnet_detector_forward_matches_jax(nano):
    """The port's forward against the JAX Model's jitted eval forward on the
    same request (800x1216 bucket), flip-aware as tests/test_torch_model.py."""
    _, _, inputs, _ = _port_probs(nano, "dog . cat .")
    jim = nano["jax"].im
    nano["jax"].predict_with_caption(nano["image"], "dog . cat .")   # compiles "fwd"
    out_j = jim._jitted["fwd"](jim.params, *(jnp.asarray(inputs[k].numpy().astype(
        np.int32) if inputs[k].dtype == torch.int64 else inputs[k].numpy()) for k in (
        "images", "image_sizes", "input_ids", "text_token_mask", "position_ids",
        "text_self_attention_masks")))
    with torch.no_grad():
        out_t = nano["port"].im.model(**inputs)
    assert tuple(inputs["images"].shape) == (1, 800, 1216, 3)
    lg_j, bx_j = np.asarray(out_j["pred_logits"]), np.asarray(out_j["pred_boxes"])
    lg_t, bx_t = out_t["pred_logits"].numpy(), out_t["pred_boxes"].numpy()
    assert lg_t.shape == lg_j.shape and bx_t.shape == bx_j.shape
    flip = np.max(np.abs(bx_t - bx_j), axis=-1) > 1e-2
    keep = ~flip
    assert flip.mean() < 0.10, f"{flip.mean():.1%} of queries flipped"
    fin = np.isfinite(lg_j) & keep[..., None]
    assert np.array_equal(np.isfinite(lg_t), np.isfinite(lg_j))
    assert np.max(np.abs(lg_t[fin] - lg_j[fin])) < 1e-3
    assert np.max(np.abs(bx_t[keep] - bx_j[keep])) < 1e-4


@pytest.mark.parametrize("api", ["predict_with_caption", "predict_with_classes"])
def test_model_api_matches_jax(nano, api):
    caption = ". ".join(CLASSES) if api == "predict_with_classes" else "dog . cat ."
    probs, _, _, tok = _port_probs(nano, caption)
    live = probs[:, tok.attention_mask[0].astype(bool)]
    box_threshold = _gap_threshold(live.max(axis=1), 1, 8)
    kept = live[live.max(axis=1) > box_threshold]
    kept = kept[kept < box_threshold]
    text_threshold = _gap_threshold(kept, 0, kept.size)
    assert 0.0 < text_threshold < box_threshold
    arg = CLASSES if api == "predict_with_classes" else caption
    res = {name: getattr(nano[name], api)(nano["image"], arg, box_threshold, text_threshold)
           for name in ("jax", "port")}
    if api == "predict_with_caption":
        (det_j, phrases_j), (det_t, phrases_t) = res["jax"], res["port"]
        assert phrases_t == phrases_j
    else:
        det_j, det_t = res["jax"], res["port"]
        assert det_t.class_id.tolist() == det_j.class_id.tolist()
        assert any(c is not None for c in det_t.class_id.tolist())
    assert isinstance(det_t, port_inference.Detections)
    assert len(det_t) == len(det_j) > 0
    np.testing.assert_allclose(det_t.xyxy, det_j.xyxy, atol=1e-4 * max(IMAGE_HW))
    np.testing.assert_allclose(det_t.confidence, det_j.confidence, atol=1e-4)


def test_model_helpers_match_jax():
    """post_process_result, phrases2classes (the None sentinel) and annotate
    against the JAX package's."""
    rng = np.random.RandomState(7)
    boxes = rng.uniform(0.1, 0.6, (5, 4)).astype(np.float32)
    logits = rng.uniform(0.3, 1.0, 5).astype(np.float32)
    got = port_inference.Model.post_process_result(90, 140, boxes, logits)
    ref = jax_inference.Model.post_process_result(90, 140, boxes, logits)
    np.testing.assert_array_equal(got.xyxy, ref.xyxy)
    np.testing.assert_array_equal(got.confidence, ref.confidence)
    assert got.class_id is None and len(got) == 5
    phrases = ["a dog", "cat", "bird dog", "", "hot dog cat"]
    classes = ["cat", "dog"]
    assert (port_inference.Model.phrases2classes(phrases, classes).tolist()
            == jax_inference.Model.phrases2classes(phrases, classes).tolist()
            == [1, 0, 1, None, 0])
    image = rng.randint(0, 255, (90, 140, 3), np.uint8)
    drawn = port_inference.annotate(image, boxes, logits, phrases)
    assert drawn.shape == image.shape and drawn.dtype == np.uint8
    np.testing.assert_array_equal(drawn, jax_inference.annotate(image, boxes, logits, phrases))
    assert not np.array_equal(drawn, image)


def test_inference_on_a_image_tool(nano):
    """The port's tool, on the CPU at nano size: pred.json holds the
    predict's boxes, scores and phrases, and the annotated image is
    written."""
    from PIL import Image

    tmp = nano["tmp"]
    Image.fromarray(nano["image"]).save(str(tmp / "image.png"))
    cfg, ckpt, vocab = nano["files"]["port"]
    out_dir = tmp / "tool_out"
    pred = inference_on_a_image.main(inference_on_a_image.get_args_parser().parse_args([
        "-c", cfg, "-p", ckpt, "--vocab", vocab, "-i", str(tmp / "image.png"),
        "-t", "dog . cat .", "-o", str(out_dir), "--box_threshold", "0.0",
        "--text_threshold", "0.05", "--device", "cpu"]))
    with open(out_dir / "pred.json") as f:
        assert json.load(f) == pred
    boxes, scores, phrases = port_inference.predict(
        nano["port"].im, Image.open(str(tmp / "image.png")).convert("RGB"), "dog . cat .",
        box_threshold=0.0, text_threshold=0.05)
    assert len(pred["boxes_cxcywh_norm"]) == len(boxes) == QN
    np.testing.assert_allclose(pred["boxes_cxcywh_norm"], boxes, atol=1e-6)
    np.testing.assert_allclose(pred["scores"], scores, atol=1e-6)
    assert pred["phrases"] == phrases
    assert Image.open(str(out_dir / "pred.jpg")).size == IMAGE_HW[::-1]
