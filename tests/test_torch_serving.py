"""The port's serving slice (serving.py, tools/export_model.py) against the
JAX package's serving.py, at nano size on the CPU.

  * (b) One checkpoint (a JAX init with perturbed offset/weight kernels,
    tests/test_torch_model.py's recipe, at one encoder and one decoder layer)
    exported by both packages at the (64, 96) bucket and loaded back: the
    port's program holds one ogd_torch op per kernel launch and equals the
    port's eager forward within 1e-5; against the JAX package's artifact it
    is flip-aware within test_forward_matches_jax_flip_aware's limits.
  * (c) `predict` / `predict_with_spans` on the two ServingModels: the same
    boxes and scores within 1e-4 and the same phrases.
  * (d) The bucket, format, device and vocab guards raise.
The custom ops themselves and the sweep and banded_point artifacts are
tests/test_torch_serving_ops.py.
"""
import json
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from PIL import Image

from open_groundingdino_tpu import inference as jax_inference
from open_groundingdino_tpu import serving as jax_serving
from open_groundingdino_tpu.models.bert import BertConfig as JBertConfig
from open_groundingdino_tpu.models.groundingdino import GroundingDINO as JGroundingDINO
from open_groundingdino_tpu.models.swin import SwinConfig as JSwinConfig
from open_groundingdino_tpu_torch import inference, serving
from open_groundingdino_tpu_torch.tools import export_model as export_tool
from open_groundingdino_tpu_torch.utils.convert import state_dict_from_jax_params
from test_torch_serving_ops import (BUCKET, DEC, ENC, NANO_CFG, VOCAB, T, _inputs, _op_counts,
                                    _torch_inputs)

# ---- the JAX init of the nano geometry (tests/test_torch_serving_ops.py's
# NANO_CFG: tests/test_torch_model.py's at one layer each)
C, NHEAD, FFN, QN = 32, 4, 64, 12
SWIN = dict(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 4), window_size=4,
            out_indices=(1, 2, 3))
BERT = dict(vocab_size=40, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
            intermediate_size=32, max_position_embeddings=32)
TOP = dict(hidden_dim=C, num_queries=QN, nheads=NHEAD, num_feature_levels=4,
           enc_layers=ENC, dec_layers=DEC, dim_feedforward=FFN, max_text_len=T)
CAPTION = "dog . cat ."
SPANS = [[(0, 3)], [(6, 9)]]                        # "dog", "cat"
PREDICT_KW = dict(box_threshold=0.0, text_threshold=0.05, size=64, max_size=96)


def _image():
    return Image.fromarray(np.random.RandomState(1).randint(0, 255, (120, 160, 3), np.uint8))


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The checkpoint, vocab and both packages' configs, from one perturbed
    JAX init."""
    model = JGroundingDINO(
        swin_cfg=JSwinConfig(**SWIN),
        bert_cfg=JBertConfig(**BERT, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0),
        msda_impl="xla", **TOP)
    inputs = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
              for k, v in _inputs().items()}
    params = jax.jit(model.init)(jax.random.PRNGKey(0), **inputs)["params"]
    rng = np.random.RandomState(1)

    def perturb(path, x):
        keys = jax.tree_util.keystr(path)
        if ("sampling_offsets" in keys or "attention_weights" in keys) and "kernel" in keys:
            return (x + 0.05 * rng.randn(*x.shape)).astype(np.float32)
        return x

    params = jax.tree_util.tree_map_with_path(perturb, jax.device_get(params))
    d = tmp_path_factory.mktemp("serving")
    (d / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    torch.save({"model": state_dict_from_jax_params(params)}, str(d / "ckpt.pth"))
    import open_groundingdino_tpu
    import open_groundingdino_tpu_torch

    for name, pkg in (("jax", open_groundingdino_tpu), ("gather", open_groundingdino_tpu_torch)):
        base = f"{pkg.__path__[0]}/config/cfg_base.py"
        (d / f"cfg_{name}.py").write_text(NANO_CFG.format(base=base))
    return d


def _files(d, name):
    return str(d / f"cfg_{name}.py"), str(d / "ckpt.pth"), str(d / "vocab.txt")


@pytest.fixture(scope="module")
def artifacts(workspace):
    """The port's eager model and its artifact, written by the tool and
    loaded; the JAX package's artifact of the same checkpoint, loaded."""
    d = workspace
    cfg, ckpt, vocab = _files(d, "gather")
    written = export_tool.main(export_tool.get_args_parser().parse_args(
        ["-c", cfg, "--checkpoint", ckpt, "--vocab", vocab, "-o", str(d / "port_art"),
         "--bucket", "64x96", "--device", "cpu"]))
    assert set(written) == {"weights.pt", "fwd_64x96.pt2", "vocab.txt", "meta.json"}
    jim = jax_inference.load_model(*_files(d, "jax"))
    jax_serving.export_model(jim, str(d / "jax_art"), buckets=[BUCKET], vocab_path=vocab)
    return (inference.load_model(cfg, ckpt, vocab, device="cpu"),
            serving.load_exported(str(d / "port_art"), device="cpu"),
            jax_serving.load_exported(str(d / "jax_art")))


def _eager(im):
    with torch.no_grad():
        out = im.model(**_torch_inputs())
    return out["pred_logits"].numpy(), out["pred_boxes"].numpy()


def _served(sm):
    with torch.inference_mode():
        out = sm.model(**_torch_inputs())
    return out["pred_logits"].numpy(), out["pred_boxes"].numpy()


# ---------------------------------------------------------------- (b), (c)
def test_artifact_matches_eager_and_jax(artifacts):
    tim, sm, jsm = artifacts
    # the gather path's forward ops, none of the other kernels' (the
    # backward ops, K8 and the training matcher's LSAP included)
    assert _op_counts(sm) == {**dict.fromkeys(_op_counts(sm), 0), "msda_fwd": ENC + DEC,
                              "fusion_fwd": ENC}
    assert len(_op_counts(sm)) == 11
    lg_t, bx_t = _served(sm)
    lg_e, bx_e = _eager(tim)
    np.testing.assert_allclose(lg_t, lg_e, rtol=0, atol=1e-5)
    np.testing.assert_allclose(bx_t, bx_e, rtol=0, atol=1e-5)

    inputs = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
              for k, v in _inputs().items()}
    out_j = jsm.forward_fn()(jsm.params, *inputs.values())
    lg_j, bx_j = np.asarray(out_j["pred_logits"]), np.asarray(out_j["pred_boxes"])
    assert lg_t.shape == lg_j.shape and bx_t.shape == bx_j.shape
    flip = np.max(np.abs(bx_t - bx_j), axis=-1) > 1e-2
    keep = ~flip
    assert flip.mean() < 0.10, f"{flip.mean():.1%} of queries flipped"
    fin = np.isfinite(lg_j) & keep[..., None]
    assert np.array_equal(np.isfinite(lg_t), np.isfinite(lg_j))
    assert np.max(np.abs(lg_t[fin] - lg_j[fin])) < 1e-3
    assert np.max(np.abs(bx_t[keep] - bx_j[keep])) < 1e-4


def test_predict_on_both_serving_models(artifacts):
    _, sm, jsm = artifacts
    image = _image()
    for ours, theirs in (
            (inference.predict(sm, image, CAPTION, **PREDICT_KW),
             jax_inference.predict(jsm, image, CAPTION, **PREDICT_KW)),
            (inference.predict_with_spans(sm, image, CAPTION, SPANS, box_threshold=0.0,
                                          size=64, max_size=96),
             jax_inference.predict_with_spans(jsm, image, CAPTION, SPANS, box_threshold=0.0,
                                              size=64, max_size=96))):
        (boxes_t, scores_t, phrases_t), (boxes_j, scores_j, phrases_j) = ours, theirs
        assert len(boxes_t) == len(boxes_j) > 0
        np.testing.assert_allclose(boxes_t, boxes_j, atol=1e-4)
        np.testing.assert_allclose(scores_t, scores_j, atol=1e-4)
        assert phrases_t == phrases_j


# ---------------------------------------------------------------- (d)
def test_guards(artifacts, workspace, tmp_path):
    _, sm, _ = artifacts
    inputs = _torch_inputs()
    inputs["images"] = torch.zeros(1, 96, 96, 3)
    with pytest.raises(ValueError, match=r"64, 96"):
        sm.model(**inputs)

    art = workspace / "port_art"
    meta = json.loads((art / "meta.json").read_text())
    assert (meta["device"], meta["msda_kernel"], meta["dtype"]) == ("cpu", "gather", "float32")
    with pytest.raises(ValueError, match="exported for 'cpu'"):
        serving.load_exported(str(art), device="cuda")
    (tmp_path / "meta.json").write_text(json.dumps({**meta, "format": 99}))
    with pytest.raises(ValueError, match="unsupported artifact format 99"):
        serving.load_exported(str(tmp_path), device="cpu")
    shutil.copyfile(art / "meta.json", tmp_path / "meta.json")
    with pytest.raises(ValueError, match="vocab.txt not found"):
        serving.load_exported(str(tmp_path), device="cpu")
