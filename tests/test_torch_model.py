"""The PyTorch port's serving slice against the JAX package, end to end.

At the nano geometry of tests/test_composed_model_parity.py:47-60, one JAX
GroundingDINO init (XLA formulations on the CPU) is exported with the port's
`state_dict_from_jax_params` and loaded into the port's GroundingDINO with
strict=True; both forwards see the same numpy inputs.  The comparison is
flip-aware (as __graft_entry__.py:376-393): at random init the two-stage
top-k may swap near-tied proposals, so fewer than 10% of queries may flip
and the rest must agree to |dlogit| < 1e-3, |dbox| < 1e-4.

The same weights then go through a reference-keyed .pth into both packages'
load_model + predict: boxes, scores and phrases must agree.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from PIL import Image

from open_groundingdino_tpu import inference as jax_inference
from open_groundingdino_tpu.models.bert import BertConfig as JBertConfig
from open_groundingdino_tpu.models.groundingdino import GroundingDINO as JGroundingDINO
from open_groundingdino_tpu.models.swin import SwinConfig as JSwinConfig
from open_groundingdino_tpu_torch import inference as port_inference
from open_groundingdino_tpu_torch.models.bert import BertConfig
from open_groundingdino_tpu_torch.models.groundingdino import GroundingDINO
from open_groundingdino_tpu_torch.models.swin import SwinConfig
from open_groundingdino_tpu_torch.utils.convert import state_dict_from_jax_params

# ---- nano geometry (tests/test_composed_model_parity.py:47-60) -------------
T, QN, C, NHEAD, FFN = 16, 12, 32, 4, 64
NL, P = 4, 4
ENC, DEC = 2, 2
IMG_H, IMG_W = 64, 96
SWIN = dict(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 4), window_size=4,
            out_indices=(1, 2, 3))
BERT = dict(vocab_size=40, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=32, max_position_embeddings=32)
TOP = dict(hidden_dim=C, num_queries=QN, nheads=NHEAD, num_feature_levels=NL,
           enc_layers=ENC, dec_layers=DEC, dim_feedforward=FFN, max_text_len=T)

VOCAB = "[PAD] [UNK] [CLS] [SEP] [MASK] . ? dog cat bird".split()
NANO_CFG = """
_base_ = "{base}"
backbone = "swin_nano_test"
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
image_buckets = [(64, 96), (96, 96)]
use_checkpoint = False
use_transformer_ckpt = False
"""


def _inputs(seed=0):
    """Padded image (valid 56x80 of 64x96) and a two-phrase caption with 10
    live text tokens."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, 40, size=(1, T)).astype(np.int32)
    ids[0, 0], ids[0, 9] = 2, 3
    text_mask = np.arange(T)[None] < 10
    sam = np.tile(np.eye(T, dtype=bool)[None], (1, 1, 1))
    sam[:, 1:5, 1:5] = True
    sam[:, 5:9, 5:9] = True
    pos = np.zeros((1, T), np.int32)
    pos[0, 1:5] = np.arange(4)
    pos[0, 5:9] = np.arange(4)
    return dict(
        images=rng.randn(1, IMG_H, IMG_W, 3).astype(np.float32),
        image_sizes=np.asarray([[56, 80]], np.int32),
        input_ids=ids,
        text_token_mask=text_mask,
        position_ids=pos,
        text_self_attention_masks=sam,
    )


@pytest.fixture(scope="module")
def jax_model():
    """One JAX init shared by the file.  The deformable-attention offset and
    weight kernels (zero at init) get small random values: at init every
    sampling point sits exactly on a pixel centre, where XLA:CPU's jitted
    forward of the JAX package rounds floor and fraction inconsistently
    (ROADMAP section 3); off the lattice, as after training, it agrees with
    its own eager forward and with the port."""
    model = JGroundingDINO(
        swin_cfg=JSwinConfig(**SWIN),
        bert_cfg=JBertConfig(**BERT, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0),
        msda_impl="xla", **TOP,
    )
    inputs = _inputs()
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 **{k: jnp.asarray(v) for k, v in inputs.items()})["params"]
    rng = np.random.RandomState(1)

    def perturb(path, x):
        keys = jax.tree_util.keystr(path)
        if ("sampling_offsets" in keys or "attention_weights" in keys) and "kernel" in keys:
            return (x + 0.05 * rng.randn(*x.shape)).astype(np.float32)
        return x

    params = jax.tree_util.tree_map_with_path(perturb, jax.device_get(params))
    return model, params, inputs


def _port_model(params):
    model = GroundingDINO(SwinConfig(**SWIN), BertConfig(**BERT), **TOP).eval()
    model.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return model


def test_forward_matches_jax_flip_aware(jax_model):
    jmodel, params, inputs = jax_model
    out_j = jax.jit(jmodel.apply)({"params": params},
                                  **{k: jnp.asarray(v) for k, v in inputs.items()})
    with torch.no_grad():
        out_t = _port_model(params)(**{k: torch.from_numpy(v).long()
                                       if v.dtype == np.int32 else torch.from_numpy(v)
                                       for k, v in inputs.items()})
    for key in ("pred_logits", "pred_boxes"):
        assert tuple(out_t[key].shape) == tuple(out_j[key].shape)
    lg_j, bx_j = np.asarray(out_j["pred_logits"]), np.asarray(out_j["pred_boxes"])
    lg_t, bx_t = out_t["pred_logits"].numpy(), out_t["pred_boxes"].numpy()

    flip = np.max(np.abs(bx_t - bx_j), axis=-1) > 1e-2          # (B, Q)
    keep = ~flip
    assert flip.mean() < 0.10, f"{flip.mean():.1%} of queries flipped"
    fin = np.isfinite(lg_j) & keep[..., None]
    assert np.array_equal(np.isfinite(lg_t), np.isfinite(lg_j))
    assert np.max(np.abs(lg_t[fin] - lg_j[fin])) < 1e-3
    assert np.max(np.abs(bx_t[keep] - bx_j[keep])) < 1e-4
    # the encoder's two-stage proposals, before any selection, agree tightly
    np.testing.assert_allclose(out_t["interm_outputs"]["pred_boxes"].numpy(),
                               np.asarray(out_j["interm_outputs"]["pred_boxes"]),
                               atol=1e-4)


def test_load_model_predict_matches_jax(jax_model, tmp_path):
    import open_groundingdino_tpu
    import open_groundingdino_tpu_torch

    _, params, _ = jax_model
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    torch.save({"model": state_dict_from_jax_params(params)}, str(tmp_path / "ckpt.pth"))
    for name, pkg in (("jax", open_groundingdino_tpu), ("port", open_groundingdino_tpu_torch)):
        base = f"{pkg.__path__[0]}/config/cfg_base.py"
        (tmp_path / f"cfg_{name}.py").write_text(NANO_CFG.format(base=base))

    files = lambda name: (str(tmp_path / f"cfg_{name}.py"), str(tmp_path / "ckpt.pth"),
                          str(tmp_path / "vocab.txt"))
    jim = jax_inference.load_model(*files("jax"))
    tim = port_inference.load_model(*files("port"), device="cpu")
    assert next(tim.model.parameters()).device.type == "cpu"

    image = Image.fromarray(np.random.RandomState(1).randint(0, 255, (120, 160, 3), np.uint8))
    kw = dict(box_threshold=0.0, text_threshold=0.05, size=64, max_size=96)
    boxes_j, scores_j, phrases_j = jax_inference.predict(jim, image, "dog . cat .", **kw)
    boxes_t, scores_t, phrases_t = port_inference.predict(tim, image, "dog . cat .", **kw)
    assert len(boxes_t) == len(boxes_j) > 0
    np.testing.assert_allclose(boxes_t, boxes_j, atol=1e-4)
    np.testing.assert_allclose(scores_t, scores_j, atol=1e-4)
    assert phrases_t == phrases_j

    spans = [[(0, 3)], [(6, 9)]]                       # "dog", "cat"
    kw = dict(box_threshold=0.0, size=64, max_size=96)
    boxes_j, scores_j, phrases_j = jax_inference.predict_with_spans(
        jim, image, "dog . cat .", spans, **kw)
    boxes_t, scores_t, phrases_t = port_inference.predict_with_spans(
        tim, image, "dog . cat .", spans, **kw)
    assert len(boxes_t) == len(boxes_j) > 0
    np.testing.assert_allclose(boxes_t, boxes_j, atol=1e-4)
    np.testing.assert_allclose(scores_t, scores_j, atol=1e-4)
    assert phrases_t == phrases_j


def test_leaf_math_matches_jax():
    """Box conversions, inverse_sigmoid and the three sine embeddings."""
    from open_groundingdino_tpu.models import position_encoding as jpe
    from open_groundingdino_tpu.utils import box_ops as jbox
    from open_groundingdino_tpu.utils.misc import inverse_sigmoid as jinverse_sigmoid
    from open_groundingdino_tpu_torch.models import position_encoding as pe
    from open_groundingdino_tpu_torch.utils import box_ops
    from open_groundingdino_tpu_torch.utils.misc import inverse_sigmoid

    rng = np.random.RandomState(4)
    boxes = rng.uniform(0.0, 1.0, (3, 7, 4)).astype(np.float32)
    pad = np.zeros((2, 6, 9), bool)
    pad[1, 4:, :] = True
    pad[1, :, 7:] = True
    pos = rng.uniform(0.0, 1.0, (2, 5, 1)).astype(np.float32) * 9
    pairs = [
        (box_ops.box_cxcywh_to_xyxy(torch.from_numpy(boxes)), jbox.box_cxcywh_to_xyxy(boxes)),
        (box_ops.box_xyxy_to_cxcywh(torch.from_numpy(boxes)), jbox.box_xyxy_to_cxcywh(boxes)),
        (inverse_sigmoid(torch.from_numpy(boxes)), jinverse_sigmoid(boxes)),
        (pe.position_embedding_sine_hw(torch.from_numpy(pad), 16),
         jpe.position_embedding_sine_hw(pad, 16)),
        (pe.get_sine_pos_embed(torch.from_numpy(pos), 32, exchange_xy=False),
         jpe.get_sine_pos_embed(pos, 32, exchange_xy=False)),
        (pe.gen_sineembed_for_position(torch.from_numpy(boxes)),
         jpe.gen_sineembed_for_position(boxes)),
    ]
    for ours, ref in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
