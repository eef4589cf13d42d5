"""The port's RoBERTa text encoder against the JAX package's, at nano size.

The byte-level BPE tokenizer (vocab.json + merges.txt learnt by the smoke's
`write_bpe_vocab` on its seeded corpus, 1200 entries) gives the JAX
`RobertaBPETokenizer`'s ids, masks, char offsets, special ids, decoded text,
truncation and int padding on captions with non-ASCII text, doubled spaces,
newlines, digits and apostrophes; `build_tokenizer` dispatches as the JAX
one; the sub-sentence masks, positive maps and label maps built through BPE
are equal.  Then a nano detector of roberta-base's geometry (one token type,
vocab and positions of the BPE vocab) on seeded weights of the JAX package's
tree, exported by its `export_groundingdino_checkpoint` and loaded strictly
into the port: the port's forward against the JAX Model's jitted forward,
flip-aware as tests/test_torch_model.py; `load_model` with the BPE directory,
then `predict` and `predict_with_spans`, against the JAX package's.
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke
import jax
import jax.numpy as jnp
from PIL import Image

from open_groundingdino_tpu import inference as jax_inference
from open_groundingdino_tpu.config import SLConfig as JSLConfig
from open_groundingdino_tpu.data import tokenization as jtok
from open_groundingdino_tpu.models.groundingdino import build_groundingdino as jbuild
from open_groundingdino_tpu.utils.checkpoint import export_groundingdino_checkpoint
from open_groundingdino_tpu_torch import inference as port_inference
from open_groundingdino_tpu_torch.config import SLConfig
from open_groundingdino_tpu_torch.data import tokenization as ptok
from open_groundingdino_tpu_torch.models.groundingdino import build_groundingdino

BPE_SIZE = 1200
T = 32
CAPS = [
    "dog . cat . zebra .",
    "a cat . a dog . person . bicycle .",
    "hello world's 123 hydrant?",
    "cat  dog\nhello .",
    "Café naïve 北京 — über straße .",
    "it's we'll they'd I'm you've   she'd .",
    "  leading and trailing   ",
    "tabs\tand\r\nnewlines\n\n . 2024 '3.14 x2",
    "emoji 🐱 and ½ ⅔ digits ٣٤ .",
    "",
]
CATS = [["cat", "dog"], ["person", "traffic light", "bicycle"], ["naïve", "北京", "zebra"]]


@pytest.fixture(scope="module")
def bpe(tmp_path_factory):
    d = tmp_path_factory.mktemp("roberta")
    chip_smoke.write_bpe_vocab(str(d / "bpe"), BPE_SIZE)
    return str(d / "bpe")


@pytest.fixture(scope="module")
def toks(bpe):
    vj, mt = os.path.join(bpe, "vocab.json"), os.path.join(bpe, "merges.txt")
    return ptok.RobertaBPETokenizer(vj, mt), jtok.RobertaBPETokenizer(vj, mt)


def test_bpe_vocab_file(bpe, toks):
    """The writer's vocabulary: its size, roberta-base's special ids, and
    every merge's parts and product in vocab.json."""
    tok, _ = toks
    assert len(tok.vocab) == BPE_SIZE
    assert [tok.vocab[t] for t in chip_smoke.BPE_SPECIALS] == [0, 1, 2, 3, 4]
    assert (tok.cls_token_id, tok.pad_token_id, tok.sep_token_id) == (0, 1, 2)
    for (a, b) in tok.bpe_ranks:
        assert a in tok.vocab and b in tok.vocab and a + b in tok.vocab


def test_pretokenize_matches_jax():
    for cap in CAPS:
        assert ptok._gpt2_pretokenize(cap) == jtok._gpt2_pretokenize(cap), cap
    assert ptok._bytes_to_unicode() == jtok._bytes_to_unicode()


@pytest.mark.parametrize("padding,max_length", [("longest", None), (48, None), (12, 12)])
def test_bpe_tokenizer_matches_jax(toks, padding, max_length):
    """ids, masks, token types and offsets (HF trim_offsets: an all-space
    token collapses to (b, b)), padded to the longest, to an int width, and
    truncated to 12 with </s> kept last."""
    tok, jt = toks
    got, want = tok(CAPS, padding=padding, max_length=max_length), jt(
        CAPS, padding=padding, max_length=max_length)
    for key in ("input_ids", "attention_mask", "token_type_ids"):
        np.testing.assert_array_equal(got[key], want[key])
        assert got[key].dtype == want[key].dtype
    assert got.offsets == want.offsets
    if max_length:
        assert (got.input_ids[got.attention_mask.sum(1) == 12, 11] == tok.sep_token_id).all()
    for cap in CAPS:
        assert tok.tokenize_with_offsets(cap) == jt.tokenize_with_offsets(cap)
        for c in range(len(cap)):
            assert got.char_to_token(CAPS.index(cap), c) == want.char_to_token(CAPS.index(cap), c)


def test_bpe_decode_and_special_ids(toks):
    tok, jt = toks
    assert tok.special_token_ids() == jt.special_token_ids()
    assert tok.vocab["Ġ."] in tok.special_token_ids()   # the delimiter as captions hold it
    enc = tok(CAPS, padding="longest")
    for row, cap in zip(enc.input_ids, CAPS):
        assert tok.decode(row) == jt.decode(row)
        assert tok.decode(row) == cap.strip()
    assert tok.convert_tokens_to_ids(["Ġcat", "no-such"]) == jt.convert_tokens_to_ids(
        ["Ġcat", "no-such"])


def test_masks_and_positive_maps_through_bpe(toks):
    """Sub-sentence masks and position ids (one block a '.'-phrase: the
    'Ġ.' id delimits), positive maps and label maps, against the JAX
    package's on the same tokenization."""
    tok, jt = toks
    caps = [ptok.build_caption(c) for c in CATS]
    assert caps == [jtok.build_caption(c) for c in CATS]
    enc = tok(caps, padding=T)
    attn, pos = ptok.generate_masks_with_special_tokens(enc.input_ids, tok.special_token_ids())
    jattn, jpos = jtok.generate_masks_with_special_tokens(enc.input_ids, jt.special_token_ids())
    np.testing.assert_array_equal(attn, jattn)
    np.testing.assert_array_equal(pos, jpos)
    # the first caption's phrases restart their positions: cat, ".", dog
    assert pos[0, :6].tolist() == [0, 0, 1, 0, 1, 0]
    maps = ptok.build_label_maps(enc, CATS, caps, T)
    jmaps = jtok.build_label_maps(jt(caps, padding=T), CATS, caps, T)
    for m, jm, cats in zip(maps, jmaps, CATS):
        np.testing.assert_array_equal(m, jm)
        assert (m.sum(1) > 0).all() and m.shape == (len(cats), T)
    for b, cats in enumerate(CATS):   # a non-ASCII name may end inside a token's bytes
        for j, name in enumerate(cats):
            if not name.isascii():
                continue
            got = tok.decode(enc.input_ids[b][np.nonzero(maps[b][j])[0]])
            assert got.replace(" ", "") == name.replace(" ", "")


@pytest.fixture(scope="module")
def vocab_txt(tmp_path_factory):
    d = tmp_path_factory.mktemp("wordpiece")
    chip_smoke.write_vocab(str(d / "vocab.txt"), 200)
    return str(d)


@pytest.mark.parametrize("form", ["pair", "bpe_dir", "json_path", "vocab_txt", "wordpiece_dir"])
def test_build_tokenizer_dispatch(bpe, vocab_txt, form):
    args, kind = {
        "pair": (("", os.path.join(bpe, "vocab.json"), os.path.join(bpe, "merges.txt")),
                 "RobertaBPETokenizer"),
        "bpe_dir": ((bpe,), "RobertaBPETokenizer"),
        "json_path": ((os.path.join(bpe, "vocab.json"),), "RobertaBPETokenizer"),
        "vocab_txt": ((os.path.join(vocab_txt, "vocab.txt"),), "BertWordPieceTokenizer"),
        "wordpiece_dir": ((vocab_txt,), "BertWordPieceTokenizer"),
    }[form]
    got, want = ptok.build_tokenizer(*args), jtok.build_tokenizer(*args)
    assert type(got).__name__ == type(want).__name__ == kind
    cap = "a cat . a dog ."
    np.testing.assert_array_equal(got([cap]).input_ids, want([cap]).input_ids)


def test_build_tokenizer_empty_dir_raises(tmp_path):
    for build in (ptok.build_tokenizer, jtok.build_tokenizer):
        with pytest.raises(ValueError):
            build(str(tmp_path))


# ---- a nano detector of roberta-base's geometry -------------------------------
NANO_CFG = """
_base_ = "{base}"
backbone = "swin_nano_test"
text_encoder_type = "roberta-base"
hidden_dim = 32
nheads = 4
enc_layers = 2
dec_layers = 2
dim_feedforward = 64
num_queries = 12
max_text_len = 32
bert_vocab_size = 1200
bert_hidden_size = 32
bert_layers = 2
bert_heads = 4
bert_intermediate = 32
bert_max_position = 34
bert_type_vocab = 1
image_buckets = [(64, 96), (96, 96)]
use_checkpoint = False
use_transformer_ckpt = False
"""
CAPTION = "a cat . a dog . person ."
SPANS = [[(2, 5)], [(10, 13)], [(16, 22)]]          # cat, dog, person
SIZE = dict(size=64, max_size=96)
INPUT_KEYS = ("images", "image_sizes", "input_ids", "text_token_mask", "position_ids",
              "text_self_attention_masks")


def _seeded_params(shapes, seed):
    """Seeded values on a flax param tree's shapes (tests/test_torch_backbones.py):
    kernels N(0, 1/fan_in), norm scales near 1, the rest N(0, 0.02); the
    deformable offset and weight kernels off the pixel lattice."""
    rng = np.random.RandomState(seed)

    def draw(path, x):
        key = jax.tree_util.keystr(path)
        name = key.split("'")[-2]
        n = rng.randn(*x.shape).astype(np.float32)
        if name == "kernel":
            if "sampling_offsets" in key or "attention_weights" in key:
                return 0.05 * n
            return (n / np.sqrt(np.prod(x.shape[:-1]))).astype(np.float32)
        return (1.0 + 0.1 * n) if name == "scale" else 0.02 * n

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def nano(bpe, tmp_path_factory):
    """Both packages' configs, the JAX tree exported to a reference-layout
    .pth, and both packages' load_model on it with the BPE directory."""
    import open_groundingdino_tpu
    import open_groundingdino_tpu_torch

    tmp = tmp_path_factory.mktemp("roberta_nano")
    cfgs = {}
    for name, pkg in (("jax", open_groundingdino_tpu), ("port", open_groundingdino_tpu_torch)):
        cfgs[name] = str(tmp / f"cfg_{name}.py")
        with open(cfgs[name], "w") as f:
            f.write(NANO_CFG.format(base=f"{pkg.__path__[0]}/config/cfg_base.py"))
    model = jbuild(JSLConfig.fromfile(cfgs["jax"]))
    ids = np.asarray([[0, 7, 2] + [1] * (T - 3)], np.int32)
    init = dict(images=jnp.zeros((1, 64, 96, 3)), image_sizes=jnp.asarray([[64, 96]], jnp.int32),
                input_ids=jnp.asarray(ids), text_token_mask=jnp.asarray(ids != 1),
                position_ids=jnp.zeros((1, T), jnp.int32),
                text_self_attention_masks=jnp.ones((1, T, T), bool))
    params = _seeded_params(jax.eval_shape(model.init, jax.random.PRNGKey(0), **init)["params"], 0)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          export_groundingdino_checkpoint(params).items()}
    assert sd["bert.embeddings.token_type_embeddings.weight"].shape == (1, 32)
    assert sd["bert.embeddings.position_embeddings.weight"].shape == (34, 32)
    ckpt = str(tmp / "ckpt.pth")
    torch.save({"model": sd}, ckpt)
    return dict(cfgs=cfgs, ckpt=ckpt, sd=sd,
                jax=jax_inference.load_model(cfgs["jax"], ckpt, bpe),
                port=port_inference.load_model(cfgs["port"], ckpt, bpe, device="cpu"))


def test_roberta_checkpoint_loads_strictly(nano):
    """Every tensor of the exported tree lands in the port's model, and the
    model has no tensor the file lacks (the shared box head's aliases
    aside)."""
    model = build_groundingdino(SLConfig.fromfile(nano["cfgs"]["port"]), device="cpu")
    port_inference.load_reference_state_dict(model, nano["ckpt"])
    sd = model.state_dict()
    for k, v in nano["sd"].items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    assert model.bert.embeddings.token_type_embeddings.weight.shape == (1, 32)
    assert isinstance(nano["port"].tokenizer, ptok.RobertaBPETokenizer)


def test_roberta_forward_matches_jax_flip_aware(nano):
    """The port's forward against the JAX Model's jitted forward on the same
    request's inputs (the BPE caption), flip-aware as
    tests/test_torch_model.py."""
    image = Image.fromarray(np.random.RandomState(1).randint(0, 255, (120, 160, 3), np.uint8))
    jim, tim = nano["jax"], nano["port"]
    inputs, tok = port_inference.prepare_inputs(
        tim, image, port_inference.preprocess_caption(CAPTION), **SIZE)
    assert tok.input_ids[0, 2] == tim.tokenizer.vocab["Ġcat"]
    jax_inference.predict(jim, image, CAPTION, **SIZE)                # compiles "fwd"
    out_j = jim._jitted["fwd"](jim.params, *(jnp.asarray(
        inputs[k].numpy().astype(np.int32) if inputs[k].dtype == torch.int64
        else inputs[k].numpy()) for k in INPUT_KEYS))
    with torch.no_grad():
        out_t = tim.model(**inputs)
    lg_j, bx_j = np.asarray(out_j["pred_logits"]), np.asarray(out_j["pred_boxes"])
    lg_t, bx_t = out_t["pred_logits"].numpy(), out_t["pred_boxes"].numpy()
    assert lg_t.shape == lg_j.shape == (1, 12, T) and bx_t.shape == bx_j.shape
    flip = np.max(np.abs(bx_t - bx_j), axis=-1) > 1e-2
    keep = ~flip
    assert flip.mean() < 0.10, f"{flip.mean():.1%} of queries flipped"
    fin = np.isfinite(lg_j) & keep[..., None]
    assert np.array_equal(np.isfinite(lg_t), np.isfinite(lg_j))
    assert np.max(np.abs(lg_t[fin] - lg_j[fin])) < 1e-3
    assert np.max(np.abs(bx_t[keep] - bx_j[keep])) < 1e-4


def test_roberta_predict_matches_jax(nano):
    """load_model with the BPE directory, predict (phrases decoded through
    the BPE tokenizer) and predict_with_spans, against the JAX package's."""
    image = Image.fromarray(np.random.RandomState(1).randint(0, 255, (120, 160, 3), np.uint8))
    jim, tim = nano["jax"], nano["port"]
    kw = dict(box_threshold=0.0, text_threshold=0.05, **SIZE)
    boxes_j, scores_j, phrases_j = jax_inference.predict(jim, image, CAPTION, **kw)
    boxes_t, scores_t, phrases_t = port_inference.predict(tim, image, CAPTION, **kw)
    assert len(boxes_t) == len(boxes_j) > 0
    np.testing.assert_allclose(boxes_t, boxes_j, atol=1e-4)
    np.testing.assert_allclose(scores_t, scores_j, atol=1e-4)
    assert phrases_t == phrases_j
    words = set(CAPTION.split())
    assert all(set(p.split()) <= words for p in phrases_t)
    assert any(set(p.split()) - {"."} for p in phrases_t)

    kw = dict(box_threshold=0.0, **SIZE)
    boxes_j, scores_j, phrases_j = jax_inference.predict_with_spans(jim, image, CAPTION, SPANS,
                                                                    **kw)
    boxes_t, scores_t, phrases_t = port_inference.predict_with_spans(tim, image, CAPTION, SPANS,
                                                                     **kw)
    assert len(boxes_t) == len(boxes_j) > 0
    np.testing.assert_allclose(boxes_t, boxes_j, atol=1e-4)
    np.testing.assert_allclose(scores_t, scores_j, atol=1e-4)
    assert phrases_t == phrases_j and set(phrases_t) == {"cat", "dog", "person"}


def test_load_model_rejects_a_directory_without_vocab(nano, tmp_path):
    with pytest.raises(ValueError):
        port_inference.load_model(nano["cfgs"]["port"], nano["ckpt"], str(tmp_path),
                                  device="cpu")
