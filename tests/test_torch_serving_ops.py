"""The custom ops of ops/library.py and the serving artifacts of the sweep and
banded_point paths, at nano size on the CPU (the gather path's artifact
against the JAX package's is tests/test_torch_serving.py).

  * (a) `torch.library.opcheck` on the ten custom ops (K1-K10) at tiny
    shapes, f32 and bf16: schema, the fake implementation against the CPU
    one (the plain version), dispatch under AOT tracing; and the wrappers
    reach the ops with and without a gradient, with the plain version's
    values.
  * (e) A nano model (one encoder and one decoder layer, seeded weights with
    perturbed offset/weight kernels) exported on msda_kernel="sweep" (with
    msda_dec_fused: K6 in the encoder, K7 in the decoder) and on
    "banded_point" (K5), loaded back: its program holds one op per kernel
    launch and equals the eager forward within 1e-5.
"""
import numpy as np
import pytest
import torch

from open_groundingdino_tpu_torch import inference, serving
from open_groundingdino_tpu_torch.config import SLConfig
from open_groundingdino_tpu_torch.models.deformable import MSDeformAttn
from open_groundingdino_tpu_torch.models.groundingdino import build_groundingdino, init_weights_
from open_groundingdino_tpu_torch.ops import library, msda
from open_groundingdino_tpu_torch.ops import msda_banded as mb
from open_groundingdino_tpu_torch.ops import msda_sweep as sw

# ---- nano geometry: tests/test_torch_model.py's at one layer each ----------
T, ENC, DEC = 16, 1, 1
BUCKET = (64, 96)
VOCAB = "[PAD] [UNK] [CLS] [SEP] [MASK] . ? dog cat bird".split()
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
image_buckets = [(64, 96)]
use_checkpoint = False
use_transformer_ckpt = False
"""


def _inputs(seed=0):
    """A padded image (valid 56x80 of 64x96) and a two-phrase caption with
    10 live tokens (tests/test_torch_model.py's), numpy."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, 40, size=(1, T)).astype(np.int64)
    ids[0, 0], ids[0, 9] = 2, 3
    sam = np.eye(T, dtype=bool)[None].copy()
    sam[:, 1:5, 1:5] = True
    sam[:, 5:9, 5:9] = True
    pos = np.zeros((1, T), np.int64)
    pos[0, 1:5] = np.arange(4)
    pos[0, 5:9] = np.arange(4)
    return dict(images=rng.randn(1, *BUCKET, 3).astype(np.float32),
                image_sizes=np.asarray([[56, 80]], np.int64), input_ids=ids,
                text_token_mask=np.arange(T)[None] < 10, position_ids=pos,
                text_self_attention_masks=sam)


def _torch_inputs():
    return {k: torch.from_numpy(v) for k, v in _inputs().items()}


def _op_counts(sm) -> dict:
    """The ogd_torch ops in the bucket's loaded program, by name."""
    graph = sm.model.programs[BUCKET].graph
    targets = [str(n.target) for n in graph.nodes if n.op == "call_function"]
    return {op: targets.count(f"{library.NAMESPACE}.{op}.default")
            for op in library.custom_ops()}


def _msda_args(dtype):
    shapes = ((4, 6), (2, 3))
    rng = np.random.RandomState(0)
    L = sum(h * w for h, w in shapes)
    value = torch.from_numpy(rng.randn(1, L, 2, 4).astype(np.float32)).to(dtype)
    locs = torch.from_numpy(rng.uniform(-0.1, 1.1, (1, 5, 2, 2, 4, 2)).astype(np.float32))
    attn = torch.from_numpy(rng.uniform(size=(1, 5, 2, 2, 4)).astype(np.float32))
    return value, shapes, locs, attn


def _op_cases(dtype):
    """Each op's arguments at tiny shapes: the operands its wrapper builds."""
    value, shapes, locs, attn = _msda_args(dtype)
    flat = library.flat_shapes(shapes)
    rng = np.random.RandomState(1)
    fusion = [torch.from_numpy(rng.randn(1, n, 8).astype(np.float32)).to(dtype)
              for n in (9, 4, 9, 4)]
    masks = [torch.from_numpy(np.arange(n)[None] >= live) for n, live in ((9, 7), (4, 3))]
    _, _, px, py, wa = mb.banded_operands(locs, attn, shapes, value.shape[1])
    row, tpx, w = (sw.sort_and_pad(t, None) for t in sw.rowtap_positions_and_weights(
        *sw.kernel_layout(locs, attn), shapes))
    idx, cw = (sw.sort_and_pad(t, None) for t in sw.corner_indices_and_weights(
        *sw.kernel_layout(locs, attn), shapes))
    starts = list(msda.level_starts(shapes))
    B, L, H, D = value.shape
    out_v, out_l, lse_v, lse_l = library.custom_ops()["fusion_fwd"](*fusion, *masks, 2)
    g_f = [torch.from_numpy(rng.randn(*t.shape).astype(np.float32)).to(dtype)
           for t in (out_v, out_l)]
    g_msda = torch.from_numpy(rng.randn(B, locs.shape[1], H * D).astype(np.float32)).to(dtype)
    g_taps = torch.from_numpy(rng.randn(B * H, w.shape[-1], D).astype(np.float32)).to(dtype)
    return {"msda_fwd": (value, flat, starts, locs, attn),
            "msda_bwd": (value, flat, starts, locs, attn, g_msda),
            "fusion_fwd": (*fusion, *masks, 2),
            "fusion_bwd": (*fusion, *masks, out_v, out_l, lse_v, lse_l, *g_f, 2),
            "banded_fwd": (value, flat, px, py, wa),
            "sweep_fwd": (value, flat, row, tpx, w),
            "sweep_fwd_allq": (value, flat, row, tpx, w),
            "sweep_fwd_corner": (value, flat, idx, cw),
            "sweep_bwd_corner": (value, flat, idx, cw, g_taps),
            "sweep_bwd_rowtap": (value, flat, row, tpx, w, g_taps),
            # the matcher's costs are f32 whatever the compute dtype
            "lsap": (torch.from_numpy(rng.randn(3, 12, 5).astype(np.float32)),
                     torch.from_numpy(rng.rand(3, 5) > 0.3))}


# each op's outputs that are f32 whatever the operands' dtype: K2's
# statistics, the location, weight and tap gradients
F32_OUTPUTS = {"fusion_fwd": (2, 3), "msda_bwd": (1, 2), "sweep_bwd_corner": (1,),
               "sweep_bwd_rowtap": (1, 2)}
# the matcher's assignment and its overflow flags
OUTPUT_DTYPES = {"lsap": (torch.int64, torch.bool)}


def _as_tuple(t):
    return (t,) if isinstance(t, torch.Tensor) else tuple(t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ops_opcheck(dtype):
    ops = library.custom_ops()
    cases = _op_cases(dtype)
    assert set(ops) == set(cases)
    for name, args in cases.items():
        torch.library.opcheck(ops[name], args)
        fake = ops[name](*[a.to("meta") if isinstance(a, torch.Tensor) else a for a in args])
        real = ops[name](*args)
        for f, r in zip(_as_tuple(fake), _as_tuple(real)):
            assert (f.shape, f.dtype) == (r.shape, r.dtype), name
        want = OUTPUT_DTYPES.get(name) or [
            torch.float32 if i in F32_OUTPUTS.get(name, ()) else dtype
            for i in range(len(_as_tuple(real)))]
        assert [r.dtype for r in _as_tuple(real)] == list(want), name


def test_fusion_op_statistics():
    """K2's op gives the log-sum-exp statistics K4 reads: over live text for
    each image row, over live image tokens for each text column, +inf where
    none is live."""
    q, k, val_v, val_l, mask_v, mask_l, H = _op_cases(torch.float32)["fusion_fwd"]
    mask_l = torch.ones_like(mask_l)                  # no live text: lse_v is +inf
    _, _, lse_v, lse_l = library.custom_ops()["fusion_fwd"](q, k, val_v, val_l, mask_v,
                                                            mask_l, H)
    assert torch.isinf(lse_v).all() and (lse_v > 0).all()
    logits = torch.einsum("bvhd,blhd->bhvl", q.view(1, 9, H, -1), k.view(1, 4, H, -1))
    want = torch.logsumexp(logits[:, :, ~mask_v[0]], dim=2)
    torch.testing.assert_close(lse_l, want)


def test_wrappers_reach_the_ops():
    """The wrappers' results are the ops', the plain versions' values, with
    and without a gradient."""
    value, shapes, locs, attn = _msda_args(torch.float32)
    starts = msda.level_starts(shapes)
    plain = msda.ms_deform_attn_plain(value, shapes, starts, locs, attn)
    with torch.no_grad():
        torch.testing.assert_close(msda.ms_deform_attn(value, shapes, starts, locs, attn), plain,
                                   rtol=0, atol=0)
        for fn in (mb.ms_deform_attn_banded, sw.ms_deform_attn_sweep):
            torch.testing.assert_close(fn(value.new_zeros(1, 30, 2, 32), shapes, starts,
                                          locs, attn), value.new_zeros(1, 5, 64))
    leaf = value.clone().requires_grad_(True)
    out = msda.ms_deform_attn(leaf, shapes, starts, locs, attn)
    assert out.grad_fn is not None
    torch.testing.assert_close(out.detach(), plain, rtol=0, atol=0)


# ---------------------------------------------------------------- (e)
@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A seeded nano checkpoint (the offset and weight kernels, zero at init,
    drawn so that the sampling points are query-dependent) and the vocab."""
    import open_groundingdino_tpu_torch

    d = tmp_path_factory.mktemp("serving_ops")
    (d / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    base = f"{open_groundingdino_tpu_torch.__path__[0]}/config/cfg_base.py"
    (d / "cfg.py").write_text(NANO_CFG.format(base=base))
    model = init_weights_(build_groundingdino(SLConfig.fromfile(str(d / "cfg.py")),
                                              device="cpu"), 0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MSDeformAttn):
                for lin in (m.sampling_offsets, m.attention_weights):
                    lin.weight.normal_(0.0, 0.05, generator=g)
    torch.save({"model": model.state_dict()}, str(d / "ckpt.pth"))
    return d


@pytest.mark.parametrize("keys,ops", [
    ({"msda_kernel": "sweep", "msda_dec_fused": True},
     {"sweep_fwd": ENC, "sweep_fwd_allq": DEC}),
    ({"msda_kernel": "banded_point"}, {"banded_fwd": ENC + DEC}),
], ids=["sweep", "banded_point"])
def test_msda_path_round_trip(workspace, tmp_path, keys, ops):
    cfg = tmp_path / "cfg.py"
    cfg.write_text(f"_base_ = {str(workspace / 'cfg.py')!r}\n"
                   + "".join(f"{k} = {v!r}\n" for k, v in keys.items()))
    im = inference.load_model(str(cfg), str(workspace / "ckpt.pth"),
                              str(workspace / "vocab.txt"), device="cpu")
    serving.export_model(im, str(tmp_path / "art"), buckets=[BUCKET])
    sm = serving.load_exported(str(tmp_path / "art"), vocab_path=str(workspace / "vocab.txt"),
                               device="cpu")
    assert (sm.meta["msda_kernel"], sm.meta["msda_dec_fused"]) == (
        keys["msda_kernel"], keys.get("msda_dec_fused", False))
    assert {k: v for k, v in _op_counts(sm).items() if v} == {**ops, "fusion_fwd": ENC}
    inputs = _torch_inputs()
    with torch.no_grad():
        want = im.model(**inputs)
    with torch.inference_mode():
        got = sm.model(**inputs)
    for key in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=0, atol=1e-5)
