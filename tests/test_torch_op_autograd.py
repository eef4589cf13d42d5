"""Every kernel of the port as a differentiable torch.library op
(ops/library.py), on CPU tensors at nano size.

  * `torch.library.opcheck` of all ten ogd_torch ops (K1-K10) in f32, the
    forward ops on operands that require a gradient: schema, the fake
    implementation against the CPU one, the registered autograd, dispatch
    under AOT tracing (tests/test_torch_serving_ops.py runs the ten without
    a gradient, in f32 and bf16).
  * One fusion block and one deformable encoder layer on the gather path,
    forward and backward, compiled whole (torch.compile, fullgraph=True,
    through AOTAutograd; utils/graph_check.py): no graph break, the forward
    graph holds K2's and K1's ops and the backward K3's and K4's, the loss
    and every gradient equal to eager's within 1e-6 relative (the same
    plain versions run in both; only the graph's op order differs).
  * One nano training step's loss and gradients (forward, host matching,
    criterion, backward) on each MSDA path through the ops against the same
    step through the plain versions' autograd, the parent tree's CPU path,
    f32: the gather and fusion ops' plain backwards are that autograd (1e-6);
    the sweep's K9 / K10 and banded_point's K3 plain backwards are the same
    function summed in another order (1e-5).  Each parameter's largest
    difference is held relative to the step's largest gradient (a bias
    ahead of a normalisation has a gradient that cancels to rounding noise,
    1e-7 of that scale), and the whole gradient's L2 difference relative to
    its norm.
No JAX step is compiled here.
"""
import ast
import os

import numpy as np
import pytest
import torch

from open_groundingdino_tpu_torch.config import SLConfig
from open_groundingdino_tpu_torch.models import deformable, layers as model_layers
from open_groundingdino_tpu_torch.models.criterion import build_criterion
from open_groundingdino_tpu_torch.models.groundingdino import build_groundingdino, init_weights_
from open_groundingdino_tpu_torch.ops import fusion, library, msda
from open_groundingdino_tpu_torch.ops import msda_banded as mb
from open_groundingdino_tpu_torch.ops import msda_sweep as sw
from open_groundingdino_tpu_torch.utils import graph_check

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "open_groundingdino_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "open_groundingdino_tpu")
NEW_MODULES = ("ops/library.py", "ops/msda.py", "ops/fusion.py", "ops/msda_banded.py",
               "ops/msda_sweep.py", "utils/graph_check.py", "utils/profiling.py")


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_modules_import_no_jax():
    """This slice's modules import nothing of JAX or the JAX package (an AST
    scan; tests/test_torch_imports.py imports them all)."""
    for rel in NEW_MODULES:
        assert not imported_roots(os.path.join(PKG, rel)) & set(FORBIDDEN), rel


# ---------------------------------------------------------------- opcheck
SHAPES = ((4, 6), (2, 3))


def _op_args():
    """Each op's operands at tiny shapes, f32: the forwards' value, locations
    and weights (q, k, values) require a gradient."""
    rng = np.random.RandomState(0)
    L = sum(h * w for h, w in SHAPES)
    t = lambda *shape, lo=None, hi=None: torch.from_numpy(   # noqa: E731
        (rng.randn(*shape) if lo is None else rng.uniform(lo, hi, shape)).astype(np.float32))
    value, locs, attn = t(1, L, 2, 4), t(1, 5, 2, 2, 4, 2, lo=-0.1, hi=1.1), t(1, 5, 2, 2, 4, lo=0, hi=1)
    flat, starts = library.flat_shapes(SHAPES), list(msda.level_starts(SHAPES))
    q, k, vv, vl = t(1, 9, 8), t(1, 4, 8), t(1, 9, 8), t(1, 4, 8)
    mask_v = torch.arange(9)[None] >= 7
    mask_l = torch.arange(4)[None] >= 3
    order, _, px, py, wa = mb.banded_operands(locs, attn, SHAPES, L)
    row, tpx, w = (sw.sort_and_pad(x, None) for x in sw.rowtap_positions_and_weights(
        *sw.kernel_layout(locs, attn), SHAPES))
    idx, cw = (sw.sort_and_pad(x, None) for x in sw.corner_indices_and_weights(
        *sw.kernel_layout(locs, attn), SHAPES))
    fo = fusion.fusion_fwd(q, k, vv, vl, mask_v, mask_l, 2)
    g_taps = t(2, w.shape[-1], 4)
    grad = lambda x: x.clone().requires_grad_(True)   # noqa: E731
    return {
        "msda_fwd": (grad(value), flat, starts, grad(locs), grad(attn)),
        "msda_bwd": (value, flat, starts, locs, attn, t(1, 5, 8)),
        "fusion_fwd": (grad(q), grad(k), grad(vv), grad(vl), mask_v, mask_l, 2),
        "fusion_bwd": (q, k, vv, vl, mask_v, mask_l, *fo, t(1, 9, 8), t(1, 4, 8), 2),
        "banded_fwd": (grad(value), flat, px, py, wa, grad(locs), grad(attn), order),
        "sweep_fwd": (grad(value), flat, row, grad(tpx), grad(w), "corner"),
        "sweep_fwd_allq": (grad(value), flat, row, grad(tpx), grad(w), "rowtap"),
        "sweep_fwd_corner": (grad(value), flat, idx, grad(cw)),
        "sweep_bwd_corner": (value, flat, idx, cw, g_taps),
        "sweep_bwd_rowtap": (value, flat, row, tpx, w, g_taps),
        "lsap": (t(3, 12, 5), torch.from_numpy(rng.rand(3, 5) > 0.3)),
    }


def test_opcheck_every_op():
    ops = library.custom_ops()
    cases = _op_args()
    assert set(ops) == set(cases)
    for name, args in cases.items():
        torch.library.opcheck(ops[name], args)


# ---------------------------------------------------------------- the compiled gather layers
def test_compiled_gather_layers_match_eager():
    layers = graph_check.build_layers(d_model=32, d_ffn=64, levels=4, heads=4, points=4,
                                      fusion_embed=64, fusion_heads=2, device="cpu")
    inputs = graph_check.layer_inputs(2, ((8, 12), (4, 6), (2, 3), (1, 2)), 32, text_len=16,
                                      live_text=9, device="cpu")
    r = graph_check.compile_check(layers, inputs)
    assert sorted(r["forward_ops"]) == ["fusion_fwd", "msda_fwd"]
    assert sorted(r["backward_ops"]) == ["fusion_bwd", "msda_bwd"]
    assert r["loss"] == pytest.approx(r["eager_loss"], rel=1e-6)
    assert r["max_rel_grad_err"] <= 1e-6
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in r["grads"][:2])


# ---------------------------------------------------------------- a nano training step
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
image_buckets = [(96, 128)]
use_checkpoint = False
use_transformer_ckpt = False
msda_kernel = "{kernel}"
msda_sweep_bwd = "{sweep_bwd}"
"""
B, T, G = 2, 16, 4


def _batch():
    rng = np.random.RandomState(3)
    ids = rng.randint(5, 40, size=(B, T)).astype(np.int64)
    ids[:, 0], ids[:, 9] = 2, 3
    boxes = np.concatenate([rng.uniform(0.3, 0.7, (B, G, 2)), rng.uniform(0.1, 0.3, (B, G, 2))],
                           -1).astype(np.float32)
    pos = np.zeros((B, G, T), np.float32)
    pos[:, :, 1:4] = 1.0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))   # noqa: E731
    inputs = dict(images=t(rng.randn(B, 96, 128, 3).astype(np.float32)),
                  image_sizes=t(np.asarray([[96, 128], [80, 112]], np.int64)), input_ids=t(ids),
                  text_token_mask=t(np.arange(T)[None].repeat(B, 0) < 10),
                  position_ids=t(np.tile(np.arange(T, dtype=np.int64)[None], (B, 1))),
                  text_self_attention_masks=t(np.ones((B, T, T), bool)))
    return inputs, t(boxes), t(pos), t(np.arange(G)[None].repeat(B, 0) < 3)


def _step_grads(cfg, model):
    inputs, boxes, pos, valid = _batch()
    model.train()
    model.zero_grad(set_to_none=True)
    out = model(**inputs, generator=torch.Generator().manual_seed(0))
    total, _ = build_criterion(cfg)(out, boxes, pos, valid)
    total.backward()
    return float(total.detach()), {n: p.grad.clone() for n, p in model.named_parameters()
                          if p.grad is not None}


def _plain_paths(monkeypatch):
    """The model's MSDA and fusion cores on the plain versions under
    autograd: the parent tree's CPU path."""
    monkeypatch.setattr(deformable, "ms_deform_attn", msda.ms_deform_attn_plain)
    monkeypatch.setattr(deformable, "ms_deform_attn_sweep",
                        lambda v, s, ls, l, a, bwd, dec_fused: sw.ms_deform_attn_sweep_plain(
                            v, s, l, a))
    monkeypatch.setattr(deformable, "ms_deform_attn_banded",
                        lambda v, s, ls, l, a: mb.ms_deform_attn_banded_plain(v, s, l, a))
    monkeypatch.setattr(model_layers, "fused_bi_attention", fusion.fused_bi_attention_plain)


@pytest.mark.parametrize("kernel,sweep_bwd,rtol", [
    ("gather", "corner", 1e-6), ("sweep", "corner", 1e-5), ("sweep", "rowtap", 1e-5),
    ("banded_point", "corner", 1e-5)], ids=["gather", "sweep-corner", "sweep-rowtap", "banded"])
def test_nano_step_matches_plain_autograd(tmp_path, monkeypatch, kernel, sweep_bwd, rtol):
    path = tmp_path / "cfg.py"
    path.write_text(NANO_CFG.format(base=os.path.join(PKG, "config", "cfg_coco.py"),
                                    kernel=kernel, sweep_bwd=sweep_bwd))
    cfg = SLConfig.fromfile(str(path))
    model = build_groundingdino(cfg, device="cpu")
    init_weights_(model, 0)
    with torch.no_grad():   # off the pixel lattice, where the paths' derivatives agree
        g = torch.Generator().manual_seed(1)
        for name, p in model.named_parameters():
            if "sampling_offsets.weight" in name or "attention_weights.weight" in name:
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
            if name.endswith(".bias") and p.abs().max() == 0:
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)
    loss, grads = _step_grads(cfg, model)
    _plain_paths(monkeypatch)
    ref_loss, ref = _step_grads(cfg, model)
    assert np.isfinite(loss) and loss == pytest.approx(ref_loss, rel=rtol)
    assert set(grads) == set(ref)
    scale = max(float(r.abs().max()) for r in ref.values())
    worst = max(float((grads[n] - ref[n]).abs().max()) for n in ref) / scale
    assert worst <= rtol, worst
    norm = lambda d: torch.cat([d[n].flatten() for n in sorted(ref)]).norm()   # noqa: E731
    assert float(norm({n: grads[n] - ref[n] for n in ref}) / norm(ref)) <= rtol
