"""The port's per-point banded MSDA and corner-tap forward in bf16 (the bf16
entries of K5 and K8: ops/msda_banded.py, ops/msda_sweep.py) against the JAX
package in bf16, its default mixed precision, at nano size on the CPU.

Every bound is tests/test_torch_bf16.py's anchor: the port's distance from
the JAX package in bf16 stays within twice the distance of the JAX package
in bf16 from the JAX package in f32 on the same bf16-rounded inputs, plus
1e-3 (largest |difference|, in the output's units).  The TPU kernels round
their tap weights to bf16 for the MXU (K5's x-tap matrix, msda_banded.py:190;
K8's weight matrix S, msda_pallas.py:246); the port's kernels keep them f32
(csrc/msda_banded_fwd.cu, csrc/msda_corner_fwd.cu), a difference the anchor
measures.

  * kernels: the bf16 plain K5 (`banded_fwd_plain` on a bf16 value, rounded
    once) against `_banded_call` (through `_banded_core`, MSDA_BANDED_MP=0)
    at tests/test_torch_msda_banded.py's shapes, and the bf16 plain K8
    (`sweep_fwd_corner_plain`) against `_msda_pallas_fwd_call` at
    tests/test_torch_msda_sweep.py's, both in interpret mode;
  * module: MSDeformAttn(kernel="banded_point") on bf16 parameters and
    inputs against the JAX MSDeformAttn(impl="pallas") with
    MSDA_BANDED_MP=0 on the same tree in bf16, the forward and every
    projection's gradient (encoder queries; the nano model holds the
    decoder's sorted query sets);
  * nano model: one bf16 eval forward through msda_kernel="banded_point"
    against the JAX nano model's make_eval_step in bf16 on that path (its
    fusion through the TPU kernel, as tests/test_torch_bf16.py runs it),
    flip-aware (NANO_FLIPS says why two swapped pairs), and against the
    port's bf16 forward through the gather with no flip;
  * the ops' plumbing (K5's op with K3's, and K8's with K9's, under their
    registered autograd; the ops dispatched recorded): a bf16 output, the
    value handed to K5 / K8 in bf16, a bf16 contiguous upstream gradient
    handed to K3 / K9, grad_value in bf16 and grad_locs / grad_attn in f32.
No JAX training step is compiled here (tests/test_torch_bf16.py holds one).
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from open_groundingdino_tpu.ops import msda_banded as jb
from open_groundingdino_tpu.ops import msda_pallas as mp
from open_groundingdino_tpu.parallel.train_state import make_eval_step as jmake_eval_step
from open_groundingdino_tpu.utils.checkpoint import convert_groundingdino_checkpoint
from open_groundingdino_tpu_torch.models.deformable import MSDeformAttn
from open_groundingdino_tpu_torch.ops import msda
from open_groundingdino_tpu_torch.ops import msda_banded as mb
from open_groundingdino_tpu_torch.ops import msda_sweep as sw
from open_groundingdino_tpu_torch.parallel.train_state import make_eval_step
from test_torch_banded_model import per_point  # noqa: F401 (a fixture)
from test_torch_bf16 import (BERT, JAX_TOP, PORT_KEYS, SWIN, JBertConfig, JGroundingDINO,
                             JSwinConfig, _batch, _bf, _port_model, _weights,
                             assert_anchored, jax_fusion_kernel)  # noqa: F401 (a fixture)
from test_torch_msda_banded import (BAND, P, SHAPES, STARTS, L, _banded_values, _inputs,
                                    _kernel_layout)
from test_torch_msda_sweep import _corner_operands, _pad_l
from test_torch_sweep_bf16 import L4, PROJS, SHAPES4, _jax_module_run, _module_params

BF = torch.bfloat16


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


# ---------------------------------------------------------------- the kernels
def test_bf16_banded_fwd_plain_matches_tpu_kernel(per_point):
    """K5: a padding mask, Q = 173 (two query blocks, the second part
    padded), points outside the map."""
    Q = 173
    value, locs, attn, _ = _inputs(Q, 1)
    value = _bf(value)
    locs_t, attn_t = _kernel_layout(locs, attn)
    core = jax.jit(lambda v, lt, at: jb._banded_core(v, SHAPES, lt, at, P, BAND))
    ref_b, ref_f = (core(tuple(v.astype(dt) for v in _banded_values(value)), jnp.asarray(locs_t),
                         jnp.asarray(attn_t)) for dt in (jnp.bfloat16, jnp.float32))  # (BH, D, Q)
    assert ref_b.dtype == jnp.bfloat16
    px, py, wa = (sw.sort_and_pad(t, None) for t in mb.banded_prep(*map(torch.from_numpy,
                                                                          (locs_t, attn_t)),
                                                                      SHAPES))
    ranges = mb.band_ranges(torch.from_numpy(locs_t), SHAPES, px.shape[-1] // sw.QBLOCK,
                            mb.level_bands(SHAPES, BAND))
    got = mb.banded_fwd_plain(_t(value, BF), SHAPES, px, py, wa, ranges, BAND).to(BF)
    assert_anchored(got[:, :Q], np.asarray(ref_b, np.float32).transpose(0, 2, 1),
                    np.asarray(ref_f).transpose(0, 2, 1), "K5 out")


def test_bf16_corner_fwd_plain_matches_tpu_kernel():
    """K8 on corner taps sorted by the first, as the op-level path sorts a
    Q != L query set."""
    Q = 173
    value, value_t, idx, w = _corner_operands(Q, 2)
    value, value_t = _bf(value), _bf(value_t)
    ranges = mp._tile_ranges(jnp.asarray(idx), jnp.asarray(w),
                             idx.shape[-1] // mp.QBLOCK).reshape(-1)
    ref_b, ref_f = (mp._msda_pallas_fwd_call(_pad_l(value_t, mp.TILE).astype(dt),
                                             jnp.asarray(idx), jnp.asarray(w), ranges)
                    for dt in (jnp.bfloat16, jnp.float32))
    assert ref_b.dtype == jnp.bfloat16
    got = sw.sweep_fwd_corner_plain(_t(value, BF), _t(idx, torch.int32), _t(w)).to(BF)
    assert_anchored(got, ref_b, ref_f, "K8 out")


# ---------------------------------------------------------------- the module
def test_bf16_module_matches_jax_banded_path(per_point):
    """Encoder-style inputs (Q = L, 2-d reference points, a padding mask),
    bf16-rounded, through banded_point in bf16 against the JAX banded path
    with MSDA_BANDED_MP=0 in bf16, anchored on the JAX package's f32 run
    (through its XLA formulation, the same f32 function, quicker to
    compile)."""
    rng = np.random.RandomState(26)
    Bm, C, Hm = 2, 32, 4
    case = dict(C=C, H=Hm, refs=rng.uniform(0.05, 0.95, (Bm, L4, 4, 2)).astype(np.float32),
                pad=np.zeros((Bm, L4), bool))
    case["pad"][1, 80:96] = True
    case["query"], case["value"], case["grad"] = (_bf(rng.randn(Bm, L4, C).astype(np.float32))
                                                  for _ in range(3))
    case["params"] = _module_params(C, Hm, rng)
    out_b, grads_b = _jax_module_run(case, jnp.bfloat16, "pallas")
    out_f, grads_f = _jax_module_run(case, jnp.float32, "xla")
    assert out_b.dtype == jnp.bfloat16

    mod = MSDeformAttn(C, Hm, 4, 4, kernel="banded_point")
    params = case["params"]
    mod.load_state_dict({f"{n}.{t}": _t(params[n]["kernel"].T if t == "weight" else
                                        params[n]["bias"])
                         for n in PROJS for t in ("weight", "bias")})
    mod.to(BF)
    out = mod(_t(case["query"], BF), _t(case["value"], BF), _t(case["refs"]), SHAPES4,
              torch.from_numpy(case["pad"]))
    assert out.dtype == BF
    out.backward(_t(case["grad"], BF))
    assert_anchored(out.detach(), out_b, out_f, "banded_point out")
    for n in PROJS:
        lin = getattr(mod, n)
        assert lin.weight.grad.dtype == BF
        assert_anchored(lin.weight.grad.T, grads_b[n]["kernel"], grads_f[n]["kernel"],
                        f"{n}.weight grad")
        assert_anchored(lin.bias.grad, grads_b[n]["bias"], grads_f[n]["bias"], f"{n}.bias grad")


# ---------------------------------------------------------------- the nano model
# flipped queries allowed against the JAX package's banded bf16 forward, of
# the batch's 24: two swapped pairs of near-tied proposals.  On these weights
# and this batch the port's bf16 forward swaps the proposals of queries 4/5
# and 6/7 of image 1 against the f32 forwards of both packages, on each of
# its MSDA paths alike (gather, sweep and banded_point give the same boxes);
# the JAX package's bf16 forwards part by such swaps among themselves (its
# sweep swaps 4/5, its banded path neither).  tests/test_torch_bf16.py's 10%
# (2 of 24) holds the gather, and the port's banded_point forward is held to
# its gather forward below with no flip.
NANO_FLIPS = 4


def test_bf16_nano_forward_matches_jax_banded_path(per_point, jax_fusion_kernel):
    """make_eval_step(compute_dtype=bf16) through msda_kernel="banded_point"
    against the JAX package's on its banded path with MSDA_BANDED_MP=0, on
    tests/test_torch_bf16.py's seeded nano weights: at most NANO_FLIPS
    queries flip, the others anchored (logits and boxes); and against the
    port's bf16 forward through the gather (K1 bf16), which
    tests/test_torch_bf16.py holds to the JAX package: no query flips, and
    the two differ by at most twice the gather's distance from the JAX
    package's f32 forward, plus 1e-3."""
    sd = _weights()
    params = convert_groundingdino_checkpoint(
        sd, swin_depths=SWIN["depths"], out_indices=SWIN["out_indices"],
        num_feature_levels=JAX_TOP["num_feature_levels"], enc_layers=JAX_TOP["enc_layers"],
        dec_layers=JAX_TOP["dec_layers"], bert_layers=BERT["num_hidden_layers"])
    batch = _batch()
    inputs = {k: batch[k] for k in PORT_KEYS}
    ref = {}
    # the f32 anchor through the JAX package's XLA formulation (the same f32
    # function, quicker to compile); XLA's backend optimisation off, as
    # tests/test_torch_sweep_bf16.py compiles
    for name, dt, impl in (("bf16", jnp.bfloat16, "pallas"), ("f32", None, "xla")):
        jmodel = JGroundingDINO(
            swin_cfg=JSwinConfig(**SWIN),
            bert_cfg=JBertConfig(**BERT, hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.0),
            msda_impl=impl, **JAX_TOP)
        ref[name] = (jax.jit(jmake_eval_step(jmodel, compute_dtype=dt)).lower(params, inputs)
                     .compile({"xla_backend_optimization_level": 0})(params, inputs))
    weights = {k: torch.from_numpy(v) for k, v in sd.items()}
    out, gather = (make_eval_step(_port_model(weights, JAX_TOP, msda={"kernel": kernel}),
                                  compute_dtype="bfloat16")(batch)
                   for kernel in ("banded_point", "gather"))
    lg, bx = ([np.asarray(o[k], np.float32) if not isinstance(o[k], torch.Tensor)
               else o[k].float().numpy() for o in (out, ref["bf16"], ref["f32"], gather)]
              for k in ("pred_logits", "pred_boxes"))
    flips = {name: np.abs(bx[i] - bx[j]).max(-1) > 1e-2
             for name, i, j in (("port", 0, 1), ("jax", 1, 2), ("gather", 3, 2), ("paths", 0, 3))}
    print(f"queries flipped of {flips['port'].size}: "
          f"{ {k: int(v.sum()) for k, v in flips.items()} }")
    assert flips["port"].sum() <= NANO_FLIPS and not flips["paths"].any()
    assert np.array_equal(np.isfinite(lg[0]), np.isfinite(lg[1]))
    assert np.array_equal(np.isfinite(lg[0]), np.isfinite(lg[3]))
    fin = np.isfinite(lg[1])
    for ref_i, what, keep in ((1, "", ~(flips["port"] | flips["jax"])),
                              (3, " against the gather", ~flips["gather"])):
        assert_anchored(lg[0], lg[ref_i], lg[2], "pred_logits" + what, fin & keep[..., None])
        assert_anchored(bx[0], bx[ref_i], bx[2], "pred_boxes" + what, keep)


# ---------------------------------------------------------------- the ops' plumbing
def _plumbing_inputs(Q, seed):
    value, locs, attn, grad = _inputs(Q, seed)
    return _t(_bf(value), BF), _t(locs), _t(attn), _t(_bf(grad), BF)


class Record(TorchDispatchMode):
    """The ogd_torch ops dispatched under it: (name, value dtype, the last
    tensor operand's dtype and contiguity, the output dtypes)."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "ogd_torch":
            outs = (out,) if isinstance(out, torch.Tensor) else tuple(out)
            last = [a for a in args if isinstance(a, torch.Tensor)][-1]
            self.calls.append((func.__name__.split(".")[0], args[0].dtype, last.dtype,
                               last.is_contiguous(), tuple(o.dtype for o in outs)))
        return out


@pytest.mark.parametrize("Q", [L, 150], ids=["Q=L", "Q!=L-sorted"])
def test_bf16_banded_function_dtypes(Q):
    """K5's op in bf16 under its registered autograd (the CUDA path's
    plumbing, the ops dispatched recorded): K5 given the bf16 value, a bf16
    output, the upstream gradient handed to K3 in bf16 and contiguous (the
    caller upcasts the output and sends an f32 gradient), grad_value
    returned in bf16 and grad_locs / grad_attn in f32 (read at K3's op, so
    that autograd's casts cannot hide a dtype).  The output against the
    plain banded version on the same bf16 inputs, grad_value against K3's
    plain version (which adds it in bf16, as K3 bf16 does) and grad_locs /
    grad_attn against the plain banded version under autograd."""
    v, locs, attn, g = _plumbing_inputs(Q, 7)
    leaves = [t.clone().requires_grad_(True) for t in (v, locs, attn)]
    ref = mb.ms_deform_attn_banded_plain(leaves[0], SHAPES, leaves[1], leaves[2], BAND)
    ref.backward(g)
    got = [t.clone().requires_grad_(True) for t in (v, locs, attn)]
    with Record() as rec:
        out = mb.ms_deform_attn_banded(got[0], SHAPES, STARTS, got[1], got[2], BAND)
        out.float().backward(g.float())
    assert out.dtype == BF
    gv, gl, ga = (t.grad for t in got)
    assert (gv.dtype, gl.dtype, ga.dtype) == (BF, torch.float32, torch.float32)
    assert [c[:2] for c in rec.calls] == [("banded_fwd", BF), ("msda_bwd", BF)]
    assert rec.calls[0][4] == (BF,)
    assert rec.calls[1][2:] == (BF, True, (BF, torch.float32, torch.float32))
    torch.testing.assert_close(out, ref.detach())
    want = msda.ms_deform_attn_bwd_plain(v, SHAPES, STARTS, locs, attn, g)
    torch.testing.assert_close(gv, want[0], rtol=0, atol=0)
    for got_g, want_g in ((gl, leaves[1].grad), (ga, leaves[2].grad)):
        torch.testing.assert_close(got_g, want_g, rtol=1e-4, atol=2e-4)


def test_bf16_corner_function_dtypes():
    """K8's op (fwd="corner") in bf16 under its registered autograd: K8
    given the bf16 value, a bf16 output, K9 the bf16 value and upstream
    gradient, grad_value in bf16 and gw in f32 (read at K9's op), grad_locs /
    grad_attn in f32; against the plain corner forward under autograd."""
    Q = 150
    v, locs, attn, g = _plumbing_inputs(Q, 8)
    leaves = [t.clone().requires_grad_(True) for t in (v, locs, attn)]
    ref = sw.ms_deform_attn_sweep_plain(leaves[0], SHAPES, leaves[1], leaves[2], fwd="corner")
    ref.backward(g)
    got = [t.clone().requires_grad_(True) for t in (v, locs, attn)]
    with Record() as rec:
        out = sw.ms_deform_attn_sweep(got[0], SHAPES, STARTS, got[1], got[2], fwd="corner")
        out.backward(g)
    assert out.dtype == BF
    gv, gl, ga = (t.grad for t in got)
    assert (gv.dtype, gl.dtype, ga.dtype) == (BF, torch.float32, torch.float32)
    assert rec.calls == [("sweep_fwd_corner", BF, torch.float32, True, (BF,)),
                         ("sweep_bwd_corner", BF, BF, True, (BF, torch.float32))]
    torch.testing.assert_close(out, ref.detach())
    torch.testing.assert_close(gv, leaves[0].grad)
    for got_g, want_g in ((gl, leaves[1].grad), (ga, leaves[2].grad)):
        torch.testing.assert_close(got_g, want_g, rtol=1e-4, atol=2e-4)
