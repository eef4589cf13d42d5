"""The port's sweep MSDA in bf16 (the bf16 entries of K6, K7, K9 and K10 in
ops/msda_sweep.py, and the gate in models/deformable.py) against the JAX
package's Pallas sweep in bf16, its default mixed precision on the
MSDA_BANDED=0 path, at nano size on the CPU.

Every bound but the tap gradients' is tests/test_torch_bf16.py's anchor:
the port's distance from the JAX package in bf16 stays within twice the
distance of the JAX package in bf16 from the JAX package in f32 on the same
bf16-rounded inputs, plus 1e-3 (largest |difference|, in the output's
units).  The TPU kernels round their combined tap weights to bf16 for the
MXU; the port's kernels keep them f32 (csrc/msda_rowtap_fwd.cu), a
difference the anchor measures.

  * kernels: the bf16 plain versions of K6 and K7 (`sweep_fwd_plain` on a
    bf16 value, rounded once) against `_msda_pallas_fwd_rowtap_call` and
    `_msda_pallas_fwd_rowtap_allq_call`, and of K9 and K10 against
    `_msda_pallas_bwd_call` and `_msda_rowtap_bwd_call`, on bf16 value_t (and
    upstream gradient) in interpret mode, at tests/test_torch_msda_sweep.py's
    shapes: outputs and grad_value (rounded to bf16 once on both sides, as
    the op casts the TPU kernels' f32 grad_value) anchored; gw and gpx, f32
    sums of the same bf16 products on both sides, within 1e-3 of their
    largest |reference| where the tap is live;
  * module: MSDeformAttn(kernel="sweep") on bf16 parameters and inputs
    against the JAX MSDeformAttn(impl="pallas") with MSDA_BANDED=0 on the
    same tree in bf16, the forward and every projection's gradient, with the
    corner and the row-tap backward (encoder queries; the kernels' tests and
    the nano model hold the decoder's sorted query sets), both anchored on
    the JAX package's f32 run with the corner backward;
  * nano model: one bf16 eval forward through msda_kernel="sweep" against
    the JAX nano model's make_eval_step in bf16 on the Pallas path (its
    fusion through the TPU kernel, as tests/test_torch_bf16.py runs it),
    flip-aware;
  * the ops' plumbing (their registered autograd, the CUDA path's too; the
    ops dispatched recorded): a bf16 output, a bf16 upstream gradient handed
    to K9 and K10, grad_value in bf16 and grad_locs / grad_attn in f32; a bf16
    module returns bf16 on every kernel path, and K8's launcher takes a
    bf16 value (tests/test_torch_banded_bf16.py holds banded_point and K8 in
    bf16).
No JAX training step is compiled here (tests/test_torch_bf16.py holds one).
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from open_groundingdino_tpu.models.deformable import MSDeformAttn as JMSDeformAttn
from open_groundingdino_tpu.ops import msda_pallas as mp
from open_groundingdino_tpu.parallel.train_state import make_eval_step as jmake_eval_step
from open_groundingdino_tpu.utils.checkpoint import convert_groundingdino_checkpoint
from open_groundingdino_tpu_torch.models.deformable import MSDeformAttn, sampling_offsets_bias
from open_groundingdino_tpu_torch.ops import msda_sweep as sw
from open_groundingdino_tpu_torch.parallel.train_state import make_eval_step
from test_torch_bf16 import (BERT, JAX_TOP, PORT_KEYS, SWIN, JBertConfig, JGroundingDINO,
                             JSwinConfig, _batch, _bf, _flip_aware, _port_model, _weights,
                             assert_anchored, jax_fusion_kernel)  # noqa: F401 (a fixture)
from test_torch_msda_sweep import (B, D, H, SHAPES, STARTS, _expanded, _gv_ref, _inputs, _pad_l,
                                   _pad_q, _rowtap_operands, _split_rows)

BF = torch.bfloat16
TAP_RTOL = 1e-3
Q_KERNELS = 100    # a decoder-style query set (Q != L), one query block of the TPU kernels


@pytest.fixture
def sweep_path(monkeypatch):
    """The JAX package's non-banded Pallas path (read at call time)."""
    monkeypatch.setenv("MSDA_BANDED", "0")


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def assert_live_close(port, ref, live, what):
    """max |port - ref| over the live taps within TAP_RTOL of max |ref| there."""
    p, r = np.asarray(port, np.float32)[live], np.asarray(ref, np.float32)[live]
    err, scale = float(np.abs(p - r).max()), float(np.abs(r).max())
    print(f"{what}: port-vs-JAX bf16 {err:.3e} of max|ref| {scale:.3e}")
    assert err <= TAP_RTOL * scale, (what, err, scale)


# ---------------------------------------------------------------- the kernels
@pytest.mark.parametrize("kernel", ["K6", "K7"])
def test_bf16_sweep_fwd_plain_matches_tpu_kernel(kernel):
    value, value_t, px, w = _rowtap_operands(Q_KERNELS, 2, sort=kernel == "K7")
    value, value_t = _bf(value), _bf(value_t)
    ranges = mp._rowtap_tile_ranges(jnp.asarray(px), jnp.asarray(w),
                                    px.shape[-1] // mp.QBLOCK).reshape(-1)
    call, tile = ((mp._msda_pallas_fwd_rowtap_call, mp.RT_TILE) if kernel == "K6"
                  else (mp._msda_pallas_fwd_rowtap_allq_call, mp.DEC_TILE))
    ref_b, ref_f = (call(_pad_l(value_t, tile).astype(dt), jnp.asarray(px), jnp.asarray(w),
                         ranges, tile) for dt in (jnp.bfloat16, jnp.float32))
    assert ref_b.dtype == jnp.bfloat16
    row, px_row = _split_rows(px)
    got = sw.sweep_fwd_plain(_t(value, BF), _t(row), _t(px_row), _t(w)).to(BF)
    assert_anchored(got, ref_b, ref_f, f"{kernel} out")


@pytest.mark.parametrize("kernel", ["K9", "K10"])
def test_bf16_sweep_bwd_plain_matches_tpu_kernel(kernel):
    Q = Q_KERNELS
    if kernel == "K9":
        value, value_t, locs_t, attn_t = _expanded(Q, 3)
        taps = [_pad_q(np.asarray(a), mp.QBLOCK) for a in mp._corner_indices_and_weights_t(
            jnp.asarray(locs_t), jnp.asarray(attn_t), SHAPES)]
        ranges = mp._tile_ranges(*map(jnp.asarray, taps), taps[1].shape[-1] // mp.QBLOCK)
        call, tile, plain = mp._msda_pallas_bwd_call, mp.BWD_TILE, sw.sweep_bwd_corner_plain
        port_taps = (_t(taps[0], torch.int32), _t(taps[1]))
        names = ("grad_value", "gw")
    else:
        value, value_t, px, w = _rowtap_operands(Q, 5, sort=True)
        taps = [px, w]
        ranges = mp._rowtap_tile_ranges(jnp.asarray(px), jnp.asarray(w),
                                        px.shape[-1] // mp.QBLOCK)
        call, tile, plain = mp._msda_rowtap_bwd_call, mp.RT_BWD_TILE, sw.sweep_bwd_rowtap_plain
        row, px_row = _split_rows(px)
        port_taps = (_t(row), _t(px_row), _t(w))
        names = ("grad_value", "gpx", "gw")
    w = taps[-1]
    value, value_t = _bf(value), _bf(value_t)
    g = _bf(np.random.RandomState(4).randn(B * H, w.shape[-1], D).astype(np.float32))
    ref_b, ref_f = ([np.asarray(x, np.float32) for x in call(
        _pad_l(value_t, tile).astype(dt), *map(jnp.asarray, taps), jnp.asarray(g, dt),
        ranges.reshape(-1))] for dt in (jnp.bfloat16, jnp.float32))
    got = plain(_t(value, BF), *port_taps, _t(g, BF))
    # the op casts grad_value to the value's dtype once (msda_pallas.py:1463, 1517)
    assert_anchored(got[0].to(BF), _bf(_gv_ref(ref_b[0])), _gv_ref(ref_f[0]),
                    f"{kernel} grad_value")
    live = w != 0   # a dead tap's gradient depends on the TPU sweep's ranges
    for name, port, jax_b in zip(names[1:], got[1:], ref_b[1:]):
        assert port.dtype == torch.float32
        assert_live_close(port.numpy(), jax_b, live, f"{kernel} {name}")


# ---------------------------------------------------------------- the module
SHAPES4 = ((8, 12), (4, 6), (2, 3), (1, 2))
L4 = sum(h * w for h, w in SHAPES4)
PROJS = ("value_proj", "sampling_offsets", "attention_weights", "output_proj")


def _module_params(C, Hm, rng):
    """A seeded flax parameter tree of MSDeformAttn (kernels (in, out)),
    rounded to bf16: the reference bias of the sampling offsets, kernels
    off the pixel lattice."""
    NL = P = 4
    out = {"value_proj": C, "sampling_offsets": Hm * NL * P * 2,
           "attention_weights": Hm * NL * P, "output_proj": C}
    params = {}
    for name, n in out.items():
        scale = 0.05 if name in ("sampling_offsets", "attention_weights") else C ** -0.5
        bias = (sampling_offsets_bias(Hm, NL, P) if name == "sampling_offsets"
                else 0.1 * rng.randn(n))
        params[name] = {"kernel": _bf(scale * rng.randn(C, n).astype(np.float32)),
                        "bias": _bf(np.asarray(bias, np.float32))}
    return params


def _jax_module_run(case, dt, impl="pallas"):
    """The JAX MSDeformAttn(impl=impl) forward and parameter gradients on
    `case` in dtype dt (read the path's switches as set now)."""
    jmod = JMSDeformAttn(case["C"], case["H"], 4, 4, impl=impl)
    p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), case["params"])

    def loss(p):
        out = jmod.apply({"params": p}, jnp.asarray(case["query"], dt),
                         jnp.asarray(case["value"], dt), jnp.asarray(case["refs"]), SHAPES4,
                         jnp.asarray(case["pad"]))
        return jnp.sum(out.astype(jnp.float32) * case["grad"]), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(p)
    return out, grads


@pytest.fixture(scope="module")
def module_case():
    """Encoder-style inputs (Q = L, 2-d reference points, a padding mask),
    bf16-rounded, and the JAX package's f32 forward and gradients on them:
    the anchor of both backwards (off the pixel lattice the corner and the
    row-tap backward give the f32 function's one gradient)."""
    rng = np.random.RandomState(22)
    Bm, C, Hm = 2, 32, 4
    case = dict(C=C, H=Hm, refs=rng.uniform(0.05, 0.95, (Bm, L4, 4, 2)).astype(np.float32),
                pad=np.zeros((Bm, L4), bool))
    case["pad"][1, 80:96] = True
    case["query"], case["value"], case["grad"] = (_bf(rng.randn(Bm, L4, C).astype(np.float32))
                                                  for _ in range(3))
    case["params"] = _module_params(C, Hm, rng)
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setenv("MSDA_BANDED", "0")
        mpatch.setattr(mp, "BWD_VARIANT", "corner")
        case["f32"] = _jax_module_run(case, jnp.float32)
    return case


@pytest.mark.parametrize("bwd", ["corner", "rowtap"])
def test_bf16_module_matches_jax_pallas_path(sweep_path, monkeypatch, module_case, bwd):
    case = module_case
    monkeypatch.setattr(mp, "BWD_VARIANT", bwd)
    out_b, grads_b = _jax_module_run(case, jnp.bfloat16)
    out_f, grads_f = case["f32"]
    assert out_b.dtype == jnp.bfloat16

    mod = MSDeformAttn(case["C"], case["H"], 4, 4, kernel="sweep", sweep_bwd=bwd)
    params = case["params"]
    mod.load_state_dict({f"{n}.{t}": _t(params[n]["kernel"].T if t == "weight" else
                                        params[n]["bias"])
                         for n in PROJS for t in ("weight", "bias")})
    mod.to(BF)
    out = mod(_t(case["query"], BF), _t(case["value"], BF), _t(case["refs"]), SHAPES4,
              torch.from_numpy(case["pad"]))
    assert out.dtype == BF
    out.backward(_t(case["grad"], BF))
    assert_anchored(out.detach(), out_b, out_f, f"{bwd} out")
    for n in PROJS:
        lin = getattr(mod, n)
        assert lin.weight.grad.dtype == BF
        assert_anchored(lin.weight.grad.T, grads_b[n]["kernel"], grads_f[n]["kernel"],
                        f"{bwd} {n}.weight grad")
        assert_anchored(lin.bias.grad, grads_b[n]["bias"], grads_f[n]["bias"],
                        f"{bwd} {n}.bias grad")


# ---------------------------------------------------------------- the nano model
def test_bf16_nano_forward_matches_jax_pallas_path(sweep_path, jax_fusion_kernel):
    """make_eval_step(compute_dtype=bf16) through msda_kernel="sweep" against
    the JAX package's on the Pallas path, on tests/test_torch_bf16.py's
    seeded nano weights."""
    sd = _weights()
    jmodel = JGroundingDINO(
        swin_cfg=JSwinConfig(**SWIN),
        bert_cfg=JBertConfig(**BERT, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0),
        msda_impl="pallas", **JAX_TOP)
    params = convert_groundingdino_checkpoint(
        sd, swin_depths=SWIN["depths"], out_indices=SWIN["out_indices"],
        num_feature_levels=JAX_TOP["num_feature_levels"], enc_layers=JAX_TOP["enc_layers"],
        dec_layers=JAX_TOP["dec_layers"], bert_layers=BERT["num_hidden_layers"])
    batch = _batch()
    inputs = {k: batch[k] for k in PORT_KEYS}
    # XLA's backend optimisation off: half the compile time, as
    # tests/test_torch_bf16.py compiles its JAX steps
    ref = {name: jax.jit(jmake_eval_step(jmodel, compute_dtype=dt)).lower(params, inputs)
           .compile({"xla_backend_optimization_level": 0})(params, inputs)
           for name, dt in (("bf16", jnp.bfloat16), ("f32", None))}
    model = _port_model({k: torch.from_numpy(v) for k, v in sd.items()}, JAX_TOP,
                        msda={"kernel": "sweep"})
    out = make_eval_step(model, compute_dtype="bfloat16")(batch)
    _flip_aware(out, ref["bf16"], ref["f32"], "sweep forward")


# ---------------------------------------------------------------- the CUDA path's plumbing
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


@pytest.mark.parametrize("Q,dec_fused,bwd", [(sum(h * w for h, w in SHAPES), False, "corner"),
                                             (173, True, "rowtap")],
                         ids=["Q=L-corner", "Q!=L-fused-rowtap"])
def test_bf16_function_dtypes(Q, dec_fused, bwd):
    """The sweep's ops in bf16: a bf16 output, the upstream gradient handed
    to K9/K10 in bf16 and contiguous, grad_value returned in bf16 and the
    tap gradients in f32 (read at the backward op, so that autograd's casts
    cannot hide a dtype), grad_locs / grad_attn in f32; against the plain
    forward under autograd on the same bf16 inputs."""
    value, locs, attn, grad = _inputs(Q, 7)
    v, g = _t(_bf(value), BF), _t(_bf(grad), BF)
    leaves = [t.clone().requires_grad_(True) for t in (v, _t(locs), _t(attn))]
    ref = sw.ms_deform_attn_sweep_plain(leaves[0], SHAPES, leaves[1], leaves[2])
    ref.backward(g)
    got = [t.clone().requires_grad_(True) for t in (v, _t(locs), _t(attn))]
    with Record() as rec:
        out = sw.ms_deform_attn_sweep(got[0], SHAPES, STARTS, got[1], got[2], bwd, dec_fused)
        out.backward(g)
    assert out.dtype == BF
    gv, gl, ga = (t.grad for t in got)
    assert (gv.dtype, gl.dtype, ga.dtype) == (BF, torch.float32, torch.float32)
    fwd = ("sweep_fwd_allq" if dec_fused else "sweep_fwd", BF, torch.float32, True, (BF,))
    bwd_call = (f"sweep_bwd_{bwd}", BF, BF, True,
                (BF, torch.float32) if bwd == "corner" else (BF, torch.float32, torch.float32))
    assert rec.calls == [fwd, bwd_call]
    torch.testing.assert_close(out, ref.detach())
    torch.testing.assert_close(gv, leaves[0].grad)   # one bf16 rounding of f32 sums each
    for got_g, want in ((gl, leaves[1].grad), (ga, leaves[2].grad)):
        torch.testing.assert_close(got_g, want, rtol=1e-4, atol=2e-4)


def test_bf16_runs_where_entries_exist():
    """A bf16 module returns bf16 through banded_point (K5 bf16), the sweep
    and the gather on the CPU, and K8's launcher no longer rejects a bf16
    value for its dtype: on a CPU tensor it refuses the device only."""
    C, Hm = 32, 4
    rng = np.random.RandomState(3)
    query = _t(rng.randn(1, 30, C).astype(np.float32), BF)
    value = _t(rng.randn(1, L4, C).astype(np.float32), BF)
    refs = _t(rng.uniform(0.1, 0.9, (1, 30, 4, 2)).astype(np.float32))
    for kernel in ("banded_point", "sweep", "gather"):
        out = MSDeformAttn(C, Hm, 4, 4, kernel=kernel).to(BF)(query, value, refs, SHAPES4)
        assert out.dtype == BF and torch.isfinite(out.float()).all(), kernel
    taps = torch.zeros(Hm, 4 * 4 * 4, 128)
    with pytest.raises(ValueError, match="unsupported device"):
        sw.sweep_fwd_corner(torch.zeros(1, L4, Hm, 32, dtype=BF), SHAPES4, taps.int(), taps)
    assert sw.sweep_fwd_corner.launches_bf16 == 0
