"""The port's bf16 mixed precision against the JAX package's, which is its
default (`compute_dtype = "bfloat16"`).

Every bound is anchored on the JAX package's own bf16 error: the port's
distance from the JAX package in bf16 stays within twice the distance of
the JAX package in bf16 from the JAX package in f32 on the same inputs,
plus 1e-3 (largest |difference| of each output, in its units).

  * the kernels' bf16 plain versions: K2/K4 (`fused_bi_attention_plain`,
    `fused_bi_attention_bwd_plain`) against the TPU fusion kernels in
    interpret mode on bf16 operands; K1/K3 (`ms_deform_attn_plain`,
    `ms_deform_attn_bwd_plain`) against `ms_deform_attn_xla` and its VJP in
    bf16, and grad_value against the banded TPU backward in interpret mode
    with its bf16 accumulation (MSDA_BWD_GV_BF16=1, the default);
  * the nano model (test_torch_train_step.py's, 1 + 1 layers): the dtypes of
    the towers' outputs, `pred_logits` and `pred_boxes` under bf16 equal the
    JAX package's, and the forward of `make_eval_step(compute_dtype=bf16)`
    agrees with the JAX package's, flip-aware;
  * one training step in bf16 (loss and gradients) against the JAX
    package's `make_train_step(compute_dtype=jnp.bfloat16)`, whose program
    compiles in child processes (tests/test_torch_padding_init.py says why).

The JAX package picks its fusion core by platform: the TPU kernel on the
TPU, the literal XLA formulation elsewhere.  Their outputs differ in dtype
under bf16 (the kernel returns the image side's dtype, the XLA formulation
promotes against the f32 text features), which sets the dtype of the whole
image stream after the first fusion layer.  The port follows the TPU: the
JAX reference here runs its fusion through the TPU kernel in interpret mode
(the platform query of models/layers.py answers "tpu"; nothing in the JAX
package changes).  Its deformable attention runs the XLA formulation with a
bf16 value, as `msda_impl="xla"` selects.
"""
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import open_groundingdino_tpu.models.layers as jlayers
from open_groundingdino_tpu.ops import msda_banded as jb
from open_groundingdino_tpu.ops.fusion_pallas import fused_bi_attention as jfused
from open_groundingdino_tpu.ops.msda import ms_deform_attn_xla
from open_groundingdino_tpu_torch.ops import fusion, msda
from test_torch_msda_banded import SHAPES, STARTS, _from_banded, _inputs, _kernel_layout
from test_torch_train_step import (BERT, JAX_TOP, OPT, QN, SWIN, JBertConfig, JGroundingDINO,
                                   JSetCriterion, JSwinConfig, SetCriterion, _batch,
                                   _port_model, _port_state)

BF = torch.bfloat16
SLACK = 1e-3
PORT_KEYS = ("images", "image_sizes", "input_ids", "text_token_mask", "position_ids",
             "text_self_attention_masks")


def _bf(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16, returned in f32: inputs both precisions share."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(BF).float().numpy()


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def assert_anchored(port, jax_bf16, jax_f32, what, mask=None):
    """max|port - jax_bf16| <= 2 max|jax_bf16 - jax_f32| + SLACK, over `mask`."""
    p, b, f = _np(port), _np(jax_bf16), _np(jax_f32)
    if mask is not None:
        p, b, f = p[mask], b[mask], f[mask]
    err, anchor = float(np.abs(p - b).max()), float(np.abs(b - f).max())
    print(f"{what}: port-vs-JAX bf16 {err:.3e}, JAX bf16-vs-f32 {anchor:.3e}")
    assert err <= 2 * anchor + SLACK, (what, err, anchor)


# ---------------------------------------------------------------- K2 / K4
def test_fusion_bf16_plain_matches_tpu_kernels():
    """K2's and K4's bf16 plain versions against fused_bi_attention (the
    TPU kernels, interpret mode) and its VJP on bf16 operands.  The padded
    text tokens' gradient is zero (nothing downstream reads them) and their
    text-side rows are compared only where live: the TPU kernel leaves them
    near-uniform (csrc/fusion_fwd.cu)."""
    B, Nv, Nl, H, Dh = 2, 150, 16, 2, 32
    E = H * Dh
    rng = np.random.RandomState(0)
    q, k, vv, vl = (_bf(rng.randn(B, n, E).astype(np.float32) * s)
                    for n, s in ((Nv, 0.3), (Nl, 0.3), (Nv, 1.0), (Nl, 1.0)))
    mask_v = np.zeros((B, Nv), bool)
    mask_v[1, 110:] = True
    mask_l = np.zeros((B, Nl), bool)
    mask_l[0, 12:] = mask_l[1, 9:] = True
    g_ov = _bf(rng.randn(B, Nv, E).astype(np.float32))
    g_ol = _bf(rng.randn(B, Nl, E).astype(np.float32) * ~mask_l[..., None])

    def jax_run(dt):
        args = [jnp.asarray(a, dt) for a in (q, k, vv, vl)]
        fn = lambda *a: jfused(*a, jnp.asarray(mask_v), jnp.asarray(mask_l), H)
        out, vjp = jax.vjp(fn, *args)
        return out, vjp((jnp.asarray(g_ov, dt), jnp.asarray(g_ol, dt)))

    (ov_b, ol_b), grads_b = jax_run(jnp.bfloat16)
    (ov_f, ol_f), grads_f = jax_run(jnp.float32)
    t = [torch.from_numpy(a).to(BF) for a in (q, k, vv, vl)]
    mv, ml = torch.from_numpy(mask_v), torch.from_numpy(mask_l)
    ov, ol = fusion.fused_bi_attention(*t, mv, ml, H)
    assert ov.dtype == ol.dtype == BF
    live_l = ~mask_l
    assert_anchored(ov, ov_b, ov_f, "K2 out_v")
    assert_anchored(ol, ol_b, ol_f, "K2 out_l", live_l)
    grads = fusion.fused_bi_attention_bwd_plain(
        *t, mv, ml, torch.from_numpy(g_ov).to(BF), torch.from_numpy(g_ol).to(BF), H)
    for name, g, gb, gf, m in zip(("gq", "gk", "gvv", "gvl"), grads, grads_b, grads_f,
                                  (None, live_l, None, live_l)):
        assert g.dtype == BF
        assert_anchored(g, gb, gf, f"K4 {name}", m)


# ---------------------------------------------------------------- K1 / K3
def test_msda_bf16_plain_matches_xla_and_banded(monkeypatch):
    """K1's and K3's bf16 plain versions against ms_deform_attn_xla's
    forward and VJP on a bf16 value and upstream gradient; grad_value also
    against the banded TPU backward (interpret mode), which accumulates it
    in bf16 under MSDA_BWD_GV_BF16=1."""
    monkeypatch.setenv("MSDA_BWD_GV_BF16", "1")
    value, locs, attn, grad = _inputs(150, 2)
    value, grad = _bf(value), _bf(grad)
    B, L, H, D = value.shape

    def xla_run(dt):
        fn = lambda v: ms_deform_attn_xla(v, SHAPES, jnp.asarray(locs), jnp.asarray(attn))
        out, vjp = jax.vjp(lambda v, lo, a: ms_deform_attn_xla(v, SHAPES, lo, a),
                           jnp.asarray(value, dt), jnp.asarray(locs), jnp.asarray(attn))
        return out, vjp(jnp.asarray(grad, dt))

    out_b, grads_b = xla_run(jnp.bfloat16)
    out_f, grads_f = xla_run(jnp.float32)
    tv, tl, ta, tg = (torch.from_numpy(a) for a in (value, locs, attn, grad))
    out = msda.ms_deform_attn(tv.to(BF), SHAPES, STARTS, tl, ta)
    assert out.dtype == BF
    assert_anchored(out, out_b, out_f, "K1 out")
    gv, gl, ga = msda.ms_deform_attn_bwd_plain(tv.to(BF), SHAPES, STARTS, tl, ta, tg.to(BF))
    assert gv.dtype == BF and gl.dtype == ga.dtype == torch.float32
    for name, g, gb, gf in zip(("grad_value", "grad_locs", "grad_attn"), (gv, gl, ga),
                               grads_b, grads_f):
        assert_anchored(g, gb, gf, f"K3 {name} (xla)")

    locs_t, attn_t = _kernel_layout(locs, attn)
    g_t = jnp.asarray(grad.reshape(B, -1, H, D).transpose(0, 2, 3, 1).reshape(B * H, D, -1))

    def banded_gv(dt):
        vals = []
        for (h, w), s in zip(SHAPES, STARTS):
            vl = value[:, s:s + h * w].reshape(B, h, w, H, D)
            vals.append(jnp.asarray(vl.transpose(0, 3, 1, 4, 2).reshape(B * H, h * D, w), dt))
        _, vjp = jax.vjp(lambda v: jb.ms_deform_attn_banded(
            v, SHAPES, jnp.asarray(locs_t), jnp.asarray(attn_t), 4), tuple(vals))
        return _from_banded([np.asarray(x, np.float32) for x in vjp(g_t.astype(dt))[0]])

    gv_banded_b = banded_gv(jnp.bfloat16)
    assert_anchored(gv, gv_banded_b, banded_gv(jnp.float32), "K3 grad_value (banded, bf16 sums)")


# ---------------------------------------------------------------- the nano model
class _TpuPlatform:
    platform = "tpu"


@pytest.fixture
def jax_fusion_kernel(monkeypatch):
    """The JAX package's fusion through its TPU kernel (interpret mode)."""
    proxy = types.SimpleNamespace(**{k: getattr(jax, k) for k in dir(jax) if not k.startswith("__")})
    proxy.devices = lambda *a: [_TpuPlatform()]
    monkeypatch.setattr(jlayers, "jax", proxy)


def _weights():
    """The port's seeded nano weights (1 + 1 layers), the sampling-offset
    and weight kernels perturbed off the pixel lattice and the text
    enhancer's last LayerNorm scaled by 0.3 (test_torch_train_step.py says
    why), as a reference-keyed state dict of numpy arrays."""
    rng = np.random.RandomState(1)
    sd = {}
    for name, t in _port_model(None, JAX_TOP).state_dict().items():
        x = t.numpy()
        if ("sampling_offsets" in name or "attention_weights" in name) and "weight" in name:
            x = (x + 0.05 * rng.randn(*x.shape)).astype(np.float32)
        if "text_layers.0.norm2" in name:
            x = x * np.float32(0.3)
        sd[name] = x
    return sd


def _jax_model_params(sd):
    from open_groundingdino_tpu.utils.checkpoint import convert_groundingdino_checkpoint

    model = JGroundingDINO(
        swin_cfg=JSwinConfig(**SWIN),
        bert_cfg=JBertConfig(**BERT, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0),
        msda_impl="xla", **JAX_TOP)
    params = convert_groundingdino_checkpoint(
        sd, swin_depths=SWIN["depths"], out_indices=SWIN["out_indices"],
        num_feature_levels=JAX_TOP["num_feature_levels"], enc_layers=JAX_TOP["enc_layers"],
        dec_layers=JAX_TOP["dec_layers"], bert_layers=BERT["num_hidden_layers"])
    return model, params


def _flip_aware(port, ref_b, ref_f, what):
    """Logits and boxes, flip-aware: at random init the two-stage top-k
    swaps near-tied proposals under any perturbation, bf16 rounding too
    (the JAX package's own bf16 and f32 runs swap a pair at this size).
    Fewer than 10% of the queries may flip between the port and the JAX
    package in bf16 (a box moving by more than 1e-2); the queries that
    flip in neither comparison are anchored, and the -inf pattern of the
    logits is equal."""
    lg = [_np(o["pred_logits"]) for o in (port, ref_b, ref_f)]
    bx = [_np(o["pred_boxes"]) for o in (port, ref_b, ref_f)]
    flip_port = np.abs(bx[0] - bx[1]).max(-1) > 1e-2
    flip_jax = np.abs(bx[1] - bx[2]).max(-1) > 1e-2
    print(f"{what}: {flip_port.sum()} of {flip_port.size} queries flip against JAX bf16, "
          f"{flip_jax.sum()} between JAX bf16 and f32")
    assert flip_port.mean() < 0.10, f"{what}: {flip_port.mean():.1%} of queries flipped"
    keep = ~(flip_port | flip_jax)
    assert np.array_equal(np.isfinite(lg[0]), np.isfinite(lg[1]))
    fin = np.isfinite(lg[1]) & keep[..., None]
    assert_anchored(lg[0], lg[1], lg[2], f"{what} pred_logits", fin)
    assert_anchored(bx[0], bx[1], bx[2], f"{what} pred_boxes", keep)


def test_bf16_forward_matches_jax_eval_step(jax_fusion_kernel):
    """make_eval_step(compute_dtype=bf16) against the JAX package's, and the
    dtypes along the way: each tower's output and the heads'."""
    from open_groundingdino_tpu.parallel.train_state import make_eval_step as jmake_eval_step
    from open_groundingdino_tpu_torch.parallel.train_state import make_eval_step

    sd = _weights()
    jmodel, params = _jax_model_params(sd)
    batch = _batch()
    inputs = {k: batch[k] for k in PORT_KEYS}
    ref = {name: jax.jit(jmake_eval_step(jmodel, compute_dtype=dt))(params, inputs)
           for name, dt in (("bf16", jnp.bfloat16), ("f32", None))}

    model = _port_model({k: torch.from_numpy(v) for k, v in sd.items()}, JAX_TOP)
    seen = {}
    for name, mod in (("bert", model.bert), ("backbone", model.backbone[0]),
                      ("transformer", model.transformer)):
        mod.register_forward_hook(lambda m, a, out, name=name: seen.__setitem__(name, out))
    out = make_eval_step(model, compute_dtype="bfloat16")(batch)
    # the JAX package's dtypes under bf16 (tests/test_torch_bf16.py's
    # reference flow): the text tower ends in f32 (its f32 mask bias
    # promotes it), Swin runs in bf16, the image stream stays bf16 through
    # the encoder (the fusion kernel returns the image side's dtype), the
    # heads read f32
    jax_dtypes = {k: str(v.dtype) for k, v in ref["bf16"].items()}
    assert {k: str(out[k].dtype).replace("torch.", "") for k in jax_dtypes} == jax_dtypes
    assert seen["bert"].dtype == torch.float32
    assert {f.dtype for f in seen["backbone"]} == {BF}
    assert seen["transformer"]["hs_enc"].dtype == BF           # the encoder memory's
    assert seen["transformer"]["memory_text"].dtype == torch.float32
    _flip_aware(out, ref["bf16"], ref["f32"], "forward")


# ---------------------------------------------------------------- one training step
def _jax_step(sd_path, dtype_name):
    """In a child: the JAX package's first train step (fusion through its
    TPU kernel), its loss and gradients in the port's names."""
    import optax

    from open_groundingdino_tpu.parallel.optim import make_optimizer as jmake_optimizer
    from open_groundingdino_tpu.parallel.train_state import TrainState as JTrainState
    from open_groundingdino_tpu.parallel.train_state import make_train_step as jmake_train_step
    from open_groundingdino_tpu_torch.utils.convert import state_dict_from_jax_params

    proxy = types.SimpleNamespace(**{k: getattr(jax, k) for k in dir(jax) if not k.startswith("__")})
    proxy.devices = lambda *a: [_TpuPlatform()]
    jlayers.jax = proxy
    sd = {k: v.numpy() for k, v in torch.load(sd_path).items()}
    model, params = _jax_model_params(sd)
    keep_grads = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))
    state = JTrainState.create(params, optax.chain(keep_grads, jmake_optimizer(params, **OPT)))
    dt = {"bfloat16": jnp.bfloat16, "float32": None}[dtype_name]
    step = jax.jit(jmake_train_step(model, JSetCriterion(num_queries=QN), compute_dtype=dt))
    state, metrics = step(state, _batch())
    grads = state_dict_from_jax_params(jax.device_get(state.opt_state[0]))
    return float(metrics["loss"]), {k: v.numpy().tolist() for k, v in grads.items()}


def test_bf16_train_step_matches_jax(tmp_path):
    """One bf16 step's loss and gradients against the JAX package's: the
    loss anchored, and the gradient of the model, each parameter group's
    stacked (||port - JAX bf16|| <= 2 ||JAX bf16 - JAX f32|| + 1e-3
    ||JAX f32||, over all parameters and over each top-level module)."""
    sd = _weights()
    sd_path = str(tmp_path / "sd.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, sd_path)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(here), here, os.environ.get("PYTHONPATH", "")]),
        XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " --xla_backend_optimization_level=0"))
    children = {name: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), sd_path, name, str(tmp_path / name)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for name in ("bfloat16", "float32")}
    ref = {}
    for name, child in children.items():
        _, err = child.communicate(timeout=900)
        assert child.returncode == 0, err[-4000:]
        with open(str(tmp_path / name)) as f:
            ref[name] = json.load(f)

    model = _port_model({k: torch.from_numpy(v) for k, v in sd.items()}, JAX_TOP,
                        use_checkpoint=True, use_transformer_ckpt=True)
    state = _port_state(model)
    captured = []
    state.optimizer.step = lambda grads, norm, finite: captured.append(grads)
    from open_groundingdino_tpu_torch.parallel.train_state import make_train_step

    loss = make_train_step(SetCriterion(num_queries=QN), compute_dtype="bfloat16")(
        state, _batch())["loss"]
    (loss_b, g_b), (loss_f, g_f) = ref["bfloat16"], ref["float32"]
    err, anchor = abs(loss - loss_b), abs(loss_b - loss_f)
    print(f"loss: port {loss}, JAX bf16 {loss_b}, JAX f32 {loss_f}")
    assert err <= 2 * anchor + SLACK * abs(loss_f), (loss, loss_b, loss_f)
    assert all(g.dtype == torch.float32 for g in captured[0])
    groups = {}
    for name, g in zip(state.optimizer.names, captured[0]):
        for key in ("all", name.split(".")[0]):
            groups.setdefault(key, []).append(
                (g.numpy().ravel(), np.ravel(g_b[name]), np.ravel(g_f[name])))
    for key, rows in groups.items():
        p, b, f = (np.concatenate([r[i] for r in rows]) for i in range(3))
        err, anchor = np.linalg.norm(p - b), np.linalg.norm(b - f)
        print(f"gradient of {key}: ||port - JAX bf16|| {err:.3e}, ||JAX bf16 - f32|| "
              f"{anchor:.3e}, ||JAX f32|| {np.linalg.norm(f):.3e}")
        assert err <= 2 * anchor + SLACK * np.linalg.norm(f), (key, err, anchor)


if __name__ == "__main__":
    loss, grads = _jax_step(sys.argv[1], sys.argv[2])
    with open(sys.argv[3], "w") as f:
        json.dump([loss, grads], f)
