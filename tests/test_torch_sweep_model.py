"""The sweep MSDA path of the port's model against the JAX package's
`msda_impl="pallas"` path with MSDA_BANDED=0 (the Pallas sweep kernels in
interpret mode on the CPU).

  * MSDeformAttn(kernel="sweep") against the JAX MSDeformAttn(impl="pallas"),
    whose `_transposed_path` keeps the nn.Dense parameter tree
    (models/deformable.py:165-167): the tree of the xla-path init loads into
    both, unchanged.  2-d (encoder, Q == L) and 4-d (decoder, sorted) reference
    points with a padding mask; forward and every parameter's gradient at
    5e-4 (the row-tap forward's rounding, through the W scale, as
    tests/test_msda_pallas.py:84-89).
  * A nano GroundingDINO with msda_kernel="sweep" against the JAX nano model
    on that path (which runs its encoder in interleaved query order, an exact
    reordering the port does not take), flip-aware as tests/test_torch_model.py
    is, with the offset kernels perturbed off the pixel lattice.  The weights
    are the port's seeded init, carried into the JAX tree by the JAX
    package's own reference-checkpoint converter (no JAX init to compile).
  * The config keys reach every deformable attention, and an unknown value
    raises.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open_groundingdino_tpu.models.bert import BertConfig as JBertConfig
from open_groundingdino_tpu.models.deformable import MSDeformAttn as JMSDeformAttn
from open_groundingdino_tpu.models.groundingdino import GroundingDINO as JGroundingDINO
from open_groundingdino_tpu.models.swin import SwinConfig as JSwinConfig
from open_groundingdino_tpu.utils.checkpoint import convert_groundingdino_checkpoint
from open_groundingdino_tpu_torch.config import SLConfig
from open_groundingdino_tpu_torch.models.bert import BertConfig
from open_groundingdino_tpu_torch.models.deformable import MSDeformAttn
from open_groundingdino_tpu_torch.models.groundingdino import (
    GroundingDINO,
    build_groundingdino,
    init_weights_,
)
from open_groundingdino_tpu_torch.models.swin import SwinConfig
from test_torch_model import BERT, NANO_CFG, SWIN, TOP, _inputs

NANO = dict(TOP, enc_layers=1, dec_layers=1)   # one layer each: XLA's compile grows with depth

SHAPES = ((8, 12), (4, 6), (2, 3), (1, 2))
L = sum(h * w for h, w in SHAPES)
NL, P = 4, 4
TOL = dict(rtol=5e-4, atol=5e-4)
PROJS = ("value_proj", "sampling_offsets", "attention_weights", "output_proj")


@pytest.fixture
def sweep_path(monkeypatch):
    """The JAX package's non-banded Pallas path (read at call time)."""
    monkeypatch.setenv("MSDA_BANDED", "0")


@pytest.mark.parametrize("ref_dim", [2, 4], ids=["encoder-2d-refs", "decoder-4d-refs"])
def test_module_matches_jax_pallas_path(sweep_path, ref_dim):
    B, C, H = 2, 32, 4
    Q = L if ref_dim == 2 else 30
    rng = np.random.RandomState(10 + ref_dim)
    query = rng.randn(B, Q, C).astype(np.float32)
    value = rng.randn(B, L, C).astype(np.float32)
    if ref_dim == 2:
        refs = rng.uniform(0.05, 0.95, (B, Q, NL, 2)).astype(np.float32)
    else:
        refs = np.concatenate([rng.uniform(0.1, 0.9, (B, Q, NL, 2)),
                               rng.uniform(0.05, 0.4, (B, Q, NL, 2))], -1).astype(np.float32)
    pad = np.zeros((B, L), bool)
    pad[1, 80:96] = True
    grad = rng.randn(B, Q, C).astype(np.float32)
    args = [jnp.asarray(a) for a in (query, value, refs, pad)]

    jmod_x = JMSDeformAttn(C, H, NL, P, impl="xla")
    jmod_p = JMSDeformAttn(C, H, NL, P, impl="pallas")
    params = jax.device_get(jax.jit(jmod_x.init, static_argnums=4)(
        jax.random.PRNGKey(0), *args[:3], SHAPES, args[3])["params"])
    for name in ("sampling_offsets", "attention_weights"):
        k = params[name]["kernel"]
        params[name]["kernel"] = (k + 0.05 * rng.randn(*k.shape)).astype(np.float32)

    def loss(p):
        out = jmod_p.apply({"params": p}, args[0], args[1], args[2], SHAPES, args[3])
        return jnp.sum(out * grad), out

    (_, ref_out), ref_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)

    mod = MSDeformAttn(C, H, NL, P, kernel="sweep")
    mod.load_state_dict({f"{n}.{t}": torch.from_numpy(np.array(
        params[n]["kernel"].T if t == "weight" else params[n]["bias"]))
        for n in PROJS for t in ("weight", "bias")})
    out = mod(torch.from_numpy(query), torch.from_numpy(value), torch.from_numpy(refs), SHAPES,
              torch.from_numpy(pad))
    out.backward(torch.from_numpy(grad))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), **TOL)
    for n in PROJS:
        lin = getattr(mod, n)
        np.testing.assert_allclose(lin.weight.grad.numpy().T, np.asarray(ref_grads[n]["kernel"]),
                                   **TOL, err_msg=n)
        np.testing.assert_allclose(lin.bias.grad.numpy(), np.asarray(ref_grads[n]["bias"]),
                                   **TOL, err_msg=n)


def test_nano_forward_matches_jax_pallas_path(sweep_path):
    model = init_weights_(GroundingDINO(SwinConfig(**SWIN), BertConfig(**BERT), **NANO,
                                        msda={"kernel": "sweep"}), 0).eval()
    rng = np.random.RandomState(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MSDeformAttn):
                for lin in (m.sampling_offsets, m.attention_weights):
                    lin.weight.add_(torch.from_numpy(0.05 * rng.randn(*lin.weight.shape)).float())
    params = convert_groundingdino_checkpoint(
        {k: v.numpy() for k, v in model.state_dict().items()}, swin_depths=SWIN["depths"],
        out_indices=SWIN["out_indices"], num_feature_levels=NANO["num_feature_levels"],
        enc_layers=NANO["enc_layers"], dec_layers=NANO["dec_layers"],
        bert_layers=BERT["num_hidden_layers"])
    inputs = _inputs()
    jmodel = JGroundingDINO(
        swin_cfg=JSwinConfig(**SWIN),
        bert_cfg=JBertConfig(**BERT, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0),
        msda_impl="pallas", **NANO)
    out_j = jax.jit(jmodel.apply)({"params": params},
                                  **{k: jnp.asarray(v) for k, v in inputs.items()})
    with torch.no_grad():
        out_t = model(**{k: torch.from_numpy(v).long() if v.dtype == np.int32
                         else torch.from_numpy(v) for k, v in inputs.items()})
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
    np.testing.assert_allclose(out_t["interm_outputs"]["pred_boxes"].numpy(),
                               np.asarray(out_j["interm_outputs"]["pred_boxes"]), atol=1e-4)


def test_config_keys_reach_every_deformable_attention(tmp_path):
    import open_groundingdino_tpu_torch

    cfg = tmp_path / "cfg.py"
    cfg.write_text(NANO_CFG.format(base=f"{open_groundingdino_tpu_torch.__path__[0]}"
                                        "/config/cfg_base.py"))
    args = SLConfig.fromfile(str(cfg))
    assert (args.msda_kernel, args.msda_sweep_bwd, args.msda_dec_fused) == ("gather", "corner",
                                                                            False)
    args.merge_from_dict({"msda_kernel": "sweep", "msda_sweep_bwd": "rowtap",
                          "msda_dec_fused": True})
    mods = [m for m in build_groundingdino(args, device="meta").modules()
            if isinstance(m, MSDeformAttn)]
    assert len(mods) == 4
    assert all((m.kernel, m.sweep_bwd, m.dec_fused) == ("sweep", "rowtap", True) for m in mods)
    for key, bad in (("msda_kernel", "banded"), ("msda_sweep_bwd", "dense")):
        args.merge_from_dict({key: bad})
        with pytest.raises(ValueError, match=bad):
            build_groundingdino(args, device="meta")
        args.merge_from_dict({"msda_kernel": "sweep", "msda_sweep_bwd": "rowtap"})
