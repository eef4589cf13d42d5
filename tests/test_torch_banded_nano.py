"""A nano GroundingDINO with msda_kernel="banded_point" (K5 forward, K3
backward) against the JAX nano model on its banded path with
MSDA_BANDED_MP=0 (`_msda_banded_kernel` in interpret mode; its encoder in
interleaved query order and its decoder sorted once: exact reorderings the
port does not take), flip-aware as tests/test_torch_model.py is, with the
offset kernels perturbed off the pixel lattice.  The weights are the port's
seeded init, carried into the JAX tree by the JAX package's checkpoint
converter.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from open_groundingdino_tpu.models.bert import BertConfig as JBertConfig
from open_groundingdino_tpu.models.groundingdino import GroundingDINO as JGroundingDINO
from open_groundingdino_tpu.models.swin import SwinConfig as JSwinConfig
from open_groundingdino_tpu.utils.checkpoint import convert_groundingdino_checkpoint
from open_groundingdino_tpu_torch.models.bert import BertConfig
from open_groundingdino_tpu_torch.models.deformable import MSDeformAttn
from open_groundingdino_tpu_torch.models.groundingdino import GroundingDINO, init_weights_
from open_groundingdino_tpu_torch.models.swin import SwinConfig
from test_torch_banded_model import per_point  # noqa: F401  (fixture)
from test_torch_model import BERT, SWIN, _inputs
from test_torch_sweep_model import NANO


def test_nano_forward_matches_jax_banded_path(per_point):
    model = init_weights_(GroundingDINO(SwinConfig(**SWIN), BertConfig(**BERT), **NANO,
                                        msda={"kernel": "banded_point"}), 0).eval()
    rng = np.random.RandomState(2)
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
