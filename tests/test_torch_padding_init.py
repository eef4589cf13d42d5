"""Training from the zero-bias initialization on a padded batch: the JAX
package's make_train_step and the port's blow up alike.

With every Linear/Conv bias zero (flax's default init, and the port's
`init_weights_`), the zero-padded image region enters Swin as constant
tokens: the patch embedding, window attention and MLP all map zero to zero,
so each LayerNorm there sees zero variance and its backward multiplies the
gradient by 1/sqrt(eps) ~ 316.  The gradient reaches the padded region
through the windows and convolutions that straddle its border, and comes
back amplified layer after layer.

One train step in each package from the same zero-bias weights (the port's
`init_weights_`, carried into the JAX tree by the JAX package's own
reference-checkpoint converter; sampling offsets perturbed off the pixel
lattice and the text features scaled, as in test_torch_train_step.py), on
the same batch with and without a padded image:
  * the gradient norms of the two packages agree at rel 1e-4 in both runs;
  * with Swin-T's widths and depths (2, 2, 6, 2) on a 128-pixel canvas (the
    rest of the model at nano size), padding one image multiplies the
    gradient norm by more than 1e15.  At the flagship's 800x1216 canvas the
    same step overflows f32 (ROADMAP section 3).

The JAX side runs in a child process: a second full-model gradient program
in one process corrupts jax 0.9's executable cache (tests/conftest.py).  It
compiles with XLA's backend optimisation off: the step runs twice, so
compiling it is the cost, and the code generator's optimisation level
changes no arithmetic.
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

from open_groundingdino_tpu_torch.models.deformable import MSDeformAttn
from open_groundingdino_tpu_torch.parallel.train_state import make_train_step
from test_torch_train_step import (BERT, JAX_TOP, QN, SetCriterion, _batch, _port_model,
                                   _port_state)

SWIN_T = dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24), window_size=7,
              out_indices=(1, 2, 3))
CANVAS, VALID = 128, (96, 80)       # the padded image's valid (h, w)
LEAST_BLOW_UP = 1e15


def _batch_at(padded):
    batch = _batch()
    batch["images"] = np.random.RandomState(5).randint(0, 256, (2, CANVAS, CANVAS, 3)).astype(
        np.uint8)
    batch["image_sizes"] = np.asarray([[CANVAS, CANVAS], VALID if padded else [CANVAS] * 2],
                                      np.int32)
    return batch


def _zero_bias_state_dict():
    """The port's seeded zero-bias init at Swin-T widths and depths, the
    deformable offset and weight kernels perturbed off the pixel lattice,
    the text enhancer's last LayerNorm scaled by 0.3 (test_torch_train_step.py
    says why)."""
    model = _port_model(None, JAX_TOP, swin=SWIN_T)
    rng = np.random.RandomState(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MSDeformAttn):
                for lin in (m.sampling_offsets, m.attention_weights):
                    lin.weight.add_(torch.from_numpy(0.05 * rng.randn(*lin.weight.shape)).float())
        for t in model.transformer.encoder.text_layers[0].norm2.parameters():
            t.mul_(0.3)
    return model.state_dict()


def _jax_side(sd_path):
    """In the child: the port's weights in the JAX tree, and one
    make_train_step gradient norm per batch."""
    import jax

    from open_groundingdino_tpu.parallel.optim import make_optimizer as jmake_optimizer
    from open_groundingdino_tpu.utils.checkpoint import convert_groundingdino_checkpoint
    from test_torch_train_step import (OPT, JBertConfig, JGroundingDINO, JSetCriterion,
                                       JSwinConfig, JTrainState, jmake_train_step)

    model = JGroundingDINO(
        swin_cfg=JSwinConfig(**SWIN_T),
        bert_cfg=JBertConfig(**BERT, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0),
        msda_impl="xla", **JAX_TOP)
    params = convert_groundingdino_checkpoint(
        {k: v.numpy() for k, v in torch.load(sd_path).items()}, swin_depths=SWIN_T["depths"],
        out_indices=SWIN_T["out_indices"], num_feature_levels=JAX_TOP["num_feature_levels"],
        enc_layers=JAX_TOP["enc_layers"], dec_layers=JAX_TOP["dec_layers"],
        bert_layers=BERT["num_hidden_layers"])
    state = JTrainState.create(params, jmake_optimizer(params, **OPT))
    step = jax.jit(jmake_train_step(model, JSetCriterion(num_queries=QN)))
    return [float(step(state, _batch_at(padded))[1]["grad_norm"])
            for padded in (False, True)]


def test_padding_blows_up_zero_bias_gradients_in_both_packages(tmp_path):
    sd_path = str(tmp_path / "sd.pt")
    sd = _zero_bias_state_dict()
    torch.save(sd, sd_path)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(here), here, os.environ.get("PYTHONPATH", "")]),
        XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " --xla_backend_optimization_level=0"))
    child = subprocess.run([sys.executable, os.path.abspath(__file__), sd_path],
                           capture_output=True, text=True, env=env, timeout=900)
    assert child.returncode == 0, child.stderr[-4000:]
    jax_norms = json.loads(child.stdout.strip().splitlines()[-1])

    norms = []
    for padded, ref in zip((False, True), jax_norms):
        state = _port_state(_port_model(sd, JAX_TOP, swin=SWIN_T))
        state.optimizer.step = lambda grads, norm, finite: None
        got = make_train_step(SetCriterion(num_queries=QN))(state, _batch_at(padded))
        norms.append(got["grad_norm"])
        np.testing.assert_allclose(got["grad_norm"], ref, rtol=1e-4, err_msg=f"padded={padded}")
    print(f"gradient norms without / with padding: port {norms}, JAX {jax_norms}")
    assert np.isfinite(norms[0]) and norms[1] > LEAST_BLOW_UP * norms[0], (norms, jax_norms)


if __name__ == "__main__":
    print(json.dumps(_jax_side(sys.argv[1])))
