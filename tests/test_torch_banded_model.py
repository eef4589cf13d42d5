"""The per-point banded MSDA path of the port's model (msda_kernel =
"banded_point": K5 forward, K3 backward) against the JAX package's
`msda_impl="pallas"` banded path with MSDA_BANDED_MP=0 (`_msda_banded_kernel`
and its native backward, in interpret mode on the CPU).

  * MSDeformAttn(kernel="banded_point") against the JAX
    MSDeformAttn(impl="pallas"), whose `_transposed_path` keeps the nn.Dense
    parameter tree (models/deformable.py:165-167): one tree loads into both.
    2-d (encoder, Q == L) and 4-d (decoder, through
    `ms_deform_attn_banded_sorted`) reference points with a padding mask;
    forward and every parameter's gradient at 5e-4, as
    tests/test_torch_sweep_model.py holds the sweep.
  * The config key reaches every deformable attention.
The nano model on this path is tests/test_torch_banded_nano.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open_groundingdino_tpu.models.deformable import MSDeformAttn as JMSDeformAttn
from open_groundingdino_tpu_torch.config import SLConfig
from open_groundingdino_tpu_torch.models.deformable import MSDeformAttn
from open_groundingdino_tpu_torch.models.groundingdino import build_groundingdino
from test_torch_model import NANO_CFG
from test_torch_sweep_model import NL, P, PROJS, SHAPES, TOL, L


@pytest.fixture
def per_point(monkeypatch):
    """The JAX package's per-point banded forward (read at trace time)."""
    monkeypatch.setenv("MSDA_BANDED", "1")
    monkeypatch.setenv("MSDA_BANDED_MP", "0")


@pytest.mark.parametrize("ref_dim", [2, 4], ids=["encoder-2d-refs", "decoder-4d-refs"])
def test_module_matches_jax_banded_path(per_point, ref_dim):
    B, C, H = 2, 32, 4
    Q = L if ref_dim == 2 else 30
    rng = np.random.RandomState(20 + ref_dim)
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

    mod = MSDeformAttn(C, H, NL, P, kernel="banded_point")
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


def test_config_key_reaches_every_deformable_attention(tmp_path):
    import open_groundingdino_tpu_torch

    cfg = tmp_path / "cfg.py"
    cfg.write_text(NANO_CFG.format(base=f"{open_groundingdino_tpu_torch.__path__[0]}"
                                        "/config/cfg_base.py") + 'msda_kernel = "banded_point"\n')
    mods = [m for m in build_groundingdino(SLConfig.fromfile(str(cfg)), device="meta").modules()
            if isinstance(m, MSDeformAttn)]
    assert len(mods) == 4 and all(m.kernel == "banded_point" for m in mods)
