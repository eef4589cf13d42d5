"""The port's Swin backbone against the JAX package's, on the same weights
(JAX init -> swin_state_dict_from_jax_params -> load_state_dict(strict=True)).
The nano model of tests/test_torch_model.py has one block per stage, so it
never shifts its windows; this file covers shifted and padded windows."""
import numpy as np
import torch

import jax

from open_groundingdino_tpu.models.swin import SwinConfig as JSwinConfig
from open_groundingdino_tpu.models.swin import SwinTransformer as JSwinTransformer
from open_groundingdino_tpu_torch.models.swin import SwinConfig, SwinTransformer
from open_groundingdino_tpu_torch.utils.convert import swin_state_dict_from_jax_params

IMG_H, IMG_W = 64, 96


def test_swin_shifted_padded_windows_match_jax():
    """Swin with two blocks per stage (shifted windows) and window 7 on a
    16x24-token map: every stage pads its windows, as the flagship's 200x304
    map does."""
    cfg = dict(embed_dim=8, depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4), window_size=7,
               out_indices=(1, 2, 3))
    images = np.random.RandomState(2).randn(1, IMG_H, IMG_W, 3).astype(np.float32)
    jswin = JSwinTransformer(JSwinConfig(**cfg))
    params = jax.device_get(jax.jit(jswin.init)(jax.random.PRNGKey(3), images)["params"])
    ref = jax.jit(lambda p, x: jswin.apply({"params": p}, x))(params, images)
    swin = SwinTransformer(SwinConfig(**cfg))
    swin.load_state_dict(swin_state_dict_from_jax_params(params), strict=True)
    with torch.no_grad():
        outs = swin(torch.from_numpy(images))
    assert len(outs) == len(ref) == 3
    for out, r in zip(outs, ref):
        np.testing.assert_allclose(out.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)
