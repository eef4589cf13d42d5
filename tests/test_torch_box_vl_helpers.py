"""The reference helpers the JAX package keeps beside the training path,
ported: `ciou_loss` and `diou_loss` (utils/box_ops.py) against the JAX
package's on seeded raw box parameters, values at rel 1e-6 and gradients
(autograd against jax.grad of the summed loss) at rel 1e-5, plus 1e-5 of
the largest element for the elements near zero; and
`build_captions_and_token_span` (data/vl_utils.py) exactly, with
force_lowercase both ways."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open_groundingdino_tpu.data.vl_utils import build_captions_and_token_span as jbuild
from open_groundingdino_tpu.utils import box_ops as jbox_ops
from open_groundingdino_tpu_torch.data.vl_utils import build_captions_and_token_span
from open_groundingdino_tpu_torch.utils import box_ops


def _raw_boxes(seed, n=64):
    """Raw (pre-sigmoid) box parameters: centres spread so that pairs
    overlap a lot (CIoU's alpha term live), a little and not at all."""
    rng = np.random.RandomState(seed)
    b1 = rng.randn(n, 4).astype(np.float32)
    b2 = (b1 + rng.randn(n, 4) * np.linspace(0.01, 3.0, n)[:, None]).astype(np.float32)
    return b1, b2


@pytest.mark.parametrize("name", ["ciou_loss", "diou_loss"])
def test_box_losses_match_jax(name):
    ours, ref = getattr(box_ops, name), getattr(jbox_ops, name)
    b1, b2 = _raw_boxes(0)
    t1, t2 = torch.from_numpy(b1).requires_grad_(), torch.from_numpy(b2).requires_grad_()
    loss = ours(t1, t2)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(ref(b1, b2)), rtol=1e-6,
                               atol=1e-7)
    loss.sum().backward()
    g1, g2 = jax.grad(lambda a, b: jnp.sum(ref(a, b)), argnums=(0, 1))(b1, b2)
    for got, want in ((t1.grad, g1), (t2.grad, g2)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))
    if name == "ciou_loss":   # the alpha term was live on some pairs
        iou = box_ops._sigmoid_boxes(t1, t2)[0]
        assert bool((iou > 0.5).any()) and bool((iou <= 0.5).any())


@pytest.mark.parametrize("force_lowercase", [True, False])
def test_build_captions_and_token_span_matches_jax(force_lowercase):
    cats = ["Cat", "traffic Light", "dog", "Sofa Bed", "A"]
    assert build_captions_and_token_span(cats, force_lowercase) == jbuild(cats, force_lowercase)
    caption, spans = build_captions_and_token_span(cats, force_lowercase)
    for name, [(beg, end)] in spans.items():
        assert caption[beg:end] == name
    assert build_captions_and_token_span([], force_lowercase) == jbuild([], force_lowercase)
