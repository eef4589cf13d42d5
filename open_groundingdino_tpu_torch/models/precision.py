"""The JAX package's dtype promotion on the port's modules.

With `compute_dtype = "bfloat16"` the training step casts every floating
parameter to bf16 and the images too (parallel/train_state.py), and the model
runs on what it is given, with the JAX package's promotions.  Elementwise
ops promote alike in both frameworks (bf16 with f32 gives f32), so a bf16
activation that meets an f32 mask bias or an f32 text feature turns f32 in
the port where it does in the JAX package.  Products differ: flax's Dense
and jnp.einsum promote a mixed pair to the wider type, where torch's
linear, matmul and einsum raise.  `Linear` and `einsum` promote as flax and
jnp do, so that each product runs where the JAX package runs it: in f32 on
bf16-rounded weights where its input is f32 (the decoder's FFN, the text
tower after its first attention).  `LayerNorm` and `GroupNorm` compute in
f32 and return the promoted type of input and parameters, as the JAX
package's LayerNorm (models/layers.py:36-49) and flax's normalizations do.

In float32 every cast here is a no-op: the f32 path is unchanged.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn


def promote(*ts: torch.Tensor):
    """The tensors cast to their promoted dtype (jnp.result_type's for
    float tensors)."""
    dt = functools.reduce(torch.promote_types, (t.dtype for t in ts))
    return [t.to(dt) for t in ts]


def einsum(eq: str, *ts: torch.Tensor) -> torch.Tensor:
    """torch.einsum on the promoted operands (jnp.einsum's promotion)."""
    return torch.einsum(eq, *promote(*ts))


class Linear(nn.Linear):
    """nn.Linear that promotes input, weight and bias as flax's Dense does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is None:
            x, w = promote(x, self.weight)
            return F.linear(x, w)
        return F.linear(*promote(x, self.weight, self.bias))


class LayerNorm(nn.LayerNorm):
    """f32 normalization, output in the promoted type of input and
    parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = functools.reduce(torch.promote_types, (x.dtype, self.weight.dtype, self.bias.dtype))
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(out)


class GroupNorm(nn.GroupNorm):
    """f32 normalization, output in the promoted type of input and
    parameters (flax's GroupNorm)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = functools.reduce(torch.promote_types, (x.dtype, self.weight.dtype, self.bias.dtype))
        return F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(),
                            self.eps).to(out)
