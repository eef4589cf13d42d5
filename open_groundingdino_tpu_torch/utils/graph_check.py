"""A traced training graph through the kernels' ops: one fusion block and one
deformable encoder layer on the gather path (K2 and K1 forward, K4 and K3
backward), compiled whole by torch.compile(fullgraph=True) through
AOTAutograd, against the same layers run eagerly.

`compile_check` compiles with the aot_eager backend's AOTAutograd and
compilers that record the forward and backward graphs and run them as they
are (aot_eager's own compilers do nothing else), so that the ogd_torch ops
each graph holds can be read.  fullgraph=True makes a graph break an error.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from ..models.layers import BiAttentionBlock, default_init_
from ..models.transformer import DeformableEncoderLayer, encoder_reference_points


class FusionEncoderLayer(nn.Module):
    """The encoder's order for one layer: the image<->text fusion block,
    then the deformable self-attention layer (gather path)."""

    def __init__(self, d_model: int, d_ffn: int, levels: int, heads: int, points: int,
                 fusion_embed: int, fusion_heads: int):
        super().__init__()
        self.fusion = BiAttentionBlock(d_model, d_model, fusion_embed, fusion_heads)
        self.layer = DeformableEncoderLayer(d_model, d_ffn, levels, heads, points)

    def forward(self, src, pos, reference_points, spatial_shapes: Sequence[Tuple[int, int]],
                mask_v, text, mask_l):
        src, text = self.fusion(src, text, mask_v, mask_l)
        return self.layer(src, pos, reference_points, spatial_shapes, mask_v), text


def build_layers(d_model: int, d_ffn: int, levels: int, heads: int, points: int,
                 fusion_embed: int, fusion_heads: int, device, seed: int = 0) -> FusionEncoderLayer:
    """The layers with seeded weights, the sampling offsets' and attention
    weights' kernels drawn too (zero at the reference init, which puts
    every sample on the pixel lattice) and the fusion's layer scale at 0.5
    (so that the fusion moves the encoder's input)."""
    g = torch.Generator().manual_seed(seed)
    layers = FusionEncoderLayer(d_model, d_ffn, levels, heads, points, fusion_embed,
                                fusion_heads)
    default_init_(layers, g)
    with torch.no_grad():
        attn = layers.layer.self_attn
        for lin, scale in ((attn.sampling_offsets, 0.05), (attn.attention_weights, 0.2)):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * scale)
        layers.fusion.gamma_v.fill_(0.5)
        layers.fusion.gamma_l.fill_(0.5)
    return layers.to(device)


def layer_inputs(B: int, spatial_shapes: Sequence[Tuple[int, int]], d_model: int, text_len: int,
                 live_text: int, device, seed: int = 1) -> Dict[str, object]:
    """Seeded inputs: image tokens of every level (the last image's last
    eighth padded), their positions and reference points, text tokens
    (`live_text` of `text_len` live)."""
    g = torch.Generator().manual_seed(seed)
    L = sum(h * w for h, w in spatial_shapes)
    mask_v = torch.zeros(B, L, dtype=torch.bool)
    mask_v[-1, L - L // 8:] = True
    ratios = torch.ones(B, len(spatial_shapes), 2)
    return dict(
        src=torch.randn(B, L, d_model, generator=g).to(device),
        pos=(0.1 * torch.randn(B, L, d_model, generator=g)).to(device),
        reference_points=encoder_reference_points(spatial_shapes, ratios).to(device),
        spatial_shapes=tuple(tuple(int(v) for v in hw) for hw in spatial_shapes),
        mask_v=mask_v.to(device),
        text=torch.randn(B, text_len, d_model, generator=g).to(device),
        mask_l=(torch.arange(text_len)[None] >= live_text).expand(B, text_len).to(device),
    )


def ogd_ops(gm: torch.fx.GraphModule) -> list:
    """The ogd_torch ops a graph calls, by name, in order."""
    return [str(n.target).split(".")[1] for n in gm.graph.nodes
            if n.op == "call_function" and str(n.target).startswith("ogd_torch.")]


def _loss_and_grads(layers: nn.Module, fn, inputs: Dict, weights) -> Tuple[torch.Tensor, list]:
    leaves = [inputs["src"], inputs["text"], *layers.parameters()]
    out_v, out_l = fn(**inputs)
    loss = (out_v * weights[0]).sum() + (out_l * weights[1]).sum()
    return loss.detach(), torch.autograd.grad(loss, leaves)


def compile_check(layers: nn.Module, inputs: Dict, before=None, after=None) -> Dict[str, object]:
    """The layers' forward and backward eagerly and compiled (fullgraph,
    AOTAutograd): the loss and every gradient (the inputs' and the
    parameters') of both, the largest relative difference of a gradient
    (|compiled - eager| over max |eager|), and the ogd_torch ops of the
    compiled forward and backward graphs.  `before` and `after` are called
    just before and just after the compiled run (after's result is
    "after"): to count the kernels' launches of that run, say."""
    from functorch.compile import make_boxed_func
    from torch._dynamo.backends.common import aot_autograd

    graphs = {}

    def recorder(kind):
        def compiler(gm, example_inputs):
            graphs[kind] = ogd_ops(gm)
            return make_boxed_func(gm.forward)
        return compiler

    inputs = dict(inputs)
    for key in ("src", "text"):
        inputs[key] = inputs[key].detach().requires_grad_(True)
    g = torch.Generator().manual_seed(2)
    out_v, out_l = layers(**inputs)
    weights = [torch.randn(o.shape, generator=g).to(o.device, o.dtype) for o in (out_v, out_l)]
    eager_loss, eager = _loss_and_grads(layers, layers, inputs, weights)
    torch._dynamo.reset()
    compiled = torch.compile(layers, fullgraph=True,
                             backend=aot_autograd(fw_compiler=recorder("forward"),
                                                  bw_compiler=recorder("backward")))
    if before is not None:
        before()
    loss, grads = _loss_and_grads(layers, compiled, inputs, weights)
    done = after() if after is not None else None
    rel = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
              for a, b in zip(grads, eager))
    return {"loss": float(loss), "eager_loss": float(eager_loss), "max_rel_grad_err": rel,
            "forward_ops": graphs.get("forward", []), "backward_ops": graphs.get("backward", []),
            "after": done, "grads": grads, "eager_grads": eager}
