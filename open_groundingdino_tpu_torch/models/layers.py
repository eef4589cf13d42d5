"""Shared transformer building blocks (the port of the JAX package's
models/layers.py).

A MultiHeadAttention with torch.nn.MultiheadAttention's packed-QKV parameter
names, the GLIP-style bidirectional image<->text fusion attention (reference
fuse_modules.py:99-295) whose core is K2 (ops/fusion.py), the text-enhancer
layer (reference transformer_vanilla.py:72-123), the ReLU MLP head and the
contrastive token classifier (reference GroundingDINO/utils.py:171-273).
In training mode the fusion block applies stochastic depth (factors from
`drop_path_scale`, drawn from an explicit torch.Generator); the configs'
dropout rates are 0, and the port has no dropout.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fusion import fused_bi_attention
from ..parallel import dist
from ..utils.device import to_device_async
from .position_encoding import get_sine_pos_embed
from .precision import LayerNorm, Linear, einsum, promote

MASK_NEG = -1e9


class MultiHeadAttention(nn.Module):
    """torch.nn.MultiheadAttention-compatible parameters (in_proj_weight,
    in_proj_bias, out_proj).  q, k, v: (B, T, E).  attn_mask: bool (B, Tq, Tk)
    or (Tq, Tk), True = NOT allowed; key_padding_mask: (B, Tk) bool,
    True = pad."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)

    def init_weights_(self, g: torch.Generator) -> None:
        bound = (6.0 / (4 * self.embed_dim)) ** 0.5  # xavier_uniform on (3E, E)
        with torch.no_grad():
            self.in_proj_weight.uniform_(-bound, bound, generator=g)
            self.in_proj_bias.zero_()

    def forward(self, q, k, v, attn_mask=None, key_padding_mask=None):
        E, H = self.embed_dim, self.num_heads
        D = E // H
        B, Tq, _ = q.shape
        Tk = k.shape[1]
        w, b = self.in_proj_weight, self.in_proj_bias
        qp = F.linear(*promote(q, w[:E], b[:E])).view(B, Tq, H, D)
        kp = F.linear(*promote(k, w[E : 2 * E], b[E : 2 * E])).view(B, Tk, H, D)
        vp = F.linear(*promote(v, w[2 * E :], b[2 * E :])).view(B, Tk, H, D)

        logits = einsum("bqhd,bkhd->bhqk", qp * D ** -0.5, kp)
        if attn_mask is not None:
            bias = attn_mask.to(logits.dtype) * MASK_NEG
            logits = logits + (bias[None, None] if bias.dim() == 2 else bias[:, None])
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :], MASK_NEG)
        probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        out = einsum("bhqk,bkhd->bqhd", probs, vp).reshape(B, Tq, E)
        return self.out_proj(out)


class BiMultiHeadAttention(nn.Module):
    """Bidirectional image<->text cross-attention from one logits matrix
    (reference fuse_modules.py:99-248).  The core is `fused_bi_attention`:
    K2 on CUDA tensors, the literal clamped formulation on CPU tensors."""

    def __init__(self, v_dim: int, l_dim: int, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (embed_dim // num_heads) ** -0.5
        self.v_proj = Linear(v_dim, embed_dim)
        self.l_proj = Linear(l_dim, embed_dim)
        self.values_v_proj = Linear(v_dim, embed_dim)
        self.values_l_proj = Linear(l_dim, embed_dim)
        self.out_v_proj = Linear(embed_dim, v_dim)
        self.out_l_proj = Linear(embed_dim, l_dim)

    def forward(self, v, l, attention_mask_v=None, attention_mask_l=None):
        """v: (B, Nv, v_dim); l: (B, Nl, l_dim); masks (B, N) bool, True = pad."""
        B, Nv, _ = v.shape
        Nl = l.shape[1]
        if attention_mask_v is None:
            attention_mask_v = torch.zeros(B, Nv, dtype=torch.bool, device=v.device)
        if attention_mask_l is None:
            attention_mask_l = torch.zeros(B, Nl, dtype=torch.bool, device=l.device)
        # the kernels take one dtype, the image side's: under bf16 compute
        # the text side's f32 projections are rounded to bf16 for them
        q = self.v_proj(v) * self.scale
        out_v, out_l = fused_bi_attention(
            q, self.l_proj(l).to(q.dtype), self.values_v_proj(v),
            self.values_l_proj(l).to(q.dtype), attention_mask_v, attention_mask_l,
            self.num_heads,
        )
        return self.out_v_proj(out_v), self.out_l_proj(out_l)


def drop_path_scale(batch: int, rate: float, generator: torch.Generator,
                    device) -> torch.Tensor:
    """(batch,) per-sample stochastic-depth factors (the JAX package's
    models/layers.py:203-212 drop_path, reference fuse_modules.py DropPath):
    1/(1 - rate) with probability 1 - rate, else 0, drawn from `generator`
    (on its own device) and moved to `device` without a host sync.  Under a
    process group the draw covers the global batch and this rank keeps its
    rows (dist.rand_local_rows)."""
    keep = 1.0 - rate
    u = dist.rand_local_rows((batch,), generator, generator.device)
    return to_device_async((u < keep).float() / keep, device)


class BiAttentionBlock(nn.Module):
    """Pre-LN fusion block with layer-scale residuals and stochastic depth on
    both residual branches (reference fuse_modules.py:252-295).  The
    stochastic-depth factors arrive drawn (`drop_scales`, see
    `draw_drop_scales`), so that a checkpointed replay applies the same ones;
    None is the identity (inference, or rate 0)."""

    def __init__(self, v_dim: int, l_dim: int, embed_dim: int, num_heads: int,
                 init_values: float = 1e-4, droppath: float = 0.0):
        super().__init__()
        self.init_values, self.droppath = init_values, droppath
        self.layer_norm_v = LayerNorm(v_dim, eps=1e-5)
        self.layer_norm_l = LayerNorm(l_dim, eps=1e-5)
        self.attn = BiMultiHeadAttention(v_dim, l_dim, embed_dim, num_heads)
        self.gamma_v = nn.Parameter(torch.empty(v_dim))
        self.gamma_l = nn.Parameter(torch.empty(l_dim))

    def init_weights_(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.gamma_v.fill_(self.init_values)
            self.gamma_l.fill_(self.init_values)

    def draw_drop_scales(self, batch: int, generator: Optional[torch.Generator],
                         device) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """The block's (image, text) stochastic-depth factors for one training
        forward, two draws as the reference's two DropPath calls; None in
        eval mode or at rate 0."""
        if not self.training or self.droppath == 0.0:
            return None
        if generator is None:
            raise ValueError("fusion droppath in training mode needs a torch.Generator")
        return (drop_path_scale(batch, self.droppath, generator, device),
                drop_path_scale(batch, self.droppath, generator, device))

    def forward(self, v, l, attention_mask_v=None, attention_mask_l=None, drop_scales=None):
        vn = self.layer_norm_v(v)
        ln = self.layer_norm_l(l)
        dv, dl = self.attn(vn, ln, attention_mask_v, attention_mask_l)
        dv, dl = self.gamma_v * dv, self.gamma_l * dl
        if drop_scales is not None:
            dv = dv * drop_scales[0].view(-1, 1, 1).to(dv.dtype)
            dl = dl * drop_scales[1].view(-1, 1, 1).to(dl.dtype)
        return vn + dv, ln + dl


class TextEnhancerLayer(nn.Module):
    """Post-norm encoder layer over text tokens with sine pos embeds from
    position_ids and a block-diagonal attention mask (reference
    transformer_vanilla.py:72-123 + transformer.py:571-577)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int):
        super().__init__()
        self.d_model = d_model
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.norm2 = LayerNorm(d_model, eps=1e-5)

    def forward(self, text, text_self_attention_masks, position_ids):
        """text (B, T, C); text_self_attention_masks (B, T, T) bool,
        True = may attend; position_ids (B, T) int."""
        pos = get_sine_pos_embed(
            position_ids[..., None].float(), num_pos_feats=self.d_model,
            exchange_xy=False,
        ).to(text.dtype)
        q = text + pos
        attn_out = self.self_attn(q, q, text, attn_mask=~text_self_attention_masks)
        x = self.norm1(text + attn_out)
        h = self.linear2(F.relu(self.linear1(x)))
        return self.norm2(x + h)


class MLP(nn.Module):
    """ReLU MLP head (reference GroundingDINO/utils.py:171-185)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1]) for i in range(num_layers)
        )

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def contrastive_embed(
    queries: torch.Tensor,           # (B, Q, C)
    encoded_text: torch.Tensor,      # (B, T, C)
    text_token_mask: torch.Tensor,   # (B, T) bool, True = real token
    max_text_len: int = 256,
) -> torch.Tensor:
    """Token-level contrastive logits, padded to max_text_len with -inf on
    pad/overflow positions (reference GroundingDINO/utils.py:233-273)."""
    res = einsum("bqc,btc->bqt", queries, encoded_text)
    res = res.masked_fill(~text_token_mask[:, None, :], float("-inf"))
    T = res.shape[-1]
    if T < max_text_len:
        res = F.pad(res, (0, max_text_len - T), value=float("-inf"))
    return res[..., :max_text_len]


def default_init_(module: nn.Module, g: torch.Generator) -> None:
    """Seeded init of every parameter of `module`, roughly the JAX package's
    flax defaults: lecun-normal Linear/Conv kernels with zero biases,
    unit/zero norms, N(0, 0.02) embeddings; then each submodule's own
    `init_weights_(g)` where it defines one (the reference's special inits)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, fan_in ** -0.5, generator=g)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 0.02, generator=g)
    for m in module.modules():
        init = getattr(m, "init_weights_", None)
        if init is not None:
            init(g)

