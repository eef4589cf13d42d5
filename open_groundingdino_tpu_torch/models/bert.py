"""BERT text encoder (the port of the JAX package's models/bert.py).

Embeddings + encoder returning last_hidden_state, with the two inputs the
reference had to monkey-patch HuggingFace for (reference bertwarper.py:17-166):
a 3-D self-attention mask (block-diagonal between '.'-delimited phrases) and
explicit per-phrase position ids.  The pooler is omitted: the reference
freezes it and never reads it.  Module names follow HuggingFace BertModel, so
the text tower of a published checkpoint loads by key.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .precision import LayerNorm, Linear, einsum

_MASK_NEG = -1e9


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12


class BertEmbeddings(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings, c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.hidden_size)
        self.LayerNorm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, input_ids, token_type_ids, position_ids):
        x = (
            self.word_embeddings(input_ids)
            + self.position_embeddings(position_ids)
            + self.token_type_embeddings(token_type_ids)
        )
        return self.LayerNorm(x)


class BertSelfAttention(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.num_heads = c.num_attention_heads
        self.query = Linear(c.hidden_size, c.hidden_size)
        self.key = Linear(c.hidden_size, c.hidden_size)
        self.value = Linear(c.hidden_size, c.hidden_size)

    def forward(self, x, attn_bias):
        B, T, C = x.shape
        H = self.num_heads
        D = C // H
        q = self.query(x).view(B, T, H, D)
        k = self.key(x).view(B, T, H, D)
        v = self.value(x).view(B, T, H, D)
        scores = torch.einsum("bfhd,bthd->bhft", q, k) / D ** 0.5 + attn_bias
        probs = torch.softmax(scores, dim=-1)
        return einsum("bhft,bthd->bfhd", probs, v).reshape(B, T, C)


class BertDenseNorm(nn.Module):
    """dense -> residual add -> LayerNorm (HF BertSelfOutput / BertOutput)."""

    def __init__(self, d_in: int, d_out: int, eps: float):
        super().__init__()
        self.dense = Linear(d_in, d_out)
        self.LayerNorm = LayerNorm(d_out, eps=eps)

    def forward(self, h, residual):
        return self.LayerNorm(residual + self.dense(h))


class BertAttention(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(c)
        self.output = BertDenseNorm(c.hidden_size, c.hidden_size, c.layer_norm_eps)


class BertIntermediate(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.dense = Linear(c.hidden_size, c.intermediate_size)


class BertLayer(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.attention = BertAttention(c)
        self.intermediate = BertIntermediate(c)
        self.output = BertDenseNorm(c.intermediate_size, c.hidden_size, c.layer_norm_eps)

    def forward(self, x, attn_bias):
        x = self.attention.output(self.attention.self(x, attn_bias), x)
        return self.output(F.gelu(self.intermediate.dense(x)), x)


class BertEncoder(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(c) for _ in range(c.num_hidden_layers))


class BertModel(nn.Module):
    """Returns last_hidden_state (B, T, hidden)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)

    def forward(self, input_ids, attention_mask, position_ids, token_type_ids=None):
        """attention_mask (B, T) or (B, T, T) bool, True = attend."""
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if attention_mask.dim() == 2:
            attention_mask = attention_mask[:, None, :]
        elif attention_mask.dim() != 3:
            raise ValueError(f"attention_mask must be 2-D or 3-D, got {attention_mask.dim()}-D")
        bias = ((1.0 - attention_mask.float()) * _MASK_NEG)[:, None]   # (B, 1, F|1, T)
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x
