"""BERT text encoder (the port of the JAX package's models/bert.py).

Embeddings + encoder returning last_hidden_state, with the two inputs the
reference had to monkey-patch HuggingFace for (reference bertwarper.py:17-166):
a 3-D self-attention mask (block-diagonal between '.'-delimited phrases) and
explicit per-phrase position ids.  The pooler is omitted: the reference
freezes it and never reads it.  Module names follow HuggingFace BertModel, so
the text tower of a published checkpoint loads by key.  The same stack serves
roberta-base's geometry (vocab 50265, 514 positions, one token type): with the
position ids passed explicitly the two encoders are one architecture.

Dropout (the config's text_dropout, as the JAX package's BertModel applies it
with deterministic=False): inverted dropout on the embeddings, the attention
probabilities, the attention output and the FFN output, in training mode
only.  Its masks come from a generator on the tokens' device seeded by one draw
from the generator the forward is given (the train step's), never from the
global RNG; the text tower is not recomputed under checkpointing, so each
mask is drawn once a step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import dist
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
    # the JAX package's BertConfig defaults to 0.1; build_groundingdino sets
    # both from the config's text_dropout (0.0 in every config)
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.0


def device_generator(generator: torch.Generator, device) -> torch.Generator:
    """A generator on `device` seeded by one draw from `generator` (on its
    own device): the forward's dropout masks are drawn where the tokens are,
    and the same step generator state gives the same masks."""
    seed = torch.randint(0, 2 ** 62, (), generator=generator, device=generator.device)
    return torch.Generator(device=device).manual_seed(int(seed))


class TextDropout(nn.Module):
    """Inverted dropout (flax nn.Dropout): in training mode each element is
    kept with probability 1 - p and scaled by 1/(1 - p), else zeroed, its
    mask drawn from `generator` (under a process group for the global batch,
    this rank keeping its rows: dist.rand_local_rows); the identity in eval
    mode or at p = 0."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.p == 0.0:
            return x
        keep = dist.rand_local_rows(x.shape, generator, x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), 0.0)


class BertEmbeddings(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings, c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.hidden_size)
        self.LayerNorm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.dropout = TextDropout(c.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids, position_ids, generator=None):
        x = (
            self.word_embeddings(input_ids)
            + self.position_embeddings(position_ids)
            + self.token_type_embeddings(token_type_ids)
        )
        return self.dropout(self.LayerNorm(x), generator)


class BertSelfAttention(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.num_heads = c.num_attention_heads
        self.query = Linear(c.hidden_size, c.hidden_size)
        self.key = Linear(c.hidden_size, c.hidden_size)
        self.value = Linear(c.hidden_size, c.hidden_size)
        self.dropout = TextDropout(c.attention_probs_dropout_prob)

    def forward(self, x, attn_bias, generator=None):
        B, T, C = x.shape
        H = self.num_heads
        D = C // H
        q = self.query(x).view(B, T, H, D)
        k = self.key(x).view(B, T, H, D)
        v = self.value(x).view(B, T, H, D)
        scores = torch.einsum("bfhd,bthd->bhft", q, k) / D ** 0.5 + attn_bias
        probs = self.dropout(torch.softmax(scores, dim=-1), generator)
        return einsum("bhft,bthd->bfhd", probs, v).reshape(B, T, C)


class BertDenseNorm(nn.Module):
    """dense -> dropout -> residual add -> LayerNorm (HF BertSelfOutput /
    BertOutput)."""

    def __init__(self, d_in: int, d_out: int, eps: float, dropout: float = 0.0):
        super().__init__()
        self.dense = Linear(d_in, d_out)
        self.LayerNorm = LayerNorm(d_out, eps=eps)
        self.dropout = TextDropout(dropout)

    def forward(self, h, residual, generator=None):
        return self.LayerNorm(residual + self.dropout(self.dense(h), generator))


class BertAttention(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(c)
        self.output = BertDenseNorm(c.hidden_size, c.hidden_size, c.layer_norm_eps,
                                    c.hidden_dropout_prob)


class BertIntermediate(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.dense = Linear(c.hidden_size, c.intermediate_size)


class BertLayer(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.attention = BertAttention(c)
        self.intermediate = BertIntermediate(c)
        self.output = BertDenseNorm(c.intermediate_size, c.hidden_size, c.layer_norm_eps,
                                    c.hidden_dropout_prob)

    def forward(self, x, attn_bias, generator=None):
        x = self.attention.output(self.attention.self(x, attn_bias, generator), x, generator)
        return self.output(F.gelu(self.intermediate.dense(x)), x, generator)


class BertEncoder(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(c) for _ in range(c.num_hidden_layers))


class BertModel(nn.Module):
    """Returns last_hidden_state (B, T, hidden)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)

    def forward(self, input_ids, attention_mask, position_ids, token_type_ids=None,
                generator: Optional[torch.Generator] = None):
        """attention_mask (B, T) or (B, T, T) bool, True = attend.  In
        training mode with a dropout rate above 0, `generator` seeds the
        forward's dropout masks (device_generator)."""
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if attention_mask.dim() == 2:
            attention_mask = attention_mask[:, None, :]
        elif attention_mask.dim() != 3:
            raise ValueError(f"attention_mask must be 2-D or 3-D, got {attention_mask.dim()}-D")
        bias = ((1.0 - attention_mask.float()) * _MASK_NEG)[:, None]   # (B, 1, F|1, T)
        g = None
        if self.training and (self.cfg.hidden_dropout_prob > 0.0
                              or self.cfg.attention_probs_dropout_prob > 0.0):
            if generator is None:
                raise ValueError("text dropout in training mode needs a torch.Generator")
            g = device_generator(generator, input_ids.device)
        x = self.embeddings(input_ids, token_type_ids, position_ids, g)
        for layer in self.encoder.layer:
            x = layer(x, bias, g)
        return x
