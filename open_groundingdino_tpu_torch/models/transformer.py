"""Two-stage deformable transformer with image<->text fusion (the port of the
JAX package's models/transformer.py, raster order only; reference
models/GroundingDINO/transformer.py).

Encoder layer = fusion (K2) -> text enhancer -> multi-scale deformable
self-attention (K1, or the sweep K6) + FFN (reference transformer.py:550-598, 747-808).
Two-stage selection takes the top num_queries encoder tokens by max text
logit as anchor boxes (reference transformer.py:285-328).  Decoder layer =
self-attention -> text cross-attention -> deformable cross-attention (K1, or
the sweep K6/K7) ->
FFN, with per-layer box refinement on detached reference points (reference
transformer.py:672-736, 811-936).

The JAX package's TPU-only orderings (interleaved encoder queries with a
128-pad, injective-take VJPs, the scanned encoder, the decoder sort-once)
are exact reorderings and are not ported.

Training: with `use_checkpoint` the fusion blocks, and with
`use_transformer_ckpt` the deformable encoder layers, run under
torch.utils.checkpoint (non-reentrant), as the JAX package's nn.remat wraps
the same blocks (models/transformer.py:505-530).  With `remat_save_kernels`
(the default, as the JAX package's REMAT_SAVE_KERNELS=1) the checkpoint
keeps the forward kernels' outputs (ops/library.py
saving_checkpoint_contexts, the JAX policy `save_only_these_names(
"msda_out", "fusion_attn_out")`) and recomputes the rest of each block in
the backward, which replays no kernel; without it every op is recomputed, the
kernels too (K1 in each encoder layer, K2 in each fusion block).  The fusion
blocks' stochastic-depth factors are drawn before the checkpointed call and
passed in, so the recompute applies the same ones.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import library
from ..utils.device import device_constant
from ..utils.misc import inverse_sigmoid
from .deformable import MSDeformAttn
from .layers import (
    MLP,
    BiAttentionBlock,
    MultiHeadAttention,
    TextEnhancerLayer,
    contrastive_embed,
)
from .position_encoding import gen_sineembed_for_position
from .precision import LayerNorm, Linear

Shapes = Sequence[Tuple[int, int]]


def _lattice(H: int, W: int, offset: float) -> torch.Tensor:
    """(H, W, 2) f32 (x, y) of each token of an H x W level, plus offset."""
    gy, gx = np.meshgrid(np.arange(H, dtype=np.float32) + offset,
                         np.arange(W, dtype=np.float32) + offset, indexing="ij")
    return torch.from_numpy(np.stack([gx, gy], -1))


def encoder_reference_points(spatial_shapes: Shapes, valid_ratios: torch.Tensor) -> torch.Tensor:
    """(B, sum(HW), NL, 2) reference points for encoder self-attention
    (reference transformer.py:470-485)."""
    ref_list = []
    for lvl, (H, W) in enumerate(spatial_shapes):
        grid = device_constant(("enc_ref_grid", H, W), lambda: _lattice(H, W, 0.5).view(-1, 2),
                               valid_ratios.device)
        denom = valid_ratios[:, None, lvl, :] * device_constant(
            ("wh", H, W), lambda: torch.tensor([W, H], dtype=torch.float32), valid_ratios.device)
        ref_list.append(grid[None] / denom)
    ref = torch.cat(ref_list, dim=1)
    return ref[:, :, None, :] * valid_ratios[:, None, :, :]


def make_level_masks(image_sizes: torch.Tensor, spatial_shapes: Shapes,
                     strides: Sequence[int]) -> List[torch.Tensor]:
    """Per-level padding masks from valid image sizes (B, 2) [h, w]: row i of
    a stride-s map is valid iff i < ceil(valid_h / s).  (B, H, W) bool,
    True = pad."""
    masks = []
    for (H, W), s in zip(spatial_shapes, strides):
        vh = (image_sizes[:, 0] + s - 1) // s
        vw = (image_sizes[:, 1] + s - 1) // s
        rows = torch.arange(H, device=image_sizes.device)[None, :, None]
        cols = torch.arange(W, device=image_sizes.device)[None, None, :]
        masks.append(~((rows < vh[:, None, None]) & (cols < vw[:, None, None])))
    return masks


def compute_valid_ratios(masks: List[torch.Tensor]) -> torch.Tensor:
    """(B, NL, 2) [w_ratio, h_ratio] (reference transformer.py:200-207)."""
    ratios = []
    for m in masks:
        _, H, W = m.shape
        valid_h = (~m[:, :, 0]).sum(1).float()
        valid_w = (~m[:, 0, :]).sum(1).float()
        ratios.append(torch.stack([valid_w / W, valid_h / H], dim=-1))
    return torch.stack(ratios, dim=1)


def gen_encoder_output_proposals(memory: torch.Tensor, memory_padding_mask: torch.Tensor,
                                 spatial_shapes: Shapes):
    """Anchor-box proposals from the encoder token lattice (reference
    GroundingDINO/utils.py:56-116)."""
    B = memory.shape[0]
    proposals = []
    cur = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        mask_l = memory_padding_mask[:, cur : cur + H * W].view(B, H, W)
        valid_h = (~mask_l[:, :, 0]).sum(1).float()
        valid_w = (~mask_l[:, 0, :]).sum(1).float()
        grid = device_constant(("proposal_grid", H, W), lambda: _lattice(H, W, 0.0),
                               memory.device)
        scale = torch.stack([valid_w, valid_h], -1).view(B, 1, 1, 2)
        grid = (grid[None] + 0.5) / scale
        wh = torch.ones_like(grid) * (0.05 * (2.0 ** lvl))
        proposals.append(torch.cat([grid, wh], -1).view(B, -1, 4))
        cur += H * W
    output_proposals = torch.cat(proposals, dim=1)
    valid = ((output_proposals > 0.01) & (output_proposals < 0.99)).all(-1, keepdim=True)
    output_proposals = torch.log(output_proposals / (1 - output_proposals))
    output_proposals = output_proposals.masked_fill(memory_padding_mask[..., None], float("inf"))
    output_proposals = output_proposals.masked_fill(~valid, float("inf"))
    output_memory = memory.masked_fill(memory_padding_mask[..., None], 0.0)
    output_memory = output_memory.masked_fill(~valid, 0.0)
    return output_memory, output_proposals


def two_stage_select(output_memory, output_proposals, enc_delta, enc_logits, num_queries: int):
    """Rank tokens by max token logit, take the top num_queries (ties to the
    lower index, as jax.lax.top_k), gather unsigmoid refpoints (delta +
    proposal), sigmoid init proposals and token features."""
    topk_logits = enc_logits.max(dim=-1).values
    enc_coords_unsel = enc_delta + output_proposals
    order = torch.sort(topk_logits, dim=1, descending=True, stable=True).indices
    topk_idx = order[:, :num_queries]

    def gather(t):
        return torch.gather(t, 1, topk_idx[..., None].expand(-1, -1, t.shape[-1]))

    refpoint_undetach = gather(enc_coords_unsel)
    init_box_proposal = gather(output_proposals).sigmoid()
    tgt_undetach = gather(output_memory)
    return refpoint_undetach, init_box_proposal, tgt_undetach


class DeformableEncoderLayer(nn.Module):
    def __init__(self, d_model: int, d_ffn: int, n_levels: int, n_heads: int, n_points: int,
                 msda: Optional[Dict] = None):
        super().__init__()
        self.self_attn = MSDeformAttn(d_model, n_heads, n_levels, n_points, **(msda or {}))
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.linear1 = Linear(d_model, d_ffn)
        self.linear2 = Linear(d_ffn, d_model)
        self.norm2 = LayerNorm(d_model, eps=1e-5)

    def forward(self, src, pos, reference_points, spatial_shapes, key_padding_mask):
        src2 = self.self_attn(src + pos, src, reference_points, spatial_shapes, key_padding_mask)
        src = self.norm1(src + src2)
        h = self.linear2(F.relu(self.linear1(src)))
        return self.norm2(src + h)


class DeformableDecoderLayer(nn.Module):
    def __init__(self, d_model: int, d_ffn: int, n_levels: int, n_heads: int, n_points: int,
                 use_text_cross_attention: bool = True, msda: Optional[Dict] = None):
        super().__init__()
        self.cross_attn = MSDeformAttn(d_model, n_heads, n_levels, n_points, **(msda or {}))
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        if use_text_cross_attention:
            self.ca_text = MultiHeadAttention(d_model, n_heads)
            self.catext_norm = LayerNorm(d_model, eps=1e-5)
        else:
            self.ca_text = None
        self.self_attn = MultiHeadAttention(d_model, n_heads)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.linear1 = Linear(d_model, d_ffn)
        self.linear2 = Linear(d_ffn, d_model)
        self.norm3 = LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, query_pos, reference_points, memory, memory_key_padding_mask,
                spatial_shapes, memory_text, text_attention_mask):
        q = tgt + query_pos
        tgt = self.norm2(tgt + self.self_attn(q, q, tgt))
        if self.ca_text is not None:
            ca = self.ca_text(tgt + query_pos, memory_text, memory_text,
                              key_padding_mask=text_attention_mask)
            tgt = self.catext_norm(tgt + ca)
        ca2 = self.cross_attn(tgt + query_pos, memory, reference_points, spatial_shapes,
                              memory_key_padding_mask)
        tgt = self.norm1(tgt + ca2)
        # the FFN in f32 on the (possibly bf16) weights, as the JAX package
        # forces it (models/transformer.py:389-394; reference
        # transformer.py:871)
        t32 = tgt.float()
        h = self.linear2(F.relu(self.linear1(t32)))
        return self.norm3(t32 + h).to(tgt.dtype)


class TransformerEncoder(nn.Module):
    def __init__(self, d_model, nhead, num_layers, dim_feedforward, n_levels, n_points,
                 use_fusion_layer, use_text_enhancer, fusion_droppath=0.0,
                 use_checkpoint=False, use_transformer_ckpt=False, msda=None,
                 remat_save_kernels=True):
        super().__init__()
        self.use_checkpoint, self.use_transformer_ckpt = use_checkpoint, use_transformer_ckpt
        self.remat_save_kernels = remat_save_kernels
        self.layers = nn.ModuleList(
            DeformableEncoderLayer(d_model, dim_feedforward, n_levels, nhead, n_points, msda)
            for _ in range(num_layers)
        )
        self.fusion_layers = nn.ModuleList(
            BiAttentionBlock(d_model, d_model, dim_feedforward // 2, nhead // 2,
                             droppath=fusion_droppath)
            for _ in range(num_layers if use_fusion_layer else 0)
        )
        self.text_layers = nn.ModuleList(
            TextEnhancerLayer(d_model, nhead // 2, dim_feedforward // 2)
            for _ in range(num_layers if use_text_enhancer else 0)
        )

    def forward(self, src, pos, key_padding_mask, valid_ratios, spatial_shapes, text_dict,
                generator: Optional[torch.Generator] = None):
        memory_text = text_dict["encoded_text"]
        text_pad = ~text_dict["text_token_mask"]
        reference_points = encoder_reference_points(spatial_shapes, valid_ratios)
        remat = self.training and torch.is_grad_enabled()
        output = src
        for i, layer in enumerate(self.layers):
            if len(self.fusion_layers):
                fusion = self.fusion_layers[i]
                scales = fusion.draw_drop_scales(src.shape[0], generator, src.device)
                args = (output, memory_text, key_padding_mask, text_pad, scales)
                if remat and self.use_checkpoint:
                    output, memory_text = self._checkpoint(fusion, *args)
                else:
                    output, memory_text = fusion(*args)
            if len(self.text_layers):
                memory_text = self.text_layers[i](
                    memory_text, text_dict["text_self_attention_masks"],
                    text_dict["position_ids"])
            args = (output, pos, reference_points, spatial_shapes, key_padding_mask)
            if remat and self.use_transformer_ckpt:
                output = self._checkpoint(layer, *args)
            else:
                output = layer(*args)
        return output, memory_text

    def _checkpoint(self, block, *args):
        """block(*args) under non-reentrant checkpointing, with
        remat_save_kernels keeping the kernels' outputs."""
        if self.remat_save_kernels:
            return checkpoint(block, *args, use_reentrant=False,
                              context_fn=library.saving_checkpoint_contexts)
        return checkpoint(block, *args, use_reentrant=False)


class TransformerDecoder(nn.Module):
    """Decoder with iterative box refinement.  `bbox_embed` is the shared box
    head, registered by GroundingDINO (reference groundingdino.py:173-182)."""

    def __init__(self, d_model, nhead, num_layers, dim_feedforward, n_levels, n_points,
                 use_text_cross_attention, msda=None):
        super().__init__()
        self.layers = nn.ModuleList(
            DeformableDecoderLayer(d_model, dim_feedforward, n_levels, nhead, n_points,
                                   use_text_cross_attention, msda)
            for _ in range(num_layers)
        )
        self.norm = LayerNorm(d_model, eps=1e-5)
        # input: gen_sineembed_for_position of 4-d boxes, 128 feats per coordinate
        self.ref_point_head = MLP(4 * 128, d_model, d_model, 2)
        self.bbox_embed = None

    def forward(self, tgt, refpoints_unsig, memory, memory_mask, valid_ratios, spatial_shapes,
                memory_text, text_dict):
        """Returns (hs, outputs_coord, ref_points): per layer the normed
        queries, the sigmoid boxes bbox_embed(hs_i) + inverse_sigmoid(ref
        before layer i) (reference groundingdino.py:320-329), and the n+1
        reference boxes of the refinement chain."""
        text_pad = ~text_dict["text_token_mask"]
        reference_points = refpoints_unsig.sigmoid()
        ref_points = [reference_points]
        hs, outputs_coord = [], []
        output = tgt
        vr4 = torch.cat([valid_ratios, valid_ratios], -1)[:, None]   # (B, 1, NL, 4)
        for i, layer in enumerate(self.layers):
            ref_before = reference_points
            ref_input = ref_before[:, :, None] * vr4                   # (B, Q, NL, 4)
            query_sine = gen_sineembed_for_position(ref_input[:, :, 0, :]).to(output.dtype)
            query_pos = self.ref_point_head(query_sine)
            output = layer(output, query_pos, ref_input, memory, memory_mask, spatial_shapes,
                           memory_text, text_pad)
            bbox_embed = self.bbox_embed[i]
            # the box head and the norm on the output in f32 (the JAX
            # package's models/transformer.py:788-794)
            new_ref = (bbox_embed(output.float()) + inverse_sigmoid(ref_before)).sigmoid()
            reference_points = new_ref.detach()
            ref_points.append(new_ref)
            hs_i = self.norm(output.float())
            hs.append(hs_i)
            outputs_coord.append((bbox_embed(hs_i) + inverse_sigmoid(ref_points[i])).sigmoid())
        return hs, outputs_coord, ref_points


class Transformer(nn.Module):
    def __init__(self, d_model=256, nhead=8, num_queries=900, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, num_feature_levels=4,
                 enc_n_points=4, dec_n_points=4, use_text_enhancer=True,
                 use_fusion_layer=True, use_text_cross_attention=True, max_text_len=256,
                 fusion_droppath=0.0, use_checkpoint=False, use_transformer_ckpt=False,
                 msda: Optional[Dict] = None, remat_save_kernels: bool = True):
        """`msda`: MSDeformAttn's core-op keywords (kernel, sweep_bwd,
        dec_fused) for every deformable attention of the encoder and decoder.
        `remat_save_kernels`: the checkpointed encoder blocks keep the
        kernels' outputs (see the module docstring)."""
        super().__init__()
        self.d_model, self.num_queries, self.max_text_len = d_model, num_queries, max_text_len
        self.num_feature_levels = num_feature_levels
        self.level_embed = nn.Parameter(torch.empty(num_feature_levels, d_model))
        self.encoder = TransformerEncoder(
            d_model, nhead, num_encoder_layers, dim_feedforward, num_feature_levels,
            enc_n_points, use_fusion_layer, use_text_enhancer, fusion_droppath,
            use_checkpoint, use_transformer_ckpt, msda, remat_save_kernels)
        self.decoder = TransformerDecoder(
            d_model, nhead, num_decoder_layers, dim_feedforward, num_feature_levels,
            dec_n_points, use_text_cross_attention, msda)
        self.tgt_embed = nn.Embedding(num_queries, d_model)
        self.enc_output = Linear(d_model, d_model)
        self.enc_output_norm = LayerNorm(d_model, eps=1e-5)
        self.enc_out_bbox_embed = MLP(d_model, d_model, 4, 3)

    def init_weights_(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.level_embed.normal_(0.0, 1.0, generator=g)
            self.tgt_embed.weight.normal_(0.0, 1.0, generator=g)

    def forward(self, srcs, masks, pos_embeds, text_dict,
                generator: Optional[torch.Generator] = None) -> Dict:
        """srcs / pos_embeds: per level (B, H, W, C); masks: per level
        (B, H, W) bool, True = pad.  `generator` draws the fusion blocks'
        stochastic depth in training mode."""
        B = srcs[0].shape[0]
        C = self.d_model
        shapes = tuple((s.shape[1], s.shape[2]) for s in srcs)
        src_flat = torch.cat([s.reshape(B, -1, C) for s in srcs], dim=1)
        mask_flat = torch.cat([m.reshape(B, -1) for m in masks], dim=1)
        pos_flat = torch.cat(
            [(p + self.level_embed[l]).reshape(B, -1, C) for l, p in enumerate(pos_embeds)],
            dim=1,
        )
        valid_ratios = compute_valid_ratios(masks)

        memory, memory_text = self.encoder(
            src_flat, pos_flat, mask_flat, valid_ratios, shapes, text_dict, generator)

        output_memory, output_proposals = gen_encoder_output_proposals(memory, mask_flat, shapes)
        output_memory = self.enc_output_norm(self.enc_output(output_memory))
        enc_logits = contrastive_embed(output_memory, memory_text,
                                       text_dict["text_token_mask"], self.max_text_len)
        enc_delta = self.enc_out_bbox_embed(output_memory)
        refpoint_undetach, init_box_proposal, tgt_undetach = two_stage_select(
            output_memory, output_proposals, enc_delta, enc_logits, self.num_queries)

        tgt = self.tgt_embed.weight[None].expand(B, -1, -1).to(memory.dtype)
        hs, outputs_coord, references = self.decoder(
            tgt, refpoint_undetach.detach(), memory, mask_flat, valid_ratios, shapes,
            memory_text, text_dict)
        return {
            "hs": hs,
            "outputs_coord": outputs_coord,
            "references": references,
            "memory_text": memory_text,
            "hs_enc": tgt_undetach,
            "ref_enc": refpoint_undetach.sigmoid(),
            "init_box_proposal": init_box_proposal,
        }
