"""GroundingDINO top-level model (the port of the JAX package's
models/groundingdino.py; reference models/GroundingDINO/groundingdino.py:55-402).

BERT-encode the caption with sub-sentence masks, project it to d_model
(feat_map), run the image backbone (Swin, or a frozen-BN ResNet when the
config names one), project its levels (1x1 conv + GroupNorm, plus an extra
stride-2 level), run the two-stage deformable transformer with image<->text
fusion, and read out contrastive token logits and refined boxes.

Inputs (the JAX package's contract):
  images         (B, Hb, Wb, 3) float   bucket-padded, ImageNet-normalized
  image_sizes    (B, 2) int             valid (h, w) before padding
  input_ids      (B, T) int             T = max_text_len
  text_token_mask(B, T) bool            True = real token
  position_ids   (B, T) int             per-phrase positions
  text_self_attention_masks (B, T, T) bool  block-diagonal, True = attend

Parameter names are the reference state-dict keys
(open_groundingdino_tpu/config/manifests/swint_keys.json, swinb_keys.json and
resnet50_keys.json list them): `backbone.0.*` for Swin, `backbone.0.body.*`
for ResNet; the shared decoder box head is registered under every alias the
reference has.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn

from .bert import BertConfig, BertModel
from .layers import MLP, contrastive_embed, default_init_
from .position_encoding import position_embedding_sine_hw
from .precision import GroupNorm, Linear
from .registry import MODULE_BUILD_FUNCS
from .resnet import ResNet, ResNetConfig
from .swin import SwinConfig, SwinTransformer
from .transformer import Transformer, make_level_masks


class GroundingDINO(nn.Module):
    def __init__(self, backbone_cfg: Union[SwinConfig, ResNetConfig],
                 bert_cfg: BertConfig = BertConfig(),
                 hidden_dim: int = 256, num_queries: int = 900, nheads: int = 8,
                 num_feature_levels: int = 4, enc_layers: int = 6, dec_layers: int = 6,
                 dim_feedforward: int = 2048, enc_n_points: int = 4, dec_n_points: int = 4,
                 max_text_len: int = 256, pe_temperature_h: float = 20.0,
                 pe_temperature_w: float = 20.0, use_text_enhancer: bool = True,
                 use_fusion_layer: bool = True, use_text_cross_attention: bool = True,
                 aux_loss: bool = True, fusion_droppath: float = 0.0,
                 use_checkpoint: bool = False, use_transformer_ckpt: bool = False,
                 msda: Optional[Dict] = None, remat_save_kernels: bool = True):
        """`backbone_cfg`: a SwinConfig or a ResNetConfig, which picks the
        image backbone.  `msda`: the deformable attentions' core-op keywords
        (MSDeformAttn's kernel, sweep_bwd, dec_fused); None keeps the gather
        kernels."""
        super().__init__()
        self.backbone_cfg = backbone_cfg
        self.hidden_dim, self.num_feature_levels = hidden_dim, num_feature_levels
        self.max_text_len, self.aux_loss = max_text_len, aux_loss
        self.pe_temperature_h, self.pe_temperature_w = pe_temperature_h, pe_temperature_w
        C = hidden_dim

        self.bert = BertModel(bert_cfg)
        self.feat_map = Linear(bert_cfg.hidden_size, C)
        backbone_cls = ResNet if isinstance(backbone_cfg, ResNetConfig) else SwinTransformer
        self.backbone = nn.ModuleList([backbone_cls(backbone_cfg)])
        feat_dims = [backbone_cfg.num_features[i] for i in backbone_cfg.out_indices]
        projs = [nn.Sequential(nn.Conv2d(d, C, 1), GroupNorm(32, C, eps=1e-5))
                 for d in feat_dims]
        in_dim = feat_dims[-1]
        for _ in range(len(feat_dims), num_feature_levels):
            projs.append(nn.Sequential(nn.Conv2d(in_dim, C, 3, stride=2, padding=1),
                                       GroupNorm(32, C, eps=1e-5)))
            in_dim = C
        self.input_proj = nn.ModuleList(projs)

        # one box head shared by every decoder layer and the prediction heads,
        # under both reference aliases (bbox_embed.{i} and
        # transformer.decoder.bbox_embed.{i})
        box_head = MLP(C, C, 4, 3)
        self.bbox_embed = nn.ModuleList([box_head] * dec_layers)
        self.transformer = Transformer(
            d_model=C, nhead=nheads, num_queries=num_queries,
            num_encoder_layers=enc_layers, num_decoder_layers=dec_layers,
            dim_feedforward=dim_feedforward, num_feature_levels=num_feature_levels,
            enc_n_points=enc_n_points, dec_n_points=dec_n_points,
            use_text_enhancer=use_text_enhancer, use_fusion_layer=use_fusion_layer,
            use_text_cross_attention=use_text_cross_attention, max_text_len=max_text_len,
            fusion_droppath=fusion_droppath, use_checkpoint=use_checkpoint,
            use_transformer_ckpt=use_transformer_ckpt, msda=msda,
            remat_save_kernels=remat_save_kernels,
        )
        self.transformer.decoder.bbox_embed = self.bbox_embed

    def level_strides(self):
        """Per-level strides: the backbone's stage strides (4*2^i; a dilated
        ResNet's stage 3 keeps 16); extra levels halve again."""
        strides = [self.backbone_cfg.strides[i] for i in self.backbone_cfg.out_indices]
        while len(strides) < self.num_feature_levels:
            strides.append(strides[-1] * 2)
        return strides[: self.num_feature_levels]

    def forward(self, images, image_sizes, input_ids, text_token_mask, position_ids,
                text_self_attention_masks, generator: Optional[torch.Generator] = None) -> Dict:
        """`generator` draws the text tower's dropout and the fusion blocks'
        stochastic depth in training mode (the JAX package's
        `rngs={"dropout": ...}`)."""
        bert_out = self.bert(input_ids, text_self_attention_masks, position_ids,
                             generator=generator)
        text_dict = {
            "encoded_text": self.feat_map(bert_out),
            "text_token_mask": text_token_mask,
            "position_ids": position_ids,
            "text_self_attention_masks": text_self_attention_masks,
        }

        feats = self.backbone[0](images)                       # (B, h, w, c) each
        srcs = []
        x = None
        for l, proj in enumerate(self.input_proj):
            if l < len(feats):
                x = proj(feats[l].permute(0, 3, 1, 2))
            else:
                x = proj(feats[-1].permute(0, 3, 1, 2) if l == len(feats) else x)
            srcs.append(x)
        srcs = [s.permute(0, 2, 3, 1) for s in srcs]          # NHWC
        shapes = [(s.shape[1], s.shape[2]) for s in srcs]
        masks = make_level_masks(image_sizes, shapes, self.level_strides())
        poss = [
            position_embedding_sine_hw(m, self.hidden_dim // 2, self.pe_temperature_h,
                                       self.pe_temperature_w).to(srcs[0].dtype)
            for m in masks
        ]

        t_out = self.transformer(srcs, masks, poss, text_dict, generator)

        memory_text = t_out["memory_text"]
        outputs_class = [
            contrastive_embed(hs_i, memory_text, text_token_mask, self.max_text_len)
            for hs_i in t_out["hs"]
        ]
        outputs_coord = t_out["outputs_coord"]
        out = {
            "pred_logits": outputs_class[-1],
            "pred_boxes": outputs_coord[-1],
            "text_mask": text_token_mask,
        }
        if self.aux_loss:
            out["aux_outputs"] = [
                {"pred_logits": c, "pred_boxes": b}
                for c, b in zip(outputs_class[:-1], outputs_coord[:-1])
            ]
        interm_class = contrastive_embed(t_out["hs_enc"], memory_text, text_token_mask,
                                         self.max_text_len)
        out["interm_outputs"] = {"pred_logits": interm_class, "pred_boxes": t_out["ref_enc"]}
        out["interm_outputs_for_matching_pre"] = {
            "pred_logits": interm_class, "pred_boxes": t_out["init_box_proposal"],
        }
        return out


def init_weights_(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random init of a model on the CPU (see layers.default_init_)."""
    default_init_(model, torch.Generator().manual_seed(seed))
    return model


def msda_options(args) -> Dict:
    """The config's MSDA core-op keys (cfg_base.py) as MSDeformAttn keywords;
    MSDeformAttn raises on an unknown value."""
    return {"kernel": str(getattr(args, "msda_kernel", "gather")),
            "sweep_bwd": str(getattr(args, "msda_sweep_bwd", "corner")),
            "dec_fused": bool(getattr(args, "msda_dec_fused", False))}


@MODULE_BUILD_FUNCS.registe_with_name("groundingdino")
def build_groundingdino(args, device="cuda") -> GroundingDINO:
    """Build from an SLConfig-style args namespace (reference
    groundingdino.py:726-806).  On device "meta" no memory is allocated: a
    checkpoint is then loaded with `to_empty` + `load_state_dict`.  On any
    other device the parameters are uninitialized until a checkpoint is
    loaded or `init_weights_` runs."""
    for key in ("dropout", "fusion_dropout"):
        if float(getattr(args, key, 0.0)) != 0.0:
            raise ValueError(f"{key} > 0 is not ported (the JAX package reads it nowhere)")
    use_checkpoint = bool(getattr(args, "use_checkpoint", False))
    if str(args.backbone).startswith("resnet"):
        # reference backbone.py:182-196: the torchvision resnet50/101 trunk
        backbone_cfg = ResNetConfig(name=str(args.backbone),
                                    out_indices=tuple(args.return_interm_indices),
                                    dilation=bool(getattr(args, "dilation", False)),
                                    use_checkpoint=use_checkpoint)
    else:
        backbone_cfg = SwinConfig.from_name(args.backbone, tuple(args.return_interm_indices),
                                            use_checkpoint=use_checkpoint)
    bert_cfg = BertConfig(
        vocab_size=int(getattr(args, "bert_vocab_size", 30522)),
        hidden_size=int(getattr(args, "bert_hidden_size", 768)),
        num_hidden_layers=int(getattr(args, "bert_layers", 12)),
        num_attention_heads=int(getattr(args, "bert_heads", 12)),
        intermediate_size=int(getattr(args, "bert_intermediate", 3072)),
        max_position_embeddings=int(getattr(args, "bert_max_position", 512)),
        # roberta-base: bert_vocab_size 50265, bert_max_position 514,
        # bert_type_vocab 1, with a vocab.json + merges.txt tokenizer
        type_vocab_size=int(getattr(args, "bert_type_vocab", 2)),
        hidden_dropout_prob=float(getattr(args, "text_dropout", 0.0)),
        attention_probs_dropout_prob=float(getattr(args, "text_dropout", 0.0)),
    )
    with torch.device(device):
        return GroundingDINO(
            backbone_cfg=backbone_cfg,
            bert_cfg=bert_cfg,
            hidden_dim=args.hidden_dim,
            num_queries=args.num_queries,
            nheads=args.nheads,
            num_feature_levels=args.num_feature_levels,
            enc_layers=args.enc_layers,
            dec_layers=args.dec_layers,
            dim_feedforward=args.dim_feedforward,
            enc_n_points=args.enc_n_points,
            dec_n_points=args.dec_n_points,
            max_text_len=args.max_text_len,
            pe_temperature_h=float(args.pe_temperatureH),
            pe_temperature_w=float(args.pe_temperatureW),
            use_text_enhancer=bool(args.use_text_enhancer),
            use_fusion_layer=bool(args.use_fusion_layer),
            use_text_cross_attention=bool(args.use_text_cross_attention),
            aux_loss=bool(args.aux_loss),
            fusion_droppath=float(getattr(args, "fusion_droppath", 0.0)),
            use_checkpoint=use_checkpoint,
            use_transformer_ckpt=bool(getattr(args, "use_transformer_ckpt", False)),
            msda=msda_options(args),
            remat_save_kernels=bool(getattr(args, "remat_save_kernels", True)),
        ).eval()
