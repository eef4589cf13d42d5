"""JAX-package parameter tree -> reference-keyed torch state dict.

The port's own copy of the mapping in the JAX package's
utils/checkpoint.py::export_groundingdino_checkpoint (and the Swin/ResNet/BERT
exporters of utils/torch_convert.py).  Input: the flax param tree of
GroundingDINO (per-layer encoder layout) as nested mappings of numpy-
convertible arrays.  Output: {reference key: float tensor}, which the port's
GroundingDINO loads with `load_state_dict(strict=True)`:
  * flax Dense kernels (in, out) become torch Linear weights (out, in);
  * flax Conv kernels HWIO become torch Conv2d weights OIHW;
  * LayerNorm / GroupNorm `scale` becomes `weight`;
  * a Swin backbone goes under `backbone.0.`, a ResNet one under
    `backbone.0.body.` (its `frozen_bn*` parameters become the FrozenBN
    buffers of torchvision's `bn*` / `downsample.1`);
  * the shared decoder box head is emitted under every reference alias.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, np.ndarray]


def _a(x) -> np.ndarray:
    return np.array(x, dtype=np.float32)  # a writable copy


def _linear(sd: StateDict, key: str, tree: Mapping) -> None:
    sd[f"{key}.weight"] = _a(tree["kernel"]).T
    if "bias" in tree:
        sd[f"{key}.bias"] = _a(tree["bias"])


def _norm(sd: StateDict, key: str, tree: Mapping) -> None:
    sd[f"{key}.weight"] = _a(tree["scale"])
    sd[f"{key}.bias"] = _a(tree["bias"])


def _conv(sd: StateDict, key: str, tree: Mapping) -> None:
    sd[f"{key}.weight"] = _a(tree["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in tree:
        sd[f"{key}.bias"] = _a(tree["bias"])


def _mlp(sd: StateDict, key: str, tree: Mapping) -> None:
    for name, sub in tree.items():
        _linear(sd, f"{key}.layers.{name.split('_')[-1]}", sub)


def _mha(sd: StateDict, key: str, tree: Mapping) -> None:
    sd[f"{key}.in_proj_weight"] = _a(tree["in_proj_weight"])
    sd[f"{key}.in_proj_bias"] = _a(tree["in_proj_bias"])
    _linear(sd, f"{key}.out_proj", tree["out_proj"])


def _layer_ids(tree: Mapping, prefix: str):
    return sorted(int(k[len(prefix):]) for k in tree
                  if k.startswith(prefix) and k[len(prefix):].isdigit())


def _tensors(sd: StateDict) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _swin(sd: StateDict, pre: str, bb: Mapping) -> None:
    _conv(sd, f"{pre}patch_embed.proj", bb["patch_embed"])
    _norm(sd, f"{pre}patch_embed.norm", bb["patch_norm"])
    for name in sorted(k for k in bb if k.startswith("layer_")):
        _, i, _, b = name.split("_")
        blk, bpre = bb[name], f"{pre}layers.{i}.blocks.{b}"
        _norm(sd, f"{bpre}.norm1", blk["norm1"])
        sd[f"{bpre}.attn.relative_position_bias_table"] = _a(
            blk["attn"]["relative_position_bias_table"])
        _linear(sd, f"{bpre}.attn.qkv", blk["attn"]["qkv"])
        _linear(sd, f"{bpre}.attn.proj", blk["attn"]["proj"])
        _norm(sd, f"{bpre}.norm2", blk["norm2"])
        _linear(sd, f"{bpre}.mlp.fc1", blk["fc1"])
        _linear(sd, f"{bpre}.mlp.fc2", blk["fc2"])
    for i in _layer_ids(bb, "downsample_"):
        _norm(sd, f"{pre}layers.{i}.downsample.norm", bb[f"downsample_{i}"]["norm"])
        _linear(sd, f"{pre}layers.{i}.downsample.reduction", bb[f"downsample_{i}"]["reduction"])
    for i in _layer_ids(bb, "out_norm_"):
        _norm(sd, f"{pre}norm{i}", bb[f"out_norm_{i}"])


def _frozen_bn(sd: StateDict, key: str, tree: Mapping) -> None:
    for name in ("weight", "bias", "running_mean", "running_var"):
        sd[f"{key}.{name}"] = _a(tree[name])


def _resnet(sd: StateDict, pre: str, bb: Mapping) -> None:
    """The inverse of the JAX package's torch_convert.convert_resnet_state_dict:
    `conv1` / `frozen_bn1` (the stem), `layer{i}_block{b}` with conv1-3,
    frozen_bn1-3 and, in a stage's first block, downsample_conv /
    downsample_frozen_bn."""
    _conv(sd, f"{pre}conv1", bb["conv1"])
    _frozen_bn(sd, f"{pre}bn1", bb["frozen_bn1"])
    for name in sorted(k for k in bb if k.startswith("layer")):
        stage, b = name.split("_block")
        blk, bpre = bb[name], f"{pre}{stage}.{b}"
        for j in (1, 2, 3):
            _conv(sd, f"{bpre}.conv{j}", blk[f"conv{j}"])
            _frozen_bn(sd, f"{bpre}.bn{j}", blk[f"frozen_bn{j}"])
        if "downsample_conv" in blk:
            _conv(sd, f"{bpre}.downsample.0", blk["downsample_conv"])
            _frozen_bn(sd, f"{bpre}.downsample.1", blk["downsample_frozen_bn"])


def resnet_state_dict_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX ResNet's param tree -> the port's ResNet state dict (the
    reference trunk keys under `body.`)."""
    sd: StateDict = {}
    _resnet(sd, "body.", params)
    return _tensors(sd)


def swin_state_dict_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX SwinTransformer's param tree -> the port's SwinTransformer
    state dict (the reference backbone keys without the `backbone.0.`
    prefix)."""
    sd: StateDict = {}
    _swin(sd, "", params)
    return _tensors(sd)


def state_dict_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    sd: StateDict = {}

    # --- text tower (HuggingFace BertModel keys) ---
    bert = params["bert"]
    emb = bert["embeddings"]
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        sd[f"bert.embeddings.{name}.weight"] = _a(emb[name]["embedding"])
    _norm(sd, "bert.embeddings.LayerNorm", emb["ln"])
    for i in _layer_ids(bert, "layer_"):
        lp, pre = bert[f"layer_{i}"], f"bert.encoder.layer.{i}"
        _linear(sd, f"{pre}.attention.self.query", lp["q"])
        _linear(sd, f"{pre}.attention.self.key", lp["k"])
        _linear(sd, f"{pre}.attention.self.value", lp["v"])
        _linear(sd, f"{pre}.attention.output.dense", lp["attn_out"])
        _norm(sd, f"{pre}.attention.output.LayerNorm", lp["attn_ln"])
        _linear(sd, f"{pre}.intermediate.dense", lp["inter"])
        _linear(sd, f"{pre}.output.dense", lp["out"])
        _norm(sd, f"{pre}.output.LayerNorm", lp["out_ln"])
    _linear(sd, "feat_map", params["feat_map"])

    if "patch_embed" in params["backbone"]:
        _swin(sd, "backbone.0.", params["backbone"])
    else:
        _resnet(sd, "backbone.0.body.", params["backbone"])

    # --- input projections (Sequential: .0 conv, .1 GroupNorm) ---
    for name in sorted(k for k in params if k.startswith("input_proj_")):
        l = name.split("_")[2]
        if name.endswith("_conv"):
            _conv(sd, f"input_proj.{l}.0", params[name])
        else:
            _norm(sd, f"input_proj.{l}.1", params[name])

    # --- transformer ---
    t = params["transformer"]
    sd["transformer.level_embed"] = _a(t["level_embed"])
    sd["transformer.tgt_embed.weight"] = _a(t["tgt_embed"])
    _linear(sd, "transformer.enc_output", t["enc_output"])
    _norm(sd, "transformer.enc_output_norm", t["enc_output_norm"])

    def msdeform(key, tree):
        for k in ("value_proj", "sampling_offsets", "attention_weights", "output_proj"):
            _linear(sd, f"{key}.{k}", tree[k])

    for i in _layer_ids(t, "enc_layer_"):
        e, pre = t[f"enc_layer_{i}"], f"transformer.encoder.layers.{i}"
        msdeform(f"{pre}.self_attn", e["self_attn"])
        for n in ("norm1", "norm2"):
            _norm(sd, f"{pre}.{n}", e[n])
        for n in ("linear1", "linear2"):
            _linear(sd, f"{pre}.{n}", e[n])
    for i in _layer_ids(t, "fusion_"):
        f, pre = t[f"fusion_{i}"], f"transformer.encoder.fusion_layers.{i}"
        _norm(sd, f"{pre}.layer_norm_v", f["layer_norm_v"])
        _norm(sd, f"{pre}.layer_norm_l", f["layer_norm_l"])
        sd[f"{pre}.gamma_v"] = _a(f["gamma_v"])
        sd[f"{pre}.gamma_l"] = _a(f["gamma_l"])
        for k in ("v_proj", "l_proj", "values_v_proj", "values_l_proj",
                  "out_v_proj", "out_l_proj"):
            _linear(sd, f"{pre}.attn.{k}", f["attn"][k])
    for i in _layer_ids(t, "text_layer_"):
        tl, pre = t[f"text_layer_{i}"], f"transformer.encoder.text_layers.{i}"
        _mha(sd, f"{pre}.self_attn", tl["self_attn"])
        for n in ("linear1", "linear2"):
            _linear(sd, f"{pre}.{n}", tl[n])
        for n in ("norm1", "norm2"):
            _norm(sd, f"{pre}.{n}", tl[n])

    dec_ids = _layer_ids(t, "dec_layer_")
    for i in dec_ids:
        d, pre = t[f"dec_layer_{i}"], f"transformer.decoder.layers.{i}"
        msdeform(f"{pre}.cross_attn", d["cross_attn"])
        _mha(sd, f"{pre}.self_attn", d["self_attn"])
        if "ca_text" in d:
            _mha(sd, f"{pre}.ca_text", d["ca_text"])
        for n in ("norm1", "catext_norm", "norm2", "norm3"):
            if n in d:
                _norm(sd, f"{pre}.{n}", d[n])
        for n in ("linear1", "linear2"):
            _linear(sd, f"{pre}.{n}", d[n])
    _mlp(sd, "transformer.decoder.ref_point_head", t["ref_point_head"])
    _norm(sd, "transformer.decoder.norm", t["dec_norm"])
    for i in dec_ids:
        _mlp(sd, f"bbox_embed.{i}", t["bbox_embed"])
        _mlp(sd, f"transformer.decoder.bbox_embed.{i}", t["bbox_embed"])
    _mlp(sd, "transformer.enc_out_bbox_embed", t["enc_out_bbox_embed"])

    return _tensors(sd)


def _repvit_names(tree: Mapping) -> Dict[str, str]:
    """A JAX segmentor module's child names -> the port's: a `X_conv` /
    `X_bn` pair (the JAX package's _conv_bn) is the port's ConvBN `X`
    (`X.conv`, `X.bn`); a lone `X_conv` is the port's conv `X`."""
    names = {}
    for name in tree:
        base = name[:-len("_conv")] if name.endswith("_conv") else None
        if base is not None and f"{base}_bn" in tree:
            names[name] = f"{base}.conv"
        elif name.endswith("_bn") and f"{name[:-len('_bn')]}_conv" in tree:
            names[name] = f"{name[:-len('_bn')]}.bn"
        else:
            names[name] = base if base is not None else name
    return names


def _repvit(sd: StateDict, pre: str, tree: Mapping, group_norm: bool = False) -> None:
    for name, key in _repvit_names(tree).items():
        sub = tree[name]
        if not isinstance(sub, Mapping):
            if name == "kernel":   # HWIO -> OIHW (a depthwise kernel's I is 1)
                sd[f"{pre}weight"] = _a(sub).transpose(3, 2, 0, 1)
            else:                  # FrozenBN keeps `scale`; GroupNorm's is `weight`
                sd[f"{pre}{'weight' if group_norm and name == 'scale' else name}"] = _a(sub)
        else:
            _repvit(sd, f"{pre}{key}.", sub, "_gn" in name)


def repvit_state_dict_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX RepViTSegmentor's parameter tree (with or without its
    "params" level) -> the port's RepViTSegmentor state dict: conv kernels
    HWIO -> OIHW (depthwise `feature_group_count` is the port's `groups`),
    FrozenBN `scale` / `bias` as they are, GroupNorm `scale` -> `weight`."""
    sd: StateDict = {}
    _repvit(sd, "", params.get("params", params))
    return _tensors(sd)
