"""The port's GroundingDINO carries exactly the tensors of a published
checkpoint: for Swin-T (cfg_coco.py), Swin-B (cfg_swinb.py) and ResNet-50
(cfg_resnet50.py) the state dict's names and shapes equal the `params` of
open_groundingdino_tpu/config/manifests/{swint,swinb,resnet50}_keys.json,
plus the shared box-head `aliases`, and none of the non-parameter `ignored`
keys; Swin-L (cfg_swinl.py), which has no manifest, equals Swin-B's with its
widths.  A published-layout .pth then loads with load_state_dict(strict=True)
(Swin and ResNet layouts)."""
import json
import os

import pytest
import torch

from open_groundingdino_tpu_torch.config import SLConfig
from open_groundingdino_tpu_torch.inference import load_reference_state_dict
from open_groundingdino_tpu_torch.models.bert import BertConfig
from open_groundingdino_tpu_torch.models.groundingdino import GroundingDINO, build_groundingdino
from open_groundingdino_tpu_torch.models.swin import SwinConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFESTS = os.path.join(ROOT, "open_groundingdino_tpu", "config", "manifests")
CONFIGS = os.path.join(ROOT, "open_groundingdino_tpu_torch", "config")
# manifest -> the port's config of that published geometry
CASES = {"swint_keys.json": "cfg_coco.py", "swinb_keys.json": "cfg_swinb.py",
         "resnet50_keys.json": "cfg_resnet50.py"}


def _flagship(cfg="cfg_coco.py"):
    return build_groundingdino(SLConfig.fromfile(os.path.join(CONFIGS, cfg)), device="meta")


def _manifest(name):
    with open(os.path.join(MANIFESTS, name)) as f:
        return json.load(f)


@pytest.mark.parametrize("manifest_name", list(CASES))
def test_flagship_keys_and_shapes_equal_manifest(manifest_name):
    manifest = _manifest(manifest_name)
    sd = _flagship(CASES[manifest_name]).state_dict()
    shapes = {k: list(v.shape) for k, v in sd.items()}
    aliases = manifest["aliases"]
    assert set(shapes) == set(manifest["params"]) | set(aliases)
    assert not set(shapes) & set(manifest["ignored"])
    for key, shape in manifest["params"].items():
        assert shapes[key] == shape, key
    for key, canon in aliases.items():
        assert shapes[key] == manifest["params"][canon], key


def test_reference_checkpoint_loads_strict(tmp_path):
    """A checkpoint laid out like a published one — a DDP `module.` prefix,
    only the canonical shared box head (`bbox_embed.0`), plus the ignored
    buffers and BERT pooler — loads into the port's model (nano geometry):
    ignored keys dropped, aliases filled from the shared head, strict=True."""
    model = GroundingDINO(
        SwinConfig(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 4), window_size=4),
        BertConfig(vocab_size=40, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                   intermediate_size=32, max_position_embeddings=32),
        hidden_dim=32, num_queries=12, nheads=4, enc_layers=2, dec_layers=2,
        dim_feedforward=64, max_text_len=16)
    g = torch.Generator().manual_seed(0)
    sd = {k: torch.randn(v.shape, generator=g) for k, v in model.state_dict().items()
          if not (k.startswith("transformer.decoder.bbox_embed.")
                  or (k.startswith("bbox_embed.") and not k.startswith("bbox_embed.0.")))}
    sd.update({"bert.pooler.dense.weight": torch.zeros(32, 32),
               "bert.embeddings.position_ids": torch.arange(32)[None],
               "backbone.0.layers.0.blocks.0.attn.relative_position_index":
                   torch.zeros(16, 16, dtype=torch.long)})
    path = tmp_path / "published_like.pth"
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, str(path))
    load_reference_state_dict(model, str(path))
    loaded = model.state_dict()
    key = "transformer.encoder.layers.0.self_attn.sampling_offsets.weight"
    assert torch.equal(loaded[key], sd[key])
    assert torch.equal(loaded["transformer.decoder.bbox_embed.1.layers.2.bias"],
                       sd["bbox_embed.0.layers.2.bias"])


def test_swin_l_is_swin_b_widened():
    """Swin-L (embed 192, heads 6-12-24-48) has Swin-B's keys (embed 128,
    heads 4-8-16-32) with every backbone width, every head count of a
    relative-bias table and every input projection's input width 1.5x."""
    manifest = _manifest("swinb_keys.json")
    want = dict(manifest["params"])
    for key, shape in want.items():
        if key.startswith("backbone.0."):
            want[key] = [d * 3 // 2 if d % 128 == 0 or (
                key.endswith("relative_position_bias_table") and i == 1) else d
                for i, d in enumerate(shape)]
        elif key.startswith("input_proj.") and key.endswith(".0.weight"):
            want[key] = [shape[0], shape[1] * 3 // 2, *shape[2:]]
    want.update({k: want[v] for k, v in manifest["aliases"].items()})
    sd = _flagship("cfg_swinl.py").state_dict()
    assert {k: list(v.shape) for k, v in sd.items()} == want
    assert sd["backbone.0.layers.2.blocks.17.attn.relative_position_bias_table"].shape == (529, 24)


def test_resnet_checkpoint_loads_strict(tmp_path):
    """A ResNet-layout checkpoint as torchvision and the reference write it
    (FrozenBN statistics under `backbone.0.body.*.bn*`, their
    num_batches_tracked counters, a `module.` prefix, the BERT pooler and
    position ids, only the canonical box head) loads into the port's nano
    ResNet model with strict=True; the statistics land in its buffers."""
    from open_groundingdino_tpu_torch.models.resnet import ResNetConfig

    model = GroundingDINO(
        ResNetConfig(name="resnet_nano_test"),
        BertConfig(vocab_size=40, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                   intermediate_size=32, max_position_embeddings=32),
        hidden_dim=32, num_queries=12, nheads=4, enc_layers=2, dec_layers=2,
        dim_feedforward=64, max_text_len=16)
    g = torch.Generator().manual_seed(0)
    sd = {k: torch.randn(v.shape, generator=g) for k, v in model.state_dict().items()
          if not (k.startswith("transformer.decoder.bbox_embed.")
                  or (k.startswith("bbox_embed.") and not k.startswith("bbox_embed.0.")))}
    counters = {k.replace(".running_var", ".num_batches_tracked"): torch.tensor(7)
                for k in sd if k.endswith(".running_var")}
    assert "backbone.0.body.layer4.0.downsample.1.num_batches_tracked" in counters
    sd_file = {**sd, **counters,
               "bert.pooler.dense.weight": torch.zeros(32, 32),
               "bert.pooler.dense.bias": torch.zeros(32),
               "bert.embeddings.position_ids": torch.arange(32)[None]}
    path = tmp_path / "resnet_published_like.pth"
    torch.save({"model": {f"module.{k}": v for k, v in sd_file.items()}}, str(path))
    load_reference_state_dict(model, str(path))
    loaded = model.state_dict()
    for key in ("backbone.0.body.bn1.running_var", "backbone.0.body.layer2.0.conv2.weight",
                "backbone.0.body.layer3.0.downsample.1.running_mean"):
        assert torch.equal(loaded[key], sd[key]), key
    assert "backbone.0.body.bn1.running_var" in dict(model.named_buffers())


@pytest.mark.parametrize("backbone", ["swin_T_224_1k", "swin_B_224_22k", "swin_B_384_22k",
                                      "swin_L_224_22k", "swin_L_384_22k", "resnet50",
                                      "resnet101"])
def test_every_backbone_builds(backbone):
    """build_groundingdino builds each backbone of the JAX package, and its
    backbone holds the JAX backbone's tensors: as many, of as many elements
    each in turn (the JAX FrozenBN parameters being the port's buffers)."""
    import jax
    import numpy as np

    from open_groundingdino_tpu.models.resnet import ResNet as JResNet
    from open_groundingdino_tpu.models.resnet import ResNetConfig as JResNetConfig
    from open_groundingdino_tpu.models.swin import SwinConfig as JSwinConfig
    from open_groundingdino_tpu.models.swin import SwinTransformer as JSwinTransformer

    args = SLConfig.fromfile(os.path.join(CONFIGS, "cfg_coco.py"))
    args.merge_from_dict({"backbone": backbone})
    model = build_groundingdino(args, device="meta")
    if backbone.startswith("resnet"):
        jmodel = JResNet(JResNetConfig(name=backbone))
    else:
        jmodel = JSwinTransformer(JSwinConfig.from_name(backbone))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            np.zeros((1, 64, 64, 3), np.float32))["params"]
    jax_sizes = sorted(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    port_sizes = sorted(t.numel() for t in model.backbone[0].state_dict().values())
    assert port_sizes == jax_sizes
    feat_dims = [model.backbone_cfg.num_features[i] for i in model.backbone_cfg.out_indices]
    assert [p[0].in_channels for p in model.input_proj[:3]] == feat_dims
