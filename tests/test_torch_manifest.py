"""The port's flagship GroundingDINO carries exactly the parameters of a
published Swin-T checkpoint: names and shapes equal the `params` of
open_groundingdino_tpu/config/manifests/swint_keys.json, plus the shared
box-head `aliases`, and none of the non-parameter `ignored` keys.  A
published .pth then loads with load_state_dict(strict=True)."""
import json
import os

import torch

from open_groundingdino_tpu_torch.config import SLConfig
from open_groundingdino_tpu_torch.inference import load_reference_state_dict
from open_groundingdino_tpu_torch.models.bert import BertConfig
from open_groundingdino_tpu_torch.models.groundingdino import GroundingDINO, build_groundingdino
from open_groundingdino_tpu_torch.models.swin import SwinConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = os.path.join(ROOT, "open_groundingdino_tpu", "config", "manifests", "swint_keys.json")
CFG = os.path.join(ROOT, "open_groundingdino_tpu_torch", "config", "cfg_coco.py")


def _flagship():
    return build_groundingdino(SLConfig.fromfile(CFG), device="meta")


def test_flagship_keys_and_shapes_equal_manifest():
    with open(MANIFEST) as f:
        manifest = json.load(f)
    sd = _flagship().state_dict()
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
