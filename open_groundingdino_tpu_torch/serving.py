"""Ahead-of-time serving artifacts through torch.export (the port of the JAX
package's serving.py).

A deployment exports the model once per static image bucket and serves the
saved programs with no model code: `export_model` traces the eval-mode
forward, with the weights as its first input (the JAX package's
fn(params, images, ...)), by `torch.export.export` and saves one program per
bucket with `torch.export.save`; `load_exported` rebuilds a servable model
from them without building a GroundingDINO.  The hand-written kernels are in
the programs as the custom ops of ops/library.py (ogd_torch::msda_fwd, ...),
which launch the kernels on CUDA tensors and run their plain versions on
CPU ones, so a loaded program launches the same kernels as the eager model.
The host-side pre/post-processing (tokenizer, bucket padding, phrase
decoding) is inference.py's: `predict` and `predict_with_spans` accept a
ServingModel wherever they accept an InferenceModel.

Artifact layout (a directory):
    meta.json          format version, batch, buckets, max_text_len, the
                       device type exported for, the MSDA path, the dtype,
                       the weight names the programs take
    weights.pt         {"model": state dict}, reference-keyed (what
                       inference.load_reference_state_dict reads), once
    fwd_<H>x<W>.pt2    one exported program per bucket: (weights, images,
                       image_sizes, input_ids, text_token_mask, position_ids,
                       text_self_attention_masks) -> (pred_logits, pred_boxes)
    vocab.txt          WordPiece vocab (copied when provided)

A program holds the tensors its forward builds (masks, aranges, position
grids) on the device it was exported on, so it is loaded on that device type
only; it is read under the torch version that wrote it.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .data.tokenization import BertWordPieceTokenizer, build_tokenizer
from .data.transforms import Bucketer
from .models.groundingdino import msda_options

FORMAT_VERSION = 1
WEIGHTS = "weights.pt"


def unique_weights(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The state dict with each tensor once: the shared decoder box head,
    registered under every reference alias, goes in by its first name."""
    weights, seen = {}, set()
    for name, t in model.state_dict(keep_vars=True).items():
        if id(t) not in seen:
            seen.add(id(t))
            weights[name] = t.detach()
    return weights


class _Forward(nn.Module):
    """The model's forward with its weights as the first input; it holds no
    state, so the exported program reads every weight from that input."""

    def __init__(self, model: nn.Module):
        super().__init__()
        object.__setattr__(self, "_model", model)    # not a submodule

    def forward(self, weights: Dict[str, torch.Tensor], images, image_sizes, input_ids,
                text_token_mask, position_ids, text_self_attention_masks):
        # each tensor swapped in once, by one name: an alias of it is the same
        # module (functional_call's tying swaps it under every name and, after
        # an export, leaves a traced tensor behind in the model)
        out = torch.func.functional_call(
            self._model, weights, (images, image_sizes, input_ids, text_token_mask,
                                   position_ids, text_self_attention_masks), tie_weights=False)
        return out["pred_logits"], out["pred_boxes"]


def example_inputs(batch: int, bucket: Tuple[int, int], max_text_len: int, device
                   ) -> Tuple[torch.Tensor, ...]:
    """Inputs of the shapes and dtypes inference.prepare_inputs builds."""
    H, W = bucket
    T = max_text_len
    sizes = torch.tensor([[H, W]] * batch, dtype=torch.int64, device=device)
    return (torch.zeros(batch, H, W, 3, device=device), sizes,
            torch.zeros(batch, T, dtype=torch.int64, device=device),
            torch.ones(batch, T, dtype=torch.bool, device=device),
            torch.zeros(batch, T, dtype=torch.int64, device=device),
            torch.ones(batch, T, T, dtype=torch.bool, device=device))


def export_model(im, out_dir: str, buckets: Optional[Sequence[Tuple[int, int]]] = None,
                 batch: int = 1, vocab_path: Optional[str] = None,
                 seconds: Optional[Dict[str, float]] = None) -> List[str]:
    """Write the artifact of `im` (an inference.InferenceModel) for its
    device; returns the file names written.  buckets: the static (H, W)
    shapes to export, by default the config's image_buckets.  `seconds`, if
    given, receives each program's export-and-save time by file name."""
    model = im.model.eval()
    device = torch.device(im.device)
    buckets = [(int(h), int(w)) for h, w in (buckets or im.bucketer.buckets)]
    T = int(im.max_text_len)
    os.makedirs(out_dir, exist_ok=True)

    torch.save({"model": model.state_dict()}, os.path.join(out_dir, WEIGHTS))
    written = [WEIGHTS]
    weights = unique_weights(model)
    fwd = _Forward(model)
    for bucket in buckets:
        name = f"fwd_{bucket[0]}x{bucket[1]}.pt2"
        t0 = time.perf_counter()
        args = (weights, *example_inputs(batch, bucket, T, device))
        with torch.no_grad():
            # one eager forward first: the constants the model keeps per shape
            # (Swin's masks) then exist on the device and enter the program
            # as such, not as host arrays copied over at every call
            fwd(*args)
            program = torch.export.export(fwd, args, strict=False)
        # what no output reads (the auxiliary heads, traced dtype promotions)
        program.graph.eliminate_dead_code()
        program.graph_module.recompile()
        program.example_inputs = None   # else saved with it: the weights again, in every program
        torch.export.save(program, os.path.join(out_dir, name))
        if seconds is not None:
            seconds[name] = time.perf_counter() - t0
        written.append(name)

    if vocab_path:
        shutil.copyfile(vocab_path, os.path.join(out_dir, "vocab.txt"))
        written.append("vocab.txt")
    msda = msda_options(im.args)
    meta = {
        "format": FORMAT_VERSION,
        "batch": int(batch),
        "buckets": [list(b) for b in buckets],
        "max_text_len": T,
        "device": device.type,
        "msda_kernel": msda["kernel"],
        "msda_dec_fused": msda["dec_fused"],
        "dtype": str(next(model.parameters()).dtype).replace("torch.", ""),
        "torch": torch.__version__,
        "weights": list(weights),
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    written.append("meta.json")
    return written


class ExportedForward:
    """The loaded programs behind GroundingDINO.forward's call: keyword
    inputs -> {"pred_logits", "pred_boxes"}, through the program of the
    images' bucket."""

    def __init__(self, programs: Dict[Tuple[int, int], nn.Module],
                 weights: Dict[str, torch.Tensor]):
        self.programs, self.weights = programs, weights

    def __call__(self, images, image_sizes, input_ids, text_token_mask, position_ids,
                 text_self_attention_masks) -> Dict[str, torch.Tensor]:
        key = (int(images.shape[1]), int(images.shape[2]))
        if key not in self.programs:
            raise ValueError(f"no exported bucket for image shape {key}; "
                             f"available: {sorted(self.programs)}")
        logits, boxes = self.programs[key](self.weights, images, image_sizes, input_ids,
                                           text_token_mask, position_ids,
                                           text_self_attention_masks)
        return {"pred_logits": logits, "pred_boxes": boxes}


@dataclass
class ServingModel:
    """A loaded artifact; duck-types inference.InferenceModel, so
    inference.predict / predict_with_spans work on it."""

    model: ExportedForward
    tokenizer: BertWordPieceTokenizer
    bucketer: Bucketer
    max_text_len: int
    device: torch.device
    batch: int
    meta: Dict = field(default_factory=dict)


def load_exported(out_dir: str, vocab_path: Optional[str] = None,
                  device="cuda") -> ServingModel:
    """Rebuild a servable model from an export_model artifact directory on
    `device`, which must be of the device type the artifact was exported
    for."""
    from .ops import library

    library.custom_ops()   # a saved program resolves its ops once they are registered
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT_VERSION:
        raise ValueError(f"unsupported artifact format {meta.get('format')}")
    device = torch.device(device)
    if device.type != meta["device"]:
        raise ValueError(f"the artifact was exported for {meta['device']!r}: its programs hold "
                         f"tensors built there; load it with device={meta['device']!r}, "
                         f"not {device.type!r}")
    vocab = vocab_path or os.path.join(out_dir, "vocab.txt")
    if not os.path.exists(vocab):
        raise ValueError("vocab.txt not found in the artifact; pass vocab_path=")

    state = torch.load(os.path.join(out_dir, WEIGHTS), map_location=device,
                       weights_only=True)["model"]
    weights = {n: state[n] for n in meta["weights"]}
    programs = {(int(h), int(w)): torch.export.load(
        os.path.join(out_dir, f"fwd_{h}x{w}.pt2")).module() for h, w in meta["buckets"]}
    return ServingModel(
        model=ExportedForward(programs, weights),
        tokenizer=build_tokenizer(vocab),
        bucketer=Bucketer([tuple(b) for b in meta["buckets"]]),
        max_text_len=int(meta["max_text_len"]),
        device=device,
        batch=int(meta["batch"]),
        meta=meta,
    )
