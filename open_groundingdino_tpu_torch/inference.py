"""Library inference API (the port of the JAX package's inference.py;
reference groundingdino/util/inference.py:53-259).

    im = load_model(cfg_path, checkpoint_path, vocab_path)   # device="cuda"
    boxes, scores, phrases = predict(im, image, caption,
                                     box_threshold=0.35, text_threshold=0.25)

    model = Model(cfg_path, checkpoint_path, vocab_path)    # device="cuda"
    detections, phrases = model.predict_with_caption(image_rgb, "cat . dog .")
    detections = model.predict_with_classes(image_rgb, ["cat", "dog"], 0.35, 0.25)

Images are resized shortest-edge 800 / max 1333 and padded to a static
bucket; boxes come back as normalized cxcywh, like the reference's predict
(`Model` returns absolute xyxy `Detections`).  The model runs on the device
given to load_model (CUDA by default); nothing moves to the CPU unless the
caller asks for it.  The config picks the backbone (cfg_coco.py Swin-T,
cfg_swinb.py, cfg_swinl.py, cfg_resnet50.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from PIL import Image

from .config import SLConfig
from .data.tokenization import (
    BertWordPieceTokenizer,
    RobertaBPETokenizer,
    TokenizedBatch,
    build_tokenizer,
    generate_masks_with_special_tokens,
)
from .data.transforms import Bucketer, EvalTransform, Sample, normalize_image
from .data.vl_utils import create_positive_map_from_span
from .models.groundingdino import GroundingDINO, build_groundingdino
from .utils.misc import clean_state_dict

# keys of a reference checkpoint that are not tensors of the model: Swin's
# recomputed index buffers, BERT's position-id buffer and its frozen, unused
# pooler (the "ignored" sections of the JAX package's
# config/manifests/*_keys.json), and torchvision's BatchNorm step counters,
# which FrozenBatchNorm2d drops (reference backbone.py:50-56)
_IGNORED_SUFFIXES = (".relative_position_index", ".attn_mask", ".num_batches_tracked")
_IGNORED_PREFIXES = ("bert.pooler.", "bert.embeddings.position_ids")


def _ignored(key: str) -> bool:
    return key.endswith(_IGNORED_SUFFIXES) or key.startswith(_IGNORED_PREFIXES)


def _box_head_source(key: str) -> str:
    """The canonical key of a shared decoder box-head alias
    (`bbox_embed.{i}.*` and `transformer.decoder.bbox_embed.{i}.*` are all
    `bbox_embed.0.*`)."""
    rest = key[len("transformer.decoder."):] if key.startswith("transformer.decoder.") else key
    parts = rest.split(".")
    if parts[0] == "bbox_embed" and len(parts) > 2:
        return ".".join(["bbox_embed", "0"] + parts[2:])
    return key


def load_reference_state_dict(model: GroundingDINO, path: str, ignore=()) -> None:
    """Load a reference-keyed .pth ({"model": state_dict} or a bare state
    dict) into `model` with strict=True, after dropping the non-parameter
    keys and filling absent box-head aliases from `bbox_embed.0`.

    `ignore` (keywords): the reference's finetune_ignore (main.py:343-358
    check_keep, then load_state_dict(strict=False)): a key that contains a
    keyword is not loaded, so its tensor keeps the model's own (fresh) value;
    every other key of the file must name a tensor of the model."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = clean_state_dict(ckpt.get("model", ckpt))
    sd = {k: v for k, v in sd.items() if not _ignored(k)}
    if ignore:
        sd = {k: v for k, v in sd.items() if not any(kw in k for kw in ignore)}
        unexpected = model.load_state_dict(sd, strict=False).unexpected_keys
        if unexpected:
            raise KeyError(f"{path}: keys the model does not have: {unexpected}")
        return
    for key in model.state_dict():
        if key not in sd and _box_head_source(key) in sd:
            sd[key] = sd[_box_head_source(key)]
    model.load_state_dict(sd, strict=True)


@dataclass
class InferenceModel:
    model: GroundingDINO
    tokenizer: Union[BertWordPieceTokenizer, RobertaBPETokenizer]
    args: SLConfig
    bucketer: Bucketer
    max_text_len: int
    device: torch.device


def load_model(config_path: str, checkpoint_path: str, vocab_path: str,
               device="cuda") -> InferenceModel:
    """Build the model of `config_path` on `device` and load the
    reference-keyed checkpoint; `vocab_path` is a bert-base-uncased
    vocab.txt, or for a roberta-base config a directory holding its
    vocab.json + merges.txt (data/tokenization.build_tokenizer)."""
    if not checkpoint_path:
        raise ValueError("checkpoint_path required for inference")
    if not vocab_path:
        raise ValueError("vocab_path (a bert-base-uncased vocab.txt, or a directory with "
                         "roberta-base's vocab.json + merges.txt) is required")
    args = SLConfig.fromfile(config_path)
    device = torch.device(device)
    model = build_groundingdino(args, device="meta").to_empty(device=device)
    load_reference_state_dict(model, checkpoint_path)
    return InferenceModel(
        model=model.eval(),
        tokenizer=build_tokenizer(vocab_path),
        args=args,
        bucketer=Bucketer(args.image_buckets),
        max_text_len=int(args.max_text_len),
        device=device,
    )


def preprocess_caption(caption: str) -> str:
    c = caption.lower().strip()
    return c if c.endswith(".") else c + "."


def prepare_inputs(im: InferenceModel, image: Image.Image, caption: str,
                   size: int = 800, max_size: int = 1333
                   ) -> Tuple[Dict[str, torch.Tensor], TokenizedBatch]:
    """Resize + normalize + bucket-pad the image, tokenize the (already
    preprocessed) caption, and build the model's input tensors on the
    model's device."""
    sample = EvalTransform(size, max_size)(
        Sample(image=image, boxes=np.zeros((0, 4), np.float32),
               labels=np.zeros((0,), np.int64))
    )
    images, image_sizes = im.bucketer.pad_batch([normalize_image(sample.image)])
    tok = im.tokenizer([caption], padding=im.max_text_len)
    attn_mask, position_ids = generate_masks_with_special_tokens(
        tok.input_ids, im.tokenizer.special_token_ids()
    )
    dev = im.device
    inputs = {
        "images": torch.from_numpy(images).to(dev),
        "image_sizes": torch.from_numpy(image_sizes.astype(np.int64)).to(dev),
        "input_ids": torch.from_numpy(tok.input_ids.astype(np.int64)).to(dev),
        "text_token_mask": torch.from_numpy(tok.attention_mask.astype(bool)).to(dev),
        "position_ids": torch.from_numpy(position_ids.astype(np.int64)).to(dev),
        "text_self_attention_masks": torch.from_numpy(attn_mask).to(dev),
    }
    return inputs, tok


def forward(im: InferenceModel, inputs: Dict[str, torch.Tensor]) -> Tuple[np.ndarray, np.ndarray]:
    """(sigmoid token probabilities (Q, T), boxes cxcywh (Q, 4)) of image 0."""
    with torch.inference_mode():
        out = im.model(**inputs)
        probs = out["pred_logits"][0].float().sigmoid().cpu().numpy()
        boxes = out["pred_boxes"][0].float().cpu().numpy()
    return probs, boxes


def predict(
    im: InferenceModel,
    image: Image.Image,
    caption: str,
    box_threshold: float = 0.35,
    text_threshold: float = 0.25,
    size: int = 800,
    max_size: int = 1333,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Returns (boxes cxcywh normalized (N, 4), scores (N,), phrases)."""
    caption = preprocess_caption(caption)
    inputs, tok = prepare_inputs(im, image, caption, size, max_size)
    logits, boxes = forward(im, inputs)

    valid_tokens = tok.attention_mask[0].astype(bool)
    logits = np.where(valid_tokens[None, :], logits, 0.0)
    max_logits = logits.max(axis=1)
    keep = max_logits > box_threshold
    phrases = []
    for row in logits[keep]:
        ids = tok.input_ids[0][row > text_threshold]
        # drop special tokens from the phrase (reference get_phrases_from_posmap)
        ids = [i for i in ids.tolist()
               if i not in (im.tokenizer.cls_token_id, im.tokenizer.sep_token_id)]
        phrases.append(im.tokenizer.decode(ids))
    return boxes[keep], max_logits[keep], phrases


def predict_with_spans(
    im: InferenceModel,
    image: Image.Image,
    caption: str,
    token_spans,
    box_threshold: float = 0.35,
    size: int = 800,
    max_size: int = 1333,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Given-phrase mode (reference tools/inference_on_a_image.py:116-142):
    `token_spans` lists, per phrase, (beg, end) char spans into the caption;
    each query is scored per phrase by the mean probability over the
    phrase's tokens."""
    caption = preprocess_caption(caption)
    inputs, tok = prepare_inputs(im, image, caption, size, max_size)
    logits, boxes = forward(im, inputs)

    pos_map = create_positive_map_from_span(tok, token_spans, im.max_text_len)
    phrases_text = ["".join(caption[b:e] for b, e in spans) for spans in token_spans]
    scores_per_phrase = logits @ pos_map.T  # (Q, n_phrases)
    all_boxes, all_scores, all_phrases = [], [], []
    for p in range(scores_per_phrase.shape[1]):
        keep = scores_per_phrase[:, p] > box_threshold
        all_boxes.append(boxes[keep])
        all_scores.append(scores_per_phrase[keep, p])
        all_phrases.extend([phrases_text[p]] * int(keep.sum()))
    boxes_k = np.concatenate(all_boxes) if all_boxes else np.zeros((0, 4))
    scores_k = np.concatenate(all_scores) if all_scores else np.zeros((0,))
    return boxes_k, scores_k, all_phrases


# ---------------------------------------------------------------------------
# The reference's Model API (groundingdino/util/inference.py:124-259), as the
# JAX package has it (inference.py:247-349): Detections stands in for
# supervision's, and annotate draws with PIL instead of cv2 + supervision.
# ---------------------------------------------------------------------------


@dataclass
class Detections:
    """Minimal stand-in for supervision.Detections: absolute-pixel xyxy
    boxes, per-box confidence, optional class ids (None = unmatched, the
    reference's phrases2classes sentinel)."""

    xyxy: np.ndarray                      # (N, 4) float32, abs pixels
    confidence: np.ndarray                # (N,) float32
    class_id: Optional[np.ndarray] = None  # (N,) object/int, None entries ok

    def __len__(self):
        return len(self.xyxy)


def annotate(image_source: np.ndarray, boxes: np.ndarray, logits: np.ndarray,
             phrases: List[str]) -> np.ndarray:
    """Normalized-cxcywh boxes drawn with "phrase score" labels on an RGB
    uint8 array (reference inference.py:100-115; the result stays RGB)."""
    from .utils.visualizer import draw_cxcywh_norm

    img = Image.fromarray(np.asarray(image_source, np.uint8))
    out = draw_cxcywh_norm(img, np.asarray(boxes, np.float32), labels=phrases,
                           scores=np.asarray(logits))
    return np.asarray(out)


class Model:
    """Reference groundingdino/util/inference.py:124-259.

    model = Model(cfg_path, ckpt_path, vocab_path)          # device="cuda"
    detections, phrases = model.predict_with_caption(image_rgb, "cat. dog.")
    detections = model.predict_with_classes(image_rgb, ["cat", "dog"], .35, .25)
    """

    def __init__(self, model_config_path: str, model_checkpoint_path: str, vocab_path: str,
                 device="cuda"):
        self.im = load_model(model_config_path, model_checkpoint_path, vocab_path,
                             device=device)

    def predict_with_caption(self, image: np.ndarray, caption: str,
                             box_threshold: float = 0.35, text_threshold: float = 0.25
                             ) -> Tuple[Detections, List[str]]:
        """image: RGB uint8 HWC array (the reference takes BGR from cv2.imread
        and converts; this takes RGB, as the JAX package's does)."""
        pil = Image.fromarray(np.asarray(image, np.uint8))
        boxes, scores, phrases = predict(self.im, pil, caption, box_threshold=box_threshold,
                                         text_threshold=text_threshold)
        h, w = image.shape[:2]
        return self.post_process_result(h, w, boxes, scores), phrases

    def predict_with_classes(self, image: np.ndarray, classes: List[str],
                             box_threshold: float = 0.35, text_threshold: float = 0.25
                             ) -> Detections:
        caption = ". ".join(classes)
        detections, phrases = self.predict_with_caption(image, caption, box_threshold,
                                                        text_threshold)
        detections.class_id = self.phrases2classes(phrases, classes)
        return detections

    @staticmethod
    def post_process_result(source_h: int, source_w: int, boxes: np.ndarray,
                            logits: np.ndarray) -> Detections:
        """Normalized cxcywh -> absolute xyxy Detections (reference
        inference.py:242-252)."""
        b = np.asarray(boxes, np.float32).reshape(-1, 4)
        b = b * np.asarray([source_w, source_h, source_w, source_h], np.float32)
        xyxy = np.stack([b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2,
                         b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2], axis=1)
        return Detections(xyxy=xyxy, confidence=np.asarray(logits, np.float32))

    @staticmethod
    def phrases2classes(phrases: List[str], classes: List[str]) -> np.ndarray:
        """The first class whose name is a substring of the phrase; no match:
        None (reference inference.py:254-259)."""
        class_ids = []
        for phrase in phrases:
            for class_ in classes:
                if class_ in phrase:
                    class_ids.append(classes.index(class_))
                    break
            else:
                class_ids.append(None)
        return np.array(class_ids)
