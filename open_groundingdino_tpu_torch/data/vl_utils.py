"""Vision-language span utilities (reference groundingdino/util/vl_utils.py);
the port's own copy of the JAX package's data/vl_utils.py: the caption and
character spans of a category list, and the span map.

Used by the token_spans inference mode (tools/inference_on_a_image.py:116-142)
where the user supplies character spans per phrase instead of thresholding.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .tokenization import TokenizedBatch


def build_captions_and_token_span(
    cat_list: Sequence[str], force_lowercase: bool = True
) -> Tuple[str, Dict[str, List[Tuple[int, int]]]]:
    """caption 'a . b . c .' + char span (beg, end) per category name
    (reference vl_utils.py:50-87)."""
    cat2tokenspan: Dict[str, List[Tuple[int, int]]] = {}
    caption = ""
    for name in cat_list:
        part = name.lower() if force_lowercase else name
        if caption:
            caption += " . "
        start = len(caption)
        caption += part
        cat2tokenspan[part] = [(start, len(caption))]
    caption += " ."
    return caption, cat2tokenspan


def create_positive_map_from_span(
    tokenized: TokenizedBatch,
    token_span: Sequence[Sequence[Tuple[int, int]]],
    max_text_len: int = 256,
    batch_idx: int = 0,
) -> np.ndarray:
    """(n_phrases, max_text_len) normalized map from char spans
    (reference vl_utils.py:7-47, including the +-1/2 char fallbacks)."""
    pm = np.zeros((len(token_span), max_text_len), np.float32)
    for j, spans in enumerate(token_span):
        for (beg, end) in spans:
            beg_pos = tokenized.char_to_token(batch_idx, beg)
            end_pos = tokenized.char_to_token(batch_idx, end - 1)
            if beg_pos is None:
                beg_pos = tokenized.char_to_token(batch_idx, beg + 1)
                if beg_pos is None:
                    beg_pos = tokenized.char_to_token(batch_idx, beg + 2)
            if end_pos is None:
                end_pos = tokenized.char_to_token(batch_idx, end - 2)
                if end_pos is None:
                    end_pos = tokenized.char_to_token(batch_idx, end - 3)
            if beg_pos is None or end_pos is None:
                continue
            pm[j, beg_pos : end_pos + 1] = 1.0
    s = pm.sum(-1, keepdims=True)
    return np.where(s > 0, pm / np.maximum(s, 1e-6), pm)
