"""Self-contained BERT WordPiece tokenizer + grounding text utilities.

The reference leans on HuggingFace's fast tokenizer for three things:
  1. encoding captions (reference groundingdino.py:237-239),
  2. `char_to_token` offsets to build token-level positive maps
     (reference groundingdino.py:808-855, vl_utils.py:7-47),
  3. special-token ids to build block-diagonal sub-sentence attention masks
     (reference bertwarper.py:224-273).

This module implements all three natively (host-side, numpy only) so the
framework has no network/tokenizers dependency: a BasicTokenizer
(clean/lowercase/strip-accents/punct-split) + greedy WordPiece with *original
-text character offsets* tracked through normalization, which is exactly what
`char_to_token` needs.

Vocab: pass a path to a standard `vocab.txt` (one token per line; the file
shipped with every bert-base-uncased checkpoint) or a dict.

This is the port's own copy of the JAX package's data/tokenization.py (the
WordPiece half), so the port imports nothing of that package.
"""
from __future__ import annotations

import unicodedata
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        (0x4E00 <= cp <= 0x9FFF)
        or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF)
        or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F)
        or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


def load_vocab(path: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
    return vocab


@dataclass
class TokenizedBatch:
    """Host-side tokenization result (numpy, static-width)."""

    input_ids: np.ndarray        # (B, T) int32
    attention_mask: np.ndarray   # (B, T) int32, 1 = real token
    token_type_ids: np.ndarray   # (B, T) int32 (all zeros)
    offsets: List[List[Optional[Tuple[int, int]]]] = field(default_factory=list)
    # offsets[b][t] = (char_start, char_end_exclusive) in the original caption
    # or None for special/pad tokens.

    def char_to_token(self, batch_idx: int, char_idx: int) -> Optional[int]:
        for t, span in enumerate(self.offsets[batch_idx]):
            if span is not None and span[0] <= char_idx < span[1]:
                return t
        return None

    def __getitem__(self, key: str):
        return getattr(self, key)


class BertWordPieceTokenizer:
    """Uncased BERT tokenizer with offset tracking (host-side, no deps)."""

    def __init__(
        self,
        vocab: Union[str, Dict[str, int]],
        do_lower_case: bool = True,
        unk_token: str = "[UNK]",
        max_wordpiece_chars: int = 100,
    ):
        if isinstance(vocab, str):
            vocab = load_vocab(vocab)
        self.vocab = vocab
        self.ids_to_tokens = {i: t for t, i in vocab.items()}
        self.do_lower_case = do_lower_case
        self.unk_token = unk_token
        self.max_wordpiece_chars = max_wordpiece_chars
        self.cls_token_id = vocab["[CLS]"]
        self.sep_token_id = vocab["[SEP]"]
        self.pad_token_id = vocab.get("[PAD]", 0)
        self.unk_token_id = vocab[unk_token]

    # -- public API ---------------------------------------------------------
    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]

    def decode(self, ids: Sequence[int]) -> str:
        toks = [self.ids_to_tokens.get(int(i), self.unk_token) for i in ids]
        out = ""
        for t in toks:
            if t.startswith("##"):
                out += t[2:]
            else:
                out += (" " if out else "") + t
        return out

    def special_token_ids(self, extra: Sequence[str] = (".", "?")) -> List[int]:
        """ids of [CLS], [SEP] and phrase-delimiter tokens (reference
        groundingdino.py:123)."""
        ids = [self.cls_token_id, self.sep_token_id]
        ids += [self.vocab[t] for t in extra if t in self.vocab]
        return ids

    def tokenize_with_offsets(
        self, text: str
    ) -> Tuple[List[str], List[Tuple[int, int]]]:
        """WordPiece tokens + original-text char spans (end exclusive)."""
        # 1. clean/normalize char-by-char, remembering source index
        chars: List[Tuple[str, int]] = []  # (normalized char, original index)
        for i, ch in enumerate(text):
            if ch == "\x00" or ch == "�" or _is_control(ch):
                continue
            if _is_whitespace(ch):
                chars.append((" ", i))
                continue
            if self.do_lower_case:
                for sub in unicodedata.normalize("NFD", ch.lower()):
                    if unicodedata.category(sub) == "Mn":
                        continue
                    chars.append((sub, i))
            else:
                chars.append((ch, i))

        # 2. split into words: whitespace, punctuation & CJK become boundaries
        words: List[Tuple[str, List[int]]] = []
        cur: List[Tuple[str, int]] = []

        def flush():
            nonlocal cur
            if cur:
                words.append(("".join(c for c, _ in cur), [j for _, j in cur]))
                cur = []

        for ch, i in chars:
            if ch == " ":
                flush()
            elif _is_punctuation(ch) or _is_cjk(ord(ch)):
                flush()
                words.append((ch, [i]))
            else:
                cur.append((ch, i))
        flush()

        # 3. greedy WordPiece per word
        tokens: List[str] = []
        offsets: List[Tuple[int, int]] = []
        for word, src in words:
            span = (src[0], src[-1] + 1)
            if len(word) > self.max_wordpiece_chars:
                tokens.append(self.unk_token)
                offsets.append(span)
                continue
            start = 0
            sub_tokens: List[Tuple[str, Tuple[int, int]]] = []
            bad = False
            while start < len(word):
                end = len(word)
                cur_tok = None
                while start < end:
                    piece = word[start:end]
                    if start > 0:
                        piece = "##" + piece
                    if piece in self.vocab:
                        cur_tok = piece
                        break
                    end -= 1
                if cur_tok is None:
                    bad = True
                    break
                sub_tokens.append((cur_tok, (src[start], src[end - 1] + 1)))
                start = end
            if bad:
                tokens.append(self.unk_token)
                offsets.append(span)
            else:
                for t, sp in sub_tokens:
                    tokens.append(t)
                    offsets.append(sp)
        return tokens, offsets

    def __call__(
        self,
        captions: Union[str, Sequence[str]],
        padding: Union[str, int] = "longest",
        max_length: Optional[int] = None,
    ) -> TokenizedBatch:
        """Encode captions with [CLS] ... [SEP]; padding='longest' or an int
        for a fixed static width (the TPU path always uses the fixed width)."""
        if isinstance(captions, str):
            captions = [captions]
        encoded = []
        for cap in captions:
            toks, offs = self.tokenize_with_offsets(cap)
            ids = [self.cls_token_id] + self.convert_tokens_to_ids(toks) + [self.sep_token_id]
            spans: List[Optional[Tuple[int, int]]] = [None] + list(offs) + [None]
            if max_length is not None and len(ids) > max_length:
                ids = ids[: max_length - 1] + [self.sep_token_id]
                spans = spans[: max_length - 1] + [None]
            encoded.append((ids, spans))

        width = max(len(ids) for ids, _ in encoded)
        if isinstance(padding, int):
            width = max(width, padding) if max_length is None else padding
            width = padding
        input_ids = np.full((len(encoded), width), self.pad_token_id, np.int32)
        attn = np.zeros((len(encoded), width), np.int32)
        offsets: List[List[Optional[Tuple[int, int]]]] = []
        for b, (ids, spans) in enumerate(encoded):
            n = min(len(ids), width)
            input_ids[b, :n] = ids[:n]
            attn[b, :n] = 1
            offsets.append(list(spans[:n]) + [None] * (width - n))
        return TokenizedBatch(
            input_ids=input_ids,
            attention_mask=attn,
            token_type_ids=np.zeros_like(input_ids),
            offsets=offsets,
        )


def build_tokenizer(path: str) -> BertWordPieceTokenizer:
    """A vocab.txt path, or a directory holding one -> BertWordPieceTokenizer
    (the reference get_tokenlizer.py:22-29 semantics for bert-base-uncased).
    The RoBERTa BPE tokenizer of the JAX package is not ported yet."""
    import os

    if os.path.isdir(path):
        path = os.path.join(path, "vocab.txt")
    return BertWordPieceTokenizer(path)


# ---------------------------------------------------------------------------
# grounding text utilities (host-side numpy)
# ---------------------------------------------------------------------------

def generate_masks_with_special_tokens(
    input_ids: np.ndarray, special_ids: Sequence[int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Block-diagonal sub-sentence self-attention mask + per-phrase position
    ids, the semantics of reference bertwarper.py:224-273.

    Args:
      input_ids: (B, T) int array.
    Returns:
      attn_mask: (B, T, T) bool, True = may attend.
      position_ids: (B, T) int32, restarting at 0 inside each phrase.
    """
    bs, num_token = input_ids.shape
    special = np.isin(input_ids, np.asarray(list(special_ids)))
    attn = np.tile(np.eye(num_token, dtype=bool)[None], (bs, 1, 1))
    pos = np.zeros((bs, num_token), np.int32)
    for row in range(bs):
        prev = 0
        for col in np.nonzero(special[row])[0]:
            if col == 0 or col == num_token - 1:
                pos[row, col] = 0
            else:
                attn[row, prev + 1 : col + 1, prev + 1 : col + 1] = True
                pos[row, prev + 1 : col + 1] = np.arange(0, col - prev)
            prev = col
    return attn, pos


def build_caption(cat_list: Sequence[str]) -> str:
    """COCO/ODVG caption from category names (reference engine_multi.py:641)."""
    return " . ".join(cat_list) + " ."


def create_positive_map(
    tokenized: TokenizedBatch,
    batch_idx: int,
    label_ids: Sequence[int],
    cat_list: Sequence[str],
    caption: str,
    max_text_len: int = 256,
) -> np.ndarray:
    """(n_labels, max_text_len) float map: row i is 1 on the tokens spanning
    cat_list[label_ids[i]] inside the caption.  Reproduces the reference's
    substring search and char_to_token fallbacks (groundingdino.py:808-855)."""
    pm = np.zeros((len(label_ids), max_text_len), np.float32)
    for j, label in enumerate(label_ids):
        name = cat_list[label]
        start_ind = caption.find(name)
        if start_ind < 0:
            continue
        end_ind = start_ind + len(name) - 1
        beg_pos = tokenized.char_to_token(batch_idx, start_ind)
        end_pos = tokenized.char_to_token(batch_idx, end_ind)
        if end_pos is None:
            end_pos = tokenized.char_to_token(batch_idx, end_ind - 1)
            if end_pos is None and end_ind >= 2:
                end_pos = tokenized.char_to_token(batch_idx, end_ind - 2)
        if beg_pos is None or end_pos is None or beg_pos > end_pos:
            continue
        pm[j, beg_pos : min(end_pos + 1, max_text_len)] = 1.0
    return pm


def build_label_maps(
    tokenized: TokenizedBatch,
    cat_lists: Sequence[Sequence[str]],
    captions: Sequence[str],
    max_text_len: int = 256,
) -> List[np.ndarray]:
    """Per-sample (n_cats, max_text_len) positive maps (the criterion's
    `label_map_list`, reference groundingdino.py:538-547)."""
    return [
        create_positive_map(
            tokenized, b, list(range(len(cats))), cats, captions[b], max_text_len
        )
        for b, cats in enumerate(cat_lists)
    ]
