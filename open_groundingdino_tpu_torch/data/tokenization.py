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

RoBERTa: `RobertaBPETokenizer` reads a roberta-base `vocab.json` +
`merges.txt` pair (byte-level BPE, HuggingFace's trim_offsets offsets) and
speaks the same protocol; `build_tokenizer` picks one of the two by the files
it is given.

This is the port's own copy of the JAX package's data/tokenization.py, so the
port imports nothing of that package.
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


# ---------------------------------------------------------------------------
# RoBERTa byte-level BPE (reference get_tokenlizer.py:22-29 supports
# 'roberta-base' via RobertaTokenizerFast; this is the self-contained
# equivalent with the same char_to_token offset semantics)
# ---------------------------------------------------------------------------

def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 byte <-> printable-unicode table (the standard mapping every
    byte-level BPE vocab.json is written in)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _gpt2_pretokenize(text: str) -> List[Tuple[str, int]]:
    """Segment `text` exactly like the GPT-2/RoBERTa regex
    ('s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|
    \\s+(?!\\S)|\\s+) without the `regex` module: returns (piece,
    start_char) pairs covering the text."""
    def is_l(ch):
        return unicodedata.category(ch).startswith("L")

    def is_n(ch):
        return unicodedata.category(ch).startswith("N")

    def is_s(ch):
        return ch.isspace()

    out: List[Tuple[str, int]] = []
    i, n = 0, len(text)
    while i < n:
        for c in _CONTRACTIONS:
            if text.startswith(c, i):
                out.append((c, i))
                i += len(c)
                break
        else:
            j = i + 1 if text[i] == " " and i + 1 < n else i
            ch = text[j] if j < n else ""
            if ch and is_l(ch):
                k = j
                while k < n and is_l(text[k]):
                    k += 1
                out.append((text[i:k], i))
                i = k
            elif ch and is_n(ch):
                k = j
                while k < n and is_n(text[k]):
                    k += 1
                out.append((text[i:k], i))
                i = k
            elif ch and not is_s(ch):
                k = j
                while k < n and not (is_s(text[k]) or is_l(text[k])
                                     or is_n(text[k])):
                    k += 1
                out.append((text[i:k], i))
                i = k
            else:
                # whitespace run: \s+(?!\S) leaves the LAST ws char to the
                # following token's ` ?` (or to its own \s+ if not a space)
                k = i
                while k < n and is_s(text[k]):
                    k += 1
                if k < n and k - i > 1:
                    out.append((text[i : k - 1], i))
                    i = k - 1
                else:
                    # trailing run, or a single non-space ws char before \S
                    # (a single ' ' before \S never reaches here — the
                    # ` ?X` branches above consume it)
                    out.append((text[i:k], i))
                    i = k
    return out


class RobertaBPETokenizer:
    """Self-contained byte-level BPE tokenizer (roberta-base file format:
    vocab.json + merges.txt) with original-text char offsets, implementing
    the same protocol as BertWordPieceTokenizer (__call__ ->
    TokenizedBatch, special_token_ids, decode) so every downstream
    consumer (Collator, positive maps, PostProcess) works unchanged.
    Reference: get_tokenlizer.py:22-29 returns RobertaTokenizerFast for
    text_encoder_type='roberta-base'."""

    def __init__(self, vocab_json: str, merges_txt: str):
        import json as _json

        with open(vocab_json, encoding="utf-8") as f:
            self.vocab: Dict[str, int] = _json.load(f)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        merges: List[Tuple[str, str]] = []
        with open(merges_txt, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split(" ")
                merges.append((a, b))
        self.bpe_ranks = {m: r for r, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.cls_token_id = self.vocab["<s>"]
        self.sep_token_id = self.vocab["</s>"]
        self.pad_token_id = self.vocab.get("<pad>", 1)
        self.unk_token_id = self.vocab.get("<unk>", 3)
        self._cache: Dict[str, List[str]] = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if best not in self.bpe_ranks:
                break
            a, b = best
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    # -- protocol -----------------------------------------------------------
    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]

    def decode(self, ids: Sequence[int]) -> str:
        specials = {self.cls_token_id, self.sep_token_id, self.pad_token_id}
        text = "".join(
            self.ids_to_tokens.get(int(i), "")
            for i in ids if int(i) not in specials
        )
        raw = bytearray(self.byte_decoder.get(ch, 32) for ch in text)
        return raw.decode("utf-8", errors="replace").strip()

    def special_token_ids(self, extra: Sequence[str] = (".", "?")) -> List[int]:
        """<s>, </s> + phrase-delimiter ids in BOTH surface forms ('.' and
        'Ġ.'): captions put delimiters after a space, so the leading-space
        variant is the one that actually occurs."""
        ids = [self.cls_token_id, self.sep_token_id]
        for t in extra:
            for form in (t, "Ġ" + t):  # Ġ = byte-encoded leading space
                if form in self.vocab:
                    ids.append(self.vocab[form])
        return ids

    def tokenize_with_offsets(
        self, text: str
    ) -> Tuple[List[str], List[Tuple[int, int]]]:
        tokens: List[str] = []
        offsets: List[Tuple[int, int]] = []
        for piece, start in _gpt2_pretokenize(text):
            # byte-encode, tracking each encoded char's source char index
            enc_chars: List[str] = []
            src_idx: List[int] = []
            for ci, ch in enumerate(piece):
                for byte in ch.encode("utf-8"):
                    enc_chars.append(self.byte_encoder[byte])
                    src_idx.append(start + ci)
            pos = 0
            for sub in self._bpe("".join(enc_chars)):
                a, b = src_idx[pos], src_idx[pos + len(sub) - 1] + 1
                # HF fast-tokenizer default trim_offsets=True: leading
                # space chars (Ġ) are dropped from the reported span; an
                # all-space token collapses to the zero-width (b, b)
                g = 0
                while g < len(sub) and sub[g] == "Ġ":
                    g += 1
                a = b if g == len(sub) else a + g
                tokens.append(sub)
                offsets.append((a, b))
                pos += len(sub)
        return tokens, offsets

    def __call__(
        self,
        captions: Union[str, Sequence[str]],
        padding: Union[str, int] = "longest",
        max_length: Optional[int] = None,
    ) -> TokenizedBatch:
        if isinstance(captions, str):
            captions = [captions]
        encoded = []
        for cap in captions:
            toks, offs = self.tokenize_with_offsets(cap)
            ids = ([self.cls_token_id] + self.convert_tokens_to_ids(toks)
                   + [self.sep_token_id])
            spans: List[Optional[Tuple[int, int]]] = (
                [None] + list(offs) + [None]
            )
            if max_length is not None and len(ids) > max_length:
                ids = ids[: max_length - 1] + [self.sep_token_id]
                spans = spans[: max_length - 1] + [None]
            encoded.append((ids, spans))

        width = max(len(ids) for ids, _ in encoded)
        if isinstance(padding, int):
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


def build_tokenizer(path_or_type: str, vocab_json: str = "",
                    merges_txt: str = ""):
    """Tokenizer loader, the reference get_tokenlizer.py:22-29 semantics
    without AutoTokenizer: a vocab.txt path (or a directory containing one)
    -> BertWordPieceTokenizer; a vocab.json+merges.txt pair (or a directory
    containing both, the roberta-base file layout) -> RobertaBPETokenizer."""
    import os

    if vocab_json and merges_txt:
        return RobertaBPETokenizer(vocab_json, merges_txt)
    if os.path.isdir(path_or_type):
        d = path_or_type
        if os.path.exists(os.path.join(d, "vocab.json")) and os.path.exists(
            os.path.join(d, "merges.txt")
        ):
            return RobertaBPETokenizer(
                os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt")
            )
        if os.path.exists(os.path.join(d, "vocab.txt")):
            return BertWordPieceTokenizer(os.path.join(d, "vocab.txt"))
        raise ValueError(f"no vocab.txt or vocab.json+merges.txt in {d}")
    if path_or_type.endswith(".json"):
        return RobertaBPETokenizer(
            path_or_type,
            os.path.join(os.path.dirname(path_or_type), "merges.txt"),
        )
    return BertWordPieceTokenizer(path_or_type)


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
