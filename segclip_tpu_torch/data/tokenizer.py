"""A copy of segclip_tpu/data/tokenizer.py, kept in the port so that the port
imports nothing of the JAX package (tests/test_torch_vendored.py holds the
copy equal to the original).

CLIP byte-pair-encoding tokenizer.

A from-scratch implementation of the standard (public, OpenAI-published) CLIP
BPE scheme used by the reference (modules/tokenization_clip.py): byte-level
unicode mapping, lowercased regex pre-tokenization, greedy lowest-rank merge
loop over `bpe_simple_vocab_16e6.txt.gz` (the vocab *data* file, vendored
under data/assets), with `<|startoftext|>` / `<|endoftext|>` specials and a
49,408-token vocabulary.

ftfy is optional (absent in this image): text cleaning degrades to
html-unescape + whitespace normalization, which is equivalent for ASCII
captions.
"""
from __future__ import annotations

import gzip
import html
import os
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np
import regex as re

try:
    import ftfy
    _HAS_FTFY = True
except ImportError:
    _HAS_FTFY = False

VOCAB_SIZE = 49408
BOS = "<|startoftext|>"
EOS = "<|endoftext|>"

_ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                      "bpe_simple_vocab_16e6.txt.gz")


@lru_cache()
def _byte_unicode_table() -> Dict[int, str]:
    """Invertible byte→printable-unicode map (GPT-2 convention)."""
    printable = (list(range(ord("!"), ord("~") + 1)) +
                 list(range(ord("¡"), ord("¬") + 1)) +
                 list(range(ord("®"), ord("ÿ") + 1)))
    # Canonical insertion order: printable bytes first (identity-mapped),
    # then the remaining bytes mapped to 256+k — the vocab is built from
    # this dict's value order, so it must match exactly.
    table = {b: chr(b) for b in printable}
    extra = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + extra)
            extra += 1
    return table


def _clean(text: str) -> str:
    if _HAS_FTFY:
        text = ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip()


class ClipTokenizer:
    def __init__(self, vocab_path: str = _ASSET):
        byte_enc = _byte_unicode_table()
        self.byte_encoder = byte_enc
        self.byte_decoder = {v: k for k, v in byte_enc.items()}

        merges_raw = gzip.open(vocab_path).read().decode("utf-8").split("\n")
        # header line + exactly enough merges for the 49,408 vocab
        merges_raw = merges_raw[1:49152 - 256 - 2 + 1]
        merges: List[Tuple[str, str]] = [tuple(m.split()) for m in merges_raw]

        vocab = list(byte_enc.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += [BOS, EOS]
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.merge_rank = {m: i for i, m in enumerate(merges)}
        self._cache: Dict[str, str] = {BOS: BOS, EOS: EOS}
        self._word_re = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+", re.IGNORECASE)

    @property
    def bos_id(self) -> int:
        return self.encoder[BOS]

    @property
    def eos_id(self) -> int:
        return self.encoder[EOS]

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.merge_rank.get(p, 1 << 30))
            if best not in self.merge_rank:
                break
            merged = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == best[0]
                        and word[i + 1] == best[1]):
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        result = " ".join(word)
        self._cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in re.findall(self._word_re, _clean(text).lower()):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[piece]
                       for piece in self._bpe(mapped).split(" "))
        return ids

    def decode(self, ids: List[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text
                        if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def tokenize(self, text: str, context_length: int = 77) -> np.ndarray:
        """BOS + tokens (truncated) + EOS, zero-padded — one row of int32."""
        row, _ = self.tokenize_with_length(text, context_length)
        return row

    def tokenize_with_length(self, text: str, context_length: int = 77):
        """(row, n_real_tokens). The length — not `row != 0` — must drive
        attention masks: BPE id 0 is a real token ('!' piece)."""
        ids = [self.bos_id] + self.encode(text)[:context_length - 2] + \
            [self.eos_id]
        row = np.zeros(context_length, np.int32)
        row[:len(ids)] = ids
        return row, len(ids)

    def batch_tokenize(self, texts: List[str],
                       context_length: int = 77) -> np.ndarray:
        return np.stack([self.tokenize(t, context_length) for t in texts])


@lru_cache()
def default_tokenizer() -> ClipTokenizer:
    return ClipTokenizer()


def tokenize_with_mask(tokenizer: ClipTokenizer, text: str,
                       max_words: int) -> Tuple[np.ndarray, np.ndarray]:
    """(ids, attention_mask) pair matching DatasetBase._get_text
    (dataloader_base.py:18-49): BOS + words[:max_words-2] + EOS, zero pad.
    The mask is LENGTH-based like the reference — `ids != 0` would mask out
    real tokens whose BPE id happens to be 0."""
    ids, n = tokenizer.tokenize_with_length(text, max_words)
    mask = np.zeros(max_words, np.int32)
    mask[:n] = 1
    return ids, mask
