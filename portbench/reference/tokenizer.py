"""CLIP's byte-pair tokenizer (Radford et al. 2021, the released
`simple_tokenizer.py`'s scheme) for the prompts of the text bank: bytes
mapped to printable characters, lower-cased words, the lowest-ranked merge
first, `<|startoftext|>` and `<|endoftext|>` around, zero padding. The
merges are read from the vocabulary file the program ships as data
(`bpe_simple_vocab_16e6.txt.gz`), a raw file both sides read."""
from __future__ import annotations

import gzip
import html
from functools import lru_cache
from pathlib import Path

import numpy as np
import regex

VOCAB_FILE = (Path(__file__).resolve().parents[2] / "segclip_tpu_torch" / "data" / "assets"
              / "bpe_simple_vocab_16e6.txt.gz")
_WORDS = regex.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
                       r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+", regex.IGNORECASE)


def _bytes_to_unicode():
    keep = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    table, extra = {b: chr(b) for b in keep}, 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + extra)
            extra += 1
    return table


class Tokenizer:
    def __init__(self, path: Path = VOCAB_FILE):
        self.byte_map = _bytes_to_unicode()
        lines = gzip.open(path).read().decode("utf-8").split("\n")[1:49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in lines]
        vocab = list(self.byte_map.values())
        vocab = vocab + [v + "</w>" for v in vocab] + ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.ids = {tok: i for i, tok in enumerate(vocab)}
        self.rank = {m: i for i, m in enumerate(merges)}

    def _bpe(self, token: str) -> list:
        word = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = [(word[i], word[i + 1]) for i in range(len(word) - 1)]
            best = min(pairs, key=lambda p: self.rank.get(p, float("inf")))
            if best not in self.rank:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        return word

    def encode(self, text: str) -> list:
        text = " ".join(html.unescape(html.unescape(text)).split()).lower()
        out = []
        for tok in _WORDS.findall(text):
            mapped = "".join(self.byte_map[b] for b in tok.encode("utf-8"))
            out += [self.ids[piece] for piece in self._bpe(mapped)]
        return out

    def tokenize(self, texts, context_length: int) -> np.ndarray:
        rows = np.zeros((len(texts), context_length), np.int64)
        for r, text in enumerate(texts):
            ids = ([self.ids["<|startoftext|>"]] + self.encode(text)[:context_length - 2]
                   + [self.ids["<|endoftext|>"]])
            rows[r, :len(ids)] = ids
        return rows


@lru_cache(maxsize=None)
def tokenizer() -> Tokenizer:
    return Tokenizer()
