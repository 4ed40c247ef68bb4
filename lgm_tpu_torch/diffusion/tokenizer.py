"""Prompt tokenizers: CLIP byte-level BPE, and the hashing stand-in.

``CLIPTokenizer`` gives the ids that ``transformers.CLIPTokenizer`` gives
where ``lgm_tpu`` calls it (``pipeline.py::_maybe_tokenizer``:
``padding="max_length"``, ``truncation=True``), from the same
``vocab.json`` and ``merges.txt``, without ``transformers``, ``regex`` or
``ftfy`` (the card host has none of them). Without ``ftfy``,
transformers cleans the text with BERT's ``BasicTokenizer`` (no accent
stripping, no punctuation split): control characters dropped, whitespace
made a space, spaces around CJK ideographs, NFC, lower case. Special
tokens (bos, eos, unk, pad) found in the text stay whole, as transformers'
added-token split keeps them. The pre-tokenizing pattern is CLIP's, with
``regex``'s classes spelled in stdlib ``re``: ``[\\p{L}]+`` as
``[^\\W\\d_]+`` and ``[\\p{N}]`` as ``\\d``. The first also takes the
numerals outside Unicode's Nd class (No, Nl: ``²``, ``½``, ``Ⅻ``), which
``regex`` takes as numbers, one token each; ``_split_numerals`` cuts them
out of such a run by their Unicode category, so the two agree wherever
Python's ``unicodedata`` and ``regex`` read the same Unicode version.

``HashTokenizer`` is ``lgm_tpu``'s deterministic stand-in (not CLIP BPE),
allowed only by the tiny test configurations.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import re
import unicodedata
from typing import Dict, List, Optional, Tuple

import numpy as np

_PATTERN = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
    r"""|[^\W\d_]+|\d|(?:[^\s\w]|_)+""", re.IGNORECASE)


class HashTokenizer:
    """Deterministic fallback tokenizer (NOT CLIP BPE; testing only)."""

    def __init__(self, vocab_size: int, max_tokens: int):
        self.vocab_size = vocab_size
        self.max_tokens = max_tokens
        self.bos, self.eos = 0, 1

    def __call__(self, text: str) -> np.ndarray:
        ids = [self.bos]
        for w in text.lower().split()[: self.max_tokens - 2]:
            h = int(hashlib.sha1(w.encode()).hexdigest(), 16)
            ids.append(2 + h % (self.vocab_size - 2))
        ids.append(self.eos)
        ids += [self.eos] * (self.max_tokens - len(ids))
        return np.asarray([ids], np.int64)


@functools.lru_cache(maxsize=None)
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible map of the 256 bytes to printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _basic_clean(text: str) -> str:
    """BERT's BasicTokenizer as CLIP runs it without ftfy, words joined
    by single spaces."""
    out = []
    for ch in text:
        cp = ord(ch)
        cat = unicodedata.category(ch)
        if cp == 0 or cp == 0xFFFD or (cat.startswith("C")
                                       and ch not in "\t\n\r"):
            continue
        if ch in " \t\n\r" or cat == "Zs":
            out.append(" ")
        elif _is_cjk(cp):
            out += [" ", ch, " "]
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(w.lower() for w in text.split())


def _split_numerals(pre: str) -> List[str]:
    """A run matched as letters, cut into its letter runs and its
    numerals (category N*), one token each; other matches as they are."""
    if len(pre) < 2 or not any(unicodedata.category(c)[0] == "N"
                               for c in pre):
        return [pre]
    out: List[str] = []
    run = ""
    for c in pre:
        if unicodedata.category(c)[0] == "N":
            out += [run, c] if run else [c]
            run = ""
        else:
            run += c
    return out + [run] if run else out


def _special_token(value, default: str) -> str:
    if value is None:
        return default
    return value["content"] if isinstance(value, dict) else value


class CLIPTokenizer:
    """CLIP BPE over ``vocab.json`` + ``merges.txt`` in ``path``; calling
    it with a prompt returns int64 ids [1, max_length]: bos, the prompt's
    tokens (cut to max_length - 2), eos, then pad up to max_length."""

    def __init__(self, path: str, max_length: int):
        self.path = path
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            merges = f.read().strip().split("\n")[1:49152 - 256 - 2 + 1]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.max_length = max_length
        cfg: Dict = {}
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            p = os.path.join(path, name)
            if os.path.exists(p):
                with open(p, encoding="utf-8") as f:
                    cfg.update(json.load(f))
        self.bos = _special_token(cfg.get("bos_token"), "<|startoftext|>")
        self.eos = _special_token(cfg.get("eos_token"), "<|endoftext|>")
        self.unk = _special_token(cfg.get("unk_token"), "<|endoftext|>")
        self.pad = _special_token(cfg.get("pad_token"), "<|endoftext|>")
        specials = sorted({self.bos, self.eos, self.unk, self.pad}, key=len,
                          reverse=True)
        self._specials = set(specials)
        self._split = re.compile("(" + "|".join(map(re.escape, specials))
                                 + ")")
        self._cache: Dict[str, Tuple[str, ...]] = {}

    def _id(self, token: str) -> int:
        return self.encoder.get(token, self.encoder.get(self.unk))

    def bpe(self, token: str) -> Tuple[str, ...]:
        """The merged symbols of one pre-token (already byte-mapped)."""
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, np.inf))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        self._cache[token] = word
        return word

    def tokenize(self, text: str) -> List[str]:
        byte_map = _bytes_to_unicode()
        tokens: List[str] = []
        for piece in self._split.split(text):
            if piece in self._specials:
                tokens.append(piece)
                continue
            for pre in (p for m in _PATTERN.findall(_basic_clean(piece))
                        for p in _split_numerals(m)):
                mapped = "".join(byte_map[b] for b in pre.encode("utf-8"))
                tokens.extend(self.bpe(mapped))
        return tokens

    def __call__(self, text: str) -> np.ndarray:
        ids = [self._id(t) for t in self.tokenize(text)]
        ids = ([self._id(self.bos)] + ids[:max(self.max_length - 2, 0)]
               + [self._id(self.eos)])
        ids += [self._id(self.pad)] * (self.max_length - len(ids))
        return np.asarray([ids], np.int64)


def load_tokenizer(path: str, max_length: int) -> Optional[CLIPTokenizer]:
    """The CLIP tokenizer in ``<path>/tokenizer`` where that directory
    exists, else None (``lgm_tpu``'s ``_maybe_tokenizer``)."""
    tok = os.path.join(path, "tokenizer")
    return CLIPTokenizer(tok, max_length) if os.path.isdir(tok) else None
