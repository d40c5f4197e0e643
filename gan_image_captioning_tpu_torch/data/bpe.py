"""GPT-2 byte-level BPE tokenizer (``gan_image_captioning_tpu/data/bpe.py``).

The standard GPT-2 byte-pair encoding from its two data files,
``vocab.json`` (token → id) and ``merges.txt`` (ranked merge pairs), with
the ids offset by the 4 specials ``<PAD>=0, <S>=1, <E>=2, <UNK>=3``
(framework id = BPE id + 4; the GPT-2 importer prepends 4 rows to the
embedding to match, ``models/torch_import.py``).

GPT-2's pre-tokenizer is the pattern

    's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+

which needs the third-party ``regex`` package for ``\\p{L}`` / ``\\p{N}``.
This module needs only the standard library: :func:`pre_tokenize` is a
scanner that takes the pattern's alternatives in order at each position,
with letters and numbers by ``unicodedata.category`` (``L*`` and ``N*``)
and whitespace as ``regex``'s ``\\s`` (``str.isspace()`` less the four
information separators U+001C-U+001F).  The two agree on every character
that both Unicode databases assign.
"""

from __future__ import annotations

import json
import unicodedata
from functools import lru_cache
from typing import Dict, List

NUM_SPECIALS = 4  # <PAD>, <S>, <E>, <UNK>
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _is_space(c: str) -> bool:
    return c.isspace() and not "\x1c" <= c <= "\x1f"


@lru_cache(maxsize=None)
def _kind(c: str) -> str:
    """``"s"`` whitespace, ``"L"`` letter, ``"N"`` number, ``"o"`` other."""
    if _is_space(c):
        return "s"
    cat = unicodedata.category(c)[0]
    return cat if cat in "LN" else "o"


def _run(text: str, i: int, kind: str) -> int:
    """The end of the run of ``kind`` characters from ``i``."""
    while i < len(text) and _kind(text[i]) == kind:
        i += 1
    return i


def pre_tokenize(text: str) -> List[str]:
    """GPT-2's pre-tokenization of ``text`` (``regex.findall`` of the
    pattern above)."""
    out, i, n = [], 0, len(text)
    while i < n:
        c = text[i]
        con = next((p for p in _CONTRACTIONS if text.startswith(p, i)), None)
        if con is not None:
            out.append(con)
            i += len(con)
            continue
        # " ?" then a run of one kind: letters, numbers, or other
        start = i + 1 if c == " " and i + 1 < n and _kind(text[i + 1]) != "s" \
            else i
        kind = _kind(text[start])
        if kind != "s":
            j = _run(text, start, kind)
            out.append(text[i:j])
            i = j
            continue
        # whitespace: the run less its last character when a non-space
        # follows it (\s+(?!\S)), else the whole run (\s+)
        j = _run(text, i, "s")
        if j < n and j - i > 1:
            j -= 1
        out.append(text[i:j])
        i = j
    return out


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """The reversible byte → printable-character map BPE works over:
    printable ASCII / Latin-1 ranges map to themselves, every other byte
    to 256 + n."""
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
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class BPETokenizer:
    """GPT-2 byte-level BPE over local ``vocab.json`` + ``merges.txt``."""

    def __init__(self, vocab_file: str, merges_file: str,
                 offset: int = NUM_SPECIALS):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(m.split()) for m in lines
                  if m and not m.startswith("#version") and len(m.split()) == 2]
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.offset = offset
        self._cache: Dict[str, List[str]] = {}

    @property
    def vocab_size(self) -> int:
        """The framework's vocabulary size: the BPE vocabulary and the 4
        specials."""
        return len(self.encoder) + self.offset

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        pairs = _get_pairs(word)
        while pairs:
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            a, b = best
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(a, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    new_word.append(a + b)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = list(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        """Text → framework ids (BPE id + offset)."""
        ids = []
        for tok in pre_tokenize(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(mapped):
                ids.append(self.encoder[piece] + self.offset)
        return ids

    def decode(self, ids) -> str:
        """Framework ids → text (specials dropped)."""
        pieces = [self.decoder[int(i) - self.offset] for i in ids
                  if int(i) >= self.offset]
        text = "".join(pieces)
        return bytearray(self.byte_decoder[c] for c in text).decode(
            "utf-8", errors="replace")
