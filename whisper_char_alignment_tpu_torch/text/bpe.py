"""Byte-level BPE engine.

Copy of ``whisper_char_alignment_tpu/text/bpe.py`` for the PyTorch port, which
imports nothing of the JAX package; only imports changed.

Replaces the Rust tiktoken core behind ``whisper.tokenizer`` (reference dependency
#13 in SURVEY.md §2b; call sites retokenize.py:8-24, infer_ali.py:41,69-75). Loads
either tiktoken-format rank files (``base64(token_bytes) rank`` per line) or GPT-2
``vocab.json`` + ``merges.txt``. Encoding is host work: a C++ core (cpp/bpe.cc) is
used when built, with this pure-Python implementation as the always-available
fallback and test oracle.

Pre-tokenization implements the GPT-2/tiktoken pattern

    's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+

with a hand-rolled scanner over ``unicodedata`` categories (the ``regex`` package
with \\p support is not a baked-in dependency).
"""

from __future__ import annotations

import base64
import functools
import json
import re
import unicodedata
from typing import Dict, Iterable, List

_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")

# whisper/GPT-2 special-token shape: <|endoftext|>, <|startoftranscript|>,
# <|en|>, ... — no base BPE merge ever produces a full token of this form
_SPECIAL_TOKEN_RE = re.compile(r"<\|[^|]*\|>")


def _is_letter(c: str) -> bool:
    return unicodedata.category(c).startswith("L")


def _is_number(c: str) -> bool:
    return unicodedata.category(c).startswith("N")


# `\s` in tiktoken's Rust regex engine is the Unicode White_Space property —
# NOT Python's str.isspace(), which additionally counts the \x1c-\x1f separator
# control characters. Using isspace() here would split whitespace runs
# differently from the real tokenizer (fuzzed in tests/test_tiktoken_parity.py).
_WHITE_SPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680"
    + "".join(chr(c) for c in range(0x2000, 0x200B))
    + "\u2028\u2029\u202f\u205f\u3000")


def _is_space(c: str) -> bool:
    return c in _WHITE_SPACE


def pre_tokenize(text: str) -> List[str]:
    """Split text into GPT-2 pre-tokens (see module docstring for the pattern)."""
    out: List[str] = []
    i = 0
    n = len(text)
    while i < n:
        # 1. contractions (literal, case-sensitive like the published pattern)
        matched = False
        for c in _CONTRACTIONS:
            if text.startswith(c, i):
                out.append(c)
                i += len(c)
                matched = True
                break
        if matched:
            continue
        ch = text[i]
        start = i
        # optional leading space before a letter/number/other run
        j = i
        if ch == " " and j + 1 < n and not _is_space(text[j + 1]):
            j += 1
            ch = text[j]
        if not _is_space(ch):
            if _is_letter(ch):
                k = j
                while k < n and _is_letter(text[k]):
                    k += 1
            elif _is_number(ch):
                k = j
                while k < n and _is_number(text[k]):
                    k += 1
            else:
                k = j
                while k < n and not (_is_space(text[k]) or _is_letter(text[k])
                                     or _is_number(text[k])):
                    k += 1
            out.append(text[start:k])
            i = k
            continue
        # whitespace run: `\s+(?!\S)` keeps the run except the last space when a
        # non-space follows; otherwise `\s+` takes everything
        k = i
        while k < n and _is_space(text[k]):
            k += 1
        if k < n and k - i > 1:
            out.append(text[i:k - 1])
            i = k - 1
        else:
            out.append(text[i:k])
            i = k
    return out


class ByteBPE:
    """Rank-based byte-pair encoder (tiktoken semantics)."""

    def __init__(self, ranks: Dict[bytes, int]):
        self.ranks = ranks
        self.decoder: Dict[int, bytes] = {r: b for b, r in ranks.items()}
        self.n_vocab = max(ranks.values()) + 1
        self._native = None
        self._native_tried = False

    # -- construction ------------------------------------------------------

    @classmethod
    def from_tiktoken_file(cls, path: str) -> "ByteBPE":
        ranks: Dict[bytes, int] = {}
        with open(path, "rb") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                token_b64, rank = line.split()
                ranks[base64.b64decode(token_b64)] = int(rank)
        return cls(ranks)

    @classmethod
    def from_gpt2_files(cls, vocab_json: str) -> "ByteBPE":
        """GPT-2 format: vocab.json maps unicode-mapped strings -> id.

        Special tokens (``<|endoftext|>``, ``<|en|>``, ...) that some dumps
        include in vocab.json are excluded from the base ranks: they decode
        cleanly through the byte map (printable ASCII), but the Tokenizer
        derives every special id from ``n_vocab`` (tokenizer.py), so letting
        ``<|endoftext|>`` (id == n_base) into the ranks would shift eot/sot/...
        off the checkpoint's trained ids by one. merges.txt is not needed:
        tiktoken-semantics BPE derives merge order from the rank table itself.
        """
        byte_decoder = {c: b for b, c in _bytes_to_unicode().items()}
        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        ranks: Dict[bytes, int] = {}
        for tok_str, idx in vocab.items():
            if _SPECIAL_TOKEN_RE.fullmatch(tok_str):
                continue  # special tokens: ids are derived in tokenizer.py
            try:
                b = bytes(byte_decoder[c] for c in tok_str)
            except KeyError:
                continue  # non-byte-mapped entries (HF added tokens)
            ranks[b] = idx
        return cls(ranks)

    # -- core BPE ----------------------------------------------------------

    def _bpe_merge(self, piece: bytes) -> List[int]:
        # whole-piece fast path, exactly like tiktoken's encode_ordinary: a piece
        # present in the table is emitted directly without running the merge loop
        whole = self.ranks.get(piece)
        if whole is not None:
            return [whole]
        parts = [piece[i:i + 1] for i in range(len(piece))]
        while True:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = self.ranks.get(parts[i] + parts[i + 1])
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_i = i
            if best_rank is None:
                break
            parts[best_i:best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        return [self.ranks[p] for p in parts]

    def encode_ordinary(self, text: str) -> List[int]:
        native = self._get_native()
        ids: List[int] = []
        for piece in pre_tokenize(text):
            b = piece.encode("utf-8")
            if native is not None:
                got = native.encode_piece(b)
                if got is not None:
                    ids.extend(got)
                    continue
                # the native core bounds its output buffer (4096 ids/piece);
                # an overlong unmergeable piece falls back to the pure-Python
                # merge instead of erroring ('z'*5000)
            ids.extend(self._bpe_merge(b))
        return ids

    def decode_bytes(self, ids: Iterable[int]) -> bytes:
        return b"".join(self.decoder[i] for i in ids if i in self.decoder)

    def decode(self, ids: Iterable[int]) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")

    # -- native core -------------------------------------------------------

    def _get_native(self):
        if not self._native_tried:
            self._native_tried = True
            try:
                from . import _bpe_native

                self._native = _bpe_native.build(self.ranks)
            except Exception:
                self._native = None
        return self._native


@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode mapping."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def toy_ranks(n_merges: int = 64) -> Dict[bytes, int]:
    """A miniature deterministic rank table for tests: all 256 bytes plus common
    English bigram/trigram merges derived from a fixed corpus."""
    ranks = {bytes([b]): b for b in range(256)}
    corpus = (b"the quick brown fox jumps over the lazy dog "
              b"artificial intelligence is for real "
              b"she had your dark suit in greasy wash water all year ")
    # count adjacent pairs greedily, mimicking BPE training just enough for tests
    next_rank = 256
    parts = [corpus[i:i + 1] for i in range(len(corpus))]
    for _ in range(n_merges):
        counts: Dict[bytes, int] = {}
        for a, b in zip(parts, parts[1:]):
            if a == b" " or b == b" ":
                continue
            counts[a + b] = counts.get(a + b, 0) + 1
        if not counts:
            break
        best = max(sorted(counts), key=lambda k: counts[k])
        if counts[best] < 2:
            break
        ranks[best] = next_rank
        next_rank += 1
        merged: List[bytes] = []
        i = 0
        while i < len(parts):
            if i + 1 < len(parts) and parts[i] + parts[i + 1] == best:
                merged.append(best)
                i += 2
            else:
                merged.append(parts[i])
                i += 1
        parts = merged
    return ranks
