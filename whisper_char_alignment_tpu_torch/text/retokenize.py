"""Character/subword re-tokenization and text normalization.

Copy of ``whisper_char_alignment_tpu/text/retokenize.py`` for the PyTorch port, which
imports nothing of the JAX package; only imports changed.

Re-implements the reference's retokenize module (reference: retokenize.py) on
top of our tokenizer. ``encode`` emits a char-level token stream with explicit
space tokens between words; ``split_tokens_on_spaces`` inverts unicode-split
tokens back into words; ``remove_punctuation`` strips punctuation (keeping
apostrophes) and spells out digit-only words.

Every quirk here is a tested parity contract (tests/test_text.py): the
explicit-space char stream, the char-mode grouping that ignores punctuation,
and the double-translate that strips the number-speller's hyphens/commas.
"""

from __future__ import annotations

import string
from typing import Iterable, Iterator, List, Tuple

from .numwords import num_to_words

_UNIT_TYPES = ("char", "subword")

# punctuation table with apostrophes retained (reference: retokenize.py:42) —
# built once at import instead of per call
_PUNCT_NO_APOSTROPHE = string.punctuation.replace("'", "")
_DELETE_PUNCT = str.maketrans("", "", _PUNCT_NO_APOSTROPHE)


def _char_pieces(words: List[str]) -> Iterator[str]:
    """Yield the char-mode piece stream: each character of each word, with a
    single explicit " " piece between consecutive words (never trailing)."""
    for i, word in enumerate(words):
        if i:
            yield " "
        yield from word


def encode(text, tokenizer, aligned_unit_type: str = "subword"):
    """Tokenize ``text`` as subwords, or per-character with explicit space
    tokens between words (reference: retokenize.py:5-17)."""
    assert aligned_unit_type in _UNIT_TYPES
    if aligned_unit_type == "subword":
        return tokenizer.encode(text)
    # char mode: every piece (single char or the separator space) is encoded
    # independently, so multi-token chars keep their full token runs
    return [tok
            for piece in _char_pieces(text.split())
            for tok in tokenizer.encode(piece)]


def _char_word_starts(pieces, piece_tokens, eot: int) -> List[bool]:
    """Char-mode word-boundary flags: a new word starts at a special token or
    at an exact-space piece. Deliberately NOT at punctuation — the reference
    computes a ``punctuation`` predicate (retokenize.py:31) but never tests
    it, and that unused-variable behavior is part of the parity contract."""
    flags = []
    for piece, toks in zip(pieces, piece_tokens):
        flags.append(not flags or toks[0] >= eot or piece == " ")
    return flags


def split_tokens_on_spaces(tokens, tokenizer,
                           aligned_unit_type: str = "subword"
                           ) -> Tuple[list, list]:
    """Group unicode-split tokens back into words (reference:
    retokenize.py:19-39). Subword mode delegates to the tokenizer's own word
    splitter; char mode merges every piece into the current word unless a
    boundary flag (see :func:`_char_word_starts`) opens a new one."""
    assert aligned_unit_type in _UNIT_TYPES
    if aligned_unit_type == "subword":
        return tokenizer.split_to_word_tokens(tokens)

    pieces, piece_tokens = tokenizer.split_tokens_on_unicode(tokens)
    starts = _char_word_starts(pieces, piece_tokens, tokenizer.eot)
    words: List[str] = []
    word_tokens: List[list] = []
    for piece, toks, is_start in zip(pieces, piece_tokens, starts):
        if is_start:
            words.append(piece)
            word_tokens.append(list(toks))  # defensive copy of the run
        else:
            words[-1] += piece
            word_tokens[-1].extend(toks)
    return words, word_tokens


def _respell_numbers(words: Iterable[str]) -> Iterator[str]:
    """Digit-only words become spelled-out English; every word is then
    stripped of leading/trailing punctuation (reference: retokenize.py:44-47).
    """
    for word in words:
        spelled = num_to_words(int(word)) if word.isdigit() else word
        yield spelled.strip(string.punctuation)


def remove_punctuation(text: str) -> str:
    """Strip punctuation (keeping apostrophes) and normalize digit-only words
    to spelled-out English (reference: retokenize.py:41-50). The SECOND
    translate is load-bearing: it deletes the hyphens/commas the number
    speller introduces ("42" -> "forty-two" -> "fortytwo")."""
    cleaned = text.translate(_DELETE_PUNCT)
    respelled = " ".join(_respell_numbers(cleaned.split()))
    return respelled.translate(_DELETE_PUNCT)
