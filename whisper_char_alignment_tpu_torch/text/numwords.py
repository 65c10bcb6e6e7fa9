"""English number-to-words conversion.

Copy of ``whisper_char_alignment_tpu/text/numwords.py`` for the PyTorch port, which
imports nothing of the JAX package; only imports changed.

Replaces the ``num2words`` dependency of the reference (reference: retokenize.py:2,46
— only ever called as ``num2words(int(wrd))`` on non-negative digit strings). Output
matches num2words' English style: hyphenated tens ("forty-two"), "and" before a
sub-hundred remainder ("one hundred and five", "two thousand and twenty-four"),
comma-separated scale groups ("one thousand, two hundred and thirty-four").
"""

from __future__ import annotations

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    "", "thousand", "million", "billion", "trillion", "quadrillion",
    "quintillion", "sextillion", "septillion", "octillion", "nonillion",
    "decillion",
]


def _under_100(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    if ones:
        return f"{_TENS[tens]}-{_ONES[ones]}"
    return _TENS[tens]


def _under_1000(n: int) -> str:
    hundreds, rest = divmod(n, 100)
    if hundreds == 0:
        return _under_100(rest)
    head = f"{_ONES[hundreds]} hundred"
    if rest:
        return f"{head} and {_under_100(rest)}"
    return head


def num_to_words(n: int) -> str:
    """Spell out a non-negative integer in English."""
    n = int(n)
    if n < 0:
        return "minus " + num_to_words(-n)
    if n == 0:
        return "zero"

    groups = []  # [(value_under_1000, scale_index)] most-significant first
    scale = 0
    while n:
        n, g = divmod(n, 1000)
        if g:
            groups.append((g, scale))
        scale += 1
        if scale >= len(_SCALES):
            raise ValueError("number too large to spell out")
    groups.reverse()

    parts = []
    for g, s in groups:
        text = _under_1000(g)
        if s:
            text = f"{text} {_SCALES[s]}"
        parts.append((text, g, s))

    out = parts[0][0]
    for text, g, s in parts[1:]:
        # num2words joins a trailing sub-hundred group with " and ", others with ", "
        if s == 0 and g < 100:
            out = f"{out} and {text}"
        else:
            out = f"{out}, {text}"
    return out
