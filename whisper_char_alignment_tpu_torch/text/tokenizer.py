"""Whisper tokenizer: BPE base vocab + the special-token layout.

Copy of ``whisper_char_alignment_tpu/text/tokenizer.py`` for the PyTorch port, which
imports nothing of the JAX package; only imports changed.

Replaces ``whisper.tokenizer.get_tokenizer`` (reference call sites: infer_ali.py:41,
69-75; retokenize.py:8-24; timing.py:105,167; plot.py:52). Special-token ids are
computed from the base vocab size exactly as the published tokenizer constructs
them (specials appended after the base ranks in a fixed order), so loading the
published ``gpt2.tiktoken`` / ``multilingual.tiktoken`` files reproduces the exact
ids (multilingual: eot=50257, sot=50258, ...; English: eot=50256, ...).

Assets: point ``tokenizer_dir`` at a directory containing ``multilingual.tiktoken``
or ``gpt2.tiktoken`` (or HF-style ``vocab.json``/``merges.txt``). Without assets, a
deterministic toy vocab is available for tests via ``get_test_tokenizer``.
"""

from __future__ import annotations

import functools
import os
import string
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .bpe import ByteBPE, toy_ranks

# Public language table of the whisper models; ORDER defines the language token ids.
LANGUAGES = {
    "en": "english", "zh": "chinese", "de": "german", "es": "spanish",
    "ru": "russian", "ko": "korean", "fr": "french", "ja": "japanese",
    "pt": "portuguese", "tr": "turkish", "pl": "polish", "ca": "catalan",
    "nl": "dutch", "ar": "arabic", "sv": "swedish", "it": "italian",
    "id": "indonesian", "hi": "hindi", "fi": "finnish", "vi": "vietnamese",
    "he": "hebrew", "uk": "ukrainian", "el": "greek", "ms": "malay",
    "cs": "czech", "ro": "romanian", "da": "danish", "hu": "hungarian",
    "ta": "tamil", "no": "norwegian", "th": "thai", "ur": "urdu",
    "hr": "croatian", "bg": "bulgarian", "lt": "lithuanian", "la": "latin",
    "mi": "maori", "ml": "malayalam", "cy": "welsh", "sk": "slovak",
    "te": "telugu", "fa": "persian", "lv": "latvian", "bn": "bengali",
    "sr": "serbian", "az": "azerbaijani", "sl": "slovenian", "kn": "kannada",
    "et": "estonian", "mk": "macedonian", "br": "breton", "eu": "basque",
    "is": "icelandic", "hy": "armenian", "ne": "nepali", "mn": "mongolian",
    "bs": "bosnian", "kk": "kazakh", "sq": "albanian", "sw": "swahili",
    "gl": "galician", "mr": "marathi", "pa": "punjabi", "si": "sinhala",
    "km": "khmer", "sn": "shona", "yo": "yoruba", "so": "somali",
    "af": "afrikaans", "oc": "occitan", "ka": "georgian", "be": "belarusian",
    "tg": "tajik", "sd": "sindhi", "gu": "gujarati", "am": "amharic",
    "yi": "yiddish", "lo": "lao", "uz": "uzbek", "fo": "faroese",
    "ht": "haitian creole", "ps": "pashto", "tk": "turkmen", "nn": "nynorsk",
    "mt": "maltese", "sa": "sanskrit", "lb": "luxembourgish", "my": "myanmar",
    "bo": "tibetan", "tl": "tagalog", "mg": "malagasy", "as": "assamese",
    "tt": "tatar", "haw": "hawaiian", "ln": "lingala", "ha": "hausa",
    "ba": "bashkir", "jw": "javanese", "su": "sundanese",
}
# large-v3 family appends cantonese; pass n_languages=100 for those tokenizers
LANGUAGES_V3 = {**LANGUAGES, "yue": "cantonese"}

_NAME_TO_CODE = {name: code for code, name in LANGUAGES_V3.items()}
# published alias table (TO_LANGUAGE_CODE extras)
_NAME_TO_CODE.update({
    "burmese": "my", "valencian": "ca", "flemish": "nl", "haitian": "ht",
    "letzeburgesch": "lb", "pushto": "ps", "panjabi": "pa", "moldavian": "ro",
    "moldovan": "ro", "sinhalese": "si", "castilian": "es", "mandarin": "zh",
})

N_TIMESTAMPS = 1501  # <|0.00|> .. <|30.00|> in 0.02 s steps


@dataclass
class WhisperTokenizer:
    bpe: ByteBPE
    multilingual: bool = True
    language: Optional[str] = "en"
    task: Optional[str] = "transcribe"
    n_languages: int = 99

    # special ids, filled in __post_init__
    eot: int = field(init=False)
    sot: int = field(init=False)

    def __post_init__(self):
        base = self.bpe.n_vocab
        langs = list(LANGUAGES_V3)[: self.n_languages]
        self._lang_codes = langs
        self.eot = base  # "<|endoftext|>"
        self.sot = base + 1  # "<|startoftranscript|>"
        self._lang_begin = base + 2
        self.translate = self._lang_begin + self.n_languages
        self.transcribe = self.translate + 1
        self.sot_lm = self.transcribe + 1
        self.sot_prev = self.sot_lm + 1
        self.no_speech = self.sot_prev + 1
        self.no_timestamps = self.no_speech + 1
        self.timestamp_begin = self.no_timestamps + 1
        self.n_vocab = self.timestamp_begin + N_TIMESTAMPS

        self._special_strings: Dict[int, str] = {
            self.eot: "<|endoftext|>",
            self.sot: "<|startoftranscript|>",
            self.translate: "<|translate|>",
            self.transcribe: "<|transcribe|>",
            self.sot_lm: "<|startoflm|>",
            self.sot_prev: "<|startofprev|>",
            self.no_speech: "<|nospeech|>",
            self.no_timestamps: "<|notimestamps|>",
        }
        for i, code in enumerate(langs):
            self._special_strings[self._lang_begin + i] = f"<|{code}|>"

    # -- core --------------------------------------------------------------

    def encode(self, text: str) -> List[int]:
        return self.bpe.encode_ordinary(text)

    def decode(self, token_ids: Sequence[int]) -> str:
        """Decode, dropping timestamp tokens (published tokenizer semantics);
        sub-timestamp specials render as their <|...|> strings."""
        out: List[str] = []
        run: List[int] = []
        for t in token_ids:
            t = int(t)
            if t >= self.timestamp_begin:
                continue
            if t >= self.eot:
                out.append(self.bpe.decode(run))
                run = []
                out.append(self._special_strings.get(t, f"<|special{t}|>"))
            else:
                run.append(t)
        out.append(self.bpe.decode(run))
        return "".join(out)

    def decode_with_timestamps(self, token_ids: Sequence[int]) -> str:
        out: List[str] = []
        run: List[int] = []
        for t in token_ids:
            t = int(t)
            if t >= self.timestamp_begin:
                out.append(self.decode(run))
                run = []
                out.append(f"<|{(t - self.timestamp_begin) * 0.02:.2f}|>")
            else:
                run.append(t)
        out.append(self.decode(run))
        return "".join(out)

    # -- sequence properties -------------------------------------------------

    @property
    def language_token(self) -> int:
        if self.language is None:
            raise ValueError("tokenizer has no language set")
        return self._lang_begin + self._lang_codes.index(self.language)

    @property
    def sot_sequence(self) -> Tuple[int, ...]:
        # published construction: sot, then language token if a language is set,
        # then task token if a task is set
        seq = [self.sot]
        if self.language is not None:
            seq.append(self.language_token)
        if self.task is not None:
            seq.append(self.transcribe if self.task == "transcribe"
                       else self.translate)
        return tuple(seq)

    @property
    def sot_sequence_including_notimestamps(self) -> Tuple[int, ...]:
        return tuple(self.sot_sequence) + (self.no_timestamps,)

    @property
    def all_language_tokens(self) -> Tuple[int, ...]:
        return tuple(self._lang_begin + i for i in range(self.n_languages))

    @property
    def all_language_codes(self) -> Tuple[str, ...]:
        return tuple(self._lang_codes)

    # -- word splitting ------------------------------------------------------

    def split_tokens_on_unicode(self, tokens: Sequence[int]):
        """Group tokens at points where the decoded text forms complete unicode
        (no dangling replacement char from a split multi-byte sequence)."""
        decoded_full = self.decode_with_timestamps(tokens)
        replacement_char = "�"
        words: List[str] = []
        word_tokens: List[List[int]] = []
        current: List[int] = []
        unicode_offset = 0
        for token in tokens:
            current.append(int(token))
            decoded = self.decode_with_timestamps(current)
            if (replacement_char not in decoded or
                    decoded_full[unicode_offset + decoded.index(replacement_char)]
                    == replacement_char):
                words.append(decoded)
                word_tokens.append(current)
                current = []
                unicode_offset += len(decoded)
        return words, word_tokens

    def split_tokens_on_spaces(self, tokens: Sequence[int]):
        subwords, subword_tokens_list = self.split_tokens_on_unicode(tokens)
        words: List[str] = []
        word_tokens: List[List[int]] = []
        for subword, subword_tokens in zip(subwords, subword_tokens_list):
            special = subword_tokens[0] >= self.eot
            with_space = subword.startswith(" ")
            punctuation = subword.strip() in string.punctuation
            if special or with_space or punctuation or len(words) == 0:
                words.append(subword)
                word_tokens.append(subword_tokens)
            else:
                words[-1] = words[-1] + subword
                word_tokens[-1].extend(subword_tokens)
        return words, word_tokens

    def split_to_word_tokens(self, tokens: Sequence[int]):
        if self.language in {"zh", "ja", "th", "lo", "my", "yue"}:
            # no spaces in these scripts: split on unicode points directly
            return self.split_tokens_on_unicode(tokens)
        return self.split_tokens_on_spaces(tokens)

    # -- decoding support ----------------------------------------------------

    @functools.cached_property
    def non_speech_tokens(self) -> Tuple[int, ...]:
        """Single-token non-speech symbols to suppress during decoding
        (published suppress-list construction)."""
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
        symbols += ("<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] "
                    "{{ }} ♪♪ ♪♪♪").split()
        miscellaneous = set("♩♪♫♬♭♮♯")
        result = set()
        for seed in (" -", " '"):
            ids = self.encode(seed)
            if ids:
                result.add(ids[0])
        for symbol in symbols + list(miscellaneous):
            for tokens in [self.encode(symbol), self.encode(" " + symbol)]:
                if len(tokens) == 1 or symbol in miscellaneous:
                    if tokens:
                        result.add(tokens[0])
        return tuple(sorted(result))

    @property
    def is_multilingual(self) -> bool:
        return self.multilingual


def _find_asset(tokenizer_dir: str, names: Sequence[str]) -> Optional[str]:
    for n in names:
        p = os.path.join(tokenizer_dir, n)
        if os.path.exists(p):
            return p
    return None


def normalize_language(language: Optional[str]) -> Optional[str]:
    """'English'/'en'/'EN' -> 'en'; None passes through; ValueError on an
    unknown name/code (the published TO_LANGUAGE_CODE lookup + raise — a bad
    language must never silently decode in the tokenizer's construction-time
    default)."""
    if language is None:
        return None
    lang = language.lower()
    if lang in LANGUAGES_V3:
        return lang
    if lang in _NAME_TO_CODE:
        return _NAME_TO_CODE[lang]
    raise ValueError(f"unsupported language: {language}")


def get_tokenizer(multilingual: bool = True, *, language: Optional[str] = "en",
                  task: Optional[str] = "transcribe",
                  tokenizer_dir: Optional[str] = None,
                  n_languages: int = 99) -> WhisperTokenizer:
    """Build a tokenizer from published assets in ``tokenizer_dir``.

    Accepts language names or codes ("English" -> "en"), like the published API.
    """
    language = normalize_language(language)
    # published defaulting: multilingual fills in en/transcribe; the English-only
    # tokenizer has no language/task (sot_sequence is just (sot,))
    if multilingual:
        language = language or "en"
        task = task or "transcribe"
    else:
        language = None
        task = None
    if tokenizer_dir is None:
        tokenizer_dir = os.environ.get("WCA_TOKENIZER_DIR", "")
    names = (["multilingual.tiktoken"] if multilingual else ["gpt2.tiktoken"])
    asset = _find_asset(tokenizer_dir, names) if tokenizer_dir else None
    if asset is not None:
        bpe = ByteBPE.from_tiktoken_file(asset)
    else:
        vocab = _find_asset(tokenizer_dir, ["vocab.json"]) if tokenizer_dir else None
        if vocab is not None:
            bpe = ByteBPE.from_gpt2_files(vocab)
        else:
            raise FileNotFoundError(
                "no tokenizer assets found; set WCA_TOKENIZER_DIR to a directory "
                "containing multilingual.tiktoken / gpt2.tiktoken / vocab.json, "
                "or use get_test_tokenizer() for the offline toy vocab")
    return WhisperTokenizer(bpe, multilingual=multilingual, language=language,
                            task=task, n_languages=n_languages)


def get_test_tokenizer(multilingual: bool = True, language: str = "en",
                       task: str = "transcribe") -> WhisperTokenizer:
    """Deterministic toy-vocab tokenizer for offline tests (256 bytes + a few
    English merges). Token *ids* differ from the published assets but every
    behavioral contract (special layout, splitting, round-trips) holds."""
    return WhisperTokenizer(ByteBPE(toy_ranks()), multilingual=multilingual,
                            language=language, task=task)
