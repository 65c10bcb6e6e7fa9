"""Differential fuzz of the port's long-form ``transcribe`` seek loop.

The same method as tests/test_transcribe_fuzz.py, whose oracle (a line by
line transcription of openai-whisper's published seek loop over scripted
decode outcomes) and script generator this file imports: the port's
``transcribe`` runs with ``decoding.decode`` stubbed by the script
(``transcribe.py``'s one decode call), on a tiny CPU model whose weights
are never read (only its device and dims), and every result is held field
by field against the oracle and against the JAX package's ``transcribe``
fed the same script. The 60 random configurations are JAX's, draw for draw
(ladder length, gates on and off, conditioning, initial prompts, timestamp
patterns with consecutive pairs, single-timestamp endings, ``<|0.00|>``
finals and empty outputs); each is its own case here.
"""

import numpy as np
import pytest
import torch

from tests.test_transcribe_fuzz import (LADDERS, _compare, _make_script,
                                        published_transcribe)
from whisper_char_alignment_tpu import transcribe as JT
from whisper_char_alignment_tpu.config import tiny_test_dims as jax_dims
from whisper_char_alignment_tpu.models import decoding as jdec
from whisper_char_alignment_tpu.text.tokenizer import \
    get_test_tokenizer as jax_tokenizer
from whisper_char_alignment_tpu_torch import constants
from whisper_char_alignment_tpu_torch import transcribe as T
from whisper_char_alignment_tpu_torch.config import tiny_test_dims
from whisper_char_alignment_tpu_torch.models import decoding
from whisper_char_alignment_tpu_torch.models import whisper as tw
from whisper_char_alignment_tpu_torch.text.tokenizer import get_test_tokenizer

torch.set_num_threads(1)

# JAX's draws: its test seeds each configuration from this master generator
_MASTER = np.random.default_rng(20260818)
DRAW_SEEDS = [int(_MASTER.integers(2**63)) for _ in range(60)]


@pytest.fixture(scope="module")
def port():
    tok, jtok = get_test_tokenizer(), jax_tokenizer()
    kw = dict(n_vocab=tok.n_vocab, n_audio_ctx=24, n_text_ctx=32, state=16,
              head=2, layers=2)
    model = tw.init_params(tw.Whisper(tiny_test_dims(**kw), device="cpu"),
                           torch.Generator().manual_seed(0))
    return tok, jtok, model, jax_dims(**kw)


def _stub(monkeypatch, module, result_cls, tok, script, temperatures,
          options_at: int):
    """``module.decode`` replays ``script``: a window begins where the
    ladder restarts at its first temperature. Returns the prompts each
    window's decode received."""
    state, prompts = {"w": -1}, []

    def decode(*args, **kwargs):
        options = (args[options_at] if len(args) > options_at
                   else kwargs["options"])
        t = float(options.temperature)
        if t == float(temperatures[0]):
            state["w"] += 1
            prompts.append(None if options.prompt is None
                           else list(options.prompt))
        tokens, avg_lp, cr, nsp = script[(state["w"], t)]
        return result_cls(
            language="en", tokens=list(tokens),
            text=tok.decode([x for x in tokens if x < tok.eot]),
            avg_logprob=avg_lp, no_speech_prob=nsp, temperature=t,
            compression_ratio=cr)

    monkeypatch.setattr(module, "decode", decode)
    return prompts


def _both(port, monkeypatch, audio, script, temperatures, **kwargs):
    """The port's and JAX's ``transcribe`` on the same script: (port
    result, its prompts, JAX result, its prompts)."""
    tok, jtok, model, dims = port
    prompts = _stub(monkeypatch, decoding, decoding.DecodingResult, tok,
                    script, temperatures, 3)
    got = T.transcribe(model, tok, audio, device="cpu",
                       temperature=temperatures, language="en", **kwargs)
    jax_prompts = _stub(monkeypatch, jdec, jdec.DecodingResult, jtok, script,
                        temperatures, 4)
    want = JT.transcribe(None, dims, jtok, audio, temperature=temperatures,
                         language="en", **kwargs)
    return got, prompts, want, jax_prompts


@pytest.mark.parametrize("draw", range(len(DRAW_SEEDS)))
def test_seek_loop_matches_published_oracle(port, monkeypatch, draw):
    """One of JAX's 60 configurations (``prompt_bucket=1``: the published
    exact-length conditioning context): the port's result equals the
    oracle's field by field and JAX ``transcribe``'s on the same script,
    and each window's decode got the published prompt."""
    tok, jtok, model, dims = port
    window_frames = 2 * dims.n_audio_ctx
    rng = np.random.default_rng(DRAW_SEEDS[draw])
    temperatures = LADDERS[rng.integers(0, len(LADDERS))]
    crt = float(rng.uniform(1.0, 2.5)) if rng.random() < 0.7 else None
    lpt = float(rng.uniform(-1.5, -0.5)) if rng.random() < 0.7 else None
    nst = float(rng.uniform(0.3, 0.9)) if rng.random() < 0.7 else None
    cond = bool(rng.random() < 0.8)
    initial_prompt = "seed words" if rng.random() < 0.3 else None
    n_samples = int(rng.integers(
        int(0.4 * window_frames), int(3.6 * window_frames))
    ) * constants.HOP_LENGTH
    audio = rng.normal(0, 0.05, n_samples).astype(np.float32)
    content_frames = audio.size // constants.HOP_LENGTH
    script = _make_script(rng, jtok, temperatures, content_frames // 2 + 2,
                          max(2, window_frames // 4))

    got, prompts, want, jax_prompts = _both(
        port, monkeypatch, audio, script, temperatures,
        compression_ratio_threshold=crt, logprob_threshold=lpt,
        no_speech_threshold=nst, condition_on_previous_text=cond,
        initial_prompt=initial_prompt, prompt_bucket=1)
    initial_tokens = (jtok.encode(" " + initial_prompt.strip())
                      if initial_prompt else [])
    exp = published_transcribe(
        lambda w, t: script[(w, float(t))], content_frames, window_frames,
        jtok, temperatures, crt, lpt, nst, cond, initial_tokens)
    _compare(got, exp, tok)
    assert prompts == exp["prompts"], (draw, prompts, exp["prompts"])
    assert got == want and prompts == jax_prompts
    assert got["language"] == "en"


def test_prompt_bucketing_is_a_published_prompt_suffix(port, monkeypatch):
    """With the default ``prompt_bucket=32`` every conditioning prompt is a
    bucket-aligned suffix of the published exact context (the whole context
    when shorter than a bucket), at most 192 tokens, the segments are the
    oracle's, and the port equals JAX on the same script."""
    tok, jtok, model, dims = port
    window_frames = 2 * dims.n_audio_ctx
    rng = np.random.default_rng(7)
    temperatures = (0.0,)
    n_samples = int(3.2 * window_frames) * constants.HOP_LENGTH
    audio = rng.normal(0, 0.05, n_samples).astype(np.float32)
    content_frames = audio.size // constants.HOP_LENGTH
    script = _make_script(rng, jtok, temperatures, content_frames // 2 + 2,
                          max(2, window_frames // 4))

    got, prompts, want, jax_prompts = _both(
        port, monkeypatch, audio, script, temperatures,
        compression_ratio_threshold=None, logprob_threshold=None,
        no_speech_threshold=None, prompt_bucket=32)
    exp = published_transcribe(
        lambda w, t: script[(w, float(t))], content_frames, window_frames,
        jtok, temperatures, None, None, None, True, [])
    _compare(got, exp, tok)
    assert got == want and prompts == jax_prompts
    assert len(prompts) == len(exp["prompts"])
    for p, full in zip(prompts, exp["prompts"]):
        full, p = full or [], p or []
        assert p == full[len(full) - len(p):]  # a suffix
        assert len(p) <= 192
        if len(full) >= 32:
            assert len(p) % 32 == 0
        else:
            assert p == full
