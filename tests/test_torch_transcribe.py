"""The port's long-form ``transcribe`` against the JAX package's, on the CPU,
with JAX weights carried across (f32, tiny dims: ``n_audio_ctx=24``, so a
window is 0.48 s).

Every case of tests/test_transcribe.py has its counterpart here, each also
holding the port's result dict against JAX ``transcribe``'s on the same
audio. Tolerances: the text, the language, every segment's id, seek,
start, end, text, tokens and temperature, and every word's text, tokens,
start and end are equal; ``avg_logprob``, ``compression_ratio``,
``no_speech_prob`` and the word probabilities agree within 2e-4 (the JAX
suite's model tolerance). The fallback ladder samples with JAX's own
noise, put in through ``beam.noise_source``: the stand-in reads the
window's seek back from its generator's ``initial_seed()``
(``transcribe.window_seed``) and returns ``jax.random.gumbel(fold_in(
fold_in(PRNGKey(seed), seek), position))``, the noise JAX's window draws.

Beside them: the seek branches on planted decode results fed to both
packages (consecutive timestamp pairs, a single timestamp ending, no
timestamps, a trailing timestamp, the degenerate zero advance),
``decode_with_fallback`` and ``api.align_long`` against JAX's, and the
alignment-heads check of word timestamps.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_char_alignment_tpu import api as japi
from whisper_char_alignment_tpu import transcribe as JT
from whisper_char_alignment_tpu.config import tiny_test_dims
from whisper_char_alignment_tpu.models import decoding as jdec
from whisper_char_alignment_tpu.models import whisper as jw
from whisper_char_alignment_tpu.text.tokenizer import \
    get_test_tokenizer as jax_tokenizer
from whisper_char_alignment_tpu_torch import api as tapi
from whisper_char_alignment_tpu_torch import constants
from whisper_char_alignment_tpu_torch import transcribe as T
from whisper_char_alignment_tpu_torch.audio.mel import (log_mel_spectrogram,
                                                        pad_or_trim)
from whisper_char_alignment_tpu_torch.config import ModelDims
from whisper_char_alignment_tpu_torch.models import beam as tbeam
from whisper_char_alignment_tpu_torch.models import convert as tconvert
from whisper_char_alignment_tpu_torch.models import decoding
from whisper_char_alignment_tpu_torch.text.tokenizer import get_test_tokenizer

torch.set_num_threads(1)

TOL = 2e-4


def _port(params, dims):
    return tconvert.model_from_state_dict(
        tconvert.params_from_jax(jax.tree.map(np.asarray, params)),
        ModelDims(**dataclasses.asdict(dims)), device="cpu")


@functools.lru_cache(maxsize=None)
def _setup():
    tok = get_test_tokenizer()
    dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=24, n_text_ctx=32,
                          state=16, head=2, layers=2)
    params = jw.init_params(jax.random.PRNGKey(3), dims)
    return tok, dims, params, _port(params, dims)


@pytest.fixture
def setup():
    return _setup()


def _audio(seconds, seed=0):
    n = int(constants.SAMPLE_RATE * seconds)
    return np.random.default_rng(seed).normal(0, 0.1, n).astype(np.float32)


def _windows(dims, k, seed=0):
    window_samples = 2 * dims.n_audio_ctx * constants.HOP_LENGTH
    return _audio(k * window_samples / constants.SAMPLE_RATE, seed)


def jax_window_noise(seed: int = 0):
    """``beam.noise_source``'s stand-in: the Gumbel noise JAX's window at
    ``seek`` draws, ``fold_in(fold_in(PRNGKey(seed), seek), position)``, the
    seek read back from the generator's seed."""
    def source(generator, rows, n_vocab):
        s = generator.initial_seed()
        assert s >> 32 == seed
        rng = jax.random.fold_in(jax.random.PRNGKey(seed), s & 0xFFFFFFFF)
        return lambda i: torch.from_numpy(np.array(jax.random.gumbel(
            jax.random.fold_in(rng, i), (rows, n_vocab), jnp.float32)))
    return source


def both(audio, jax_kwargs=None, **kwargs):
    """The JAX package's and the port's transcribe of ``audio``."""
    tok, dims, params, model = _setup()
    want = JT.transcribe(params, dims, jax_tokenizer(), audio,
                         **(jax_kwargs or {}), **kwargs)
    got = T.transcribe(model, tok, audio, device="cpu", **kwargs)
    return got, want


def assert_like_jax(got: dict, want: dict):
    assert got["text"] == want["text"]
    assert got["language"] == want["language"]
    assert len(got["segments"]) == len(want["segments"])
    for g, w in zip(got["segments"], want["segments"]):
        assert sorted(g) == sorted(w)
        for k in ("id", "seek", "start", "end", "text", "tokens",
                  "temperature"):
            assert g[k] == w[k], k
        for k in ("avg_logprob", "compression_ratio", "no_speech_prob"):
            assert g[k] == pytest.approx(w[k], abs=TOL), k
        if "words" in w:
            assert len(g["words"]) == len(w["words"])
            for gw, ww in zip(g["words"], w["words"]):
                for k in ("word", "tokens", "start", "end"):
                    assert gw[k] == ww[k], k
                if ww["probability"] is None:
                    assert gw["probability"] is None
                else:
                    assert gw["probability"] == pytest.approx(
                        ww["probability"], abs=TOL)


GATES_OFF = dict(temperature=0.0, compression_ratio_threshold=None,
                 logprob_threshold=None, no_speech_threshold=None,
                 language="en")


def test_single_window_matches_direct_decode(setup):
    """With the gates off, a one-window transcribe is a greedy decode of the
    padded window; the segment tokens concatenate to a prefix of it."""
    tok, dims, _, model = setup
    window_samples = 2 * dims.n_audio_ctx * constants.HOP_LENGTH
    audio = _windows(dims, 0.8)
    got, want = both(audio, **GATES_OFF, sample_len=8)
    assert_like_jax(got, want)
    mel = log_mel_spectrogram(torch.from_numpy(
        pad_or_trim(audio, window_samples)), n_mels=dims.n_mels)
    ref = decoding.decode(model, tok, mel, decoding.DecodingOptions(
        language="en", sample_len=8), device="cpu")
    cat = [t for s in got["segments"] for t in s["tokens"]]
    assert cat and ref.tokens[:len(cat)] == cat
    assert got["language"] == "en"
    assert got["text"] == tok.decode([t for t in cat if t < tok.eot])


def test_multi_window_covers_audio(setup):
    tok, dims, _, _ = setup
    audio = _windows(dims, 2.6, seed=1)
    got, want = both(audio, **GATES_OFF, sample_len=8,
                     without_timestamps=True)
    assert_like_jax(got, want)
    segs = got["segments"]
    assert segs
    for k, s in enumerate(segs):
        assert s["id"] == k
        assert 0.0 <= s["start"] <= s["end"]
    seeks = [s["seek"] for s in segs]
    assert seeks[0] == 0 and seeks == sorted(seeks)
    assert sorted(set(seeks)) == [0, 48, 96], seeks


def test_fallback_ladder_reaches_last_temperature(setup, monkeypatch):
    """An unsatisfiable compression gate walks the ladder to its last
    temperature, sampling JAX's noise."""
    monkeypatch.setattr(tbeam, "noise_source", jax_window_noise())
    got, want = both(_audio(0.3, seed=2), temperature=(0.0, 0.7),
                     compression_ratio_threshold=-1.0,
                     logprob_threshold=None, no_speech_threshold=None,
                     language="en", sample_len=6)
    assert_like_jax(got, want)
    assert got["segments"]
    assert all(s["temperature"] == 0.7 for s in got["segments"])


def test_full_ladder_with_word_timestamps_on_jax_noise(setup, monkeypatch):
    """The published ladder (0.0 ... 1.0) with its default gates, which
    random weights fail, conditioning on previous text and word timestamps
    over three windows: every rung samples JAX's noise of its window."""
    tok, dims, _, _ = setup
    monkeypatch.setattr(tbeam, "noise_source", jax_window_noise())
    got, want = both(_windows(dims, 2.4, seed=8), language="en",
                     sample_len=6, word_timestamps=True, word_aggr="topk")
    assert_like_jax(got, want)
    assert any(s["temperature"] > 0.5 for s in got["segments"])


def test_seed_moves_the_noise(setup, monkeypatch):
    """``seed`` is the port's ``rng``: JAX's ``PRNGKey(5)`` windows on the
    port's seed 5."""
    tok, dims, params, model = setup
    monkeypatch.setattr(tbeam, "noise_source", jax_window_noise(5))
    kwargs = dict(temperature=(0.0, 0.9), compression_ratio_threshold=-1.0,
                  logprob_threshold=None, no_speech_threshold=None,
                  language="en", sample_len=6)
    audio = _windows(dims, 1.5, seed=9)
    want = JT.transcribe(params, dims, jax_tokenizer(), audio,
                         rng=jax.random.PRNGKey(5), **kwargs)
    got = T.transcribe(model, tok, audio, device="cpu", seed=5, **kwargs)
    assert_like_jax(got, want)


def test_window_seed_reads_back():
    s = T.window_seed(7, 1234)
    gen = torch.Generator().manual_seed(s)
    assert gen.initial_seed() >> 32 == 7
    assert gen.initial_seed() & 0xFFFFFFFF == 1234
    assert T.window_seed(0, 96) != T.window_seed(1, 96) != T.window_seed(0, 48)


def test_prompt_conditioning_plumbing(setup, monkeypatch):
    """The second window's decode receives the first window's tokens as its
    prompt (none when conditioning is off); an initial_prompt seeds the
    first window. The prompts equal the JAX package's."""
    tok, dims, params, model = setup
    audio = _windows(dims, 2.4, seed=3)
    seen, seen_jax = [], []
    real, real_jax = decoding.decode, jdec.decode

    def spy(model_, tok_, mel_, options=None, **kw):
        seen.append(options.prompt)
        return real(model_, tok_, mel_, options, **kw)

    def spy_jax(params_, dims_, tok_, mel_, options=None, **kw):
        seen_jax.append(options.prompt)
        return real_jax(params_, dims_, tok_, mel_, options, **kw)

    monkeypatch.setattr(decoding, "decode", spy)
    monkeypatch.setattr(jdec, "decode", spy_jax)
    common = dict(GATES_OFF, sample_len=6)
    for extra in ({}, dict(condition_on_previous_text=False),
                  dict(initial_prompt="hello")):
        seen.clear()
        seen_jax.clear()
        got, want = both(audio, **common, **extra)
        assert_like_jax(got, want)
        assert seen == seen_jax
        if not extra:
            assert seen[0] is None
            if len(seen) > 1:
                assert seen[1] is not None and len(seen[1]) > 0
        elif "initial_prompt" in extra:
            assert seen[0] == tok.encode(" hello")
        else:
            assert all(p is None for p in seen)


def test_no_speech_skip(setup, monkeypatch):
    """A window whose no_speech_prob crosses the threshold (without a
    confident logprob) gives no segment, in both packages."""
    real, real_jax = decoding.decode, jdec.decode

    def spy(*a, **kw):
        r = real(*a, **kw)
        r.no_speech_prob, r.avg_logprob = 0.99, -5.0
        return r

    def spy_jax(*a, **kw):
        r = real_jax(*a, **kw)
        r.no_speech_prob, r.avg_logprob = 0.99, -5.0
        return r

    monkeypatch.setattr(decoding, "decode", spy)
    monkeypatch.setattr(jdec, "decode", spy_jax)
    got, want = both(_audio(0.3, seed=4), temperature=0.0,
                     compression_ratio_threshold=None,
                     logprob_threshold=-1.0, no_speech_threshold=0.6,
                     language="en", sample_len=6)
    assert got == want == {"text": "", "segments": [], "language": "en"}


@pytest.mark.parametrize("aggr", ["default", "topk"])
def test_word_timestamps(setup, aggr):
    """Per-word intervals tile the segment tokens, with probabilities on
    the default-heads path; word times equal the JAX package's."""
    tok, dims, _, _ = setup
    got, want = both(_windows(dims, 1.6, seed=5), **GATES_OFF, sample_len=6,
                     without_timestamps=True, word_timestamps=True,
                     word_aggr=aggr)
    assert_like_jax(got, want)
    segs = [s for s in got["segments"] if s.get("words")]
    assert segs, "no segment got word timings"
    for s in segs:
        n_text = sum(1 for t in s["tokens"] if t < tok.eot)
        assert sum(len(w["tokens"]) for w in s["words"]) == n_text >= 1
        starts = [w["start"] for w in s["words"]]
        ends = [w["end"] for w in s["words"]]
        assert all(a <= b + 1e-9 for a, b in zip(starts, ends))
        assert starts == sorted(starts)
        assert s["start"] == starts[0] and s["end"] == ends[-1]
        for w in s["words"]:
            assert (w["probability"] is None) == (aggr == "topk")


def test_word_timestamps_need_fitting_heads(setup):
    """The default word timing with a head table that does not fit the
    decoder raises before any decode (the JAX package clamps the indices);
    the top-k heads need no table."""
    tok, dims, _, model = setup
    with pytest.raises(ValueError, match="alignment heads"):
        T.transcribe(model, tok, _audio(0.3), device="cpu",
                     word_timestamps=True, model_name="medium", **GATES_OFF)
    out = T.transcribe(model, tok, _audio(0.3), device="cpu",
                       word_timestamps=True, word_aggr="topk",
                       model_name="medium", sample_len=4, **GATES_OFF)
    assert "segments" in out


def test_empty_and_subhop_audio_runs_zero_windows(setup):
    for n in (0, constants.HOP_LENGTH - 1):
        got, want = both(np.zeros((n,), np.float32), language="en",
                         sample_len=4)
        assert got == want == {"text": "", "segments": [], "language": "en"}


def test_merge_punctuations_unit():
    words = [
        {"word": " (", "tokens": [1], "start": 0.0, "end": 0.1,
         "probability": None},
        {"word": " hi", "tokens": [2], "start": 0.1, "end": 0.2,
         "probability": None},
        {"word": "!", "tokens": [3], "start": 0.2, "end": 0.3,
         "probability": None},
        {"word": " there", "tokens": [4], "start": 0.3, "end": 0.4,
         "probability": None},
        {"word": " \"", "tokens": [5], "start": 0.4, "end": 0.5,
         "probability": None},
    ]
    out = T._merge_punctuations([dict(w) for w in words], T._PREPEND_PUNCT,
                                T._APPEND_PUNCT)
    want = JT._merge_punctuations([dict(w) for w in words],
                                  JT._PREPEND_PUNCT, JT._APPEND_PUNCT)
    assert out == want
    assert [w["word"] for w in out][0] == " ( hi!"
    assert out[0]["tokens"] == [1, 2, 3]
    assert (T._PREPEND_PUNCT, T._APPEND_PUNCT) == (JT._PREPEND_PUNCT,
                                                   JT._APPEND_PUNCT)


def test_user_prompt_kwarg_is_dropped(setup):
    got, want = both(_audio(0.3, seed=6), **GATES_OFF, sample_len=4,
                     prompt=[1, 2, 3])
    assert_like_jax(got, want)
    assert "segments" in got


@pytest.mark.parametrize("bucket", [8, 1])
def test_prompt_bucketing_bounds_signatures(setup, monkeypatch, bucket):
    """The conditioning context is kept in prompt_bucket-token steps (exact
    below one bucket); prompt_bucket=1 keeps exact lengths. The lengths
    equal the JAX package's."""
    tok, dims, _, _ = setup
    seen, seen_jax = [], []
    real, real_jax = decoding.decode, jdec.decode

    def spy(model_, tok_, mel_, options=None, **kw):
        seen.append(0 if options.prompt is None else len(options.prompt))
        return real(model_, tok_, mel_, options, **kw)

    def spy_jax(params_, dims_, tok_, mel_, options=None, **kw):
        seen_jax.append(0 if options.prompt is None else len(options.prompt))
        return real_jax(params_, dims_, tok_, mel_, options, **kw)

    monkeypatch.setattr(decoding, "decode", spy)
    monkeypatch.setattr(jdec, "decode", spy_jax)
    got, want = both(_windows(dims, 3.4, seed=7), **GATES_OFF, sample_len=7,
                     without_timestamps=True, prompt_bucket=bucket)
    assert_like_jax(got, want)
    assert seen == seen_jax and seen[0] == 0
    assert any(n > 0 for n in seen), "conditioning never engaged"
    if bucket > 1:
        assert all(n < bucket or n % bucket == 0 for n in seen), seen


def test_resolved_sot_sequence():
    tok, jtok = get_test_tokenizer(), jax_tokenizer()
    for lang, task in ((None, "transcribe"), ("English", "transcribe"),
                       (tok.all_language_codes[3], "translate")):
        assert (T._resolved_sot_sequence(tok, lang, task)
                == JT._resolved_sot_sequence(jtok, lang, task))
    assert T._resolved_sot_sequence(tok, None, "transcribe") == list(
        tok.sot_sequence)
    sot = T._resolved_sot_sequence(tok, tok.all_language_codes[3],
                                   "translate")
    assert sot[1] == tok.sot + 1 + 3 and sot[2] == tok.translate


def test_invalid_beam_patience_rejected(setup):
    tok, dims, _, model = setup
    mel = torch.zeros((dims.n_mels, 2 * dims.n_audio_ctx))
    with pytest.raises(ValueError):
        decoding.decode(model, tok, mel, decoding.DecodingOptions(
            language="en", beam_size=2, patience=0.2), device="cpu")
    with pytest.raises(ValueError):
        T.transcribe(model, tok, _audio(0.3), device="cpu", beam_size=2,
                     patience=0.2, **GATES_OFF)


def test_cli_str2bool():
    import argparse

    from whisper_char_alignment_tpu.cli.transcribe import str2bool as jax_s2b
    from whisper_char_alignment_tpu_torch.cli.transcribe import str2bool

    for s in ("False", "false", "0", "no", "True", "true", "1", "yes"):
        assert str2bool(s) is jax_s2b(s)
    assert str2bool("False") is False and str2bool("True") is True
    with pytest.raises(argparse.ArgumentTypeError):
        str2bool("nope")


def test_transcribe_with_beam_multi_window(setup):
    """Beam search composes with the seek loop and conditioning (the ladder
    keeps beam options only at t=0)."""
    tok, dims, _, _ = setup
    got, want = both(_windows(dims, 2.3, seed=11), **GATES_OFF, sample_len=6,
                     beam_size=2, without_timestamps=True)
    assert_like_jax(got, want)
    assert len({s["seek"] for s in got["segments"]}) >= 2
    assert all(s["temperature"] == 0.0 for s in got["segments"])


def test_language_none_detects_first(setup):
    """``language=None`` on the multilingual toy tokenizer runs the detect
    request on the first window; the detected code equals JAX's."""
    tok, dims, _, _ = setup
    got, want = both(_windows(dims, 1.3, seed=12),
                     **dict(GATES_OFF, language=None), sample_len=5)
    assert_like_jax(got, want)
    assert got["language"] in tok.all_language_codes


def test_language_normalized_on_every_path(setup, monkeypatch):
    tok, dims, _, model = setup
    monkeypatch.setattr(tbeam, "noise_source", jax_window_noise())
    empty = np.zeros(10, np.float32)
    got, want = both(empty, language="English")
    assert got == want == {"text": "", "segments": [], "language": "en"}
    for audio in (empty, _audio(0.4)):
        with pytest.raises(ValueError, match="language"):
            T.transcribe(model, tok, audio, device="cpu", language="klingon",
                         sample_len=4, without_timestamps=True)
    got, want = both(_audio(0.4), language="English", sample_len=4,
                     without_timestamps=True)
    assert_like_jax(got, want)
    assert got["language"] == "en"


# ---------------------------------------------------------------------------
# the seek branches on planted decode results
# ---------------------------------------------------------------------------

TS = get_test_tokenizer().timestamp_begin
A, B, C = (get_test_tokenizer().encode(w) for w in (" hello", " world",
                                                   " again"))
PLANTS = {
    # two consecutive-timestamp pairs: two segments, seek by the last pair
    "consecutive pairs": [TS, *A, TS + 5, TS + 5, *B, TS + 12, TS + 12],
    # a pair, then text closed by a single timestamp: the window is consumed
    "single timestamp ending": [TS, *A, TS + 5, TS + 5, *B, TS + 9],
    # no timestamps: one segment over the window
    "no timestamps": [*A, *B, *C],
    # text then one trailing timestamp: its time sets the segment's end
    "trailing timestamp": [*A, *C, TS + 7],
    # <|0.00|><|0.00|>: advancing 0 frames would loop forever
    "degenerate zero advance": [TS, TS],
}


def _planted(tokens, result_cls, options_at: int):
    """A decode returning ``tokens``; its options are positional argument
    ``options_at`` (JAX: params, dims, tokenizer, mel, options)."""
    def fake(*args, **kwargs):
        return result_cls(language="en", tokens=list(tokens), text="x",
                          avg_logprob=-0.25, no_speech_prob=0.1,
                          temperature=args[options_at].temperature,
                          compression_ratio=1.0)
    return fake


@pytest.mark.parametrize("case", sorted(PLANTS))
def test_seek_branches_on_planted_decodes(setup, monkeypatch, case):
    """The same planted decode result in every window of both packages:
    the segments, their times and seeks, and each window's word timings
    (default heads) equal the JAX package's."""
    tok, dims, _, _ = setup
    monkeypatch.setattr(decoding, "decode",
                        _planted(PLANTS[case], decoding.DecodingResult, 3))
    monkeypatch.setattr(jdec, "decode",
                        _planted(PLANTS[case], jdec.DecodingResult, 4))
    got, want = both(_windows(dims, 2.5, seed=13), **GATES_OFF,
                     word_timestamps=True)
    assert_like_jax(got, want)
    seeks = sorted({s["seek"] for s in got["segments"]})
    if case == "consecutive pairs":
        assert seeks == [0, 24, 48, 72, 96] and len(got["segments"]) == 10
    else:
        assert seeks == [0, 48, 96]
    if case != "degenerate zero advance":
        assert all(s.get("words") for s in got["segments"])


def test_decode_with_fallback_matches_jax(setup, monkeypatch):
    """The library helper: the first passing rung, sampled on JAX's noise
    of ``fold_in(PRNGKey(0), 0)``, the window at seek 0."""
    tok, dims, params, model = setup
    monkeypatch.setattr(tbeam, "noise_source", jax_window_noise())
    mel = np.random.default_rng(14).normal(
        0, 1, (dims.n_mels, 2 * dims.n_audio_ctx)).astype(np.float32)
    opts = dict(language="en", sample_len=6)
    want = JT.decode_with_fallback(
        params, dims, jax_tokenizer(), mel, jdec.DecodingOptions(**opts),
        (0.0, 0.4, 0.8), -1.0, None, None,
        rng=jax.random.fold_in(jax.random.PRNGKey(0), 0))
    got = T.decode_with_fallback(
        model, tok, torch.from_numpy(mel), decoding.DecodingOptions(**opts),
        (0.0, 0.4, 0.8), -1.0, None, None, device="cpu",
        seed=T.window_seed(0, 0))
    assert got.tokens == want.tokens and got.temperature == 0.8
    assert got.avg_logprob == pytest.approx(want.avg_logprob, abs=TOL)


# ---------------------------------------------------------------------------
# the api: align_long and transcribe
# ---------------------------------------------------------------------------

def _pin(pipeline_cls):
    """``AlignmentPipeline`` whose transcripts are pinned per chunk (random
    weights transcribe empty, which would make the comparison vacuous)."""
    words = ("hello world there", "alpha beta", "gamma delta epsilon")

    def make(*a, **k):
        p = pipeline_cls(*a, **k)
        p.transcribe_override = lambda utts: [
            words[int(u.fid.rsplit("#", 1)[-1]) % 3] for u in utts]
        return p
    return make


def test_align_long_matches_jax(setup, monkeypatch):
    """``api.align_long`` over 2.5 windows of the model: three chunks
    aligned through ``run_dataset``, each chunk's eot group dropped and its
    times offset by its window; words and boundaries equal JAX
    ``api.align_long``'s."""
    tok, dims, params, model = setup
    monkeypatch.setattr(tapi, "AlignmentPipeline",
                        _pin(tapi.AlignmentPipeline))
    monkeypatch.setattr(japi, "AlignmentPipeline",
                        _pin(japi.AlignmentPipeline))
    window_s = 2 * dims.n_audio_ctx * constants.HOP_LENGTH / 16000
    audio = _windows(dims, 2.5, seed=15)
    want = japi.align_long(japi.Model(params=params, dims=dims,
                                      tokenizer=jax_tokenizer(), name="t"),
                           audio)
    got = tapi.align_long(tapi.Model(model=model, tokenizer=tok, name="t"),
                          audio, device="cpu")
    assert got.words == want.words and got.words[-1] == "<|endoftext|>"
    np.testing.assert_array_equal(got.start_times, want.start_times)
    np.testing.assert_array_equal(got.end_times, want.end_times)
    assert got.transcription == want.transcription
    assert len(got.end_times) == 3 + 2 + 3
    assert got.end_times.max() <= 3 * window_s + 1e-6
    assert (np.diff(got.start_times) >= -1e-9).all()


def test_api_transcribe_takes_the_model_name(setup, monkeypatch):
    """``api.transcribe`` runs the module's transcribe with the model's
    name as ``model_name``, in the model's dtype or a cast copy."""
    tok, dims, _, model = setup
    seen = {}
    real = T.transcribe

    def spy(net, tok_, audio, **kw):
        seen.update(kw, dtype=next(net.parameters()).dtype)
        return real(net, tok_, audio, **kw)

    monkeypatch.setattr(T, "transcribe", spy)
    m = tapi.Model(model=model, tokenizer=tok, name="t")
    out = tapi.transcribe(m, _audio(0.3), device="cpu", language="en",
                          sample_len=3, without_timestamps=True)
    assert seen["model_name"] == "t" and seen["dtype"] == torch.float32
    assert "segments" in out
    tapi.transcribe(m, _audio(0.3), device="cpu", compute_dtype=torch.bfloat16,
                    language="en", sample_len=3, without_timestamps=True)
    assert seen["dtype"] == torch.bfloat16
    assert next(model.parameters()).dtype == torch.float32
