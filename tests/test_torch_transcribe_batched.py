"""The port's ``transcribe_batched`` against its solo ``transcribe`` and the
JAX package's, on the CPU, with JAX weights carried across (f32, tiny
dims), mirroring tests/test_transcribe_batched.py.

Batched results equal the port's solo results in every field (tokens,
texts, times, temperatures; float fields within 1e-6, as the JAX suite
holds its own batched-vs-solo), and the JAX package's batched results
within the model tolerance 2e-4 for the float fields. The fallback ladder
samples JAX's noise (``beam.noise_source`` stand-in of
tests/test_torch_transcribe.py), each solo retry with its window's seed as
in the solo loop.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_transcribe import (_audio, _setup, assert_like_jax,
                                   jax_window_noise)
from whisper_char_alignment_tpu import transcribe as JT
from whisper_char_alignment_tpu.models import decoding as jdec
from whisper_char_alignment_tpu.text.tokenizer import \
    get_test_tokenizer as jax_tokenizer
from whisper_char_alignment_tpu_torch import constants
from whisper_char_alignment_tpu_torch import transcribe as T
from whisper_char_alignment_tpu_torch.models import beam as tbeam
from whisper_char_alignment_tpu_torch.models import decoding

torch.set_num_threads(1)


@pytest.fixture
def setup():
    return _setup()


def _window_s(dims):
    return 2 * dims.n_audio_ctx * constants.HOP_LENGTH / constants.SAMPLE_RATE


def _assert_results_match(solo, batched):
    assert solo["text"] == batched["text"]
    assert solo["language"] == batched["language"]
    assert len(solo["segments"]) == len(batched["segments"])
    for s, b in zip(solo["segments"], batched["segments"]):
        for k in ("id", "seek", "start", "end", "text", "tokens",
                  "temperature"):
            assert s[k] == b[k], k
        for k in ("avg_logprob", "compression_ratio", "no_speech_prob"):
            assert s[k] == pytest.approx(b[k], abs=1e-6), k


def test_per_row_prompts_match_solo_decodes(setup):
    """``decode`` with per-row prompt lists reproduces each row's solo
    decode with its own prompt, and JAX's batched decode."""
    tok, dims, params, model = setup
    mels = np.random.default_rng(0).normal(
        0, 1, (3, dims.n_mels, 2 * dims.n_audio_ctx)).astype(np.float32)
    prompts = [[5, 6, 7, 8], [9, 10, 11, 12], [6, 9, 5, 11]]
    batched = decoding.decode(model, tok, torch.from_numpy(mels),
                              decoding.DecodingOptions(
                                  language="en", sample_len=6,
                                  prompt=prompts), device="cpu")
    want = jdec.decode(params, dims, jax_tokenizer(), jnp.asarray(mels),
                       jdec.DecodingOptions(language="en", sample_len=6,
                                            prompt=prompts))
    for k in range(3):
        solo = decoding.decode(model, tok, torch.from_numpy(mels[k]),
                               decoding.DecodingOptions(
                                   language="en", sample_len=6,
                                   prompt=prompts[k]), device="cpu")
        assert batched[k].tokens == solo.tokens == want[k].tokens, k
        assert batched[k].text == solo.text == want[k].text
        assert batched[k].avg_logprob == pytest.approx(solo.avg_logprob,
                                                       abs=1e-5)
        assert batched[k].avg_logprob == pytest.approx(want[k].avg_logprob,
                                                       abs=2e-4)


@pytest.mark.parametrize("prompt,match", [
    ([[1, 2], [1, 2, 3]], "one length"), ([[1, 2]], "batch"),
    ([[], []], "non-empty")])
def test_per_row_prompt_validation(setup, prompt, match):
    tok, dims, params, model = setup
    opts = dict(language="en", sample_len=2, prompt=prompt)
    with pytest.raises(ValueError, match=match):
        decoding.decode(model, tok,
                        torch.zeros((2, dims.n_mels, 2 * dims.n_audio_ctx)),
                        decoding.DecodingOptions(**opts), device="cpu")
    with pytest.raises(ValueError, match=match):
        jdec.decode(params, dims, jax_tokenizer(),
                    jnp.zeros((2, dims.n_mels, 2 * dims.n_audio_ctx)),
                    jdec.DecodingOptions(**opts))


def _run(audios, **kwargs):
    tok, dims, params, model = _setup()
    solo = [T.transcribe(model, tok, a, device="cpu", **kwargs)
            for a in audios]
    batched = T.transcribe_batched(model, tok, audios, device="cpu",
                                   **kwargs)
    want = JT.transcribe_batched(params, dims, jax_tokenizer(), audios,
                                 **kwargs)
    assert len(batched) == len(audios) == len(want)
    for s, b, w in zip(solo, batched, want):
        _assert_results_match(s, b)
        assert_like_jax(b, w)
    return solo


@pytest.mark.parametrize("conditioning", [True, False])
def test_batched_matches_solo_multi_window(setup, conditioning):
    """3 audios of 1-3 windows: every request's result dict equals its solo
    transcribe and JAX's batched result."""
    tok, dims, _, _ = setup
    w = _window_s(dims)
    audios = [_audio(0.9 * w, seed=1), _audio(2.4 * w, seed=2),
              _audio(1.7 * w, seed=3)]
    solo = _run(audios, language="en", sample_len=6, temperature=0.0,
                compression_ratio_threshold=None, logprob_threshold=None,
                no_speech_threshold=None,
                condition_on_previous_text=conditioning)
    assert any(len(s["segments"]) > 1 for s in solo)
    assert any(s["text"] for s in solo)
    assert len({s["text"] for s in solo}) > 1


def test_batched_matches_solo_with_fallback_ladder(setup, monkeypatch):
    """With the gates on, random weights trip the fallback: the t > 0
    retries run solo with their window's seed, the same noise as solo."""
    tok, dims, _, _ = setup
    monkeypatch.setattr(tbeam, "noise_source", jax_window_noise())
    w = _window_s(dims)
    solo = _run([_audio(1.6 * w, seed=4), _audio(1.2 * w, seed=5)],
                language="en", sample_len=6, temperature=(0.0, 0.5, 1.0),
                logprob_threshold=-0.2)
    assert any(seg["temperature"] > 0 for s in solo for seg in s["segments"])


def test_batched_word_timestamps_and_detect(setup):
    """Word timestamps and ``language=None`` (one batched detect of the
    first windows) through the batched loop, against solo and JAX."""
    tok, dims, _, _ = setup
    w = _window_s(dims)
    _run([_audio(1.3 * w, seed=6), _audio(0.7 * w, seed=7)],
         language=None, sample_len=5, temperature=0.0,
         compression_ratio_threshold=None, logprob_threshold=None,
         no_speech_threshold=None, word_timestamps=True, word_aggr="topk")


def test_batched_groups_pad_to_pow2(setup, monkeypatch):
    """Three first windows decode as one batch padded to four rows by
    repeating row 0, and ``max_batch`` chunks larger groups."""
    tok, dims, _, _ = setup
    rows = []
    real = decoding.decode

    def spy(model_, tok_, mel_, options=None, **kw):
        rows.append(mel_.shape[0] if mel_.ndim == 3 else 0)
        return real(model_, tok_, mel_, options, **kw)

    monkeypatch.setattr(decoding, "decode", spy)
    audios = [_audio(0.3, seed=s) for s in range(3)]
    kwargs = dict(language="en", sample_len=3, temperature=0.0,
                  compression_ratio_threshold=None, logprob_threshold=None,
                  no_speech_threshold=None, without_timestamps=True)
    T.transcribe_batched(_setup()[3], tok, audios, device="cpu", **kwargs)
    assert rows == [4]
    rows.clear()
    T.transcribe_batched(_setup()[3], tok, audios, device="cpu", max_batch=2,
                         **kwargs)
    assert rows == [2, 1]


def test_pad_pow2():
    assert [T._pad_pow2(n, 8) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 8]
    assert T._pad_pow2(3, 2) == 2
    assert all(T._pad_pow2(n, c) == JT._pad_pow2(n, c)
               for n in range(1, 20) for c in (1, 2, 4, 8, 16))


def test_machine_requests_are_batchable_greedy_only(setup):
    """The seek machine marks t=0 no-beam decodes batchable and everything
    else solo; its request carries the window's seed."""
    tok, dims, _, model = setup
    audio = _audio(0.4)
    gen = T._seek_machine(model, tok, audio, language="en", sample_len=4,
                          temperature=(0.0, 0.8), seed=3, device="cpu")
    req = gen.send(None)
    assert req["kind"] == "decode" and req["batchable"]
    assert req["options"].temperature == 0.0
    assert req["seed"] == T.window_seed(3, 0)
    bad = decoding.DecodingResult(language="en", tokens=[5], text="x",
                                  avg_logprob=-0.1, no_speech_prob=0.0,
                                  temperature=0.0, compression_ratio=99.0)
    req2 = gen.send(bad)
    assert req2["options"].temperature == 0.8 and not req2["batchable"]
    assert req2["seed"] == req["seed"]

    gen_beam = T._seek_machine(model, tok, audio, language="en",
                               sample_len=4, temperature=0.0, beam_size=2,
                               device="cpu")
    assert not gen_beam.send(None)["batchable"]
    gen_detect = T._seek_machine(model, tok, audio, sample_len=4,
                                 device="cpu")
    req3 = gen_detect.send(None)
    assert req3["kind"] == "detect"
    assert tuple(req3["mel_segment"].shape) == (dims.n_mels,
                                                2 * dims.n_audio_ctx)
