"""The port's decode options against the JAX package's, on the CPU, with JAX
weights carried across (f32, tiny dims): conditioning, language detection
and the published option validation.

- ``_decode_plan``: the initial tokens (sot sequence, ``[sot_prev] +
  prompt``, prefix, their published trims and truthiness guards, per-row
  prompts, detected languages patched per row) equal JAX's;
- ``decode`` with a prompt (string, tokens, per row) and a prefix (string,
  tokens), through the greedy and the beam loop: tokens, texts, languages
  and ``n_steps`` equal, scores within 2e-4 (the JAX suite's model
  tolerance);
- ``detect_language``: codes equal and probabilities within 2e-4, from a
  mel or from the decode's own encoder states; ``language=None`` decodes
  each row in its detected language and reports it;
- every ValueError of the plan and of ``_verify_options`` fires where
  JAX's does;
- the pipeline (``AlignmentPipeline.run_dataset``) with beam search and
  with sampling (JAX's noise put in) gives JAX's transcripts, words and
  boundaries; the capture pass recomputes the cross K/V the beam loop
  does not return.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_char_alignment_tpu import api as japi
from whisper_char_alignment_tpu import runner as jrunner
from whisper_char_alignment_tpu.config import AlignConfig as JaxAlignConfig
from whisper_char_alignment_tpu.config import tiny_test_dims
from whisper_char_alignment_tpu.data.dataset import TIMIT as JaxTIMIT
from whisper_char_alignment_tpu.data.synthetic import make_timit_corpus
from whisper_char_alignment_tpu.models import decoding as jdec
from whisper_char_alignment_tpu.models import whisper as jw
from whisper_char_alignment_tpu.text.tokenizer import \
    get_test_tokenizer as jax_tokenizer
from whisper_char_alignment_tpu_torch import runner as trunner
from whisper_char_alignment_tpu_torch.config import AlignConfig, ModelDims
from whisper_char_alignment_tpu_torch.data.dataset import TIMIT
from whisper_char_alignment_tpu_torch.models import beam as tbeam
from whisper_char_alignment_tpu_torch.models import convert as tconvert
from whisper_char_alignment_tpu_torch.models import decoding as tdec
from whisper_char_alignment_tpu_torch.models import whisper as tw
from whisper_char_alignment_tpu_torch.text.tokenizer import get_test_tokenizer

torch.set_num_threads(1)


def _port(params, dims):
    return tconvert.model_from_state_dict(
        tconvert.params_from_jax(jax.tree.map(np.asarray, params)),
        ModelDims(**dataclasses.asdict(dims)), device="cpu")


@functools.lru_cache(maxsize=None)
def _setup():
    tok = get_test_tokenizer()
    dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=32, n_text_ctx=48,
                          state=16, head=2, layers=2)
    params = jw.init_params(jax.random.PRNGKey(3), dims)
    mel = np.random.default_rng(0).normal(
        0, 1, (3, dims.n_mels, 2 * dims.n_audio_ctx)).astype(np.float32)
    return tok, dims, params, _port(params, dims), mel


@pytest.fixture
def setup():
    return _setup()


def assert_like_jax(got, want):
    if not isinstance(got, list):
        got, want = [got], [want]
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.text for r in got] == [r.text for r in want]
    assert [r.language for r in got] == [r.language for r in want]
    assert [r.n_steps for r in got] == [r.n_steps for r in want]
    np.testing.assert_allclose([r.avg_logprob for r in got],
                               [r.avg_logprob for r in want], rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose([r.no_speech_prob for r in got],
                               [r.no_speech_prob for r in want], rtol=0,
                               atol=2e-4)


ROWS = [[5, 6, 7], [9, 10, 11], [12, 13, 14]]
PLANS = {
    "plain": dict(language="en"),
    "no timestamps": dict(language="en", without_timestamps=True),
    "prompt str": dict(language="en", prompt="alpha beta"),
    "prompt tokens": dict(language="en", prompt=[9, 11, 300]),
    "prompt trimmed": dict(language="en", prompt=list(range(100, 140))),
    "prefix str": dict(language="en", prefix=" hello "),
    "prefix tokens": dict(language="en", prefix=[5, 7]),
    "prefix trimmed": dict(language="en", prefix=list(range(50, 60)),
                           sample_len=20),
    "prompt and prefix": dict(language="en", prompt="alpha", prefix="ab",
                              without_timestamps=True),
    "empty": dict(language="en", prompt="", prefix=[]),
    "per-row prompts": dict(language="en", prompt=ROWS, prefix=[5]),
    "translate": dict(language="German", task="translate"),
    "detect": dict(language=None),
    "detect per-row": dict(language=None, prompt=ROWS),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_plan_matches_jax(setup, name):
    tok, dims, params, model, mel = setup
    kw = PLANS[name]
    want = jdec._decode_plan(params, dims, jax_tokenizer(), jnp.asarray(mel),
                             jdec.DecodingOptions(**kw), jnp.float32)
    got = tdec._decode_plan(model.dims, tok, torch.from_numpy(mel),
                            tdec.DecodingOptions(**kw),
                            detect=lambda: want[3])
    (_, single, mel3, sample_begin, sample_len, sot_index, prompt, suppress,
     blank, max_init, detected) = got
    (_, j_single, j_mel, j_detected, j_sb, j_sl, j_sot, j_prompt, j_sup,
     j_blank, j_max) = want
    assert (single, tuple(mel3.shape), detected) == (
        j_single, tuple(j_mel.shape), j_detected)
    assert (sample_begin, sample_len, sot_index, max_init) == (
        j_sb, j_sl, j_sot, j_max)
    np.testing.assert_array_equal(prompt, np.asarray(j_prompt))
    np.testing.assert_array_equal(suppress, j_sup)
    np.testing.assert_array_equal(blank, j_blank)
    if name == "empty":
        assert sample_begin == len(tok.sot_sequence)
    if name == "prefix trimmed":  # n_text_ctx // 2 - sample_len = 4 kept
        assert list(prompt[-4:]) == list(range(56, 60))
        assert sample_begin == len(tok.sot_sequence) + 4


DECODES = {
    "prompt str": dict(prompt="alpha beta"),
    "prompt tokens + prefix str": dict(prompt=[9, 11], prefix="ab"),
    "prefix tokens, no timestamps": dict(prefix=[5, 7],
                                         without_timestamps=True),
    "per-row prompts": dict(prompt=ROWS),
    "beam, prompt + prefix": dict(prompt="alpha", prefix=[5], beam_size=3),
    "beam, per-row prompts": dict(prompt=ROWS, beam_size=2),
}


@functools.lru_cache(maxsize=None)
def _jax_decode(name):
    _, dims, params, _, mel = _setup()
    return jdec.decode(params, dims, jax_tokenizer(), jnp.asarray(mel),
                       jdec.DecodingOptions(language="en", sample_len=8,
                                            **DECODES[name]))


@pytest.mark.parametrize("name", list(DECODES))
def test_conditioned_decode_matches_jax(setup, name):
    tok, _, _, model, mel = setup
    got = tdec.decode(model, tok, torch.from_numpy(mel),
                      tdec.DecodingOptions(language="en", sample_len=8,
                                           **DECODES[name]), device="cpu")
    assert_like_jax(got, _jax_decode(name))


def test_conditioning_moves_the_no_speech_probe(setup):
    """Under a prompt the sot moves right (sot_index > 0) and the no-speech
    probability is read there, as JAX reads it."""
    want = _jax_decode("prompt str")
    base = jdec.decode(_setup()[2], _setup()[1], jax_tokenizer(),
                       jnp.asarray(_setup()[4]),
                       jdec.DecodingOptions(language="en", sample_len=8))
    assert [r.no_speech_prob for r in want] != [r.no_speech_prob
                                                for r in base]


@pytest.mark.parametrize("batched", [False, True])
def test_detect_language_matches_jax(setup, batched):
    tok, dims, params, model, mel = setup
    m = mel if batched else mel[0]
    want = jdec.detect_language(params, dims, jax_tokenizer(), jnp.asarray(m))
    got = tdec.detect_language(model, tok, torch.from_numpy(m), device="cpu")
    if not batched:
        got, want = [got], [want]
    for (code, probs), (j_code, j_probs) in zip(got, want):
        assert code == j_code and list(probs) == list(j_probs)
        np.testing.assert_allclose(list(probs.values()),
                                   list(j_probs.values()), rtol=0, atol=2e-4)
        assert abs(sum(probs.values()) - 1) < 1e-5
    xa = tw.encode_audio(model, torch.from_numpy(mel), device="cpu")
    from_xa = tdec.detect_language(model, tok, xa=xa, device="cpu")
    assert [c for c, _ in from_xa] == [
        c for c, _ in (got if batched else tdec.detect_language(
            model, tok, torch.from_numpy(mel), device="cpu"))]


@pytest.mark.parametrize("extra", [{}, dict(beam_size=2),
                                   dict(prompt=ROWS)])
def test_language_none_detects_each_row(setup, extra):
    tok, dims, params, model, mel = setup
    kw = dict(language=None, sample_len=6, **extra)
    want = jdec.decode(params, dims, jax_tokenizer(), jnp.asarray(mel),
                       jdec.DecodingOptions(**kw))
    got = tdec.decode(model, tok, torch.from_numpy(mel),
                      tdec.DecodingOptions(**kw), device="cpu")
    assert_like_jax(got, want)
    codes = [c for c, _ in tdec.detect_language(
        model, tok, torch.from_numpy(mel), device="cpu")]
    assert [r.language for r in got] == codes


def test_a_monolingual_tokenizer_detects_nothing(setup, monkeypatch):
    _, dims, params, model, mel = setup
    called = []
    monkeypatch.setattr(tdec, "detect_language",
                        lambda *a, **k: called.append(1))
    opts = dict(language=None, sample_len=4)
    got = tdec.decode(model, get_test_tokenizer(multilingual=False),
                      torch.from_numpy(mel), tdec.DecodingOptions(**opts),
                      device="cpu")
    want = jdec.decode(params, dims, jax_tokenizer(multilingual=False),
                       jnp.asarray(mel), jdec.DecodingOptions(**opts))
    assert not called
    assert_like_jax(got, want)


ERRORS = {
    "empty row": (dict(prompt=[[1, 2], []]), "non-empty"),
    "ragged rows": (dict(prompt=[[1, 2], [3], [4, 5]]), "share one length"),
    "row count": (dict(prompt=[[1, 2], [3, 4]]), "2 per-row prompts"),
    "beam with best_of": (dict(beam_size=2, best_of=2, temperature=1.0),
                          "can't be given together"),
    "best_of greedy": (dict(best_of=2), "not compatible"),
    "patience alone": (dict(patience=2.0), "requires beam_size"),
    "patience too small": (dict(beam_size=2, patience=0.2),
                           "less than one finished"),
    "length penalty": (dict(beam_size=2, length_penalty=2.0), "between 0"),
    "negative length penalty": (dict(length_penalty=-0.1), "between 0"),
    "unknown language": (dict(language="klingon"), "language"),
}


@pytest.mark.parametrize("name", list(ERRORS))
def test_option_errors_fire_where_jax_raises(setup, name):
    tok, dims, params, model, mel = setup
    kw, match = ERRORS[name]
    kw = dict(dict(language="en", sample_len=4), **kw)
    with pytest.raises(ValueError, match=match):
        jdec.decode(params, dims, jax_tokenizer(), jnp.asarray(mel),
                    jdec.DecodingOptions(**kw))
    with pytest.raises(ValueError, match=match):
        tdec.decode(model, tok, torch.from_numpy(mel),
                    tdec.DecodingOptions(**kw), device="cpu")


# ---------------------------------------------------------------------------
# the pipeline with beam search and with sampling
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipeline_setup(tmp_path_factory):
    jm = japi.test_model(0)
    model = _port(jm.params, jm.dims)
    scp = make_timit_corpus(str(tmp_path_factory.mktemp("corpus")), n_utts=4,
                            seconds=(1.0, 2.0), words_per_utt=(3, 5), seed=0)
    return jm, model, scp


# every byte but the lowercase letters and the space suppressed, so that
# the random model's transcripts are words the alignment can time
LETTERS = [t for t in range(256) if not (97 <= t <= 122 or t == 32)]


@pytest.mark.parametrize("opts", [
    dict(beam_size=2, suppress_tokens=LETTERS),
    dict(temperature=0.7, best_of=2, suppress_tokens=LETTERS)],
    ids=["beam", "sampling"])
def test_pipeline_with_beam_and_sampling_matches_jax(pipeline_setup, opts,
                                                     monkeypatch):
    """``run_dataset`` with the decode transcripts driving the alignment:
    the same transcripts, words and boundaries as the JAX pipeline (its
    sampling noise, PRNGKey(0), put in); the capture pass recomputes the
    cross K/V, which the beam and sampling loops do not return."""
    jm, model, scp = pipeline_setup
    rng = jax.random.PRNGKey(0)
    monkeypatch.setattr(tbeam, "noise_source", lambda gen, rows, v: (
        lambda i: torch.from_numpy(np.array(jax.random.gumbel(
            jax.random.fold_in(rng, i), (rows, v), jnp.float32)))))
    kw = dict(model="test", batch_size=4, use_gt_transcript=False,
              decode_sample_len=8)
    jp = jrunner.AlignmentPipeline(jm.params, jm.dims, jm.tokenizer,
                                   JaxAlignConfig.recommended(**kw))
    jp.options = jdec.DecodingOptions(language="en", sample_len=8, **opts)
    tp = trunner.AlignmentPipeline(model, get_test_tokenizer(),
                                   AlignConfig.recommended(**kw),
                                   device="cpu")
    tp.options = tdec.DecodingOptions(language="en", sample_len=8, **opts)
    p = tp._dispatch_transcribe([TIMIT(scp)[i] for i in range(4)])
    assert p["cross_kv"] is None
    ours = list(tp.run_dataset(TIMIT(scp)))
    theirs = list(jp.run_dataset(JaxTIMIT(scp), progress=False))
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        assert (a.fid, a.transcription, a.words, a.skipped) == (
            b.fid, b.transcription, b.words, b.skipped)
        np.testing.assert_array_equal(a.start_times, b.start_times)
        np.testing.assert_array_equal(a.end_times, b.end_times)
    assert all(not a.skipped and len(a.words) >= 2 for a in ours)
