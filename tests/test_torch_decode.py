"""The port's greedy decode against the JAX package on a tiny random model
with the toy tokenizer, on the CPU: the same token ids, and log-probs within
the model tolerance."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_char_alignment_tpu.config import tiny_test_dims
from whisper_char_alignment_tpu.models import decoding as jdec
from whisper_char_alignment_tpu.models import whisper as jw
from whisper_char_alignment_tpu.text.tokenizer import \
    get_test_tokenizer as jax_tokenizer
from whisper_char_alignment_tpu_torch.config import ModelDims
from whisper_char_alignment_tpu_torch.models import convert as tconvert
from whisper_char_alignment_tpu_torch.models import decoding as tdec
from whisper_char_alignment_tpu_torch.text.tokenizer import get_test_tokenizer

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    tok = get_test_tokenizer()
    dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=32, n_text_ctx=24,
                          state=32, head=2, layers=2)
    params = jw.init_params(jax.random.PRNGKey(11), dims)
    model = tconvert.model_from_state_dict(
        tconvert.params_from_jax(jax.tree.map(np.asarray, params)),
        ModelDims(**dataclasses.asdict(dims)), device="cpu")
    mel = np.random.default_rng(0).normal(
        size=(3, dims.n_mels, 2 * dims.n_audio_ctx)).astype(np.float32)
    return tok, dims, params, model, mel


@pytest.mark.parametrize("without_timestamps", [False, True])
@pytest.mark.parametrize("sample_len", [2, 8])
def test_greedy_tokens_match_jax(setup, sample_len, without_timestamps):
    tok, dims, params, model, mel = setup
    opts = dict(language="en", sample_len=sample_len,
                without_timestamps=without_timestamps)
    want = jdec.decode(params, dims, jax_tokenizer(), jnp.asarray(mel),
                       jdec.DecodingOptions(**opts))
    got = tdec.decode(model, tok, torch.from_numpy(mel),
                      tdec.DecodingOptions(**opts), device="cpu")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.tokens == w.tokens
        assert g.text == w.text
        assert g.language == w.language == "en"
        assert g.n_steps == w.n_steps
        np.testing.assert_allclose(g.avg_logprob, w.avg_logprob, rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(g.no_speech_prob, w.no_speech_prob,
                                   rtol=2e-4, atol=2e-4)


def test_decode_returns_encoder_states_and_cross_kv(setup):
    tok, dims, _, model, mel = setup
    opts = tdec.DecodingOptions(language="en", sample_len=2)
    res, xa, (ck, cv) = tdec.decode(model, tok, torch.from_numpy(mel), opts,
                                    return_cross_kv=True, device="cpu")
    assert xa.shape == (3, dims.n_audio_ctx, dims.n_audio_state)
    assert ck.shape == cv.shape == (dims.n_text_layer, 3, dims.n_text_head,
                                    dims.n_text_head_dim, dims.n_audio_ctx)
    again = tdec.decode(model, tok, torch.from_numpy(mel), opts, xa=xa,
                        device="cpu")
    assert [r.tokens for r in again] == [r.tokens for r in res]
    single = tdec.decode(model, tok, torch.from_numpy(mel[0]), opts,
                         device="cpu")
    assert single.tokens == res[0].tokens


def test_logit_filters_match_jax(setup):
    tok, dims, _, _, _ = setup
    rng = np.random.default_rng(4)
    b, v = 4, dims.n_vocab
    logits = rng.normal(0, 3, (b, v)).astype(np.float32)
    tokens = rng.integers(0, v, (b, 10)).astype(np.int32)
    tokens[:, 5] = tok.timestamp_begin + np.array([0, 3, 5, 1])
    has_ts = np.array([True, False, True, False])
    last_ts = np.array([tok.timestamp_begin + 2, 0, tok.timestamp_begin, 0],
                       np.int32)
    suppress = np.zeros(v, np.float32)
    suppress[list(jdec._get_suppress_tokens(
        jax_tokenizer(), jdec.DecodingOptions()))] = -np.inf
    blank = np.zeros(v, np.float32)
    blank[tok.encode(" ") + [tok.eot]] = -np.inf
    for cur_len in (3, 4, 6):
        kw = dict(sample_begin=3, ts_begin=tok.timestamp_begin, eot=tok.eot,
                  no_timestamps=tok.no_timestamps, max_initial_ts_index=50,
                  use_timestamps=True)
        want = np.asarray(jdec.apply_logit_filters(
            jnp.asarray(logits), cur_len, jnp.asarray(tokens),
            jnp.asarray(has_ts), jnp.asarray(last_ts), jnp.asarray(suppress),
            jnp.asarray(blank), jnp.arange(v), **kw))
        got = tdec.apply_logit_filters(
            torch.from_numpy(logits), cur_len,
            torch.from_numpy(tokens).long(), torch.from_numpy(has_ts),
            torch.from_numpy(last_ts).long(), torch.from_numpy(suppress),
            torch.from_numpy(blank), torch.arange(v), **kw).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)


def test_suppress_tokens_match_jax():
    tok = get_test_tokenizer()
    for opt in ("-1", "", "5,7", [3, -1]):
        want = jdec._get_suppress_tokens(
            jax_tokenizer(), jdec.DecodingOptions(suppress_tokens=opt))
        got = tdec._get_suppress_tokens(
            tok, tdec.DecodingOptions(suppress_tokens=opt))
        assert got == want
