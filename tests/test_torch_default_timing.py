"""Whisper's default timing (``--default_whisper_timing``) in the port
against the JAX package, on the CPU.

Tiny dims (state 16, 2 heads, 2 layers; tests/test_librispeech_and_default_
timing.py:122-123), JAX weights carried across, the same numpy inputs:
``default_find_alignment_batch`` gives bit-equal jump frames, the z-norm
matrix within 2e-4 and token probabilities within 1e-5; through the runner
the words, boundaries and word probabilities (1e-5) equal the JAX
pipeline's."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_char_alignment_tpu import runner as jrunner
from whisper_char_alignment_tpu.align import timing as jtiming
from whisper_char_alignment_tpu.config import AlignConfig as JaxAlignConfig
from whisper_char_alignment_tpu.config import tiny_test_dims
from whisper_char_alignment_tpu.data.dataset import TIMIT as JaxTIMIT
from whisper_char_alignment_tpu.data.synthetic import make_timit_corpus
from whisper_char_alignment_tpu.models import whisper as jwhisper
from whisper_char_alignment_tpu_torch import runner as trunner
from whisper_char_alignment_tpu_torch.align import timing as ttiming
from whisper_char_alignment_tpu_torch.config import AlignConfig, ModelDims
from whisper_char_alignment_tpu_torch.data.dataset import TIMIT
from whisper_char_alignment_tpu_torch.models import convert as tconvert
from whisper_char_alignment_tpu_torch.text.tokenizer import get_test_tokenizer

torch.set_num_threads(1)

DIMS = tiny_test_dims(n_vocab=get_test_tokenizer().n_vocab, n_audio_ctx=32,
                      n_text_ctx=24, state=16, head=2, layers=2)


@pytest.fixture(scope="module")
def models():
    params = jwhisper.init_params(jax.random.PRNGKey(0), DIMS)
    model = tconvert.model_from_state_dict(
        tconvert.params_from_jax(jax.tree.map(np.asarray, params)),
        ModelDims(**dataclasses.asdict(DIMS)), device="cpu")
    return params, model


def test_znorm_mean_heads_matches_jax_with_a_constant_column():
    rng = np.random.default_rng(0)
    sel = rng.random((3, 4, 7, 9)).astype(np.float32)
    sel[0, :, :, 2] = 0.25  # every row equal: 0 / 0, as in JAX
    sel[1, 1, :, 5] = 0.0
    tl = np.array([7, 4, 1], np.int32)
    want = np.asarray(jtiming._znorm_mean_heads(jnp.asarray(sel),
                                                jnp.asarray(tl)))
    got = ttiming._znorm_mean_heads(torch.from_numpy(sel),
                                    torch.from_numpy(tl)).numpy()
    assert np.isnan(want[0, :, 2]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_default_find_alignment_batch_matches_jax(models):
    params, model = models
    tok = get_test_tokenizer()
    rng = np.random.default_rng(1)
    mel = rng.normal(0, 1, (3, 80, 64)).astype(np.float32)
    tokens = rng.integers(0, tok.eot, (3, 16)).astype(np.int32)
    tl = np.array([16, 9, 6], np.int32)
    fl = np.array([32, 20, 11], np.int32)
    heads = [(1, 0), (1, 1), (0, 1)]
    jf_j, probs_j, m_j = jtiming.default_find_alignment_batch(
        params, DIMS, jnp.asarray(mel), jnp.asarray(tokens), jnp.asarray(tl),
        jnp.asarray(fl), heads, eot=tok.eot, medfilt_width=3, sot_len=3)
    jf_t, probs_t, m_t = ttiming.default_find_alignment_batch(
        model, torch.from_numpy(mel), torch.from_numpy(tokens),
        torch.from_numpy(tl), torch.from_numpy(fl), heads, eot=tok.eot,
        medfilt_width=3, sot_len=3, device="cpu")
    np.testing.assert_array_equal(jf_t.numpy(), np.asarray(jf_j))
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j),
                               rtol=1e-5, atol=1e-5)


def test_filter_attention_matches_jax():
    attns = np.random.default_rng(2).random((3, 4, 6, 20)).astype(np.float32)
    sel_j, scores_j = jtiming.filter_attention(attns, topk=5)
    sel_t, scores_t = ttiming.filter_attention(torch.from_numpy(attns),
                                               topk=5)
    assert [s[1:] for s in scores_t] == [s[1:] for s in scores_j]
    np.testing.assert_allclose([s[0] for s in scores_t],
                               [s[0] for s in scores_j], rtol=1e-6)
    for a, b in zip(sel_t, sel_j):
        np.testing.assert_array_equal(a, b)


def test_default_timing_through_the_runner_matches_jax(models, tmp_path):
    params, model = models
    tok = get_test_tokenizer()
    scp = make_timit_corpus(str(tmp_path), n_utts=3, seconds=(0.3, 0.6),
                            words_per_utt=(2, 4), seed=1)
    kw = dict(model="test", aligned_unit_type="subword", batch_size=3,
              default_whisper_timing=True, medfilt_width=3,
              use_gt_transcript=True, decode_sample_len=4)
    jp = jrunner.AlignmentPipeline(params, DIMS, tok, JaxAlignConfig(**kw))
    tp = trunner.AlignmentPipeline(model, tok, AlignConfig(**kw),
                                   device="cpu")
    assert tp.alignment_heads == jp.alignment_heads == [(1, 0), (1, 1)]
    theirs = jp.align_batch([JaxTIMIT(scp)[i] for i in range(3)],
                            return_matrix=True)
    ours = tp.align_batch([TIMIT(scp)[i] for i in range(3)],
                          return_matrix=True)
    assert "capture+align" in tp.stage_seconds
    for a, b in zip(ours, theirs):
        assert a.words == b.words and len(a.words) >= 2
        np.testing.assert_array_equal(a.start_times, b.start_times)
        np.testing.assert_array_equal(a.end_times, b.end_times)
        assert len(a.word_probabilities) == len(a.words) - 1
        np.testing.assert_allclose(a.word_probabilities,
                                   b.word_probabilities, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(a.matrix, b.matrix, rtol=2e-4, atol=2e-4)


def test_default_timing_refuses_heads_outside_the_model(models):
    _, model = models
    cfg = AlignConfig(model="medium", default_whisper_timing=True)
    with pytest.raises(ValueError, match="alignment heads"):
        trunner.AlignmentPipeline(model, get_test_tokenizer(), cfg,
                                  device="cpu")
