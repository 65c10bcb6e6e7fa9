"""The pipeline's edge cases, the port beside the JAX pipeline on the same
tiny dims and weights (carried across with ``params_from_jax``), on the CPU.

Port counterparts of tests/test_edge_cases.py (an all-skipped batch, empty
transcripts), tests/test_skip_guards.py (an overlong utterance skipped, the
rest aligned), tests/test_pipeline_vs_single.py (a batch whose fids are all
the same gives the unique-fid batch's results, row by row) and
tests/test_cross_kv_reuse.py (a skip in the middle reorders the live rows:
the capture pass drops the decode's cross K/V and gives the no-reuse
results). Each holds the port's skip flags, words and boundaries equal to
the JAX pipeline's, and the last the runner's shape telemetry (the padded
decode and capture shapes the MFU roll-up reads) equal to JAX's."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from whisper_char_alignment_tpu.config import AlignConfig as JaxAlignConfig
from whisper_char_alignment_tpu.config import tiny_test_dims
from whisper_char_alignment_tpu.data.dataset import Utterance as JaxUtterance
from whisper_char_alignment_tpu.models import whisper as jwhisper
from whisper_char_alignment_tpu.runner import \
    AlignmentPipeline as JaxPipeline
from whisper_char_alignment_tpu.text.tokenizer import \
    get_test_tokenizer as jax_test_tokenizer
from whisper_char_alignment_tpu_torch.align import timing
from whisper_char_alignment_tpu_torch.config import AlignConfig, ModelDims
from whisper_char_alignment_tpu_torch.data.dataset import Utterance
from whisper_char_alignment_tpu_torch.models import convert as tconvert
from whisper_char_alignment_tpu_torch.runner import AlignmentPipeline
from whisper_char_alignment_tpu_torch.text.tokenizer import get_test_tokenizer

torch.set_num_threads(1)


def _models(n_audio_ctx, n_text_ctx, layers, seed):
    """(JAX params, JAX dims, port model) of one tiny random Whisper."""
    dims = tiny_test_dims(n_vocab=get_test_tokenizer().n_vocab,
                          n_audio_ctx=n_audio_ctx, n_text_ctx=n_text_ctx,
                          state=16, head=2, layers=layers)
    params = jwhisper.init_params(jax.random.PRNGKey(seed), dims)
    model = tconvert.model_from_state_dict(
        tconvert.params_from_jax(jax.tree.map(np.asarray, params)),
        ModelDims(**dataclasses.asdict(dims)), device="cpu")
    return params, dims, model


@pytest.fixture(scope="module")
def edge_models():
    """tests/test_edge_cases.py's and tests/test_skip_guards.py's model."""
    return _models(32, 24, 2, 0)


def _pipes(models, override=None, **cfg):
    """The JAX and the port pipeline over one model and one config:
    ``AlignConfig.recommended(topk=2, batch_size=2)`` by default, else
    ``AlignConfig(**cfg)``; ``override`` gives both the same transcripts."""
    params, dims, model = models
    if cfg:
        jcfg, tcfg = JaxAlignConfig(**cfg), AlignConfig(**cfg)
    else:
        jcfg = JaxAlignConfig.recommended(topk=2, batch_size=2)
        tcfg = AlignConfig.recommended(topk=2, batch_size=2)
    jp = JaxPipeline(params, dims, jax_test_tokenizer(), jcfg)
    tp = AlignmentPipeline(model, get_test_tokenizer(), tcfg, device="cpu")
    if override is not None:
        jp.transcribe_override = override
        tp.transcribe_override = override
    return jp, tp


def _utt(audio, text, starts, ends, fid):
    return Utterance(audio=audio, duration=len(audio), text=text,
                     starts=starts, ends=ends, fid=fid)


def _jax_utts(utts):
    return [JaxUtterance(**dataclasses.asdict(u)) for u in utts]


def _same(ours, theirs, check_matrix=False):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.fid == b.fid and a.skipped == b.skipped
        assert a.words == b.words
        assert a.transcription == b.transcription
        np.testing.assert_array_equal(a.start_times, b.start_times)
        np.testing.assert_array_equal(a.end_times, b.end_times)
        if check_matrix:
            np.testing.assert_allclose(a.matrix, b.matrix, rtol=1e-5,
                                       atol=1e-6)


def _too_long(fid):
    return _utt(np.zeros(16000 * 31, np.float32), "x", [0.0], [31.0], fid)


def test_all_skipped_batch(edge_models):
    jp, tp = _pipes(edge_models)
    utts = [_too_long(f"long{i}") for i in range(2)]
    ours = tp.align_batch(utts)
    assert all(r.skipped for r in ours)
    _same(ours, jp.align_batch(_jax_utts(utts)))


def test_empty_transcription_yields_empty_alignment(edge_models):
    jp, tp = _pipes(edge_models, override=lambda utts: ["" for _ in utts])
    rng = np.random.default_rng(0)
    utts = [_utt(rng.normal(0, .1, 8000).astype(np.float32), "a b", [0.0],
                 [0.3], f"u{i}") for i in range(2)]
    ours = tp.align_batch(utts)
    for r in ours:
        assert not r.skipped
        assert r.words == [] and len(r.end_times) == 0
    _same(ours, jp.align_batch(_jax_utts(utts)))


def test_overlong_utterance_skipped_others_align(edge_models):
    jp, tp = _pipes(edge_models)
    rng = np.random.default_rng(0)
    ok = _utt(rng.normal(0, .1, 16000 // 2).astype(np.float32), "hi there",
              [0.0, 0.2], [0.2, 0.5], "ok")
    utts = [ok, _too_long("long")]
    ours = tp.align_batch(utts)
    by_fid = {r.fid: r for r in ours}
    assert by_fid["long"].skipped
    assert not by_fid["ok"].skipped
    assert len(by_fid["ok"].start_times) == len(by_fid["ok"].end_times)
    _same(ours, jp.align_batch(_jax_utts(utts)))


TRANSCRIPTS = ["hello world", "the quick brown fox", "greasy wash water"]


def test_duplicate_fids_do_not_cross_wire():
    """Device rows are consumed positionally: a batch whose utterances all
    share one fid (what serve's micro-batcher submits) equals the
    unique-fid batch field by field, in the port and in JAX."""
    models = _models(48, 64, 2, 7)
    jp, tp = _pipes(models, override=lambda batch: TRANSCRIPTS[:len(batch)],
                    aligned_unit_type="char", aggr="topk", topk=3,
                    medfilt_width=3, batch_size=3)
    rng = np.random.default_rng(0)
    utts = [_utt(rng.normal(0, 0.1, int(16000 * s)).astype(np.float32),
                 "a b", [0.0], [0.1], f"u{i}")
            for i, s in enumerate([0.51, 0.29, 0.40])]
    unique = tp.align_batch(utts, return_matrix=True)
    dup_utts = [dataclasses.replace(u, fid="utterance") for u in utts]
    dup = tp.align_batch(dup_utts, return_matrix=True)
    # the rows differ, so the comparison is not vacuous
    assert unique[0].words != unique[1].words
    for a, b in zip(unique, dup):
        assert a.words == b.words
        np.testing.assert_array_equal(a.start_times, b.start_times)
        np.testing.assert_array_equal(a.end_times, b.end_times)
        np.testing.assert_array_equal(a.matrix, b.matrix)
        np.testing.assert_array_equal(a.scores[0], b.scores[0])
        np.testing.assert_array_equal(a.scores[1], b.scores[1])
    _same(dup, jp.align_batch(_jax_utts(dup_utts), return_matrix=True),
          check_matrix=True)


def test_pipeline_reuse_falls_back_on_skip_reorder(monkeypatch):
    """The middle utterance's char tokens exceed n_text_ctx=64, so it is
    skipped and the live rows no longer follow the decode's: with
    ``reuse_cross_kv`` the capture pass must take the encoder states, not
    the decode's K/V, and give the no-reuse results (and JAX's)."""
    models = _models(48, 64, 3, 3)
    rng = np.random.default_rng(2)
    utts = [_utt(rng.normal(0, 0.1, int(16000 * s)).astype(np.float32),
                 text, [0.0], [0.1], f"u{i}")
            for i, (text, s) in enumerate(zip(
                ["hello world", "a" * 100, "deep blue sea"], [0.5, 0.4, 0.3]))]
    captures = []
    get_attentions = timing.get_attentions

    def spy(*args, **kw):
        captures.append(kw["cross_kv"] is not None)
        return get_attentions(*args, **kw)

    monkeypatch.setattr(timing, "get_attentions", spy)
    outs = {}
    for reuse in (True, False):
        jp, tp = _pipes(models, override=lambda batch: [u.text for u in batch],
                        aligned_unit_type="char", aggr="topk", topk=3,
                        medfilt_width=3, batch_size=3, reuse_cross_kv=reuse,
                        model="tiny-test")
        outs[reuse] = tp.align_batch(utts)
        assert outs[reuse][1].skipped
        _same(outs[reuse], jp.align_batch(_jax_utts(utts)))
        # the MFU roll-up's shape telemetry, reuse flag included
        assert tp.decode_shapes == jp.decode_shapes == [(3, 3, None)]
        assert tp.capture_shapes == jp.capture_shapes
        assert [s[3] for s in tp.capture_shapes] == [False]
    assert captures == [False, False]  # no capture reused the K/V
    _same(outs[True], outs[False])
    # without the skip the same rows do reuse it
    captures.clear()
    tp.cfg = dataclasses.replace(tp.cfg, reuse_cross_kv=True)
    tp.align_batch([utts[0], utts[2]])
    assert captures == [True]
    assert tp.capture_shapes[-1][1:] == (3, 2, True)
