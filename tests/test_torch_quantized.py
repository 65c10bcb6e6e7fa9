"""The int8 and frame-bucketed decode modes against the JAX package, on the
CPU, with JAX weights carried across by ``convert.params_from_jax`` (f32).

- the cross K/V quantizer: codes and scales bit-equal on the same f32 input;
- the int8-product (``mxu``) step within one probability code (1e-3 of the
  output's largest magnitude);
- tiny-model decodes: int8 tokens equal across the port's three modes and
  JAX's two; a full-window bucket equal to the unbucketed decode; the guard
  merge bit-equal to the exact decode when it flags every row and to the
  unguarded mode when it flags none; ``min_margin`` tracked or NaN;
- the pipeline with both guards: the JAX pipeline's words, boundaries and
  transcripts, and no capture-pass K/V reuse under int8 or buckets.
"""

import dataclasses

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
from whisper_char_alignment_tpu_torch.models import convert as tconvert
from whisper_char_alignment_tpu_torch.models import decoding as tdec
from whisper_char_alignment_tpu_torch.models import whisper as tw
from whisper_char_alignment_tpu_torch.ops import _lib
from whisper_char_alignment_tpu_torch.text.tokenizer import get_test_tokenizer

torch.set_num_threads(1)


def _port(params, dims):
    return tconvert.model_from_state_dict(
        tconvert.params_from_jax(jax.tree.map(np.asarray, params)),
        ModelDims(**dataclasses.asdict(dims)), device="cpu")


def _setup(n_text_ctx, n_rows, mel_seed, sample_len):
    tok = get_test_tokenizer()
    dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=32,
                          n_text_ctx=n_text_ctx, state=16, head=2, layers=2)
    params = jw.init_params(jax.random.PRNGKey(3), dims)
    mel = np.random.default_rng(mel_seed).normal(
        0, 1, (n_rows, dims.n_mels, 2 * dims.n_audio_ctx)).astype(np.float32)
    return tok, dims, params, _port(params, dims), mel, sample_len


@pytest.fixture(scope="module")
def small():
    """tests/test_kv_int8.py's setup fixture, carried across."""
    return _setup(24, 2, 0, 6)


@pytest.fixture(scope="module")
def wide():
    """tests/test_kv_int8.py's guard fixture: 8 rows, so the guard's
    per-row merge is exercised."""
    return _setup(48, 8, 3, 16)


def _opts(mod, sample_len):
    return mod.DecodingOptions(language="en", sample_len=sample_len)


def _port_decode(s, **kw):
    tok, _, _, model, mel, n = s
    return tdec.decode(model, tok, torch.from_numpy(mel), _opts(tdec, n),
                       device="cpu", **kw)


def _jax_decode(s, **kw):
    _, dims, params, _, mel, n = s
    return jdec.decode(params, dims, jax_tokenizer(), jnp.asarray(mel),
                       _opts(jdec, n), **kw)


def _tokens(results):
    return [r.tokens for r in results]


# ---------------------------------------------------------------------------
# quantizer and the int8-product step
# ---------------------------------------------------------------------------

def _jax_kv(s):
    _, dims, params, _, mel, _ = s
    xa = jw.encode_audio(params, dims, jnp.asarray(mel))
    return (xa, jw.precompute_cross_kv(params, dims, xa),
            jw.precompute_cross_kv(params, dims, xa, quantize=True))


def test_quantizer_bit_equal_to_jax(small):
    _, (ks, vs), ((kq, k_s), (vq, v_s)) = _jax_kv(small)
    for x, codes, scales in ((ks, kq, k_s), (vs, vq, v_s)):
        got_q, got_s = tw.quantize_cross_kv(torch.from_numpy(np.array(x)))
        assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(codes))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(scales))
    # round half to even, and an all-zero column's scale of 1.0
    x = torch.tensor([[0.5, 0.0], [1.5, 0.0], [-2.5, 0.0], [127.0, 0.0]])
    q, s = tw.quantize_cross_kv(x)
    assert q[:, 0].tolist() == [0, 2, -2, 127] and s.tolist() == [[1.0, 1.0]]


def test_precompute_cross_kv_quantized_matches_jax(small):
    _, dims, _, model, _, _ = small
    xa, _, ((kq, k_s), (vq, v_s)) = _jax_kv(small)
    (tq, t_ks), (tv, t_vs) = tw.precompute_cross_kv(
        model, torch.from_numpy(np.asarray(xa)), quantize=True)
    assert tq.shape == (dims.n_text_layer, 2, dims.n_text_head,
                        dims.n_text_head_dim, dims.n_audio_ctx)
    assert t_ks.shape == (dims.n_text_layer, 2, dims.n_text_head, 1,
                          dims.n_audio_ctx)
    # projections agree within f32 noise, so codes within one step
    for a, b in ((tq, kq), (tv, vq)):
        assert np.abs(a.numpy().astype(int) - np.asarray(b).astype(int)
                      ).max() <= 1
    np.testing.assert_allclose(t_ks.numpy(), np.asarray(k_s), rtol=1e-5)
    np.testing.assert_allclose(t_vs.numpy(), np.asarray(v_s), rtol=1e-5)


@pytest.mark.parametrize("rows", [1, 3])
def test_mxu_step_matches_jax_within_one_code(small, rows):
    _, dims, _, _, _, _ = small
    _, _, ((kq, k_s), (vq, v_s)) = _jax_kv(small)
    hd = dims.n_text_head_dim
    scale = hd ** -0.25
    qc = np.random.default_rng(rows).normal(
        0, 1, (2, dims.n_text_head, rows, hd)).astype(np.float32) * scale
    want = np.asarray(jw._cross_attn_step_int8_mxu(
        jnp.asarray(qc), (kq[0], k_s[0]), (vq[0], v_s[0]), scale,
        jnp.float32))
    t = [torch.from_numpy(np.asarray(a[0])) for a in (kq, k_s, vq, v_s)]
    got = tw._cross_attn_step_int8_mxu(torch.from_numpy(qc), (t[0], t[1]),
                                       (t[2], t[3]), scale, torch.float32)
    assert got.shape == want.shape == (2, dims.n_text_head, rows, hd)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-3 * np.abs(want).max())


def test_mxu_value_product_is_exact_past_2_24():
    """A uniform softmax gives w8 = 127 in every frame; over 1500 frames the
    integer sum 127 * sum(v8) passes 2**24, where float32 would round."""
    f, hd = 1500, 4
    rng = np.random.default_rng(0)
    v8 = rng.integers(100, 128, (1, 1, hd, f)).astype(np.int8)
    k8 = np.zeros((1, 1, hd, f), np.int8)
    ones = torch.ones(1, 1, 1, f)
    got = tw._cross_attn_step_int8_mxu(
        torch.zeros(1, 1, 1, hd), (torch.from_numpy(k8), ones),
        (torch.from_numpy(v8), ones), 1.0, torch.float32)
    exact = 127 * v8.astype(np.int64).sum(-1)  # (1, 1, hd)
    assert exact.max() > 2 ** 24
    w_s = np.float32(1.0 / f) * np.float32(1.0 / 127.0)
    np.testing.assert_array_equal(
        got[0, 0, 0].numpy(), exact[0, 0].astype(np.float32) * w_s)


# ---------------------------------------------------------------------------
# tiny-model decodes
# ---------------------------------------------------------------------------

def test_int8_tokens_agree_across_modes_and_with_jax(small, monkeypatch):
    outs = {}
    for mode in ("xla", "mxu", "pallas"):
        monkeypatch.setenv("WCA_CROSS_ATTN", mode)
        outs["port " + mode] = _tokens(_port_decode(small, kv_int8=True))
    for mode in ("xla", "mxu"):
        monkeypatch.setenv("WCA_CROSS_ATTN", mode)
        outs["jax " + mode] = _tokens(_jax_decode(small, kv_int8=True))
    assert all(v == outs["jax xla"] for v in outs.values()), outs
    assert _lib.launch_counts()["cross_attn_int8"] == 0  # CPU: plain only


def test_full_window_bucket_equals_unbucketed(small):
    _, dims, _, _, _, _ = small
    exact = _port_decode(small)
    full = _port_decode(small, kv_frames=dims.n_audio_ctx)
    assert _tokens(full) == _tokens(exact)
    assert [r.avg_logprob for r in full] == [r.avg_logprob for r in exact]
    assert _tokens(_port_decode(small, kv_frames=16)) == _tokens(
        _jax_decode(small, kv_frames=16))


@pytest.mark.parametrize("kw", [
    dict(kv_int8_guard=1e9), dict(kv_frames=8, kv_frames_guard=1e9),
    dict(kv_frames=8, kv_int8_guard=1e9, kv_frames_guard=1e9)])
def test_guard_flagging_every_row_equals_exact(wide, kw):
    exact = _port_decode(wide)
    guarded = _port_decode(wide, **kw)
    assert _tokens(guarded) == _tokens(exact)
    for a, b in zip(guarded, exact):
        assert a.avg_logprob == b.avg_logprob
        assert a.no_speech_prob == b.no_speech_prob
        assert np.isfinite(a.min_margin) and np.isnan(b.min_margin)


@pytest.mark.parametrize("kw,plain", [
    (dict(kv_int8_guard=0.0), dict(kv_int8=True)),
    (dict(kv_frames=8, kv_frames_guard=0.0), dict(kv_frames=8))])
def test_guard_flagging_no_row_equals_the_unguarded_mode(wide, kw, plain):
    assert _tokens(_port_decode(wide, **kw)) == _tokens(
        _port_decode(wide, **plain))


def test_unguarded_int8_survives_the_bucket_redecode(wide):
    got = _port_decode(wide, kv_int8=True, kv_frames=8, kv_frames_guard=1e9)
    assert _tokens(got) == _tokens(_port_decode(wide, kv_int8=True))


def test_bucket_guard_catches_truncation_flips_like_jax(wide):
    plain = _port_decode(wide, kv_frames=8)
    assert _tokens(plain) == _tokens(_jax_decode(wide, kv_frames=8))
    exact = _port_decode(wide)
    assert sum(a.tokens != b.tokens for a, b in zip(plain, exact)) >= 1
    guarded = _port_decode(wide, kv_frames=8,
                           kv_frames_guard=tdec.default_bucket_guard_margin())
    assert _tokens(guarded) == _tokens(exact)


def test_min_margin_tracked_or_nan_and_close_to_jax(wide):
    assert all(np.isnan(r.min_margin) for r in _port_decode(wide))
    got = _port_decode(wide, kv_int8_guard=0.0)
    want = _jax_decode(wide, kv_int8_guard=0.0)
    assert all(np.isfinite(r.min_margin) and r.min_margin >= 0.0 for r in got)
    np.testing.assert_allclose([r.min_margin for r in got],
                               [r.min_margin for r in want], atol=1e-3)


def test_bucket_guard_requires_kv_frames(wide):
    with pytest.raises(ValueError, match="kv_frames"):
        _port_decode(wide, kv_frames_guard=1.0)


def test_guard_defaults_and_their_environment(monkeypatch):
    monkeypatch.delenv("WCA_KV_INT8_GUARD_MARGIN", raising=False)
    monkeypatch.delenv("WCA_BUCKET_GUARD_MARGIN", raising=False)
    assert tdec.default_guard_margin() == jdec.default_guard_margin() == 2.0
    assert (tdec.default_bucket_guard_margin()
            == jdec.default_bucket_guard_margin() == 2.0)
    monkeypatch.setenv("WCA_KV_INT8_GUARD_MARGIN", "0.5")
    monkeypatch.setenv("WCA_BUCKET_GUARD_MARGIN", "3")
    assert tdec.default_guard_margin() == 0.5
    assert tdec.default_bucket_guard_margin() == 3.0


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipe_setup(tmp_path_factory):
    jm = japi.test_model(0)
    model = _port(jm.params, jm.dims)
    scp = make_timit_corpus(str(tmp_path_factory.mktemp("corpus")), n_utts=4,
                            seconds=(1.0, 2.0), words_per_utt=(3, 5), seed=0)
    return jm, model, scp


GUARDED = dict(decode_kv_int8_guarded=True, decode_frame_bucket=128,
               decode_frame_bucket_guarded=True)


def _pipes(pipe_setup, **over):
    jm, model, _ = pipe_setup
    kw = dict(model="test", batch_size=4, use_gt_transcript=True,
              decode_sample_len=8, **over)
    jp = jrunner.AlignmentPipeline(jm.params, jm.dims, jm.tokenizer,
                                   JaxAlignConfig.recommended(**kw))
    tp = trunner.AlignmentPipeline(model, get_test_tokenizer(),
                                   AlignConfig.recommended(**kw),
                                   device="cpu")
    return jp, tp


def test_guarded_pipeline_matches_jax(pipe_setup, monkeypatch):
    monkeypatch.setenv("WCA_CROSS_ATTN", "xla")
    _, _, scp = pipe_setup
    jp, tp = _pipes(pipe_setup, **GUARDED)
    ours = list(tp.run_dataset(TIMIT(scp), progress=False))
    theirs = list(jp.run_dataset(JaxTIMIT(scp), progress=False))
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        assert a.fid == b.fid and a.words == b.words and len(a.words) >= 2
        np.testing.assert_array_equal(a.start_times, b.start_times)
        np.testing.assert_array_equal(a.end_times, b.end_times)
    assert tp.active_guard_margin() == jp.active_guard_margin() == 4.0
    assert len(tp.min_margins) == len(jp.min_margins) == 4
    np.testing.assert_allclose(tp.min_margins, jp.min_margins, atol=1e-3)
    assert tp.flag_rate() == jp.flag_rate()
    batch = [TIMIT(scp)[i] for i in range(4)]
    assert tp.transcribe_batch(batch)[0] == jp.transcribe_batch(
        [JaxTIMIT(scp)[i] for i in range(4)])[0]


def test_kernel_modes_pipeline_matches_jax(pipe_setup, monkeypatch):
    """int8 + a 128-frame bucket, the cross-attention kernel mode and the mel
    kernel (plain versions on the CPU) against the JAX pipeline with its
    dequantizing step and its own mel kernel (interpret mode)."""
    _, _, scp = pipe_setup
    monkeypatch.setenv("WCA_MEL_IMPL", "pallas")
    jp, tp = _pipes(pipe_setup, decode_kv_int8=True, decode_frame_bucket=128)
    monkeypatch.setenv("WCA_CROSS_ATTN", "xla")
    batch = [JaxTIMIT(scp)[i] for i in range(4)]
    theirs = jp.align_batch(batch)
    want_text = jp.transcribe_batch(batch)[0]
    monkeypatch.setenv("WCA_CROSS_ATTN", "pallas")
    batch = [TIMIT(scp)[i] for i in range(4)]
    ours = tp.align_batch(batch)
    for a, b in zip(ours, theirs):
        assert a.words == b.words and len(a.words) >= 2
        np.testing.assert_array_equal(a.start_times, b.start_times)
        np.testing.assert_array_equal(a.end_times, b.end_times)
    assert tp.transcribe_batch(batch)[0] == want_text
    assert tp.flag_rate() is None and tp.min_margins == []


@pytest.mark.parametrize("over,reused", [
    ({}, True), (dict(decode_kv_int8=True), False),
    (dict(decode_kv_int8_guarded=True), False),
    (dict(decode_frame_bucket=128), False), (GUARDED, False)])
def test_capture_pass_reuses_kv_only_when_they_are_its_own(pipe_setup, over,
                                                          reused):
    _, model, scp = pipe_setup
    cfg = AlignConfig.recommended(model="test", batch_size=4,
                                  decode_sample_len=2, **over)
    tp = trunner.AlignmentPipeline(model, get_test_tokenizer(), cfg,
                                   device="cpu")
    tp_out = tp._dispatch_transcribe([TIMIT(scp)[i] for i in range(2)])
    assert (tp_out["cross_kv"] is not None) == reused


def test_bucket_guard_without_a_bucket_is_refused(pipe_setup):
    _, model, _ = pipe_setup
    cfg = AlignConfig.recommended(model="test",
                                  decode_frame_bucket_guarded=True)
    with pytest.raises(ValueError, match="decode_frame_bucket"):
        trunner.AlignmentPipeline(model, get_test_tokenizer(), cfg,
                                  device="cpu")
