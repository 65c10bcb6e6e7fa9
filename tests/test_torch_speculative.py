"""The port's speculative decode and its window pass against the JAX
package's, on the CPU, with JAX weights carried across (f32, tiny dims).

- ``decode_window`` at a device-tensor offset: its logits within 2e-4 of
  sequential ``decode_step`` calls and of JAX ``decode_window``, its cache
  columns equal;
- ``decode_speculative`` with ``draft_k`` 1, 3 and 4 on a smaller draft and
  with the target drafting for itself: tokens, texts, languages,
  ``n_steps`` and ``n_rounds`` equal to JAX's, scores within 2e-4, and the
  transcript equal to the port's greedy ``decode``; budgets that reach past
  the learned positions (the zero-padded table);
- the eager rounds in chunks of 1, 3 and 40 agree; the graph runner's
  bookkeeping for the rounds with the CUDA graph stubbed;
- JAX's ValueErrors (vocab, n_mels, ``draft_k``, a batch, non-greedy
  options).
"""

import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_char_alignment_tpu.config import ModelDims as JaxDims
from whisper_char_alignment_tpu.config import tiny_test_dims
from whisper_char_alignment_tpu.models import decoding as jdec
from whisper_char_alignment_tpu.models import whisper as jw
from whisper_char_alignment_tpu.text.tokenizer import \
    get_test_tokenizer as jax_tokenizer
from whisper_char_alignment_tpu_torch.config import ModelDims
from whisper_char_alignment_tpu_torch.models import convert as tconvert
from whisper_char_alignment_tpu_torch.models import decode_graph
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
    dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=24, n_text_ctx=24,
                          state=16, head=2, layers=2)
    draft_dims = JaxDims(
        n_mels=dims.n_mels, n_audio_ctx=dims.n_audio_ctx, n_audio_state=8,
        n_audio_head=1, n_audio_layer=1, n_vocab=dims.n_vocab,
        n_text_ctx=dims.n_text_ctx, n_text_state=8, n_text_head=1,
        n_text_layer=1)
    params = jw.init_params(jax.random.PRNGKey(0), dims)
    draft = jw.init_params(jax.random.PRNGKey(7), draft_dims)
    mel = np.random.default_rng(3).normal(
        size=(dims.n_mels, 2 * dims.n_audio_ctx)).astype(np.float32)
    return (tok, dims, params, _port(params, dims), draft_dims, draft,
            _port(draft, draft_dims), mel)


@pytest.fixture
def setup():
    return _setup()


@pytest.mark.parametrize("start", [0, 3, 9])
def test_window_matches_steps_and_jax(setup, start):
    _, dims, params, model, _, _, _, _ = setup
    rng = np.random.default_rng(start)
    max_len, p = 16, 5
    tokens = rng.integers(0, dims.n_vocab, (2, max_len))
    xa = rng.normal(0, 1, (2, dims.n_audio_ctx, dims.n_audio_state)
                    ).astype(np.float32)
    ckv = tw.precompute_cross_kv(model, torch.from_numpy(xa))
    tok_t = torch.from_numpy(tokens)
    caches = [tw.init_kv_cache(model.dims, 2, max_len, device="cpu")
              for _ in range(2)]
    for c in caches:
        if start:
            tw.decode_prefill(model, tok_t[:, :start], c, ckv)
    got, _ = tw.decode_window(model, tok_t[:, start:start + p],
                              torch.tensor([start]), caches[0], ckv)
    steps = torch.stack([tw.decode_step(model, tok_t[:, q:q + 1], q,
                                        caches[1], ckv)[0]
                         for q in range(start, start + p)], dim=1)
    np.testing.assert_allclose(got.numpy(), steps.numpy(), rtol=0, atol=2e-4)
    np.testing.assert_allclose(caches[0]["k"].numpy(),
                               caches[1]["k"].numpy(), rtol=0, atol=1e-5)
    ckv_j = jw.precompute_cross_kv(params, dims, jnp.asarray(xa))
    cache_j = jw.init_kv_cache(dims, 2, max_len)
    if start:
        _, cache_j = jw.decode_prefill(
            params, dims, jnp.asarray(tokens[:, :start], jnp.int32), cache_j,
            ckv_j)
    want, cache_j = jw.decode_window(
        params, dims, jnp.asarray(tokens[:, start:start + p], jnp.int32),
        jnp.int32(start), cache_j, ckv_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(caches[0]["v"].numpy(),
                               np.asarray(cache_j["v"]), rtol=0, atol=1e-5)


# (draft_k, sample_len, without_timestamps, self-draft)
CASES = [(1, 12, False, False), (3, 12, True, False), (4, 12, False, False),
         (4, 40, False, False), (3, 12, False, True), (4, 40, True, True)]


@functools.lru_cache(maxsize=None)
def _jax_spec(k, sample_len, without_ts, self_draft):
    _, dims, params, _, ddims, draft, _, mel = _setup()
    dp, dd = (params, dims) if self_draft else (draft, ddims)
    return jdec.decode_speculative(
        params, dims, dp, dd, jax_tokenizer(), jnp.asarray(mel),
        jdec.DecodingOptions(language="en", sample_len=sample_len,
                             without_timestamps=without_ts),
        draft_k=k, return_info=True)


def _port_spec(setup, k, sample_len, without_ts, self_draft, **kw):
    tok, _, _, model, _, _, dmodel, mel = setup
    return tdec.decode_speculative(
        model, model if self_draft else dmodel, tok, torch.from_numpy(mel),
        tdec.DecodingOptions(language="en", sample_len=sample_len,
                             without_timestamps=without_ts),
        draft_k=k, return_info=True, device="cpu", **kw)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_speculative_matches_jax_and_greedy(setup, case):
    tok, _, _, model, _, _, _, mel = setup
    got, info = _port_spec(setup, *case)
    want, j_info = _jax_spec(*case)
    assert info == j_info
    assert (got.tokens, got.text, got.language, got.n_steps) == (
        want.tokens, want.text, want.language, want.n_steps)
    np.testing.assert_allclose(got.avg_logprob, want.avg_logprob, rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(got.no_speech_prob, want.no_speech_prob,
                               rtol=0, atol=2e-4)
    greedy = tdec.decode(model, tok, torch.from_numpy(mel),
                         tdec.DecodingOptions(
                             language="en", sample_len=case[1],
                             without_timestamps=case[2]), device="cpu")
    assert (got.tokens, got.n_steps) == (greedy.tokens, greedy.n_steps)
    np.testing.assert_allclose(got.avg_logprob, greedy.avg_logprob, rtol=0,
                               atol=2e-4)
    if case[3]:  # the target drafting for itself commits several a round
        assert info["n_rounds"] < info["n_steps"] - 3
    if case[1] == 40:  # the budget is clamped to the context: 24 - 3
        assert got.n_steps == len(tok.sot_sequence) + 21 - 1


def _round_args(setup, k=3):
    tok, _, _, model, _, _, dmodel, mel = setup
    mel_t = torch.from_numpy(mel)[None]
    opts = tdec.DecodingOptions(language="en", sample_len=12)
    plan = tdec._decode_plan(model.dims, tok, mel_t, opts)
    spec = tdec.SpeculativeSpec(
        sample_begin=plan[3], total=plan[3] + plan[4], k=k,
        ts_begin=tok.timestamp_begin, eot=tok.eot,
        no_timestamps=tok.no_timestamps, no_speech=tok.no_speech,
        max_initial_ts_index=plan[9], use_timestamps=True,
        sot_index=plan[5])
    xa = tw.encode_audio(model, mel_t, device="cpu")
    xa_d = tw.encode_audio(dmodel, mel_t, device="cpu")
    return (model, dmodel, xa, xa_d, plan[6], torch.from_numpy(plan[7]),
            torch.from_numpy(plan[8]), spec)


def test_rounds_in_chunks_agree(setup, monkeypatch):
    args = _round_args(setup)
    outs = []
    for chunk in (1, 3, 40):
        monkeypatch.setattr(tdec, "runner_for", lambda dev: functools.partial(
            tdec.run_eager, chunk=chunk))
        outs.append(tdec._speculative_loop(*args))
    for other in outs[1:]:
        for a, b in zip(other, outs[0]):
            assert torch.equal(a, b)


class _StubFlag:
    def __init__(self, done):
        self.value = bool(done)

    def read(self):
        return self.value


def test_graph_runner_replays_speculative_rounds(setup, monkeypatch):
    """The rounds through the graph runner (graph stubbed by a callable):
    outputs equal the eager rounds'; one capture and one warm-up round;
    the entry keeps the draft model alive; a second decode replays it."""
    args = _round_args(setup)
    eager = tdec._speculative_loop(*args)
    monkeypatch.setattr(tdec, "runner_for", lambda dev: decode_graph.replay)
    monkeypatch.setattr(decode_graph, "_warm_up", lambda fn: fn())
    monkeypatch.setattr(decode_graph, "_capture",
                        lambda fn: types.SimpleNamespace(replay=fn))
    monkeypatch.setattr(decode_graph, "_Flag", _StubFlag)
    decode_graph.reset_record()
    got = tdec._speculative_loop(*args)
    for a, b in zip(got, eager):
        assert torch.equal(a, b)
    rounds = int(eager[4][0])
    chunks = -(-rounds // decode_graph.CHUNK_STEPS)
    record = decode_graph.replay_record()
    assert record["captures"] == 1 and record["warmup_steps"] == 1
    assert record["replays"] == min(chunks + 1, -(-12 // 4))
    (entry,) = decode_graph._GRAPHS[args[0]].values()
    assert entry.keep is args[1]
    again = tdec._speculative_loop(*args)
    assert torch.equal(again[0], eager[0])
    assert decode_graph.replay_record()["captures"] == 1


def test_speculative_refuses_what_jax_refuses(setup):
    tok, dims, params, model, ddims, draft, dmodel, mel = setup
    mel_t = torch.from_numpy(mel)
    greedy = tdec.DecodingOptions(language="en", sample_len=4)
    other_vocab = tw.Whisper(dataclasses.replace(
        dmodel.dims, n_vocab=dims.n_vocab + 1), device="cpu")
    other_mels = tw.Whisper(dataclasses.replace(
        dmodel.dims, n_mels=dims.n_mels + 8), device="cpu")
    cases = [
        (dict(draft=other_vocab), "vocab"),
        (dict(draft=other_mels), "n_mels"),
        (dict(draft_k=0), "draft_k"),
        (dict(mel=torch.from_numpy(np.stack([mel, mel]))), "single-utterance"),
        (dict(options=tdec.DecodingOptions(language="en", beam_size=2)),
         "greedy-only"),
        (dict(options=tdec.DecodingOptions(language="en", temperature=0.5)),
         "greedy-only"),
    ]
    for kw, match in cases:
        call = dict(draft=dmodel, mel=mel_t, options=greedy, draft_k=2)
        call.update(kw)
        with pytest.raises(ValueError, match=match):
            tdec.decode_speculative(model, call["draft"], tok, call["mel"],
                                    call["options"], draft_k=call["draft_k"],
                                    device="cpu")
    with pytest.raises(ValueError, match="single-utterance"):
        jdec.decode_speculative(params, dims, draft, ddims, jax_tokenizer(),
                                jnp.asarray(np.stack([mel, mel])),
                                jdec.DecodingOptions(language="en"))


def test_unbatched_and_batch_of_one(setup):
    got = _port_spec(setup, 2, 8, False, False)[0]
    tok, _, _, model, _, _, dmodel, mel = setup
    one = tdec.decode_speculative(model, dmodel, tok,
                                  torch.from_numpy(mel)[None],
                                  tdec.DecodingOptions(language="en",
                                                       sample_len=8),
                                  draft_k=2, device="cpu")
    assert isinstance(one, list) and one[0].tokens == got.tokens
