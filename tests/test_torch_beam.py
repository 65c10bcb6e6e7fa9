"""The port's beam search against the JAX package's, on the CPU, with JAX
weights carried across (f32, tiny dims).

- ``decode`` with ``beam_size`` 1, 2, 3 and 5, ``patience`` 0.5, 1 and 2,
  ``length_penalty`` None and 0.6, with and without timestamps and at
  ``sample_len`` 1: tokens, texts, languages and ``n_steps`` equal to JAX
  ``decode``'s, ``avg_logprob`` and ``no_speech_prob`` within 2e-4 (the JAX
  suite's model tolerance), on a model planted so that the audios bank
  their candidates at different steps (the same weight edit on both
  sides);
- the raw loop on planted ``-inf`` ties (every token suppressed but three):
  ``lax.top_k`` takes the lower index among equal values, and so must the
  port, in every row the loop keeps (tokens, scores, the bank);
- the eager loop stepped in chunks of 1, 3 and 40 gives the same outputs;
- the graph runner's bookkeeping for a beam loop with the CUDA graph
  stubbed by a callable, as for the greedy loop
  (tests/test_torch_decode_graph.py); the graph itself is held against the
  eager loop on the card (tests/test_torch_cuda.py, ``chip_smoke.py``);
- the host-side finalize (``beam_candidates``' published tie order,
  ``ml_rank``) against JAX's on the same arrays.
"""

import dataclasses
import functools
import types
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_char_alignment_tpu.config import tiny_test_dims
from whisper_char_alignment_tpu.models import beam as jbeam
from whisper_char_alignment_tpu.models import decoding as jdec
from whisper_char_alignment_tpu.models import whisper as jw
from whisper_char_alignment_tpu.text.tokenizer import \
    get_test_tokenizer as jax_tokenizer
from whisper_char_alignment_tpu_torch.config import ModelDims
from whisper_char_alignment_tpu_torch.models import beam as tbeam
from whisper_char_alignment_tpu_torch.models import convert as tconvert
from whisper_char_alignment_tpu_torch.models import decode_graph
from whisper_char_alignment_tpu_torch.models import decoding as tdec
from whisper_char_alignment_tpu_torch.models import whisper as tw
from whisper_char_alignment_tpu_torch.text.tokenizer import get_test_tokenizer

torch.set_num_threads(1)

# the weight edit (both sides): cross-attention output projections x 3.0
# make the audio matter, the eot embedding x -1.5 makes eot a candidate at
# some steps. On this seed beam 5 banks its audios' winners after 4 and 10
# tokens, beam 2 after 7 and 13, and the loop stops before its budget.
OUT_SCALE, EOT_SCALE = 3.0, -1.5


def _planted(params, eot: int):
    dec = dict(params["decoder"])
    blocks = dict(dec["blocks"])
    cross = dict(blocks["cross_attn"])
    cross["out"] = dict(cross["out"], w=cross["out"]["w"] * OUT_SCALE)
    blocks["cross_attn"] = cross
    dec["blocks"] = blocks
    emb = np.array(dec["tok_emb"])
    emb[eot] *= EOT_SCALE
    dec["tok_emb"] = jnp.asarray(emb)
    return dict(params, decoder=dec)


@functools.lru_cache(maxsize=None)
def _setup():
    tok = get_test_tokenizer()
    dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=32, n_text_ctx=48,
                          state=16, head=2, layers=2)
    params = _planted(jw.init_params(jax.random.PRNGKey(3), dims), tok.eot)
    model = tconvert.model_from_state_dict(
        tconvert.params_from_jax(jax.tree.map(np.asarray, params)),
        ModelDims(**dataclasses.asdict(dims)), device="cpu")
    mel = np.random.default_rng(3).normal(
        0, 1, (4, dims.n_mels, 2 * dims.n_audio_ctx)).astype(np.float32)
    return tok, dims, params, model, mel


@pytest.fixture
def setup():
    return _setup()


def assert_like_jax(got, want):
    """Tokens, texts, languages and n_steps equal; scores within 2e-4."""
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
    assert [r.temperature for r in got] == [r.temperature for r in want]


# (beam_size, patience, length_penalty, without_timestamps, sample_len)
CASES = [
    (1, None, None, False, 16),
    (2, None, None, False, 16),
    (2, 0.5, 0.6, False, 16),
    (3, 1.0, 0.6, True, 16),
    (5, None, None, False, 16),
    (5, 0.5, 0.6, False, 16),  # round(2.5) = 2 banked, topped up to 5
    (5, 2.0, None, True, 16),
    (5, 2.0, 0.6, False, 16),
    (5, None, None, False, 1),
    (2, 2.0, None, True, 1),
]


@functools.lru_cache(maxsize=None)
def jax_decode(beam_size, patience, alpha, without_ts, sample_len):
    tok, dims, params, _, mel = _setup()
    return jdec.decode(params, dims, jax_tokenizer(), jnp.asarray(mel),
                       jdec.DecodingOptions(
                           language="en", beam_size=beam_size,
                           patience=patience, length_penalty=alpha,
                           without_timestamps=without_ts,
                           sample_len=sample_len))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_beam_decode_matches_jax(setup, case):
    tok, _, _, model, mel = setup
    beam_size, patience, alpha, without_ts, sample_len = case
    got = tdec.decode(model, tok, torch.from_numpy(mel),
                      tdec.DecodingOptions(
                          language="en", beam_size=beam_size,
                          patience=patience, length_penalty=alpha,
                          without_timestamps=without_ts,
                          sample_len=sample_len), device="cpu")
    assert_like_jax(got, jax_decode(*case))


def test_audios_bank_their_candidates_at_different_steps():
    """The plant: the audios' winners have different lengths and the loop
    stops before its budget, so steps after an audio's bank filled (and
    the bank's cap) are exercised."""
    for case in ((5, None, None, False, 16), (2, None, None, False, 16)):
        res = jax_decode(*case)
        lengths = [len(r.tokens) for r in res]
        assert len(set(lengths)) >= 2, lengths
        assert res[0].n_steps < 3 + 16 - 1


def test_beam_of_one_is_greedy(setup):
    tok, _, _, model, mel = setup
    kw = dict(language="en", sample_len=16)
    beam = tdec.decode(model, tok, torch.from_numpy(mel),
                       tdec.DecodingOptions(beam_size=1, **kw), device="cpu")
    greedy = tdec.decode(model, tok, torch.from_numpy(mel),
                         tdec.DecodingOptions(**kw), device="cpu")
    assert [r.tokens for r in beam] == [r.tokens for r in greedy]


def _raw_loops(setup, options, chunk=1):
    """JAX ``_beam_loop`` and the port's eager ``_beam_loop`` (``chunk``
    steps between reads of its done flag) on the same plan; returns both
    outputs as numpy, in JAX's order."""
    tok, dims, params, model, mel = setup
    jplan = jdec._decode_plan(params, dims, jax_tokenizer(), jnp.asarray(mel),
                              options[0], jnp.float32)
    (_, _, _, _, sample_begin, sample_len, sot_index, prompt, suppress,
     blank, max_init) = jplan
    g = options[0].beam_size
    mc = max(1, round(g * (options[0].patience or 1.0)))
    want = jbeam._beam_loop(
        params, dims, jnp.asarray(mel), jnp.asarray(prompt),
        jnp.asarray(suppress), jnp.asarray(blank),
        sample_begin=sample_begin, max_steps=sample_len,
        ts_begin=tok.timestamp_begin, eot=tok.eot,
        no_timestamps=tok.no_timestamps, no_speech=tok.no_speech,
        max_initial_ts_index=max_init,
        use_timestamps=not options[0].without_timestamps, beam_size=g,
        max_candidates=mc, sot_index=sot_index)[:7]
    plan = tdec._decode_plan(model.dims, tok, torch.from_numpy(mel),
                             options[1])
    spec = tbeam.GroupSpec(
        sample_begin=plan[3], total=plan[3] + plan[4],
        ts_begin=tok.timestamp_begin, eot=tok.eot,
        no_timestamps=tok.no_timestamps, no_speech=tok.no_speech,
        max_initial_ts_index=plan[9],
        use_timestamps=not options[1].without_timestamps, sot_index=plan[5],
        group=g, max_candidates=mc)
    xa = tw.encode_audio(model, torch.from_numpy(mel), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdec, "runner_for", lambda dev: functools.partial(
            tdec.run_eager, chunk=chunk))
        got = tbeam._beam_loop(model, xa, plan[6], torch.from_numpy(plan[7]),
                               torch.from_numpy(plan[8]), spec)
    return [np.asarray(w) for w in want], [t.numpy() for t in got], spec


def _opts(**kw):
    return jdec.DecodingOptions(**kw), tdec.DecodingOptions(**kw)


def _assert_raw_equal(got, want, with_lp=True):
    tokens, sum_lp, fin_tok, fin_lp, fin_cnt, ns_prob, n_steps = got
    j_tokens, j_sum_lp, j_fin_tok, j_fin_lp, j_fin_cnt, j_ns, j_n = want
    np.testing.assert_array_equal(tokens, j_tokens)
    np.testing.assert_array_equal(fin_tok, j_fin_tok)
    np.testing.assert_array_equal(fin_cnt, j_fin_cnt)
    assert int(n_steps[0]) == int(j_n)
    for a, b in ((sum_lp, j_sum_lp), (fin_lp, j_fin_lp), (ns_prob, j_ns)):
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=2e-4)


def test_top_k_ties_take_the_lower_index(setup):
    """Every token but three text tokens suppressed (and eot, after the
    first step): beam 0's top 6 at the first step hold three ``-inf``
    entries, two of which become beams (seen after one step).
    ``lax.top_k`` takes the lowest ids among them, and the port's rows must
    hold the same tokens, there and after six steps."""
    tok, dims, _, _, _ = setup
    allowed = {300, 301, 302, tok.eot}
    suppress = [t for t in range(dims.n_vocab) if t not in allowed]
    for sample_len in (1, 6):
        options = _opts(language="en", beam_size=5, sample_len=sample_len,
                        without_timestamps=True, suppress_tokens=suppress)
        want, got, spec = _raw_loops(setup, options)
        _assert_raw_equal(got, want)
        if sample_len == 1:
            first = got[0][:5, spec.sample_begin]
            assert sorted(first) == [0, 1, 300, 301, 302], first
            assert np.isneginf(got[1][:5]).sum() == 2


@pytest.mark.parametrize("chunk", [1, 3, 40])
def test_raw_loop_in_chunks_matches_jax(setup, chunk):
    options = _opts(language="en", beam_size=3, patience=2.0, sample_len=16)
    want, got, _ = _raw_loops(setup, options, chunk=chunk)
    _assert_raw_equal(got, want)


def test_beam_drops_the_greedy_speedups_with_jax_warning(setup):
    tok, _, _, model, mel = setup
    opts = tdec.DecodingOptions(language="en", beam_size=2, sample_len=6)
    base = tdec.decode(model, tok, torch.from_numpy(mel), opts, device="cpu")
    for kw in ({"kv_frames": 16}, {"kv_int8": True},
               {"kv_int8_guard": 0.5}, {"kv_frames": 16,
                                        "kv_frames_guard": 0.5}):
        with pytest.warns(UserWarning, match="greedy-decode-only speedups"):
            res, xa, cross_kv = tdec.decode(
                model, tok, torch.from_numpy(mel), opts, device="cpu",
                return_cross_kv=True, **kw)
        assert cross_kv is None and xa.shape[0] == mel.shape[0]
        assert [r.tokens for r in res] == [r.tokens for r in base], kw
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tdec.decode(model, tok, torch.from_numpy(mel), opts, device="cpu")


def test_beam_results_are_deferred_like_greedy(setup):
    tok, _, _, model, mel = setup
    opts = tdec.DecodingOptions(language="en", beam_size=2, sample_len=6)
    fut, xa = tdec.decode(model, tok, torch.from_numpy(mel), opts,
                          device="cpu", async_results=True, return_xa=True)
    assert isinstance(fut, tdec.DecodeFuture)
    got = fut.result()
    assert fut.result() is got
    sync = tdec.decode(model, tok, torch.from_numpy(mel), opts, xa=xa,
                       device="cpu")
    assert [r.tokens for r in got] == [r.tokens for r in sync]
    one = tdec.decode(model, tok, torch.from_numpy(mel[1]), opts,
                      device="cpu")
    assert one.tokens == got[1].tokens


class _StubFlag:
    def __init__(self, done):
        self.value = bool(done)

    def read(self):
        return self.value


def stub_graphs(monkeypatch):
    """The CUDA graph stubbed by a callable that runs the captured chunk
    eagerly, the done flag read at once."""
    monkeypatch.setattr(decode_graph, "_warm_up", lambda fn: fn())
    monkeypatch.setattr(decode_graph, "_capture",
                        lambda fn: types.SimpleNamespace(replay=fn))
    monkeypatch.setattr(decode_graph, "_Flag", _StubFlag)
    decode_graph.reset_record()


def test_graph_runner_replays_a_beam_loop(setup, monkeypatch):
    """A beam loop through the graph runner (graph stubbed): outputs equal
    the eager loop's, one capture and one warm-up step, replays stopping a
    chunk after the flag; a second decode replays the same graph, and a
    beam loop of another spec evicts it (one non-greedy graph is held)."""
    tok, dims, _, model, mel = setup
    options = _opts(language="en", beam_size=5, sample_len=16)
    want, eager, spec = _raw_loops(setup, options)
    stub_graphs(monkeypatch)
    monkeypatch.setattr(tdec, "runner_for", lambda dev: decode_graph.replay)
    plan = tdec._decode_plan(model.dims, tok, torch.from_numpy(mel),
                             options[1])
    xa = tw.encode_audio(model, torch.from_numpy(mel), device="cpu")
    args = (model, xa, plan[6], torch.from_numpy(plan[7]),
            torch.from_numpy(plan[8]))
    got = tbeam._beam_loop(*args, spec)
    for a, b in zip(got, eager):
        np.testing.assert_array_equal(a.numpy(), b)
    n_steps = int(eager[6][0]) - spec.sample_begin + 1  # steps that ran
    chunks = -(-n_steps // decode_graph.CHUNK_STEPS)
    record = decode_graph.replay_record()
    assert record == dict(captures=1, warmup_steps=1, replays=chunks + 1,
                          steps=(chunks + 1) * decode_graph.CHUNK_STEPS)
    again = tbeam._beam_loop(*args, spec)
    assert torch.equal(again[0], got[0])
    assert decode_graph.replay_record()["captures"] == 1
    other = dataclasses.replace(spec, max_candidates=2)
    tbeam._beam_loop(*args, other)
    keys = list(decode_graph._GRAPHS[model])
    assert decode_graph.replay_record()["captures"] == 2
    assert [k[1] for k in keys] == [other]


def test_finalize_matches_jax_on_tied_sums():
    """``beam_candidates`` keeps the published ``argsort(...)[::-1]`` order
    on equal sums (the higher beam row first) and ``ml_rank`` the
    published penalties."""
    rng = np.random.default_rng(0)
    g, b, total, sb, eot = 3, 2, 9, 2, 7
    tokens = rng.integers(0, 6, (b * g, total))
    tokens[1, 5] = eot
    sum_lp = np.array([-1.0, -1.0, -2.0, -3.0, -0.5, -0.5], np.float32)
    fin_tok = rng.integers(0, 6, (b, 2, total))
    fin_tok[:, :, 6] = eot
    fin_lp = np.array([[-4.0, -5.0], [-6.0, -7.0]], np.float32)
    fin_cnt = np.array([1, 0])
    kw = dict(beam_size=g, sample_begin=sb, eot=eot)
    want = jbeam.beam_candidates(tokens, sum_lp, fin_tok, fin_lp, fin_cnt,
                                 **kw)
    got = tbeam.beam_candidates(tokens, sum_lp, fin_tok, fin_lp, fin_cnt,
                                **kw)
    assert got == want
    for cands, lps in want:
        for alpha in (None, 0.0, 0.6, 1.0):
            assert tbeam.ml_rank(cands, lps, alpha) == jbeam.ml_rank(
                cands, lps, alpha)
    assert tbeam.ml_rank([[], [1, 2]], [-1.0, -1.5], None) == jbeam.ml_rank(
        [[], [1, 2]], [-1.0, -1.5], None)
    assert tbeam.group_candidates(tokens, sum_lp, n_group=3, sample_begin=sb,
                                  eot=eot) == jbeam.group_candidates(
        tokens, sum_lp, n_group=3, sample_begin=sb, eot=eot)
