"""The port's temperature sampling against the JAX package's, on the CPU,
with JAX weights carried across (f32, tiny dims).

The port draws its Gumbel noise from a ``torch.Generator``, whose numbers
differ from JAX's threefry; ``beam.noise_source`` is the seam through which
these tests put in JAX's own noise, ``jax.random.gumbel(fold_in(rng, i))``
for the step that predicts position i (what ``jax.random.categorical``
adds inside JAX's loop). With it:

- ``decode`` with ``temperature`` 0.1, 0.7 and 1.0, with and without
  ``best_of`` and timestamps: tokens, texts, languages and ``n_steps``
  equal to JAX ``decode``'s, ``avg_logprob`` and ``no_speech_prob`` within
  2e-4, on a model whose rows end at different steps (at 0.1); the
  ``no_speech=None`` tokenizer reports NaN as JAX's does;
- two temperatures run one loop spec (the temperature is a tensor of the
  state) and, through the graph runner with the CUDA graph stubbed, one
  captured graph;
- with the port's own noise: a decode is reproducible from its generator,
  other seeds draw other noise, and the eager loop stepped in chunks of 1,
  3 and 40 samples alike (one draw per position, in order).
"""

import copy
import dataclasses
import functools
import types

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
from whisper_char_alignment_tpu_torch.models import beam as tbeam
from whisper_char_alignment_tpu_torch.models import convert as tconvert
from whisper_char_alignment_tpu_torch.models import decode_graph
from whisper_char_alignment_tpu_torch.models import decoding as tdec
from whisper_char_alignment_tpu_torch.models import whisper as tw
from whisper_char_alignment_tpu_torch.text.tokenizer import get_test_tokenizer

torch.set_num_threads(1)

SEED = 5  # JAX's rng for the loop (PRNGKey(SEED)), put in through the seam


@functools.lru_cache(maxsize=None)
def _setup():
    tok = get_test_tokenizer()
    dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=32, n_text_ctx=48,
                          state=16, head=2, layers=2)
    params = jw.init_params(jax.random.PRNGKey(3), dims)
    # the weight edit of tests/test_torch_decode_graph.py's staggered plant
    # (both sides): at temperature 0.1 two rows end early, after 10 and 13
    # tokens; the flatter draws at 0.7 and 1.0 run to the budget
    dec = dict(params["decoder"])
    blocks = dict(dec["blocks"])
    cross = dict(blocks["cross_attn"])
    cross["out"] = dict(cross["out"], w=cross["out"]["w"] * 4.0)
    emb = np.array(dec["tok_emb"])
    emb[tok.eot] *= -1.6
    params = dict(params, decoder=dict(
        dec, tok_emb=jnp.asarray(emb), blocks=dict(blocks, cross_attn=cross)))
    model = tconvert.model_from_state_dict(
        tconvert.params_from_jax(jax.tree.map(np.asarray, params)),
        ModelDims(**dataclasses.asdict(dims)), device="cpu")
    mel = np.random.default_rng(3).normal(
        0, 1, (8, dims.n_mels, 2 * dims.n_audio_ctx)).astype(np.float32)
    return tok, dims, params, model, mel


@pytest.fixture
def setup():
    return _setup()


def jax_noise(seed: int = SEED):
    """``beam.noise_source``'s stand-in: JAX's own Gumbel noise of each
    position, as ``jax.random.categorical`` draws it in JAX's loop."""
    rng = jax.random.PRNGKey(seed)

    def source(generator, rows, n_vocab):
        return lambda i: torch.from_numpy(np.array(jax.random.gumbel(
            jax.random.fold_in(rng, i), (rows, n_vocab), jnp.float32)))
    return source


@functools.lru_cache(maxsize=None)
def jax_decode(temperature, best_of, without_ts, no_speech=True):
    _, dims, params, _, mel = _setup()
    tok = jax_tokenizer()
    if not no_speech:
        tok = copy.copy(tok)
        tok.no_speech = None
    return jdec.decode(params, dims, tok, jnp.asarray(mel),
                       jdec.DecodingOptions(
                           language="en", temperature=temperature,
                           best_of=best_of, without_timestamps=without_ts,
                           sample_len=16),
                       rng=jax.random.PRNGKey(SEED))


def port_decode(setup, temperature, best_of, without_ts, tok=None, **kw):
    _tok, _, _, model, mel = setup
    return tdec.decode(model, tok or _tok, torch.from_numpy(mel),
                       tdec.DecodingOptions(
                           language="en", temperature=temperature,
                           best_of=best_of, without_timestamps=without_ts,
                           sample_len=16), device="cpu", **kw)


def assert_like_jax(got, want):
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.text for r in got] == [r.text for r in want]
    assert [r.language for r in got] == [r.language for r in want]
    assert [r.n_steps for r in got] == [r.n_steps for r in want]
    assert [r.temperature for r in got] == [r.temperature for r in want]
    np.testing.assert_allclose([r.avg_logprob for r in got],
                               [r.avg_logprob for r in want], rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose([r.no_speech_prob for r in got],
                               [r.no_speech_prob for r in want], rtol=0,
                               atol=2e-4)


@pytest.mark.parametrize("temperature,best_of,without_ts", [
    (0.7, 5, False), (1.0, 5, False), (1.0, None, False), (0.7, 2, True),
    (0.1, None, False)])
def test_sampling_matches_jax_given_its_noise(setup, monkeypatch,
                                              temperature, best_of,
                                              without_ts):
    monkeypatch.setattr(tbeam, "noise_source", jax_noise())
    got = port_decode(setup, temperature, best_of, without_ts)
    assert_like_jax(got, jax_decode(temperature, best_of, without_ts))


def test_rows_end_at_different_steps():
    res = jax_decode(0.1, None, False)
    lengths = [len(r.tokens) for r in res]
    assert len(set(lengths)) >= 3 and min(lengths) < 16, lengths


def test_no_speech_none_tokenizer_reports_nan(setup, monkeypatch):
    monkeypatch.setattr(tbeam, "noise_source", jax_noise())
    tok = copy.copy(setup[0])
    tok.no_speech = None
    got = port_decode(setup, 0.7, 2, True, tok=tok)
    want = jax_decode(0.7, 2, True, no_speech=False)
    assert all(np.isnan(r.no_speech_prob) for r in got)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    np.testing.assert_allclose([r.avg_logprob for r in got],
                               [r.avg_logprob for r in want], rtol=0,
                               atol=2e-4)


def _loop_args(setup, options):
    tok, _, _, model, mel = setup
    plan = tdec._decode_plan(model.dims, tok, torch.from_numpy(mel), options)
    g = options.best_of or 1
    spec = tbeam.GroupSpec(
        sample_begin=plan[3], total=plan[3] + plan[4],
        ts_begin=tok.timestamp_begin, eot=tok.eot,
        no_timestamps=tok.no_timestamps, no_speech=tok.no_speech,
        max_initial_ts_index=plan[9],
        use_timestamps=not options.without_timestamps, sot_index=plan[5],
        group=g)
    xa = tw.encode_audio(model, torch.from_numpy(mel), device="cpu")
    args = (model, xa, plan[6], torch.from_numpy(plan[7]),
            torch.from_numpy(plan[8]), spec)
    return args, g * mel.shape[0], model.dims.n_vocab


class _StubFlag:
    def __init__(self, done):
        self.value = bool(done)

    def read(self):
        return self.value


def test_two_temperatures_share_one_spec_and_one_graph(setup, monkeypatch):
    """The temperature is a tensor of the state, not part of the spec, so
    one captured graph serves both (graph stubbed by a callable); each
    temperature's outputs equal the eager loop's on the same JAX noise, and
    the eager loop's equal JAX's results."""
    opts = tdec.DecodingOptions(language="en", temperature=0.7, best_of=5,
                                sample_len=16)
    args, rows, n_vocab = _loop_args(setup, opts)
    noise = jax_noise()(None, rows, n_vocab)
    monkeypatch.setattr(decode_graph, "_warm_up", lambda fn: fn())
    monkeypatch.setattr(decode_graph, "_capture",
                        lambda fn: types.SimpleNamespace(replay=fn))
    monkeypatch.setattr(decode_graph, "_Flag", _StubFlag)
    decode_graph.reset_record()
    for temperature in (0.7, 1.0):
        monkeypatch.setattr(tdec, "runner_for", lambda dev: tdec.run_eager)
        eager = tbeam._sample_loop(*args, temperature, noise)
        monkeypatch.setattr(tdec, "runner_for",
                            lambda dev: decode_graph.replay)
        graphed = tbeam._sample_loop(*args, temperature, noise)
        for a, b in zip(graphed, eager):
            assert torch.equal(a, b)
        want = jax_decode(temperature, 5, False)
        groups = tbeam.group_candidates(
            eager[0].numpy(), eager[1].numpy(), n_group=5,
            sample_begin=args[-1].sample_begin, eot=args[-1].eot)
        for (cands, lps), w in zip(groups, want):
            assert cands[tbeam.ml_rank(cands, lps, None)] == w.tokens
    record = decode_graph.replay_record()
    assert record["captures"] == 1 and record["warmup_steps"] == 1
    assert len(decode_graph._GRAPHS[args[0]]) == 1


def test_own_noise_is_reproducible_and_chunk_free(setup, monkeypatch):
    """The port's own noise: a decode is reproducible from its generator
    (seeded 0 by default), another seed samples otherwise, and the eager
    loop samples alike in chunks of 1, 3 and 40 steps."""
    first = port_decode(setup, 1.0, 3, False)
    again = port_decode(setup, 1.0, 3, False,
                        generator=torch.Generator().manual_seed(0))
    other = port_decode(setup, 1.0, 3, False,
                        generator=torch.Generator().manual_seed(1))
    assert [r.tokens for r in first] == [r.tokens for r in again]
    assert [r.tokens for r in first] != [r.tokens for r in other]
    opts = tdec.DecodingOptions(language="en", temperature=1.0, best_of=3,
                                sample_len=16)
    args, rows, n_vocab = _loop_args(setup, opts)
    outs = []
    for chunk in (1, 3, 40):
        noise = tbeam.noise_source(torch.Generator().manual_seed(7), rows,
                                   n_vocab)
        monkeypatch.setattr(tdec, "runner_for", lambda dev: functools.partial(
            tdec.run_eager, chunk=chunk))
        outs.append(tbeam._sample_loop(*args, 1.0, noise))
    for other in outs[1:]:
        for a, b in zip(other, outs[0]):
            assert torch.equal(a, b)


def test_gumbel_noise_is_jax_shaped():
    """The port's noise has the Gumbel distribution's mean and spread
    (Euler's constant, pi / sqrt(6)) and a draw per call."""
    noise = tbeam.noise_source(torch.Generator().manual_seed(0), 64, 4096)
    a, b = noise(3), noise(3)
    assert a.shape == (64, 4096) and a.dtype == torch.float32
    assert not torch.equal(a, b) and bool(torch.isfinite(a).all())
    assert abs(a.mean().item() - 0.5772) < 0.01
    assert abs(a.std().item() - np.pi / np.sqrt(6)) < 0.01
