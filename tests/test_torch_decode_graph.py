"""The port's static-shape decode step and its greedy loop against the JAX
package, on the CPU, with JAX weights carried across (f32, tiny dims).

- the step attends over the whole cache under a position mask: its logits
  are within 2e-4 of JAX ``decode_step`` at every position, with the
  position a Python int or a device tensor;
- the eager loop, stepped in chunks of 1, 3 and more than ``total`` steps
  between reads of its done flag, gives JAX ``decode``'s tokens and
  ``n_steps``, ``sum_logprob`` within 2e-4 and ``min_margin`` within 1e-3,
  in every decode mode (float; int8 through the dequantizing, ``mxu`` and
  kernel steps, the kernel's plain version here; a frame bucket; each guard
  and both), on a model whose rows finish at different steps (the same
  weight edit on both sides), so that steps after a row or the whole batch
  has finished are exercised;
- ``DecodeFuture.result()`` equals the synchronous decode with a guard that
  flags every row (JAX tests/test_kv_int8.py:143-150);
- the graph runner's bookkeeping (launch counts under replay, the done flag
  read one chunk behind) with the CUDA graph stubbed by a callable; the
  event-based stage timers with stub CUDA events; the busy share of a stub
  trace. The graph itself is held against the eager loop on the card
  (tests/test_torch_cuda.py, ``chip_smoke.py``).
"""

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
from whisper_char_alignment_tpu_torch.models import convert as tconvert
from whisper_char_alignment_tpu_torch.models import decode_graph
from whisper_char_alignment_tpu_torch.models import decoding as tdec
from whisper_char_alignment_tpu_torch.models import whisper as tw
from whisper_char_alignment_tpu_torch.ops import _lib, cross_attn_cuda
from whisper_char_alignment_tpu_torch.text.tokenizer import get_test_tokenizer
from whisper_char_alignment_tpu_torch.utils import profiling

torch.set_num_threads(1)

SAMPLE_LEN = 16
# weight edits found on this seed (both sides get the same): the
# cross-attention output projections x OUT_SCALE make the rows' audio
# matter, and the eot embedding x EOT_SCALE makes eot win at some steps.
# "staggered": rows end after 1 and 4 tokens, the rest run to the budget;
# "early": every row ends after one token, so the loop stops early
PLANTS = {"staggered": (4.0, -1.6), "early": (2.0, -1.55)}


def _planted_params(params, eot: int, out_scale: float, eot_scale: float):
    dec = dict(params["decoder"])
    blocks = dict(dec["blocks"])
    cross = dict(blocks["cross_attn"])
    cross["out"] = dict(cross["out"], w=cross["out"]["w"] * out_scale)
    blocks["cross_attn"] = cross
    dec["blocks"] = blocks
    emb = np.array(dec["tok_emb"])
    emb[eot] *= eot_scale
    dec["tok_emb"] = jnp.asarray(emb)
    return dict(params, decoder=dec)


def _port(params, dims):
    return tconvert.model_from_state_dict(
        tconvert.params_from_jax(jax.tree.map(np.asarray, params)),
        ModelDims(**dataclasses.asdict(dims)), device="cpu")


@functools.lru_cache(maxsize=None)
def _setup(plant: str):
    tok = get_test_tokenizer()
    dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=32, n_text_ctx=48,
                          state=16, head=2, layers=2)
    params = _planted_params(jw.init_params(jax.random.PRNGKey(3), dims),
                             tok.eot, *PLANTS[plant])
    mel = np.random.default_rng(3).normal(
        0, 1, (8, dims.n_mels, 2 * dims.n_audio_ctx)).astype(np.float32)
    return tok, dims, params, _port(params, dims), mel


def _opts(mod):
    return mod.DecodingOptions(language="en", sample_len=SAMPLE_LEN)


# decode modes: (WCA_CROSS_ATTN for the port, for JAX, decode kwargs); the
# port's kernel mode (its plain version here) is held against JAX's
# dequantizing step, as tests/test_torch_quantized.py holds their tokens
MODES = {
    "float": ("xla", "xla", {}),
    "int8-xla": ("xla", "xla", dict(kv_int8=True)),
    "int8-mxu": ("mxu", "mxu", dict(kv_int8=True)),
    "int8-kernel": ("pallas", "xla", dict(kv_int8=True)),
    "bucket": ("xla", "xla", dict(kv_frames=8)),
    "int8-guard": ("pallas", "xla", dict(kv_int8_guard=0.5)),
    "bucket-guard": ("xla", "xla", dict(kv_frames=8, kv_frames_guard=0.5)),
    "both-guards": ("pallas", "xla", dict(kv_frames=8, kv_int8_guard=0.25,
                                          kv_frames_guard=0.25)),
}
CHUNKS = (1, 3, 40)  # 40 > total (3 prompt tokens + 16)


@functools.lru_cache(maxsize=None)
def _jax_results(plant: str, mode: str):
    tok, dims, params, _, mel = _setup(plant)
    jax_mode, kw = MODES[mode][1], MODES[mode][2]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WCA_CROSS_ATTN", jax_mode)
        return jdec.decode(params, dims, jax_tokenizer(), jnp.asarray(mel),
                           _opts(jdec), **kw)


def _port_results(plant, mode, chunk, monkeypatch, **extra):
    tok, _, _, model, mel = _setup(plant)
    monkeypatch.setenv("WCA_CROSS_ATTN", MODES[mode][0])
    monkeypatch.setattr(tdec, "_loop_for", lambda dev: functools.partial(
        tdec._decode_loop, chunk=chunk))
    return tdec.decode(model, tok, torch.from_numpy(mel), _opts(tdec),
                       device="cpu", **MODES[mode][2], **extra)


def _sum_lp(r):
    return r.avg_logprob * (len(r.tokens) + 1)


def _assert_like_jax(got, want, guarded: bool):
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.n_steps for r in got] == [r.n_steps for r in want]
    np.testing.assert_allclose([_sum_lp(r) for r in got],
                               [_sum_lp(r) for r in want], rtol=0, atol=2e-4)
    np.testing.assert_allclose([r.no_speech_prob for r in got],
                               [r.no_speech_prob for r in want], rtol=0,
                               atol=2e-4)
    if guarded:
        np.testing.assert_allclose([r.min_margin for r in got],
                                   [r.min_margin for r in want], rtol=0,
                                   atol=1e-3)
    else:
        assert all(np.isnan(r.min_margin) for r in got)


@pytest.mark.parametrize("pos_kind", ["int", "tensor"])
def test_static_step_logits_match_jax_at_every_position(pos_kind):
    _, dims, params, model, _ = _setup("staggered")
    rng = np.random.default_rng(5)
    max_len, p = 12, 3
    tokens = rng.integers(0, dims.n_vocab, (2, max_len))
    xa = rng.normal(0, 1, (2, dims.n_audio_ctx, dims.n_audio_state)
                    ).astype(np.float32)
    ckv_j = jw.precompute_cross_kv(params, dims, jnp.asarray(xa))
    cache_j = jw.init_kv_cache(dims, 2, max_len)
    pj, cache_j = jw.decode_prefill(params, dims,
                                    jnp.asarray(tokens[:, :p], jnp.int32),
                                    cache_j, ckv_j, logits_at=p - 1)
    ckv_t = tw.precompute_cross_kv(model, torch.from_numpy(xa))
    cache_t = tw.init_kv_cache(model.dims, 2, max_len, device="cpu")
    tok_t = torch.from_numpy(tokens)
    pt, cache_t = tw.decode_prefill(model, tok_t[:, :p], cache_t, ckv_t,
                                    logits_at=p - 1)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=2e-4)
    for pos in range(p, max_len):
        lj, cache_j = jw.decode_step(
            params, dims, jnp.asarray(tokens[:, pos:pos + 1], jnp.int32),
            jnp.int32(pos), cache_j, ckv_j)
        at = pos if pos_kind == "int" else torch.tensor([pos])
        lt, cache_t = tw.decode_step(model, tok_t[:, pos:pos + 1], at,
                                     cache_t, ckv_t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=2e-4, err_msg=f"position {pos}")
    np.testing.assert_allclose(cache_t["k"].numpy(),
                               np.asarray(cache_j["k"]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("mode", list(MODES))
def test_eager_loop_in_chunks_matches_jax(mode, chunk, monkeypatch):
    got = _port_results("staggered", mode, chunk, monkeypatch)
    _assert_like_jax(got, _jax_results("staggered", mode),
                     guarded="guard" in mode)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("mode", ["float", "int8-kernel", "both-guards"])
def test_loop_stopping_early_matches_jax(mode, chunk, monkeypatch):
    got = _port_results("early", mode, chunk, monkeypatch)
    want = _jax_results("early", mode)
    _assert_like_jax(got, want, guarded="guard" in mode)
    if "guard" not in mode:
        # every row gives eot after one token: the loop stops after two
        # steps, however many steps a chunk ran past them
        assert {len(r.tokens) for r in got} == {1}
        assert got[0].n_steps == 4 < 3 + SAMPLE_LEN - 1


def test_rows_finish_at_different_steps(monkeypatch):
    """The staggered plant: rows end at three different steps, and the
    chunked loops agree bit for bit (steps after a row finished change
    nothing)."""
    runs = [_port_results("staggered", "int8-guard", c, monkeypatch)
            for c in CHUNKS]
    lengths = [len(r.tokens) for r in runs[0]]
    assert len(set(lengths)) == 3 and max(lengths) == SAMPLE_LEN, lengths
    for other in runs[1:]:
        for a, b in zip(other, runs[0]):
            assert (a.tokens, a.n_steps, a.avg_logprob, a.min_margin,
                    a.no_speech_prob) == (b.tokens, b.n_steps, b.avg_logprob,
                                          b.min_margin, b.no_speech_prob)


def test_decode_future_equals_sync_with_every_row_flagged(monkeypatch):
    tok, _, _, model, mel = _setup("staggered")
    monkeypatch.setenv("WCA_CROSS_ATTN", "pallas")
    kw = dict(kv_int8_guard=1e9, device="cpu")
    sync = tdec.decode(model, tok, torch.from_numpy(mel), _opts(tdec), **kw)
    fut = tdec.decode(model, tok, torch.from_numpy(mel), _opts(tdec),
                      async_results=True, **kw)
    assert isinstance(fut, tdec.DecodeFuture)
    got = fut.result()
    assert fut.result() is got  # finalized once
    exact = tdec.decode(model, tok, torch.from_numpy(mel), _opts(tdec),
                        device="cpu")
    for a, b, e in zip(got, sync, exact):
        assert (a.tokens, a.avg_logprob, a.no_speech_prob, a.min_margin) == (
            b.tokens, b.avg_logprob, b.no_speech_prob, b.min_margin)
        assert a.tokens == e.tokens and a.avg_logprob == e.avg_logprob
    _, dims, params, _, _ = _setup("staggered")
    monkeypatch.setenv("WCA_CROSS_ATTN", "xla")  # JAX's pallas needs a TPU
    want = jdec.decode(params, dims, jax_tokenizer(), jnp.asarray(mel),
                       _opts(jdec), kv_int8_guard=1e9, async_results=True)
    assert [r.tokens for r in got] == [r.tokens for r in want.result()]


# ---------------------------------------------------------------------------
# the graph runner's bookkeeping, with the CUDA graph stubbed
# ---------------------------------------------------------------------------

class _StubFlag:
    """A done flag read at once (no card, no event)."""

    def __init__(self, done):
        self.value = bool(done)

    def read(self):
        return self.value


def test_graph_runner_counts_replays_and_reads_flags_a_chunk_behind(
        monkeypatch):
    """The runner's capture takes back what it counted, each replay adds it
    again, and the loop stops one chunk after the flag says done: with the
    graph stubbed by a callable that runs the captured chunk eagerly (and,
    as a replay, calls no wrapper), the results equal the eager loop's and
    ``cross_attn_int8`` counts layers x (warm-up step + replayed steps)."""
    tok, dims, _, model, mel = _setup("staggered")
    xa = tw.encode_audio(model, torch.from_numpy(mel), device="cpu")
    spec = tdec.LoopSpec(
        sample_begin=3, total=3 + SAMPLE_LEN, ts_begin=tok.timestamp_begin,
        eot=tok.eot, no_timestamps=tok.no_timestamps,
        no_speech=tok.no_speech, max_initial_ts_index=50,
        use_timestamps=True, sot_index=0, cross_mode="kernel",
        track_margin=True)
    plan = tdec._decode_plan(model.dims, tok, torch.from_numpy(mel),
                             _opts(tdec))
    prompt, suppress, blank = plan[6], plan[7], plan[8]
    args = (model, xa, prompt, torch.from_numpy(suppress),
            torch.from_numpy(blank), spec)

    def counted(q, k8, k_s, v8, v_s, *, k_scale):
        _lib.count("cross_attn_int8")
        return cross_attn_cuda.cross_attn_step_int8_plain(
            q, k8, k_s, v8, v_s, k_scale=k_scale)

    def stub_capture(fn):
        fn()  # the capture runs the chunk once, counted as launches

        def replay():
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(_lib, "count", lambda name: None)
                fn()
        return types.SimpleNamespace(replay=replay)

    monkeypatch.setattr(tw, "cross_attn_step_int8", counted)
    # the counts this test makes are its own: the process's stay as they
    # were (tests/test_torch_quantized.py holds the CPU path to 0)
    monkeypatch.setattr(_lib, "LAUNCHES", dict(_lib.LAUNCHES))
    want = tdec._decode_loop(*args, kv_int8=True)
    monkeypatch.setattr(decode_graph, "_warm_up", lambda fn: fn())
    monkeypatch.setattr(decode_graph, "_capture", stub_capture)
    monkeypatch.setattr(decode_graph, "_Flag", _StubFlag)
    decode_graph.reset_record()
    _lib.reset_launches()
    got = decode_graph._graphed(*args, kv_frames=None, kv_int8=True)
    for a, b in zip(got[:4] + got[5:], want[:4] + want[5:]):
        assert torch.equal(a, b)
    record = decode_graph.replay_record()
    layers = dims.n_text_layer
    # rows run to the budget: 16 steps = 4 chunks; the flag of chunk 3 says
    # done only once chunk 4 is queued, the last there is
    assert record == dict(captures=1, warmup_steps=1, replays=4,
                          steps=4 * decode_graph.CHUNK_STEPS)
    assert _lib.launch_counts()["cross_attn_int8"] == layers * (
        record["warmup_steps"] + record["steps"])
    # a second decode of the same shapes replays the same graph
    again = decode_graph._graphed(*args, kv_frames=None, kv_int8=True)
    assert torch.equal(again[0], want[0])
    assert decode_graph.replay_record()["captures"] == 1
    assert _lib.launch_counts()["cross_attn_int8"] == layers * (
        1 + 2 * record["steps"])


def test_graph_runner_stops_a_chunk_after_the_flag(monkeypatch):
    """Every row of the early plant gives eot at the second step: chunk 1's
    flag says done while chunk 2 runs, so two replays are made of the 4."""
    tok, _, _, model, mel = _setup("early")
    xa = tw.encode_audio(model, torch.from_numpy(mel), device="cpu")
    plan = tdec._decode_plan(model.dims, tok, torch.from_numpy(mel),
                             _opts(tdec))
    spec = tdec.LoopSpec(
        sample_begin=3, total=3 + SAMPLE_LEN, ts_begin=tok.timestamp_begin,
        eot=tok.eot, no_timestamps=tok.no_timestamps,
        no_speech=tok.no_speech, max_initial_ts_index=50,
        use_timestamps=True, sot_index=0, cross_mode="xla",
        track_margin=False)
    args = (model, xa, plan[6], torch.from_numpy(plan[7]),
            torch.from_numpy(plan[8]), spec)
    monkeypatch.setattr(decode_graph, "_warm_up", lambda fn: fn())
    monkeypatch.setattr(decode_graph, "_capture",
                        lambda fn: types.SimpleNamespace(replay=fn))
    monkeypatch.setattr(decode_graph, "_Flag", _StubFlag)
    decode_graph.reset_record()
    got = decode_graph._graphed(*args, kv_frames=None, kv_int8=False)
    want = tdec._decode_loop(*args)
    assert all(torch.equal(a, b) for a, b in zip(got[:4], want[:4]))
    assert int(got[3]) == 4
    assert decode_graph.replay_record()["replays"] == 2


def test_graphed_loop_refuses_a_cpu_model():
    tok, _, _, model, mel = _setup("early")
    with pytest.raises(ValueError, match="CUDA"):
        decode_graph.graphed_loop(model, torch.zeros(1, 32, 16), None, None,
                                  None, None)


# ---------------------------------------------------------------------------
# stage timers and the busy share
# ---------------------------------------------------------------------------

class _StubEvent:
    """A CUDA event on a fake device clock: ``record`` stamps the clock,
    ``elapsed_time`` gives milliseconds between two stamps."""
    clock = 0.0
    synced = 0

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = _StubEvent.clock

    def synchronize(self):
        _StubEvent.synced += 1

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_stage_timers_resolve_device_events_only_when_read(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _StubEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail(
        "a stage synchronised the device"))
    _StubEvent.clock, _StubEvent.synced = 0.0, 0
    timers = profiling.StageTimers(torch.device("cuda"))
    assert timers.on_device
    for dt in (0.5, 0.25):
        with timers.stage("decode dispatch", units=8):
            _StubEvent.clock += dt
    with timers.stage("collect sync", units=8):
        pass
    assert _StubEvent.synced == 0  # nothing resolved while stages run
    totals = timers.totals
    assert _StubEvent.synced == 3
    assert totals == {"decode dispatch": 0.75, "collect sync": 0.0}
    summary = timers.summary()
    assert summary["decode dispatch"]["units_per_s"] == round(16 / 0.75, 2)
    assert set(summary["decode dispatch"]) == {
        "total_s", "calls", "ms_per_call", "host_s", "units_per_s"}
    assert "units_per_s" not in summary["collect sync"]
    assert timers.totals == totals  # resolved once, kept
    timers.reset()
    assert not timers.totals and not timers.host_totals


def test_busy_share_of_a_stub_trace():
    from torch.autograd import DeviceType

    def event(start, end, device):
        return types.SimpleNamespace(
            time_range=types.SimpleNamespace(start=start, end=end),
            device_type=DeviceType.CUDA if device else DeviceType.CPU)

    events = [event(0, 1000, False), event(100, 300, True),
              event(250, 400, True), event(600, 700, True),
              event(-50, 50, True), event(900, 1000, False)]
    got = profiling.trace_busy(types.SimpleNamespace(events=lambda: events))
    assert got["share"] == pytest.approx(0.4)  # (100..400, 600..700) / 1000
    assert got["window_s"] == pytest.approx(1e-3)
    assert got["busy_s"] == pytest.approx(4e-4)
    assert got["records"] == 3  # the one that began before the trace: out
    assert profiling.trace_busy(types.SimpleNamespace(
        events=lambda: [event(0, 5, False)]))["share"] is None
    assert profiling.busy_share([(0, 2), (1, 3), (5, 9)], (0, 10)) == 0.7
