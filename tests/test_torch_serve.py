"""The port's HTTP server against its solo API and the JAX package's API, on
the CPU: a live ``serve(..., device="cpu")`` thread on the tiny model of
tests/test_torch_transcribe.py (JAX weights carried across; stdlib client,
WAV bytes in, JSON out), mirroring tests/test_serve.py.

- ``/align`` JSON equals the port's solo ``api.align`` and JAX
  ``api.align`` (words and boundaries equal), transcripts pinned per audio
  on every side (random weights transcribe empty, which would make the
  comparison vacuous);
- ``/transcribe`` JSON equals the port's solo ``api.transcribe`` and, within
  the model tolerance 2e-4 for float fields, JAX ``api.transcribe``
  (the fallback ladder samples JAX's noise, put in through
  ``beam.noise_source``);
- concurrent requests share micro-batches and each equals its solo twin;
  mixed recipe keys never share a batch; a 413 before the body is read; a
  timed-out request withdraws itself; the pipeline LRU; device work runs on
  the two dispatcher threads only; options the port lacks raise their
  ROADMAP item;
- the warmups: their run counts, and with the CUDA graph stubbed as in
  tests/test_torch_decode_graph.py, no graph captured by a first request of
  a warmed shape.
"""

import json
import os
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from test_torch_transcribe import _setup, assert_like_jax, jax_window_noise
from whisper_char_alignment_tpu import api as japi
from whisper_char_alignment_tpu.text.tokenizer import \
    get_test_tokenizer as jax_tokenizer
from whisper_char_alignment_tpu_torch import api as tapi
from whisper_char_alignment_tpu_torch.audio.wav import save as wav_save
from whisper_char_alignment_tpu_torch.cli import serve as serve_mod
from whisper_char_alignment_tpu_torch.cli.serve import (AlignBatcher, serve,
                                                        warmup,
                                                        warmup_transcribe)
from whisper_char_alignment_tpu_torch.models import beam as tbeam
from whisper_char_alignment_tpu_torch.models import decode_graph, decoding

torch.set_num_threads(1)

TRANSCRIBE_Q = dict(language="en", sample_len=6)


def _models():
    tok, dims, params, model = _setup()
    return (tapi.Model(model=model, tokenizer=tok, name="test"),
            japi.Model(params=params, dims=dims, tokenizer=jax_tokenizer(),
                       name="test"))


def _pin_transcripts(pipe):
    """Fake transcripts keyed on the audio's sample count (the JAX suite's
    pin), so every aligned request has non-empty words."""
    words = ("alpha", "beta", "gamma", "delta", "epsilon")

    def fake(utts):
        return [f"{words[u.duration % 5]} {words[(u.duration // 3) % 5]}"
                for u in utts]

    pipe.transcribe_override = fake


def _pinned(pipeline_cls):
    def make(*a, **k):
        p = pipeline_cls(*a, **k)
        _pin_transcripts(p)
        return p
    return make


@pytest.fixture(scope="module")
def srv_obj():
    model, _ = _models()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbeam, "noise_source", jax_window_noise())
        # long linger so concurrent test clients coalesce into one batch
        srv = serve(model, host="127.0.0.1", port=0, batch_size=4,
                    linger_ms=300.0, device="cpu")
        srv.batcher.pipe_hook = _pin_transcripts
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        yield srv
        srv.shutdown()
        srv.batcher.close()
        srv.tbatcher.close()
        t.join(timeout=60)


@pytest.fixture(scope="module")
def server(srv_obj):
    return f"http://127.0.0.1:{srv_obj.server_address[1]}"


def _samples(seconds, seed):
    return (np.random.default_rng(seed).normal(0, 0.05, int(16000 * seconds))
            .astype(np.float32))


def _wav_bytes(seconds=0.4, seed=0):
    with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
        path = f.name
    try:
        wav_save(path, _samples(seconds, seed), 16000)
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.unlink(path)


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def _align_json(res):
    return {"fid": "utterance", "words": res.words,
            "start_times": [float(t) for t in res.start_times],
            "end_times": [float(t) for t in res.end_times],
            "transcription": res.transcription, "skipped": res.skipped}


def test_healthz(server):
    with urllib.request.urlopen(f"{server}/healthz", timeout=60) as r:
        assert r.status == 200
        assert json.loads(r.read()) == {"ok": True, "model": "test"}


def test_align_endpoint_matches_solo_and_jax(server, monkeypatch):
    from whisper_char_alignment_tpu_torch.audio.resample import \
        load_resampled_bytes

    model, jmodel = _models()
    body = _wav_bytes(0.41, seed=1)
    status, out = _post(f"{server}/align?topk=3", body)
    assert status == 200
    audio = load_resampled_bytes(body)
    monkeypatch.setattr(tapi, "AlignmentPipeline",
                        _pinned(tapi.AlignmentPipeline))
    monkeypatch.setattr(japi, "AlignmentPipeline",
                        _pinned(japi.AlignmentPipeline))
    solo = tapi.align(model, audio, topk=3, device="cpu")
    want = japi.align(jmodel, audio, topk=3)
    assert out == _align_json(solo)
    assert out["words"] == want.words and len(out["words"]) >= 3
    assert out["start_times"] == [float(t) for t in want.start_times]
    assert out["end_times"] == [float(t) for t in want.end_times]


def test_transcribe_endpoint_matches_solo_and_jax(server):
    from whisper_char_alignment_tpu_torch.audio.resample import \
        load_resampled_bytes

    model, jmodel = _models()
    body = _wav_bytes(1.1, seed=2)
    status, out = _post(f"{server}/transcribe?language=en&sample_len=6"
                        "&word_timestamps=1", body)
    assert status == 200
    audio = load_resampled_bytes(body)
    kwargs = dict(language="en", sample_len=6, word_timestamps=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbeam, "noise_source", jax_window_noise())
        solo = tapi.transcribe(model, audio, device="cpu", **kwargs)
    assert out == json.loads(json.dumps(solo))
    assert_like_jax(out, japi.transcribe(jmodel, audio, **kwargs))
    assert out["segments"] and out["language"] == "en"


def test_unknown_route_and_bad_body(server):
    req = urllib.request.Request(f"{server}/nope", data=b"x", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 404
    req = urllib.request.Request(f"{server}/align", data=b"not a wav",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 500
    assert "error" in json.loads(e.value.read())
    with urllib.request.urlopen(f"{server}/healthz", timeout=60) as r:
        assert r.status == 200


def _concurrent(url, bodies):
    outs, errors = {}, []

    def client(i, body):
        try:
            outs[i] = _post(url, body)[1]
        except Exception as e:  # pragma: no cover - surfaced via errors
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i, b))
               for i, b in enumerate(bodies)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errors and not any(t.is_alive() for t in threads), errors
    return [outs[i] for i in range(len(bodies))]


def test_concurrent_aligns_micro_batch_and_match_solo(server, srv_obj):
    """Three audios posted solo, then six requests (each audio twice) land
    together: each equals its solo twin, in fewer batches than requests."""
    bodies = [_wav_bytes(0.25 + 0.08 * s, seed=s) for s in range(3)]
    solo = [_post(f"{server}/align?topk=3", b)[1] for b in bodies]
    for s in solo:
        assert len(s["words"]) >= 2 and len(s["end_times"]) >= 2
    assert len({json.dumps(s, sort_keys=True) for s in solo}) == 3
    launches0, reqs0 = srv_obj.batcher.n_launches, srv_obj.batcher.n_reqs
    outs = _concurrent(f"{server}/align?topk=3", bodies * 2)
    assert outs == solo * 2
    assert srv_obj.batcher.n_reqs - reqs0 == 6
    assert srv_obj.batcher.n_launches - launches0 < 6


def test_mixed_recipe_keys_never_share_a_batch(server):
    body = _wav_bytes(0.35, seed=7)
    solo = {q: _post(f"{server}/align?topk={q}", body)[1] for q in (3, 1)}
    assert solo[3] != solo[1]
    out = {}

    def client(q):
        out[q] = _post(f"{server}/align?topk={q}", body)[1]

    threads = [threading.Thread(target=client, args=(q,)) for q in (3, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert out == solo


def test_batcher_stress_mixed_keys_and_clients(server):
    """16 requests across two recipe keys land together; every response
    equals its solo twin, none lost or misrouted."""
    bodies = {s: _wav_bytes(0.2 + 0.1 * s, seed=20 + s) for s in range(2)}
    jobs = [(s, q) for s in range(2) for q in (3, 1)] * 4
    solo = {(s, q): _post(f"{server}/align?topk={q}", bodies[s])[1]
            for s, q in set(jobs)}
    results, errors, lock = {}, [], threading.Lock()

    def client(i, s, q):
        try:
            o = _post(f"{server}/align?topk={q}", bodies[s])[1]
            with lock:
                results[i] = ((s, q), o)
        except Exception as e:  # pragma: no cover
            with lock:
                errors.append(e)

    threads = [threading.Thread(target=client, args=(i, s, q))
               for i, (s, q) in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errors and len(results) == len(jobs), errors
    for key, o in results.values():
        assert o == solo[key], key


def test_concurrent_transcribes_micro_batch_and_match_solo(server, srv_obj):
    tb = srv_obj.tbatcher
    bodies = [_wav_bytes(0.3 + 0.2 * k, seed=10 + k) for k in range(3)]
    url = f"{server}/transcribe?language=en&sample_len=6"
    solo = [_post(url, b)[1] for b in bodies]
    launches0, reqs0 = tb.n_launches, tb.n_reqs
    outs = _concurrent(url, bodies)
    assert tb.n_reqs - reqs0 == 3
    assert tb.n_launches - launches0 < 3
    assert outs == solo
    assert len({o["text"] for o in outs}) > 1


def test_device_work_runs_on_the_dispatcher_threads(server, monkeypatch):
    """Handler threads parse WAV bytes only: every decode runs on the
    /align or the /transcribe dispatcher thread."""
    names = set()
    real = decoding.decode

    def spy(*a, **kw):
        names.add(threading.current_thread().name)
        return real(*a, **kw)

    monkeypatch.setattr(decoding, "decode", spy)
    _post(f"{server}/align?topk=3", _wav_bytes(0.3, seed=30))
    _post(f"{server}/transcribe?language=en&sample_len=4",
          _wav_bytes(0.3, seed=31))
    assert names == {"align-batcher", "transcribe-batcher"}


def test_oversized_body_rejected_413(server, monkeypatch):
    monkeypatch.setattr(serve_mod, "MAX_BODY_BYTES", 1024)
    req = urllib.request.Request(f"{server}/align", data=b"\x00" * 4096,
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 413
    assert "exceeds cap" in json.loads(e.value.read())["error"]
    with urllib.request.urlopen(f"{server}/healthz", timeout=60) as r:
        assert r.status == 200


def test_timed_out_request_is_withdrawn_from_queue():
    model, _ = _models()
    gate = threading.Lock()
    gate.acquire()  # stall the dispatcher's first batch on the device lock
    b = AlignBatcher(model, torch.float32, batch_size=1, linger_ms=0.0,
                     device_lock=gate, device="cpu")
    t1 = None
    try:
        audio = np.zeros(1600, np.float32)
        key = ("char", "topk", 3, 3)
        t1 = threading.Thread(target=lambda: b.submit(audio, key,
                                                      timeout=120))
        t1.start()
        for _ in range(200):
            if not b._queue and t1.is_alive():
                break
            time.sleep(0.01)
        with pytest.raises(TimeoutError):
            b.submit(audio, key, timeout=0.2)
        with b._cv:
            assert len(b._queue) == 0
    finally:
        gate.release()
        if t1 is not None:
            t1.join(timeout=300)
            assert not t1.is_alive()
        b.close()


def test_pipe_cache_is_lru_bounded():
    model, _ = _models()
    b = AlignBatcher(model, torch.float32, batch_size=1, linger_ms=0.0,
                     max_pipes=2, device="cpu")
    b.pipe_hook = _pin_transcripts
    try:
        audio = _samples(0.3, 5)
        key = lambda q: ("char", "topk", q, 3)  # noqa: E731
        first = b.submit(audio, key(1))
        for q in (2, 3):  # evicts q=1
            b.submit(audio, key(q))
        assert len(b._pipes) == 2 and key(1) not in b._pipes
        again = b.submit(audio, key(1))
        assert again.words == first.words and len(first.words) >= 2
        np.testing.assert_array_equal(again.end_times, first.end_times)
    finally:
        b.close()


@pytest.mark.parametrize("over,item", [
    (dict(encoder_int8=True), "item 7"), (dict(data_parallel=2), "item 9"),
    (dict(tensor_parallel=2), "item 9")])
def test_unported_overrides_name_their_item(over, item):
    model, _ = _models()
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
        AlignBatcher(model, torch.float32, config_overrides=over,
                     device="cpu")
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
        serve(model, port=0, config_overrides=over, device="cpu")


def test_main_refuses_unported_flags(monkeypatch):
    monkeypatch.setenv("WCA_PLATFORM", "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 7"):
        serve_mod.main(["--test_model", "--encoder_int8", "--port", "0"])
    with pytest.raises(SystemExit):
        serve_mod.main(["--test_model", "--decode_frame_bucket_guarded"])


class _Flag:
    def __init__(self, done):
        self.value = bool(done)

    def read(self):
        return self.value


@pytest.fixture
def stub_graphs(monkeypatch):
    """The CUDA graph runner on the CPU: capture runs the chunk, replay
    runs it again (tests/test_torch_decode_graph.py's stubs)."""
    monkeypatch.setattr(decode_graph, "_warm_up", lambda fn: fn())
    monkeypatch.setattr(decode_graph, "_capture",
                        lambda fn: types.SimpleNamespace(replay=fn))
    monkeypatch.setattr(decode_graph, "_Flag", _Flag)
    monkeypatch.setattr(decoding, "_loop_for",
                        lambda dev: decode_graph._graphed)
    monkeypatch.setattr(decoding, "runner_for",
                        lambda dev: decode_graph.replay)
    monkeypatch.setattr(tbeam, "noise_source", jax_window_noise())


def test_warmup_runs_each_bucket(stub_graphs):
    model, _ = _models()
    assert warmup(model, seconds=(0.2, 0.4), device="cpu") == 2
    assert warmup_transcribe(model, batch_size=4, seconds=0.3, sample_len=4,
                             temperature=0.0, device="cpu") == 3  # 1, 2, 4


def test_no_capture_after_warmup(stub_graphs):
    """After ``warmup`` through the /align batcher and ``warmup_transcribe``
    with the traffic's recipe, a first /align request and a first wave of
    one-window /transcribe requests (batch 1 and 4, the fallback ladder
    climbing) capture no graph."""
    model, _ = _models()
    srv = serve(model, port=0, batch_size=4, linger_ms=300.0, device="cpu")
    srv.batcher.pipe_hook = _pin_transcripts
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        decode_graph.reset_record()
        warmup(model, seconds=(0.3,), batcher=srv.batcher)
        warmup_transcribe(model, batch_size=4, seconds=0.3,
                          tbatcher=srv.tbatcher, **TRANSCRIBE_Q)
        warmed = decode_graph.replay_record()
        assert warmed["captures"] >= 4  # /align, B=1, 2, 4 (+ sampling)
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        _post(f"{url}/align", _wav_bytes(0.3, seed=40))
        q = "&".join(f"{k}={v}" for k, v in TRANSCRIBE_Q.items())
        _post(f"{url}/transcribe?{q}", _wav_bytes(0.3, seed=41))
        outs = _concurrent(f"{url}/transcribe?{q}",
                           [_wav_bytes(0.2 + 0.05 * k, seed=42 + k)
                            for k in range(4)])
        after = decode_graph.replay_record()
        assert after["captures"] == warmed["captures"], (warmed, after)
        assert after["replays"] > warmed["replays"]
        assert any(s["temperature"] > 0 for o in outs for s in o["segments"])
    finally:
        srv.shutdown()
        srv.batcher.close()
        srv.tbatcher.close()
        t.join(timeout=60)
