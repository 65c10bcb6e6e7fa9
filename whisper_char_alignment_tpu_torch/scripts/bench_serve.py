"""Serving-layer throughput bench: multi-stream /align (or /transcribe) vs
request-at-a-time (port of the repository's ``scripts/bench_serve.py``).

    python -m whisper_char_alignment_tpu_torch.scripts.bench_serve
    WCA_PLATFORM=cpu WCA_SERVE_BENCH_TINY=1 python -m whisper_char_alignment_tpu_torch.scripts.bench_serve

Boots the HTTP server (``cli/serve.serve``) in process with Whisper-medium
shapes and random bf16 weights, captures its decode graphs through the
batchers (``warmup`` / ``warmup_transcribe``), posts one warm request and a
concurrent warm wave, then measures the same client workload two ways:

1. **serial**: one client posts N requests back to back (the p50 is the
   per-request floor: one batch per request);
2. **concurrent**: M client threads post the same N requests; the
   server's micro-batcher runs them as shared padded batches.

The client threads only do HTTP: every device call runs on the server's
dispatcher threads. Any lost or failed request fails the run.

Prints ONE JSON line: the JAX script's keys (serial and concurrent req/s,
p50 latencies, the speedup, the batchers' counts) plus
``p95_concurrent_ms`` with its sample count ``concurrent_samples``,
``peak_device_mem_gib`` (``torch.cuda.max_memory_allocated`` over the run,
warmups included), ``device``, ``launches`` (kernel launches of the serial
and concurrent phases) and ``graph_captures_timed`` (decode graphs captured
in them). Everything else goes to stderr. Runs on ``cuda`` unless
``WCA_PLATFORM=cpu``; without a card it exits non-zero and prints no line.

Knobs (env): WCA_SERVE_BENCH_REQS (32), WCA_SERVE_BENCH_CLIENTS (8),
WCA_SERVE_BENCH_BATCH (8), WCA_SERVE_BENCH_DECODE_LEN (32),
WCA_SERVE_BENCH_SECONDS (5.0), WCA_SERVE_BENCH_ENDPOINT (align or
transcribe), WCA_SERVE_BENCH_TEMPERATURE (unset: the published fallback
ladder; 0 pins one greedy rung, the shape of real traffic whose windows
pass the quality thresholds), WCA_SERVE_BENCH_MODEL (medium),
WCA_SERVE_BENCH_TINY=1 (tiny dims, CPU-friendly).
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import tempfile
import threading
import time
import urllib.request
from typing import Optional, Sequence

import numpy as np
import torch

from .. import api
from ..audio.wav import save as wav_save
from ..bench import (add_counts, build_model, device_label, log,
                     peak_mem_gib, platform_device, reset_peak_mem,
                     synchronize, timed)
from ..cli.serve import serve, warmup, warmup_transcribe
from ..config import MODEL_DIMS, tiny_test_dims
from ..text.tokenizer import get_test_tokenizer


@dataclasses.dataclass(frozen=True)
class Settings:
    tiny: bool = False
    n_reqs: int = 32
    clients: int = 8
    batch: int = 8
    decode_len: int = 32
    seconds: float = 5.0
    endpoint: str = "align"
    temperature: Optional[str] = None
    model: str = "medium"

    @classmethod
    def from_env(cls) -> "Settings":
        env = os.environ.get
        tiny = env("WCA_SERVE_BENCH_TINY") == "1"
        endpoint = env("WCA_SERVE_BENCH_ENDPOINT", "align")
        if endpoint not in ("align", "transcribe"):
            raise ValueError(f"WCA_SERVE_BENCH_ENDPOINT={endpoint!r}: "
                             "'align' or 'transcribe'")
        return cls(
            tiny=tiny,
            n_reqs=int(env("WCA_SERVE_BENCH_REQS", "8" if tiny else "32")),
            clients=int(env("WCA_SERVE_BENCH_CLIENTS",
                            "4" if tiny else "8")),
            batch=int(env("WCA_SERVE_BENCH_BATCH", "4" if tiny else "8")),
            decode_len=int(env("WCA_SERVE_BENCH_DECODE_LEN",
                               "8" if tiny else "32")),
            seconds=float(env("WCA_SERVE_BENCH_SECONDS",
                              "0.5" if tiny else "5.0")),
            endpoint=endpoint,
            temperature=env("WCA_SERVE_BENCH_TEMPERATURE"),
            model=env("WCA_SERVE_BENCH_MODEL", "medium"))


def latency_summary(latencies_s: Sequence[float]) -> dict:
    """p50 (``statistics.median``, as the JAX script) and p95 (linear
    interpolation, ``numpy.percentile``) in ms, with the sample count."""
    ms = np.asarray(latencies_s, np.float64) * 1e3
    return {"p50_ms": round(float(statistics.median(ms)), 1),
            "p95_ms": round(float(np.percentile(ms, 95)), 1),
            "samples": int(ms.size)}


def _wav_body(seconds: float) -> bytes:
    audio = (np.random.default_rng(0)
             .normal(0, 0.05, int(seconds * 16000)).astype(np.float32))
    with tempfile.TemporaryDirectory(prefix="wca_serve_bench_") as d:
        path = os.path.join(d, "req.wav")
        wav_save(path, audio, 16000)
        with open(path, "rb") as f:
            return f.read()


def _wave(post, n: int, clients: int) -> list:
    """``n`` posts from ``clients`` threads (each takes the next request
    when its last one is answered); the latencies in completion order.
    Raises when any request fails or is lost."""
    lat, errors = [], []
    lock = threading.Lock()
    todo = iter(range(n))

    def client():
        while True:
            with lock:
                if next(todo, None) is None:
                    return
            try:
                d = post()
            except Exception as e:  # re-raised below, after the join
                with lock:
                    errors.append(e)
                return
            with lock:
                lat.append(d)

    threads = [threading.Thread(target=client) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=3600)
    if errors or len(lat) != n or any(t.is_alive() for t in threads):
        # a partially failed wave must fail loudly, never print a plausible
        # line over the surviving subset
        raise RuntimeError(
            f"concurrent wave failed: {len(errors)} errors, {len(lat)}/{n} "
            f"completed; first: {errors[0] if errors else 'requests lost'}")
    return lat


def run(model, tokenizer, *, device=None, settings: Optional[Settings] = None,
        model_name: str = "medium") -> dict:
    """Serve ``model`` (built, on ``device``, computed in its own dtype),
    measure it, shut the server down, and return the one line's payload."""
    s = settings or Settings.from_env()
    device = torch.device(device or model.device)
    m = api.Model(model=model, tokenizer=tokenizer, name=model_name)
    reset_peak_mem(device)
    srv = serve(m, host="127.0.0.1", port=0, compute_dtype=model.dtype,
                batch_size=s.batch, linger_ms=5.0,
                config_overrides={"decode_sample_len": s.decode_len},
                device=device)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        body = _wav_body(s.seconds)
        if s.endpoint == "transcribe":
            url = f"{base}/transcribe?language=en&sample_len={s.decode_len}"
            if s.temperature is not None:
                url += f"&temperature={s.temperature}"
            expect_key = "segments"
        else:
            url = f"{base}/align?topk=10"
            expect_key = "end_times"

        def post():
            t0 = time.perf_counter()
            req = urllib.request.Request(url, data=body, method="POST")
            with urllib.request.urlopen(req, timeout=3600) as r:
                out = json.loads(r.read())
            if expect_key not in out:
                raise RuntimeError(f"response without {expect_key}: {out}")
            return time.perf_counter() - t0

        log("warmup (captures the batchers' decode graphs)...")
        t0 = time.perf_counter()
        if s.endpoint == "transcribe":
            # every power-of-two batch a staggered wave can form is
            # captured before timing, on the batcher's model and recipe
            tkw = dict(language="en", sample_len=s.decode_len)
            if s.temperature is not None:
                tkw["temperature"] = float(s.temperature)
            warmup_transcribe(m, compute_dtype=model.dtype,
                              batch_size=s.batch, seconds=s.seconds,
                              tbatcher=srv.tbatcher, **tkw)
        else:
            warmup(m, compute_dtype=model.dtype, seconds=(s.seconds,),
                   batcher=srv.batcher)
        log(f"warmup done in {time.perf_counter() - t0:.1f}s")
        post()  # one warm request through the HTTP path
        # a full concurrent wave before timing: a failed warm wave would
        # leave its shapes to be captured inside the timed phase
        t0 = time.perf_counter()
        n_warm = min(s.clients, s.batch)
        _wave(post, n_warm, n_warm)
        log(f"concurrent-wave warmup done in {time.perf_counter() - t0:.1f}s")

        log(f"serial: {s.n_reqs} requests, 1 client...")
        with timed(device) as serial:
            serial_lat = [post() for _ in range(s.n_reqs)]
        log(f"concurrent: {s.n_reqs} requests, {s.clients} clients...")
        with timed(device) as conc:
            conc_lat = _wave(post, s.n_reqs, s.clients)
        batcher = srv.tbatcher if s.endpoint == "transcribe" else srv.batcher
        n_launches, n_reqs = batcher.n_launches, batcher.n_reqs
    finally:
        srv.shutdown()
        srv.batcher.close()
        srv.tbatcher.close()
        thread.join(timeout=60)
        srv.server_close()
    synchronize(device)

    serial_rps = s.n_reqs / serial["wall_s"]
    conc_rps = len(conc_lat) / conc["wall_s"]
    serial_sum = latency_summary(serial_lat)
    conc_sum = latency_summary(conc_lat)
    payload = {
        "metric": f"serve_{s.endpoint}_multistream_req_per_sec",
        "value": round(conc_rps, 3),
        "unit": "req/sec",
        "vs_baseline": None,
        "serial_req_per_sec": round(serial_rps, 3),
        "speedup_vs_serial": round(conc_rps / serial_rps, 2),
        "p50_serial_ms": serial_sum["p50_ms"],
        "p50_concurrent_ms": conc_sum["p50_ms"],
        "p95_concurrent_ms": conc_sum["p95_ms"],
        "concurrent_samples": conc_sum["samples"],
        "n_reqs": s.n_reqs, "clients": s.clients, "batch": s.batch,
        "decode_len": s.decode_len, "audio_seconds": s.seconds,
        "temperature": s.temperature,
        "batcher_launches": n_launches,
        "batcher_reqs": n_reqs,
        "peak_device_mem_gib": peak_mem_gib(device),
        "device": device_label(device),
        "launches": add_counts(serial["launches"], conc["launches"]),
        "graph_captures_timed": serial["captures"] + conc["captures"],
    }
    log(f"serial {serial_rps:.2f} req/s (p50 {payload['p50_serial_ms']} ms) "
        f"-> concurrent {conc_rps:.2f} req/s (p50 "
        f"{payload['p50_concurrent_ms']} ms, p95 "
        f"{payload['p95_concurrent_ms']} ms of {conc_sum['samples']}), "
        f"{payload['speedup_vs_serial']}x")
    return payload


def main() -> None:
    s = Settings.from_env()
    device = platform_device()
    tok = get_test_tokenizer()
    if s.tiny:
        dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=128,
                              n_text_ctx=96, state=32, head=4, layers=2)
        name = "tiny-test"
    else:
        name = s.model
        if name not in MODEL_DIMS:
            raise SystemExit(f"unknown WCA_SERVE_BENCH_MODEL={name!r}; "
                             f"choose from {sorted(MODEL_DIMS)}")
        dims = MODEL_DIMS[name]
    log(f"device: {device_label(device)}")
    payload = run(build_model(dims, device), tok, device=device, settings=s,
                  model_name=name)
    print(json.dumps(payload), flush=True)


if __name__ == "__main__":
    main()
