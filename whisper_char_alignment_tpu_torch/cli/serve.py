"""Minimal HTTP serving layer (port of
``whisper_char_alignment_tpu/cli/serve.py``): load the model once, serve
alignment and transcription over plain HTTP (standard library only).

    python -m whisper_char_alignment_tpu_torch.cli.serve --port 8200 \\
        --model medium --checkpoint medium.pt --warmup

Endpoints (WAV bytes in, JSON out):
- ``POST /align``       -> {fid, words, start_times, end_times, transcription,
  skipped}; query params: aligned_unit_type, aggregation, topk,
  medfilt_width
- ``POST /transcribe``  -> the transcribe() result dict; query params:
  language, task, beam_size, best_of, patience, length_penalty,
  initial_prompt, temperature, sample_len, word_timestamps,
  without_timestamps
- ``GET /healthz``      -> {"ok": true, "model": ...}

Requests are handled on a thread pool, and the handler threads only parse
WAV bytes on the host. All CUDA work runs on the two dispatcher threads
(one per endpoint), behind one device lock: every decode, graph capture and
replay, ``DecodeFuture.result()`` and stage-timer event read. Concurrent
/align requests that share a recipe (aligned_unit_type, aggregation, topk,
medfilt_width) are micro-batched: a dispatcher collects them for up to
``--serve_linger_ms`` or ``--serve_batch_size`` items and runs them as one
``AlignmentPipeline.align_batch``. Concurrent same-recipe /transcribe
requests micro-batch too: their seek loops advance independently and each
round's pending window decodes run as shared batched decodes
(``TranscribeBatcher`` -> ``transcribe_batched``). Results equal serving
each request alone.

The decode loops replay CUDA graphs keyed by their shapes (rows, prompt
length, options; ``models/decode_graph.py``), captured on first use;
``--warmup`` captures the /align graph and the /transcribe graphs of each
power-of-two batch of first windows at boot. The model is cast to the
compute dtype once, and every pipeline and graph uses that one module.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .. import api
from ..config import AlignConfig
from ..data.dataset import Utterance
from ..models import whisper as wmodel
from ..runner import AlignmentPipeline
from ..utils.device import resolve_device
from . import common

_TRUE = ("1", "true", "True", "yes")

# request-body cap: 30 s of 16 kHz float64 WAV is ~4 MB; 256 MB leaves room
# for long-form multi-channel uploads while bounding a single POST's memory
MAX_BODY_BYTES = int(float(os.environ.get("WCA_SERVE_MAX_BODY_MB", "256"))
                     * 1024 * 1024)


class _Server(ThreadingHTTPServer):
    # the listen backlog: at the default 5, a burst of concurrent clients
    # past it has its connections dropped and retried a second later
    request_queue_size = 128


class _BodyTooLarge(ValueError):
    """Raised before reading an oversized request body (HTTP 413)."""


def _q(qs, name, default=None, cast=str):
    vals = qs.get(name)
    if not vals:
        return default
    return cast(vals[0])


class _AlignRequest:
    __slots__ = ("audio", "key", "event", "result", "error")

    def __init__(self, audio, key):
        self.audio = audio
        self.key = key
        self.event = threading.Event()
        self.result = None
        self.error = None


class _MicroBatcher:
    """Queue/linger/dispatch skeleton shared by the /align and /transcribe
    batchers: handler threads :meth:`submit` and block; one dispatcher thread
    drains the queue, groups requests sharing a recipe key, lingers up to
    ``linger_ms`` for the batch to fill, and runs the subclass's
    :meth:`_run_batch` for each group."""

    def __init__(self, batch_size: int = 8, linger_ms: float = 5.0,
                 device_lock: "threading.Lock | None" = None,
                 name: str = "micro-batcher"):
        self.batch_size = max(1, batch_size)
        self.linger_s = max(0.0, linger_ms) / 1000.0
        self.device_lock = device_lock or threading.Lock()
        self._queue: "collections.deque[_AlignRequest]" = collections.deque()
        self._cv = threading.Condition()
        self._stop = False
        self.n_launches = 0
        self.n_reqs = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=name)
        self._thread.start()

    def _run_batch(self, batch):  # -> list of per-request results
        raise NotImplementedError

    def submit(self, audio: np.ndarray, key, timeout: "float | None" = None):
        """Queue one request and block until its batch completes.

        The default timeout tolerates a first request's graph captures
        (``WCA_SERVE_SUBMIT_TIMEOUT_S`` overrides; ``--warmup`` moves them
        to boot)."""
        if timeout is None:
            timeout = float(os.environ.get("WCA_SERVE_SUBMIT_TIMEOUT_S",
                                           "3600"))
        req = _AlignRequest(audio, key)
        with self._cv:
            self._queue.append(req)
            self._cv.notify_all()
        if not req.event.wait(timeout):
            # withdraw a still-queued request so the dispatcher never spends
            # a device launch on a client that already got its error; an
            # already-taken request's launch is in flight and completes
            # harmlessly (nobody waits on it)
            with self._cv:
                try:
                    self._queue.remove(req)
                except ValueError:
                    pass
            raise TimeoutError("request timed out in the batch queue")
        if req.error is not None:
            raise req.error
        return req.result

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=5)

    def _take_batch(self):
        """Under the cv: pop the oldest request plus up to batch_size-1 more
        sharing its key, lingering until the deadline while short."""
        first = self._queue.popleft()
        batch = [first]
        deadline = time.monotonic() + self.linger_s

        def drain():
            keep = collections.deque()
            while self._queue and len(batch) < self.batch_size:
                r = self._queue.popleft()
                (batch if r.key == first.key else keep).append(r)
            # unmatched keys keep their arrival order for the next launch
            self._queue.extendleft(reversed(keep))

        drain()
        while len(batch) < self.batch_size and not self._stop:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            self._cv.wait(remaining)
            drain()
        return batch

    def _loop(self):
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait()
                if self._stop:
                    for r in self._queue:
                        r.error = RuntimeError("server shutting down")
                        r.event.set()
                    return
                batch = self._take_batch()
            try:
                results = self._run_batch(batch)
                for r, res in zip(batch, results):
                    r.result = res
                    r.event.set()
                self.n_launches += 1
                self.n_reqs += len(batch)
            except Exception as e:  # fan the failure out to every waiter
                for r in batch:
                    r.error = e
                    r.event.set()


class AlignBatcher(_MicroBatcher):
    """Cross-request micro-batching for /align.

    Runs one padded batch through the same ``AlignmentPipeline.align_batch``
    the offline CLI uses, so a batched request's boundaries equal a solo
    one's. Requests with another recipe key stay queued and form the next
    batch. ``device_lock`` is shared with /transcribe so the two endpoints
    never interleave device work. The pipelines (one per recipe) are kept in
    an LRU of ``max_pipes``. ``config_overrides`` are extra AlignConfig
    fields (``encoder_int8`` quantizes each pipeline's encoder; as in the
    JAX package, ``data_parallel``/``tensor_parallel`` are read by the CLIs
    only); an unknown field raises here."""

    def __init__(self, model: api.Model, compute_dtype,
                 batch_size: int = 8, linger_ms: float = 5.0,
                 device_lock: "threading.Lock | None" = None,
                 config_overrides: "dict | None" = None,
                 max_pipes: int = 8, device=None):
        self.model = model
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        self.config_overrides = dict(config_overrides or {})
        AlignConfig(**self.config_overrides)
        self.max_pipes = max(1, max_pipes)
        self._pipes: "collections.OrderedDict" = collections.OrderedDict()
        # test seam: called with each newly built pipeline (e.g. to install a
        # deterministic transcribe_override so batched-vs-solo checks compare
        # real, non-empty alignments)
        self.pipe_hook = None
        super().__init__(batch_size=batch_size, linger_ms=linger_ms,
                         device_lock=device_lock, name="align-batcher")

    def _pipe(self, key) -> AlignmentPipeline:
        pipe = self._pipes.get(key)
        if pipe is not None:
            self._pipes.move_to_end(key)
        else:
            unit, aggr, topk, medfilt = key
            cfg = AlignConfig(aligned_unit_type=unit, aggr=aggr, topk=topk,
                              medfilt_width=medfilt,
                              batch_size=self.batch_size,
                              model=self.model.name,
                              **self.config_overrides)
            pipe = AlignmentPipeline(self.model.model, self.model.tokenizer,
                                     cfg, device=self.device,
                                     compute_dtype=self.compute_dtype)
            if self.pipe_hook is not None:
                self.pipe_hook(pipe)
            self._pipes[key] = pipe
            while len(self._pipes) > self.max_pipes:
                self._pipes.popitem(last=False)  # evict least recently used
        return pipe

    def _run_batch(self, batch):
        # unique fids per request: rows are matched positionally, and
        # duplicate fids must never be load-bearing
        utts = [Utterance(audio=r.audio.astype(np.float32),
                          duration=r.audio.size, text="", starts=[],
                          ends=[], fid=f"req{j}")
                for j, r in enumerate(batch)]
        with self.device_lock:
            pipe = self._pipe(batch[0].key)
            # no matrix: the handler serializes only words/times/text
            out = pipe.align_batch(utts, return_matrix=False)
            # resolve the stage timers' CUDA events now, under the lock, so
            # a long-lived pipeline does not keep every batch's events
            pipe.timers.totals
        return out


class TranscribeBatcher(_MicroBatcher):
    """Cross-request micro-batching for /transcribe.

    Concurrent requests sharing one recipe key (the transcribe query params)
    run as one ``transcribe_batched`` call: each request's seek loop
    advances independently, but every round their pending window decodes
    group into shared batched decodes. Each result equals the request
    served alone."""

    def __init__(self, model: api.Model, compute_dtype,
                 batch_size: int = 8, linger_ms: float = 5.0,
                 device_lock: "threading.Lock | None" = None, device=None):
        self.device = resolve_device(device)
        self.model = api.Model(
            model=wmodel.cast_params(model.model, compute_dtype, self.device),
            tokenizer=model.tokenizer, name=model.name)
        super().__init__(batch_size=batch_size, linger_ms=linger_ms,
                         device_lock=device_lock, name="transcribe-batcher")

    def _run_batch(self, batch):
        from ..transcribe import transcribe_batched

        kwargs = dict(batch[0].key)
        kwargs.setdefault("model_name", self.model.name)
        with self.device_lock:
            return transcribe_batched(
                self.model.model, self.model.tokenizer,
                [r.audio for r in batch], max_batch=self.batch_size,
                device=self.device.type, **kwargs)


def make_handler(model: api.Model, batcher: AlignBatcher,
                 tbatcher: TranscribeBatcher):
    """The request handler: it parses the WAV bytes and the query on its own
    thread and hands the device work to the two batchers' threads."""
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            print(f"{self.address_string()} {fmt % args}", file=sys.stderr)

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_wav(self) -> np.ndarray:
            n = int(self.headers.get("Content-Length", "0"))
            if n > MAX_BODY_BYTES:
                # refuse before reading: an oversized POST must not be able to
                # exhaust host memory. WCA_SERVE_MAX_BODY_MB sets the cap.
                raise _BodyTooLarge(
                    f"request body {n} bytes exceeds cap {MAX_BODY_BYTES}")
            data = self.rfile.read(n)
            from ..audio.resample import load_resampled_bytes

            return load_resampled_bytes(data)

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                return self._json(200, {"ok": True, "model": model.name})
            return self._json(404, {"error": "unknown route"})

        def do_POST(self):
            url = urlparse(self.path)
            qs = parse_qs(url.query)
            if url.path not in ("/align", "/transcribe"):
                return self._json(404, {"error": "unknown route"})
            try:
                audio = self._read_wav()
                if url.path == "/align":
                    key = (_q(qs, "aligned_unit_type", "char"),
                           _q(qs, "aggregation", "topk"),
                           _q(qs, "topk", 10, int),
                           _q(qs, "medfilt_width", 3, int))
                    res = batcher.submit(audio, key)
                    return self._json(200, {
                        # the internal fid encodes the batch slot; a response
                        # must not depend on which slot a request got
                        "fid": "utterance",
                        "words": res.words,
                        "start_times": [float(t) for t in res.start_times],
                        "end_times": [float(t) for t in res.end_times],
                        "transcription": res.transcription,
                        "skipped": res.skipped,
                    })
                # path is /transcribe (the 404 guard above excludes the rest)
                kwargs = {}
                for name, cast in (("language", str), ("task", str),
                                   ("beam_size", int), ("best_of", int),
                                   ("patience", float),
                                   ("length_penalty", float),
                                   ("initial_prompt", str),
                                   ("temperature", float),
                                   ("sample_len", int)):
                    v = _q(qs, name, None, cast)
                    if v is not None:
                        kwargs[name] = v
                if _q(qs, "word_timestamps") in _TRUE:
                    kwargs["word_timestamps"] = True
                if _q(qs, "without_timestamps") in _TRUE:
                    kwargs["without_timestamps"] = True
                # the key is the full kwarg tuple, so requests of two recipes
                # never share a decode
                out = tbatcher.submit(audio, tuple(sorted(kwargs.items())))
                return self._json(200, out)
            except _BodyTooLarge as e:
                return self._json(413, {"error": str(e)})
            except Exception as e:  # surface the failure to the client
                return self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(model: api.Model, host: str = "127.0.0.1", port: int = 8200,
          compute_dtype=torch.float32, batch_size: int = 8,
          linger_ms: float = 5.0, config_overrides: "dict | None" = None,
          max_pipes: int = 8, device=None) -> ThreadingHTTPServer:
    """Build the server (the caller invokes serve_forever / shutdown).

    The model is cast to ``compute_dtype`` on ``device`` (cuda unless
    'cpu') once; the batchers and the handler share that module, so they
    share its decode graphs. Both endpoints run on their dispatcher
    threads, one request a batch at ``batch_size=1``. ``config_overrides`` are extra
    AlignConfig fields for the /align pipelines (e.g. ``decode_sample_len``
    to bound a request's decode)."""
    dev = resolve_device(device)
    model = api.Model(model=wmodel.cast_params(model.model, compute_dtype,
                                               dev),
                      tokenizer=model.tokenizer, name=model.name)
    lock = threading.Lock()
    batcher = AlignBatcher(model, compute_dtype, batch_size=batch_size,
                           linger_ms=linger_ms, device_lock=lock,
                           config_overrides=config_overrides,
                           max_pipes=max_pipes, device=dev)
    tbatcher = TranscribeBatcher(model, compute_dtype, batch_size=batch_size,
                                 linger_ms=linger_ms, device_lock=lock,
                                 device=dev)
    handler = make_handler(model, batcher, tbatcher)
    srv = _Server((host, port), handler)
    srv.batcher = batcher  # tests/shutdown paths reach it here
    srv.tbatcher = tbatcher
    return srv


def warmup(model: api.Model, compute_dtype=torch.float32,
           seconds=(4.9, 9.9, 29.5),
           batcher: "AlignBatcher | None" = None, device=None) -> int:
    """Capture the /align decode graphs before accepting traffic: one dummy
    align per requested duration (the runner's 5 s wire buckets; with
    ``decode_frame_bucket`` each frame bucket is its own graph). When
    ``batcher`` is given the warmup runs through it, so the graphs carry
    the server's padded batch, model and recipe ("char", "topk", 10, 3).
    Returns the number of warmup runs."""
    n_samples = 2 * model.dims.n_audio_ctx * 160
    n = 0
    for sec in seconds:
        take = min(int(sec * 16000), n_samples)
        if take <= 0:
            continue
        audio = np.zeros((take,), np.float32)
        if batcher is not None:
            batcher.submit(audio, ("char", "topk", 10, 3))
        else:
            api.align(model, audio, compute_dtype=compute_dtype,
                      device=device)
        n += 1
        print(f"warmup: {sec:.1f}s bucket run", file=sys.stderr)
    return n


def warmup_transcribe(model: api.Model, compute_dtype=torch.float32,
                      batch_size: int = 8, seconds: float = 5.0,
                      tbatcher: "TranscribeBatcher | None" = None,
                      device=None, **decode_options) -> int:
    """Capture the /transcribe first-window decode graphs before traffic.

    ``transcribe_batched`` pads each shared decode to a power of two <=
    ``batch_size`` rows, and each row count is its own greedy graph: one
    dummy ``transcribe_batched`` per count captures them (and, where the
    dummy window climbs the fallback ladder, the one sampling graph its
    solo rungs share). ``decode_options`` must match the traffic's recipe
    (language, sample_len, temperature, ... are part of the graph key).
    With ``tbatcher`` it runs on the batcher's model under its lock (the
    graphs are cached per model module). Windows whose rolling prompt has
    another length are other graphs, captured on first use."""
    from ..transcribe import transcribe_batched

    lock = contextlib.nullcontext()
    if tbatcher is not None:
        model, device, lock = (tbatcher.model, tbatcher.device,
                               tbatcher.device_lock)
    else:
        model = api.Model(model=wmodel.cast_params(
            model.model, compute_dtype, resolve_device(device)),
            tokenizer=model.tokenizer, name=model.name)
    audio = np.zeros((int(seconds * 16000),), np.float32)
    decode_options.setdefault("language", "en")
    decode_options.setdefault("model_name", model.name)
    sizes = []
    b = 1
    while b <= max(1, batch_size):
        sizes.append(b)
        b *= 2
    for b in sizes:
        with lock:
            transcribe_batched(model.model, model.tokenizer, [audio] * b,
                               max_batch=batch_size, device=device,
                               **decode_options)
        print(f"warmup: transcribe batch B={b} run", file=sys.stderr)
    return len(sizes)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8200)
    p.add_argument("--model", type=str, default="medium")
    p.add_argument("--n_mels", type=int, default=80)
    p.add_argument("--warmup", action="store_true",
                   help="capture the /align and /transcribe decode graphs "
                        "(5/10/30 s audio, every power-of-two batch) before "
                        "accepting traffic")
    p.add_argument("--serve_batch_size", type=int, default=8,
                   help="micro-batch size for concurrent /align requests "
                        "(one device launch per batch; 1 disables batching)")
    p.add_argument("--serve_linger_ms", type=float, default=5.0,
                   help="max time the align dispatcher waits for a "
                        "micro-batch to fill before launching short")
    p.add_argument("--decode_sample_len", type=int, default=0,
                   help="cap /align decode steps per request (0 = published "
                        "default, n_text_ctx // 2) — bounds worst-case "
                        "per-request device time")
    p.add_argument("--max_pipes", type=int, default=8,
                   help="LRU bound on cached per-recipe align pipelines")
    p.add_argument("--decode_kv_int8_guarded", action="store_true",
                   help="serve with the guarded int8 K/V decode "
                        "(WCA_KV_INT8_GUARD_MARGIN; see infer_ali --help)")
    p.add_argument("--decode_frame_bucket", type=int, default=0,
                   help="bucket decode cross-K/V to each batch's true frames "
                        "(multiple N; 0 = full 30s window, reference-exact)")
    p.add_argument("--decode_frame_bucket_guarded", action="store_true",
                   help="guard the bucketed decode (WCA_BUCKET_GUARD_MARGIN; "
                        "see infer_ali --help)")
    common.add_tpu_flags(p)
    args = p.parse_args(argv)
    if args.decode_frame_bucket_guarded and args.decode_frame_bucket <= 0:
        # fail at parse time, not inside the batcher's thread on the first
        # request (AlignmentPipeline raises the same requirement)
        p.error("--decode_frame_bucket_guarded requires "
                "--decode_frame_bucket N (the bucket multiple)")
    device = common.apply_platform_env()
    net, tok = common.load_model_and_tokenizer(args, device)
    dtype = common.compute_dtype(args)
    name = "tiny-test" if args.test_model else args.model
    model = api.Model(model=net, tokenizer=tok, name=name)
    srv = serve(model, args.host, args.port, compute_dtype=dtype,
                batch_size=args.serve_batch_size,
                linger_ms=args.serve_linger_ms,
                config_overrides={
                    k: v for k, v in dict(
                        decode_sample_len=args.decode_sample_len,
                        decode_kv_int8_guarded=args.decode_kv_int8_guarded,
                        decode_frame_bucket=args.decode_frame_bucket,
                        decode_frame_bucket_guarded=(
                            args.decode_frame_bucket_guarded),
                    ).items() if v} or None,
                max_pipes=args.max_pipes, device=device)
    if args.warmup:
        warmup(model, compute_dtype=dtype, batcher=srv.batcher)
        warmup_transcribe(model, compute_dtype=dtype,
                          batch_size=args.serve_batch_size,
                          tbatcher=srv.tbatcher)
    print(f"serving {args.model} on http://{args.host}:{args.port}",
          file=sys.stderr)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()
    finally:
        srv.batcher.close()
        srv.tbatcher.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
