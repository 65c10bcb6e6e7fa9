"""Spans, stage timers and device traces (port of ``whisper_char_alignment_tpu/utils/profiling.py``).

:class:`StageTimers` is the port's one tracing system. A span
(:meth:`StageTimers.stage`, or :func:`span` inside whatever span is open)
has a name, a kind (:data:`KINDS`: ``issue``, the host queues device work;
``wait``, the host is blocked on the card; ``host``, host-only work that
launches nothing) and a parent, the innermost span open on the same thread.
Per name it keeps host seconds, self seconds (host seconds less the part
that child spans cover), calls, units and counters: the deltas of
``ops/_lib.LAUNCHES`` and ``models/decode_graph.RECORD`` that fell in the
span outside its children, on the thread that owns the stream, and the
counts the code adds (:func:`count`). On a CUDA device each top-level span
of the thread that owns the stream also records a pair of CUDA events on
the current stream; nothing synchronises while spans run, so timing does
not serialise the runner's software pipeline, and the events are resolved
only when ``totals`` or ``summary`` is read. The port issues on one stream,
so a ``host`` span's device seconds are the card's idle time during it.

While a ``torch.profiler`` is running each span also opens a
``record_function`` range ``wca.<name>``, with its batch index in its
arguments. :func:`device_trace` records a ``torch.profiler`` trace of a
block (host and, on a card, device activity) and writes it as a Chrome
trace for Perfetto; :func:`busy_window` and :func:`trace_busy` give a
trace's device-busy share and its idle time by span.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import sys
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

from ..ops import _lib

KINDS = ("issue", "wait", "host")

# models/decode_graph.RECORD's keys under their span counter names
_RECORD_COUNTERS = {"captures": "decode captures",
                    "warmup_steps": "decode warm-up steps",
                    "replays": "decode replays", "steps": "decode steps run"}

# per thread: ``frames``, the spans open on it (innermost last), and
# ``last``, the counter values at its last span boundary
_local = threading.local()


def _open_frames() -> list:
    try:
        return _local.frames
    except AttributeError:
        _local.frames = []
        return _local.frames


# the module of RECORD; not imported here, since it imports this module
_DECODE_GRAPH = __name__.rsplit(".", 2)[0] + ".models.decode_graph"


def _counter_values() -> tuple:
    graph = sys.modules.get(_DECODE_GRAPH)  # not loaded: nothing replayed
    return (tuple(_lib.LAUNCHES.items()),
            () if graph is None else tuple(graph.RECORD.items()))


def _tick(frames: list) -> None:
    """Charge the counters' growth since this thread's last span boundary
    to its innermost open span (none: the growth fell outside every
    span)."""
    now = _counter_values()
    last = getattr(_local, "last", None)
    _local.last = now
    if last is None or not frames or now == last:
        return
    top = frames[-1]
    for names, items, before in (
            (None, now[0], dict(last[0])),
            (_RECORD_COUNTERS, now[1], dict(last[1]))):
        for k, v in items:
            d = v - before.get(k, 0)
            if d:
                top.count("launches " + k if names is None
                          else names.get(k, k), d)


@dataclasses.dataclass
class SpanStats:
    """One span name's aggregate over its calls."""
    kind: str
    calls: int = 0
    units: int = 0
    host_s: float = 0.0  # host seconds, on every thread
    self_s: float = 0.0  # host seconds less what child spans cover
    main_s: float = 0.0  # self seconds on the thread that owns the stream
    # device seconds of its CUDA event pairs; None where it recorded none
    device_s: Optional[float] = None
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)


class SpanTotals(dict):
    """What :attr:`StageTimers.totals` returns: seconds by stage (device
    seconds of the spans that recorded CUDA events on a card, host seconds
    of every span on the CPU), and in ``spans`` a snapshot, taken at the
    read, of every span's :class:`SpanStats` by name."""

    def __init__(self, seconds: Dict[str, float],
                 spans: Dict[str, SpanStats]):
        super().__init__(seconds)
        self.spans = spans


class _Frame:
    """An open span."""
    __slots__ = ("timers", "name", "kind", "batch", "frames", "main",
                 "child_s", "counts")

    def __init__(self, timers, name, kind, batch, frames, main):
        self.timers = timers
        self.name, self.kind, self.batch = name, kind, batch
        self.frames, self.main = frames, main
        self.child_s = 0.0
        self.counts: Dict[str, int] = {}

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n


class StageTimers:
    """Spans by name (module docstring): host and self seconds, calls,
    units and counters, and on a CUDA ``device`` the device seconds of each
    top-level span on the thread that owns the stream (the thread that made
    the timers, or the last to :meth:`claim` them)."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = device
        self._owner = threading.get_ident()
        self._lock = threading.Lock()
        self._spans: Dict[str, SpanStats] = {}
        self._pending: Dict[str, list] = collections.defaultdict(list)

    @property
    def on_device(self) -> bool:
        return (self.device is not None
                and torch.device(self.device).type == "cuda")

    def claim(self) -> None:
        """Make the calling thread the one that owns the stream."""
        self._owner = threading.get_ident()

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._pending.clear()

    @contextlib.contextmanager
    def stage(self, name: str, units: int = 0, kind: str = "issue",
              batch: Optional[int] = None):
        """A span ``name`` of ``kind`` over the block; ``batch`` (inherited
        from the parent when None) names the batch in a profiler range.
        Yields the open span, whose ``count(name, n)`` adds to its
        counters."""
        if kind not in KINDS:
            raise ValueError(f"span kind {kind!r} is not one of {KINDS}")
        frames = _open_frames()
        parent = frames[-1] if frames else None
        main = threading.get_ident() == self._owner
        if batch is None and parent is not None:
            batch = parent.batch
        frame = _Frame(self, name, kind, batch, frames, main)
        if main:
            _tick(frames)
        pair = None
        if (main and parent is None and self.on_device
                and not (torch.cuda.is_initialized()
                         and torch.cuda.is_current_stream_capturing())):
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record()
        rng = None
        if _autograd_profiler._is_profiler_enabled:
            rng = torch.autograd.profiler.record_function(
                "wca." + name, None if batch is None else f"batch={batch}")
            rng.__enter__()
        frames.append(frame)
        t0 = time.perf_counter()
        try:
            yield frame
        finally:
            dt = time.perf_counter() - t0
            here = frames is _open_frames()
            if main and here:
                _tick(frames)
            if frames and frames[-1] is frame:
                frames.pop()
            else:  # closed out of order (a generator closed elsewhere)
                frames.remove(frame)
            if parent is not None:
                parent.child_s += dt
            if pair is not None:
                pair[1].record()
            if rng is not None:
                rng.__exit__(None, None, None)
            self._add(frame, dt, units, pair)

    def _add(self, frame: _Frame, dt: float, units: int, pair) -> None:
        with self._lock:
            s = self._spans.get(frame.name)
            if s is None:
                s = self._spans[frame.name] = SpanStats(frame.kind)
            own = dt - frame.child_s
            s.calls += 1
            s.units += units
            s.host_s += dt
            s.self_s += own
            if frame.main:
                s.main_s += own
            for k, v in frame.counts.items():
                s.counters[k] = s.counters.get(k, 0) + v
            if pair is not None:
                self._pending[frame.name].append(pair)

    @property
    def totals(self) -> SpanTotals:
        """Seconds by stage: on a card the device seconds between each
        top-level span's events (resolved here, which waits for the last of
        them), on the CPU the host seconds; with the snapshot of every
        span (:class:`SpanTotals`)."""
        with self._lock:
            for name, pairs in self._pending.items():
                s = self._spans[name]
                for start, end in pairs:
                    end.synchronize()
                    s.device_s = ((s.device_s or 0.0)
                                  + start.elapsed_time(end) / 1e3)
                pairs.clear()
            spans = {n: dataclasses.replace(s, counters=dict(s.counters))
                     for n, s in self._spans.items()}
        if self.on_device:
            seconds = {n: s.device_s for n, s in spans.items()
                       if s.device_s is not None}
        else:
            seconds = {n: s.host_s for n, s in spans.items()}
        return SpanTotals(seconds, spans)

    def summary(self) -> Dict[str, dict]:
        """Per stage: ``total_s`` (:attr:`totals`), calls, ms per call, units
        per second, and on a card ``host_s`` beside the device seconds."""
        totals = self.totals
        out = {}
        for name, total in sorted(totals.items(), key=lambda kv: -kv[1]):
            s = totals.spans[name]
            out[name] = {
                "total_s": round(total, 4),
                "calls": s.calls,
                "ms_per_call": round(1000 * total / max(s.calls, 1), 2),
            }
            if self.on_device:
                out[name]["host_s"] = round(s.host_s, 4)
            if s.units and total > 0:
                out[name]["units_per_s"] = round(s.units / total, 2)
        return out

    def span_summary(self) -> Dict[str, dict]:
        """Per span, children and other threads' spans included: kind,
        calls, host and self seconds, and counters."""
        return {name: {"kind": s.kind, "calls": s.calls,
                       "host_s": round(s.host_s, 4),
                       "self_s": round(s.self_s, 4), "counters": s.counters}
                for name, s in sorted(self.totals.spans.items(),
                                      key=lambda kv: -kv[1].self_s)}

    def report(self, file=sys.stderr) -> None:
        if self._spans:
            print("stage profile: " + json.dumps(self.summary()), file=file)
            print("span profile: " + json.dumps(self.span_summary()),
                  file=file)


def span(name: str, kind: str = "issue", units: int = 0):
    """A child span of the innermost span open on this thread, in its
    timers; nothing where none is open."""
    frames = _open_frames()
    if not frames:
        return contextlib.nullcontext()
    return frames[-1].timers.stage(name, units, kind=kind)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost span open on this
    thread; nothing where none is open."""
    frames = _open_frames()
    if frames:
        frames[-1].count(name, n)


def _union(intervals: Iterable[Tuple[float, float]],
           window: Tuple[float, float]) -> List[list]:
    """The union of ``intervals``, each clipped to ``window``, as ordered
    disjoint [start, end] pairs."""
    out, reach = [], window[0]
    for start, end in sorted(intervals):
        start, end = max(start, reach), min(end, window[1])
        if end > start:
            if out and start == out[-1][1]:
                out[-1][1] = end
            else:
                out.append([start, end])
            reach = end
    return out


def busy_share(intervals: Iterable[Tuple[float, float]],
               window: Tuple[float, float]) -> float:
    """The share of ``window`` (start, end) covered by the union of
    ``intervals``, each clipped to the window."""
    lo, hi = window
    covered = sum(end - start for start, end in _union(intervals, window))
    return covered / (hi - lo) if hi > lo else 0.0


def _innermost(ranges) -> List[tuple]:
    """Disjoint (start, end, name) pieces of time, in order, each charged to
    the innermost of the nested ``ranges`` (start, end, name) open over
    it."""
    out, open_, t = [], [], None  # open_: (end, name), innermost last
    for start, end, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while open_ and open_[-1][0] <= start:
            e, n = open_.pop()
            out.append((t, e, n))
            t = e
        if open_:
            out.append((t, start, open_[-1][1]))
            end = min(end, open_[-1][0])
        open_.append((end, name))
        t = start
    while open_:
        e, n = open_.pop()
        out.append((t, e, n))
        t = e
    return [p for p in out if p[1] > p[0]]


def _idle_by_span(busy, window, pieces) -> Dict[str, float]:
    """The gaps of ``window`` between the merged, ordered ``busy``
    intervals, charged to the ordered ``pieces`` (:func:`_innermost`) they
    overlap, the rest to ``other``; in the records' units."""
    idle: Dict[str, float] = collections.defaultdict(float)
    edges = [window[0]] + [x for b in busy for x in b] + [window[1]]
    j = 0
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        covered, k = 0.0, j
        while k < len(pieces) and pieces[k][0] < g1:
            o = min(g1, pieces[k][1]) - max(g0, pieces[k][0])
            if o > 0:
                idle[pieces[k][2]] += o
                covered += o
            k += 1
        if g1 - g0 > covered:
            idle["other"] += g1 - g0 - covered
    return dict(idle)


def _is_annotation(e) -> bool:
    """A ``record_function`` range mirrored on the device's timeline."""
    return (getattr(e, "activity_type", None) == "gpu_user_annotation"
            or bool(getattr(e, "is_user_annotation", False)))


def trace_busy(prof) -> Dict[str, Optional[float]]:
    """The device-busy share of a ``torch.profiler`` profile taken with CUDA
    activity: the union of its device records (kernels, copies, sets; not
    the ranges mirrored there) over the window from its first to its last
    record, host or device. Records that begin before the trace (negative
    starts) are left out. Returns ``busy_s``, ``window_s``, ``share`` (None
    without device records), ``records``, the count of device records, and
    ``idle_by_span``: the idle seconds charged to the innermost ``wca.``
    span range (:meth:`StageTimers.stage`) open on the main thread, the one
    whose ranges cover the most time, and the rest to ``other``."""
    from torch.autograd import DeviceType

    spans, device = [], []
    ranges: Dict[object, list] = collections.defaultdict(list)
    for e in prof.events():
        r = (e.time_range.start, e.time_range.end)
        if r[0] < 0:
            continue
        if e.device_type == DeviceType.CUDA:
            if _is_annotation(e):
                continue
            device.append(r)
        elif getattr(e, "name", "").startswith("wca."):
            ranges[getattr(e, "thread", 0)].append((*r, e.name[4:]))
        spans.append(r)
    if not device:
        return dict(busy_s=None, window_s=None, share=None, records=0,
                    idle_by_span={})
    window = (min(r[0] for r in spans), max(r[1] for r in spans))
    busy = _union(device, window)
    width = window[1] - window[0]
    share = sum(end - start for start, end in busy) / width if width else 0.0
    main = max(ranges.values(), default=[],
               key=lambda rs: sum(r[1] - r[0] for r in rs))
    idle = _idle_by_span(busy, window, _innermost(main))
    width /= 1e6  # the records are in microseconds
    return dict(busy_s=share * width, window_s=width, share=share,
                records=len(device),
                idle_by_span={k: v / 1e6 for k, v in idle.items()})


@contextlib.contextmanager
def busy_window(out: dict):
    """Trace the block on the card (``torch.profiler``, CPU and CUDA
    activity; the card is synchronised before the trace stops) and fill
    ``out`` with :func:`trace_busy` of it. Raises without a card: a busy
    share is a device number."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("a device-busy share needs a CUDA card")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield out
        torch.cuda.synchronize()
    out.update(trace_busy(prof))


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]):
    """A ``torch.profiler`` trace of the block, written to
    ``{trace_dir}/trace-{pid}-{time}.json`` (Chrome trace format) when the
    block ends, also on an exception; nothing when ``trace_dir`` is None.
    With device records, the card's idle seconds by span
    (:func:`trace_busy`) are printed to stderr."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"trace-{os.getpid()}-{int(time.time())}.json"))
        busy = trace_busy(prof)
        if busy["share"] is not None:
            print("device idle by span: " + json.dumps(
                {k: round(v, 6) for k, v in sorted(
                    busy["idle_by_span"].items(), key=lambda kv: -kv[1])}),
                file=sys.stderr)
