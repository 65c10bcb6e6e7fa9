"""Stage timers and device traces (port of ``whisper_char_alignment_tpu/utils/profiling.py``).

:class:`StageTimers` accumulates, per named stage, host seconds, calls and
units, and on a CUDA device the device seconds between two CUDA events
recorded on the current stream at the stage's start and end. Nothing
synchronises while stages run, so timing a stage does not serialise the
runner's software pipeline; the events are resolved only when ``totals`` or
``summary`` is read. :func:`device_trace` records a ``torch.profiler`` trace
of a block (host and, on a card, device activity) and writes it as a Chrome
trace for Perfetto; :func:`busy_window` and :func:`trace_busy` give a
trace's device-busy share.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import time
from typing import Dict, Iterable, Optional, Tuple

import torch


class StageTimers:
    """Host seconds, calls and units per named stage, and device seconds on
    a CUDA ``device`` (a pair of CUDA events per stage call, resolved when
    read)."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = device
        self.host_totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)
        self.units: Dict[str, int] = collections.defaultdict(int)
        self._pending = collections.defaultdict(list)
        self._device_totals: Dict[str, float] = collections.defaultdict(float)

    @property
    def on_device(self) -> bool:
        return (self.device is not None
                and torch.device(self.device).type == "cuda")

    def reset(self) -> None:
        for d in (self.host_totals, self.counts, self.units, self._pending,
                  self._device_totals):
            d.clear()

    @contextlib.contextmanager
    def stage(self, name: str, units: int = 0):
        pair = None
        if self.on_device:
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if pair is not None:
                pair[1].record()
                self._pending[name].append(pair)
            self.host_totals[name] += time.perf_counter() - t0
            self.counts[name] += 1
            self.units[name] += units

    @property
    def totals(self) -> Dict[str, float]:
        """Seconds by stage: on a card the device seconds between each
        stage's events (resolved here, which waits for the last of them),
        on the CPU the host seconds."""
        if not self.on_device:
            return dict(self.host_totals)
        for name, pairs in self._pending.items():
            for start, end in pairs:
                end.synchronize()
                self._device_totals[name] += start.elapsed_time(end) / 1e3
            pairs.clear()
        return {name: self._device_totals[name] for name in self.host_totals}

    def summary(self) -> Dict[str, dict]:
        """Per stage: ``total_s`` (:attr:`totals`), calls, ms per call, units
        per second, and on a card ``host_s`` beside the device seconds."""
        out = {}
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            out[name] = {
                "total_s": round(total, 4),
                "calls": self.counts[name],
                "ms_per_call": round(1000 * total / max(self.counts[name], 1),
                                     2),
            }
            if self.on_device:
                out[name]["host_s"] = round(self.host_totals[name], 4)
            if self.units[name] and total > 0:
                out[name]["units_per_s"] = round(self.units[name] / total, 2)
        return out

    def report(self, file=sys.stderr) -> None:
        if self.host_totals:
            print("stage profile: " + json.dumps(self.summary()), file=file)


def busy_share(intervals: Iterable[Tuple[float, float]],
               window: Tuple[float, float]) -> float:
    """The share of ``window`` (start, end) covered by the union of
    ``intervals``, each clipped to the window."""
    lo, hi = window
    covered, reach = 0.0, lo
    for start, end in sorted(intervals):
        start, end = max(start, reach), min(end, hi)
        if end > start:
            covered += end - start
            reach = end
    return covered / (hi - lo) if hi > lo else 0.0


def trace_busy(prof) -> Dict[str, Optional[float]]:
    """The device-busy share of a ``torch.profiler`` profile taken with CUDA
    activity: the union of its device records (kernels, copies, sets) over
    the window from its first to its last record, host or device. Records
    that begin before the trace (negative starts) are left out. Returns
    ``busy_s``, ``window_s``, ``share`` (None without device records) and
    ``records``, the count of device records."""
    from torch.autograd import DeviceType

    spans, device = [], []
    for e in prof.events():
        r = (e.time_range.start, e.time_range.end)
        if r[0] < 0:
            continue
        spans.append(r)
        if e.device_type == DeviceType.CUDA:
            device.append(r)
    if not device:
        return dict(busy_s=None, window_s=None, share=None, records=0)
    window = (min(r[0] for r in spans), max(r[1] for r in spans))
    share = busy_share(device, window)
    width = (window[1] - window[0]) / 1e6  # the records are in microseconds
    return dict(busy_s=share * width, window_s=width, share=share,
                records=len(device))


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
    block ends, also on an exception; nothing when ``trace_dir`` is None."""
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
