"""Stage timers and a device trace (port of ``whisper_char_alignment_tpu/utils/profiling.py``).

:class:`StageTimers` accumulates wall time, calls and units per named stage,
with the device synchronised at each stage's end, so a stage's time holds
its own device work and nothing of the next stage's. :func:`device_trace`
records a ``torch.profiler`` trace of a block (host and, on a card, device
activity) and writes it as a Chrome trace for Perfetto.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import time
from typing import Dict, Optional

import torch


class StageTimers:
    """Accumulates wall time + counts per named stage. ``device``: a CUDA
    device is synchronised at the end of every stage; the CPU needs none."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = device
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)
        self.units: Dict[str, int] = collections.defaultdict(int)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self.units.clear()

    @contextlib.contextmanager
    def stage(self, name: str, units: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1
            self.units[name] += units

    def summary(self) -> Dict[str, dict]:
        out = {}
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            out[name] = {
                "total_s": round(total, 4),
                "calls": self.counts[name],
                "ms_per_call": round(1000 * total / max(self.counts[name], 1),
                                     2),
            }
            if self.units[name]:
                out[name]["units_per_s"] = round(self.units[name] / total, 2)
        return out

    def report(self, file=sys.stderr) -> None:
        if self.totals:
            print("stage profile: " + json.dumps(self.summary()), file=file)


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
