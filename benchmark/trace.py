"""Reading a ``torch.profiler`` trace of the card: busy time, kernel time by
name, and the idle gaps by what the host was doing.

The device's busy time is the union of its records (kernels, copies, sets)
over the traced window, as ``utils/profiling.busy_window`` of the port
reckons it (its arithmetic copied, not imported). An idle gap is charged to
the CUDA runtime calls that overlap it, and what no call covers to
``host (between CUDA calls)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch

HOST = "host (between CUDA calls)"


@dataclasses.dataclass
class Trace:
    busy_s: float
    window_s: float
    kernels: Dict[str, float]  # device seconds by record name
    idle: Dict[str, float]  # idle seconds by host call

    def kernel_s(self, patterns) -> float:
        """Device seconds of the records whose name holds any pattern."""
        return sum(s for name, s in self.kernels.items()
                   if any(p in name for p in patterns))

    def breakdown(self, n: int = 10) -> dict:
        def top(d):
            return [[k[:64], v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:n]]
        return {"device_ops": top(self.kernels), "idle_gaps": top(self.idle)}


def union(intervals: np.ndarray) -> np.ndarray:
    """Merged, sorted (start, end) rows of possibly overlapping ones."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > reach[:-1]
    starts = iv[new, 0]
    ends = np.append(reach[np.flatnonzero(new)[1:] - 1], reach[-1])
    return np.stack([starts, ends], 1)


def read(events, window: Tuple[float, float] = None) -> Trace:
    """A :class:`Trace` from ``(name, is_device, start_ns, end_ns)``
    records; the window runs from the first record to the last unless
    given."""
    dev, host, names = [], [], []
    kernels: Dict[str, float] = defaultdict(float)
    lo, hi = np.inf, -np.inf
    for name, is_device, start, end in events:
        lo, hi = min(lo, start), max(hi, end)
        if is_device:
            dev.append((start, end))
            kernels[name] += (end - start) / 1e9
        else:
            host.append((start, end))
            names.append(name)
    if window is not None:
        lo, hi = window
    busy = union(np.asarray(dev, np.float64).reshape(-1, 2))
    busy = np.clip(busy, lo, hi)
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) / 1e9
    gaps = np.stack([np.append(lo, busy[:, 1]), np.append(busy[:, 0], hi)], 1)
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    idle: Dict[str, float] = defaultdict(float)
    h = np.asarray(host, np.float64).reshape(-1, 2)
    order = np.argsort(h[:, 0], kind="stable")
    h, names = h[order], [names[i] for i in order]
    reach = np.maximum.accumulate(h[:, 1]) if len(h) else h[:, 1]
    for g0, g1 in gaps:
        # host calls that may overlap the gap: begun before its end, and
        # (by the running maximum of ends) not all over before its start
        j1 = np.searchsorted(h[:, 0], g1)
        j0 = np.searchsorted(reach[:j1], g0, side="right")
        covered = 0.0
        for j in range(j0, j1):
            o = min(h[j, 1], g1) - max(h[j, 0], g0)
            if o > 0:
                idle[names[j]] += o / 1e9
                covered += o
        rest = (g1 - g0) - covered
        if rest > 0:
            idle[HOST] += rest / 1e9
    return Trace(busy_s, float(hi - lo) / 1e9, dict(kernels), dict(idle))


def kineto_records(prof) -> List[tuple]:
    """(name, is_device, start_ns, end_ns) of a finished profile's records
    (those begun before the profile are left out)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        if start < 0:
            continue
        out.append((e.name(), e.device_type() == DeviceType.CUDA, start,
                    start + e.duration_ns()))
    return out


@contextlib.contextmanager
def profiled(out: dict):
    """Trace the block on the card (CUDA activity: kernels, copies and the
    runtime's calls) and put its :class:`Trace` in ``out["trace"]``. The
    card is synchronised before the trace stops."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield out
        torch.cuda.synchronize()
    out["trace"] = read(kineto_records(prof))
