"""What the profiling programs (``scripts/profile_*.py``) share: their
readings, timed as the JAX scripts time them (the least of a few calls after
one warm call), and the one JSON line each prints.

A timed call lies between two ``torch.cuda.synchronize`` calls
(``bench.timed``); the warm call before them captures the call's decode
graphs and builds its kernels, outside the timed region. The line holds each
reading (least ms) under its JAX line name, beside ``device``, ``launches``
(the kernel launches of the timed calls, ``ops/_lib``) and
``graph_captures_timed`` (CUDA graphs captured inside timed calls: the decode
runner's and a program's own).
"""

from __future__ import annotations

import json
from typing import Callable, Dict

import torch

from ..bench import add_counts, device_label, log, timed
from ..ops import _lib

# the card's memory rate (H100 SXM data sheet), for the byte floors the
# programs print
HBM_BYTES_PER_S = 3.35e12


class Readings:
    """The readings of one program on ``device``; :meth:`emit` prints its
    line."""

    def __init__(self, program: str, device: torch.device):
        self.program = program
        self.device = device
        self.ms: Dict[str, float] = {}
        self.extra: dict = {}
        self.launches: Dict[str, int] = dict.fromkeys(_lib.LAUNCHES, 0)
        self.captures = 0
        # graphs a program captures itself (profile_decode_step's steps)
        self.own_captures = 0

    def time(self, name: str, fn: Callable, iters: int, width: int = 38,
             median: bool = False, warm: bool = True, suffix=None):
        """``fn`` once (unless ``warm`` is False), then ``iters`` timed
        calls. Keeps the least wall in ms as the reading ``name``, logs the
        JAX line (``name: min X ms``, with the median when ``median``, then
        ``suffix(least_s)`` when given) and returns (least seconds, the last
        call's result)."""
        out = fn() if warm else None
        walls = []
        for _ in range(iters):
            own = self.own_captures
            with timed(self.device) as m:
                out = fn()
            walls.append(m["wall_s"])
            self.launches = add_counts(self.launches, m["launches"])
            self.captures += m["captures"] + self.own_captures - own
        best = min(walls)
        self.ms[name] = best * 1e3
        line = f"{name:>{width}}: min {best * 1e3:8.1f} ms"
        if median:
            line += f"   med {sorted(walls)[len(walls) // 2] * 1e3:8.1f} ms"
        if suffix is not None:
            line += suffix(best)
        log(line)
        return best, out

    def payload(self) -> dict:
        return {"program": self.program, "unit": "ms", "readings": self.ms,
                **self.extra, "device": device_label(self.device),
                "launches": self.launches,
                "graph_captures_timed": self.captures}

    def emit(self) -> None:
        print(json.dumps(self.payload()), flush=True)

