"""The decode loops as captured CUDA graphs: the counterpart of the JAX
package's jitted ``lax.while_loop`` programs (greedy
``whisper_char_alignment_tpu/models/decoding.py:196-347``, beam and sampling
``models/beam.py:73-356``, speculative ``models/decoding.py:765-953``).

Eagerly, one step of the Whisper-medium decoder is about a thousand small
launches from Python and a host read of the finished rows, so the decode
stage is bound by the host. Here a loop's state lives in static device
buffers (a ``decoding.DeviceState``: the tokens, the self-attention caches,
the position as a tensor, the finished rows, the scores, a beam's bank of
finished candidates, the sampling noise) beside static cross K/V (float, or
int8 codes and scales), and ``CHUNK_STEPS`` steps of the loop's step
function (a ``decoding.LoopKind``: greedy, beam, sampling, or a speculative
round) are captured once into one graph. A decode copies its prefilled
state and cross K/V in, replays the graph until the done flag says the loop
has ended, and reads that flag one chunk behind the card: a chunk is always
queued when the host waits, so the host never idles the card. What a step
reads from the host side (the sampling noise) is refilled into its static
buffer before each replay, in stream order. Steps past the end change no
output, so the results equal the eager loop's (``decoding.run_eager``, the
plain version ``chip_smoke.py`` holds this against, bit for bit).

A graph is keyed by its loop: the kind, its spec (budget, beam, candidates,
cross-attention mode, margin tracking, the tokenizer's ids), the rows, the
cross K/V frames, int8 and the dtypes (and the draft model of a speculative
loop, which its entry keeps alive). Greedy graphs are kept per model in a
small LRU cache. A beam, sampling or speculative graph is kept one at a
time: its static cross K/V are repeated per beam, 24 layers x 2 x 40 rows x
1500 frames x 1024 x 2 bytes = 5.9 GB at Whisper-medium, B=8, beam 5, bf16,
so the one held is evicted before another is captured. There is no
fallback: a capture or replay that fails raises.

Launch counts: a replay launches the captured kernels without calling their
Python wrappers, so the capture's counts are taken back and added again at
each replay (``ops/_lib.add_launches``): ``cross_attn_int8`` then counts
layers x the steps actually replayed. The warm-up step before a capture
really launches its kernels and counts as such. :data:`RECORD` keeps the
captures, warm-up steps, replays and replayed steps.
"""

from __future__ import annotations

import collections
import weakref
from typing import Dict

import numpy as np
import torch

from ..ops import _lib
from . import decoding

# Steps one replay runs. The host reads the done flag one chunk behind the
# card, so once every row has finished the card runs at most
# 2 * CHUNK_STEPS - 1 steps that change nothing. The main path's budget is
# 32 steps (decode_len 32): 4 gives at most 8 replays and flag reads a
# batch and bounds that waste to 7 steps; a larger chunk would save host
# reads that the queued chunk already hides.
CHUNK_STEPS = decoding.CHUNK_STEPS
# Greedy graphs kept per model: the frame-bucketed modes give at most
# ceil(1500 / 128) = 12 frame keys, beside the full window a guard's
# re-decode takes. Each holds its cross K/V (up to 1.2 GB at Whisper-medium,
# B=8, bf16, 1500 frames).
MAX_GRAPHS = 16

RECORD: Dict[str, int] = {"captures": 0, "warmup_steps": 0, "replays": 0,
                          "steps": 0}

_GRAPHS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def reset_record() -> None:
    for k in RECORD:
        RECORD[k] = 0


def replay_record() -> Dict[str, int]:
    return dict(RECORD)


def _flat_kv(cross_kv):
    out = []
    for c in cross_kv:
        out.extend(c if isinstance(c, tuple) else (c,))
    return out


def _clone_kv(cross_kv):
    return tuple(tuple(t.clone() for t in c) if isinstance(c, tuple)
                 else c.clone() for c in cross_kv)


def _warm_up(fn) -> None:
    """Run ``fn`` once on a side stream, as CUDA graph capture wants: it
    initializes the BLAS handles and workspaces and loads the kernel library
    outside the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)


def _capture(fn) -> torch.cuda.CUDAGraph:
    """A CUDA graph of what ``fn`` launches. ``thread_local``: the runner's
    wire-prep thread may call the runtime while this thread captures."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        fn()
    return graph


class _Flag:
    """One chunk's done flag, copied to pinned host memory behind a CUDA
    event, read without blocking anything queued after it."""

    def __init__(self, done: torch.Tensor):
        self.host = torch.empty(1, dtype=torch.bool, pin_memory=True)
        self.host.copy_(done, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def read(self) -> bool:
        self.event.synchronize()
        return bool(self.host)


def _chunk(kind: decoding.LoopKind, st, kv) -> None:
    for slot in range(CHUNK_STEPS):
        kind.step(st, kv, slot)
    kind.finish(st)


class _Captured:
    """One captured chunk of a loop and the static buffers it reads and
    writes. ``keep`` holds what the graph reads besides them (a speculative
    loop's draft model)."""

    def __init__(self, kind: decoding.LoopKind, st, cross_kv, keep=None):
        self.keep = keep
        self.state = st.clone()
        self.cross_kv = _clone_kv(cross_kv)
        _warm_up(lambda: kind.step(self.state, self.cross_kv, 0))
        RECORD["warmup_steps"] += 1
        before = _lib.launch_counts()
        self.graph = _capture(lambda: _chunk(kind, self.state, self.cross_kv))
        after = _lib.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        _lib.add_launches(self.launches, -1)  # the capture launched nothing
        RECORD["captures"] += 1

    def run(self, kind: decoding.LoopKind, st, cross_kv, max_steps: int):
        """Load ``st`` and ``cross_kv`` into the static buffers, replay until
        done (at most enough chunks for ``max_steps`` steps), and return
        copies of the loop's outputs."""
        for dst, src in zip(self.state.flat(), st.flat()):
            dst.copy_(src)
        for dst, src in zip(_flat_kv(self.cross_kv), _flat_kv(cross_kv)):
            dst.copy_(src)
        n_chunks = -(-max_steps // CHUNK_STEPS)
        flags = []
        for j in range(n_chunks):
            if kind.refill is not None:
                for slot in range(CHUNK_STEPS):
                    kind.refill(self.state, j * CHUNK_STEPS + slot, slot)
            self.graph.replay()
            flags.append(_Flag(self.state.done))
            # chunk j runs while the host reads chunk j - 1's flag
            if j and flags[j - 1].read():
                break
        replays = len(flags)
        _lib.add_launches(self.launches, replays)
        RECORD["replays"] += replays
        RECORD["steps"] += replays * CHUNK_STEPS
        return tuple(t.clone() for t in kind.outputs(self.state))


@torch.no_grad()
def replay(model, key, kind: decoding.LoopKind, st, cross_kv, max_steps: int,
           keep=None):
    """A loop on a CUDA model by graph replay: ``decoding.run_eager``'s
    arguments and returns. The graph for ``key`` is captured from ``st`` on
    first use (``key[0]`` names the loop: greedy graphs share an LRU cache,
    any other kind is held one at a time). ``keep`` is held as long as the
    graph: what it reads besides its buffers (a speculative draft)."""
    graphs = _GRAPHS.setdefault(model, collections.OrderedDict())
    entry = graphs.get(key)
    if entry is None:
        if key[0] != "greedy":
            for k in [k for k in graphs if k[0] != "greedy"]:
                del graphs[k]
        while len(graphs) >= MAX_GRAPHS:
            graphs.popitem(last=False)
        entry = graphs[key] = _Captured(kind, st, cross_kv, keep)
    graphs.move_to_end(key)
    return entry.run(kind, st, cross_kv, max_steps)


def _frames(cross_kv) -> int:
    ck = cross_kv[0]
    return (ck[0] if isinstance(ck, tuple) else ck).shape[-1]


@torch.no_grad()
def graphed_loop(model, xa: torch.Tensor, prompt: np.ndarray,
                 suppress_mask: torch.Tensor, blank_mask: torch.Tensor,
                 spec: decoding.LoopSpec, kv_frames=None,
                 kv_int8: bool = False):
    """``decoding._decode_loop`` on a CUDA model, by graph replay: the same
    arguments and the same returns, (tokens, sum_logprobs, no_speech_probs,
    n_steps, cross_kv, min_margin). The cross K/V and the prompt's prefill
    are computed eagerly (``decoding.loop_setup``), once a decode."""
    if xa.device.type != "cuda":
        raise ValueError(f"the decode graph needs a CUDA model, not "
                         f"{xa.device}")
    return _graphed(model, xa, prompt, suppress_mask, blank_mask, spec,
                    kv_frames, kv_int8)


def _graphed(model, xa, prompt, suppress_mask, blank_mask, spec, kv_frames,
             kv_int8):
    st, cross_kv = decoding.loop_setup(model, xa, prompt, suppress_mask,
                                       blank_mask, spec, kv_frames, kv_int8)
    key = ("greedy", spec, xa.shape[0], _frames(cross_kv), kv_int8,
           model.dtype)
    tokens, sum_lp, ns_prob, n_steps, margin = replay(
        model, key, decoding.greedy_kind(model, spec), st, cross_kv,
        spec.total - spec.sample_begin)
    return tokens, sum_lp, ns_prob, n_steps, cross_kv, margin
