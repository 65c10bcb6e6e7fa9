"""The greedy decode loop as a captured CUDA graph: the counterpart of the JAX
package's jitted ``lax.while_loop`` (``whisper_char_alignment_tpu/models/
decoding.py:196-347``).

Eagerly, one step of the Whisper-medium decoder is about a thousand small
launches from Python and a host read of the finished rows, so the decode
stage is bound by the host. Here the loop's state lives in static device
buffers (``decoding.LoopState``: the tokens, the self-attention cache, the
position as a tensor, the finished rows, the scores and margins) beside
static cross K/V (float, or int8 codes and scales), and ``CHUNK_STEPS``
steps of ``decoding.loop_step_`` are captured once into one graph. A decode
copies its prefilled state and cross K/V in, replays the graph until the
done flag says every row has finished or the budget is spent, and reads
that flag one chunk behind the card: a chunk is always queued when the host
waits, so the host never idles the card. Steps past the end change no
output (``decoding.loop_step_``), so the results equal the eager loop's
(``decoding._decode_loop``, the plain version ``chip_smoke.py`` holds this
against, bit for bit).

A graph is keyed by the loop's ``LoopSpec`` (budget, cross-attention mode,
margin tracking, the tokenizer's ids), the batch, the cross K/V frames, int8
and the model's dtype, and kept per model in a small LRU cache. There is no
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
CHUNK_STEPS = 4
# Graphs kept per model: the frame-bucketed modes give at most
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


class _Captured:
    """One captured chunk of the loop and the static buffers it reads and
    writes."""

    def __init__(self, model, st: decoding.LoopState, cross_kv,
                 spec: decoding.LoopSpec):
        self.spec = spec
        self.state = st.clone()
        self.cross_kv = _clone_kv(cross_kv)
        _warm_up(lambda: decoding.loop_step_(model, self.state, self.cross_kv,
                                             spec))
        RECORD["warmup_steps"] += 1
        before = _lib.launch_counts()
        self.graph = _capture(lambda: decoding.run_chunk_(
            model, self.state, self.cross_kv, spec, CHUNK_STEPS))
        after = _lib.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        _lib.add_launches(self.launches, -1)  # the capture launched nothing
        RECORD["captures"] += 1

    def run(self, st: decoding.LoopState, cross_kv):
        """Load ``st`` and ``cross_kv`` into the static buffers, replay until
        done, and return copies of the loop's outputs
        (``decoding.loop_outputs``)."""
        for dst, src in zip(self.state.flat(), st.flat()):
            dst.copy_(src)
        for dst, src in zip(_flat_kv(self.cross_kv), _flat_kv(cross_kv)):
            dst.copy_(src)
        spec = self.spec
        n_chunks = -(-(spec.total - spec.sample_begin) // CHUNK_STEPS)
        flags = []
        for j in range(n_chunks):
            self.graph.replay()
            flags.append(_Flag(self.state.done))
            # chunk j runs while the host reads chunk j - 1's flag
            if j and flags[j - 1].read():
                break
        replays = len(flags)
        _lib.add_launches(self.launches, replays)
        RECORD["replays"] += replays
        RECORD["steps"] += replays * CHUNK_STEPS
        return tuple(t.clone() for t in decoding.loop_outputs(self.state))


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
    key = (spec, xa.shape[0], _frames(cross_kv), kv_int8, model.dtype)
    graphs = _GRAPHS.setdefault(model, collections.OrderedDict())
    entry = graphs.get(key)
    if entry is None:
        while len(graphs) >= MAX_GRAPHS:
            graphs.popitem(last=False)
        entry = graphs[key] = _Captured(model, st, cross_kv, spec)
    graphs.move_to_end(key)
    tokens, sum_lp, ns_prob, n_steps, margin = entry.run(st, cross_kv)
    return tokens, sum_lp, ns_prob, n_steps, cross_kv, margin
