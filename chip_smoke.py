#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py    # needs one CUDA card

Phases (any failure exits non-zero and prints no final line):

1. Print the card's name and power limit (``nvidia-smi``), build the kernel
   library from ``whisper_char_alignment_tpu_torch/csrc`` and print the build
   time.
2. Kernel vs plain version on the card at the main path's shapes: encoder
   attention (B=8, H=16, T=1500, hd=64) in f32 and bf16, with K as it is and
   K transposed, at n_valid 1, 63, 64, 65, 1000 and 1500, at head dims 16,
   32 and 128 on a small B*H, and timed at T=1536 (aligned K^T rows); the
   QK post-process (B=8, H=16, T=96, F=1500) at widths 3, 7, 15, 17 and 31
   (sorted windows of their own width) and 33 and 101 (padded) with
   ragged and edge lengths, each beside a bound from the bytes these
   lengths need; the DTW wavefront and backtrace (bit-equal), at
   B=16, N<=120, M=1500 and at the ``DTW_SHAPES`` edges on tied integer and
   random costs, with pad rows and walks cut at window edges, timed beside
   their chains' floor (one dependent shuffle or shared-memory load per
   step, measured on the card); the decode
   cross-attention (B=8, H=16, hd=64) over int8 and bf16 K/V at F=1500, at
   the bucket F=384, at F=1536, 131 and 1, and at B=1, F=1500 (one file's
   window: 16 blocks on the card's 132 SMs); the mel spectrum and clip
   kernels (B=8, 30 s) at 80 and 128 mels, the clip bit-equal, beside
   Whisper's ``torch.stft`` frontend (a composite yardstick). Each kernel is
   timed from a ``torch.profiler`` trace of 20 calls after warmup (the
   median of the records of its launches made in the trace) beside its
   plain version (CUDA events), its bound, and, where one PyTorch call
   computes the same function, that call; the cross-attention, the mel
   kernels and their yardsticks read inputs rotated over 100 MB of copies,
   so from HBM, with the L2-warm time beside; the plain int8 step of the
   ``mxu`` mode is timed beside the cross-attention kernel. The int8
   encoder linear's two kernels (row quantize, epilogue) at
   Whisper-medium's six linear shapes (M = 12,000), bit-equal in bf16 and
   f32, timed against their byte bounds beside ``torch._int_mm`` (its
   int32 product exact) and bf16 ``F.linear``. The decoder's two
   row-invariant kernels (``csrc/dec_attn.cu``, ``csrc/rows_linear.cu``) at
   a decode step's shapes (8 utterances, 16 heads of 64, 1500 frames, the
   cache, a 5-row window, the capture's 96 rows; linears 1024 and 4096
   wide and the 51865-token lm head, at 8, 768 and 12,000 rows) against
   their plain versions, each item and row alone bit-equal to it among
   others, timed (inputs rotated out of L2) beside SDPA and ``F.linear``.
3. The port's main path, ``AlignmentPipeline.run_dataset`` at Whisper-medium
   width (random weights from torch.Generator seed 0, bf16, toy tokenizer,
   16 synthetic utterances of 2-7 s), twice: as configured by default, and
   with int8 cross K/V, a 128-frame decode bucket, ``WCA_CROSS_ATTN=pallas``
   and ``WCA_MEL_IMPL=pallas``. Each run's launch counts are reset before it
   and must be exact after it; alignment sanity checks and a NumPy DTW
   recompute of one batch follow each. The decode stage of that int8 +
   bucket pipeline is then timed under ``WCA_CROSS_ATTN=mxu`` and
   ``pallas``, alternately. Then one batch with both margin guards, set so
   that some rows are flagged and some are not: the pipeline's own decode
   must give each flagged row the exact decode's tokens and each other row
   the int8 + bucket decode's. A tiny f32 model is also held against the
   CPU path (plain versions). Then the command-line surface at
   Whisper-medium width, the model loader replaced by the smoke's model:
   ``cli.infer_ali`` on the same corpus with the README recipe at median
   width 17 (``--save_prediction``, re-scored by ``cli.eval_ali``) and with
   ``--default_whisper_timing`` at width 33 (the QK post-process's rank
   selection), and ``cli.probe_oracle`` on 8 utterances of 18-24 words
   (its per-head DTW in 3 launches of 1024 rows, timed), each with exact
   launch counts and jump frames equal to the NumPy DTW oracle; and
   ``infer_ali --test_model`` on ``sample/`` on the card and on the CPU,
   with equal words and boundaries. After the CLI phase, the checkpoint
   path: the medium bf16 model written by ``convert.save_openai_pt`` and
   the toy ranks as a ``multilingual.tiktoken`` file, read back by
   ``infer_ali --checkpoint --tokenizer_dir`` (the real loader) with the
   width-17 recipe, which must give the in-memory run's tokenizer ids,
   launch counts, words, boundaries and P/R/F1; ``whisper.forward`` on one
   batch of 8 (24 encoder kernel launches, no QK post-process) and
   ``qk_to_attention`` over its 24 layers (24 launches), bit-equal to the
   capture's in-layer post-process; both native host libraries
   (``cpp/wavio.cc``, ``cpp/bpe.cc``) built by g++ and loaded, equal to the
   Python paths on the corpus; and the default run's ``utils/flops``
   MFU roll-up, logged. The DTW kernels are then held and timed
   on the inputs the default main path gave them (its own shape).
   The decode runs as a replayed CUDA graph (``models/decode_graph.py``):
   the steps the main path ran are read from the graph runner's replay
   record, so the cross-attention kernel's launches are layers x (replayed
   + warm-up steps). Each decode mode of the main path (float, int8 + bucket
   through the kernel and through ``mxu``, the guarded pair) is held bit for
   bit against the eager loop on the card, with its decode time graphed and
   eager, the device-busy share of each from a trace, and one step's time
   against the step's byte floor; then ``run_dataset`` at
   ``pipeline_depth`` 1 and 2 gives the same results in the same order,
   with utts/s and the busy share of each. The decoding modes follow:
   ``run_dataset`` with beam 5 and with sampling at 0.7 with best_of 5,
   each with exact launch counts, the capture pass recomputing the cross
   K/V, and the NumPy DTW oracle; on one batch's encoder states, beam 5
   (patience None and 2.0, length penalty None and 0.6, with and without
   timestamps), sampling at 0.7 and 1.0 through one graph, a prompt plus a
   prefix under ``language=None`` and per-row prompts through the greedy
   and the beam graph, each graphed decode bit-equal to its eager loop on
   the card (raw loop outputs too), the detected languages equal to an
   eager ``detect_language``, a beam and a sampling step against their
   byte floor and the busy share of a traced beam decode; and the
   speculative decode (medium target, a ``MODEL_DIMS["tiny"]`` draft,
   ``draft_k`` 4, one utterance) graphed against eager in bf16 and f32,
   each equal to greedy's bit for bit (tokens, text, logprob, no-speech
   probability), its round time beside a greedy B=1 step. Then the rows
   phase: ``scripts/diagnose_rows`` on the main model, every op of every
   case bit-equal (a row alone against the same row among others: the
   decode step at B=1 and 4/8/16, a window and a prompt against steps, the
   encoder and cross K/V at B=1 and 4/8/16, the capture padded by a token
   bucket), and ``align_batch`` of one utterance alone against the same
   utterance in batches of 8 and 16 holding a longer transcript (another
   token bucket): equal decode, words and boundaries, capture attention
   rows bit-equal. The decoder kernels' launches on the main path are
   derived exactly from what it ran (decode steps, prefills, cross K/V
   projections, captures); elsewhere the other kernels are held exactly
   and these two left free.
   The main path with the int8 encoder follows the default run: exactly
   144 launches of each int8 kernel per encoder run, the encoder stage
   beside bf16's, the int8 states' error against bf16's.
4. Long-form transcription and serving at Whisper-medium width, each path
   with its launch counts set to 0 just before it and equal just after it
   to the counts of what it executed (the encoder kernel per layer for
   each decode, detect and word-timing request, the QK post-process per
   decoder layer and the DTW kernels per word-timing capture), every DTW
   held against the NumPy oracle: ``transcribe`` of 65 s of speech-like
   audio (three windows, the whole fallback ladder, conditioning,
   ``language=None``, word timestamps, 64 steps a rung), graphed against
   the eager loops field for field, floats bit for bit, and with top-k
   word timing; ``transcribe_batched`` of 4 audios of 35-40 s against
   their solo runs, in f32 and bf16, every field bit for bit;
   ``cli.transcribe`` with every output format at
   medium width, and ``--test_model`` on ``sample/test.wav`` on the card
   and the CPU with equal files; an in-process ``serve`` with its warmups
   (8 concurrent /align in one batch and 4 concurrent /transcribe, each
   equal to its solo answer, floats bit for bit, a 413, no graph of a
   warmed shape captured after the warmups, then one /align at
   ``medfilt_width=101``), all in f32, and a bf16 server's 8 /align in one
   batch, each equal to its solo answer. The
   graphed ``transcribe`` gives the QK post-process's width-7 row its
   launches, the width-101 request that row's. Logs windows, rungs, graph
   captures and their seconds, the real-time factor, /align req/s and
   p50/p95 latency, and peak device memory.
5. The port's benchmark programs at Whisper-medium width: each module's
   ``run`` in process on the bf16 model at cut sizes (``bench``: 16
   utterances at batch 8, one pass, its guarded sweep at 32 steps;
   ``scripts.bench_serve``: 8 requests from 4 clients, /align and
   /transcribe at temperature 0; ``scripts.measure_latency``: 3 calls;
   ``scripts.bench_transcribe_longform``: 35 s, one timed call;
   ``scripts.bench_probe``: 8 utterances, one pass), each with its launch
   counts set to 0 before it and equal after it to the counts of what it
   ran, its one line's keys, no decode graph captured in a timed pass,
   ``bench``'s NumPy DTW recompute and the first DTW call against the
   oracle; then ``python -m whisper_char_alignment_tpu_torch.bench`` in a
   subprocess (16 utterances, batch 8, one pass, no sweep) printing
   exactly one JSON line. Logs each run's line, with the card's name and
   power limit, and the phase's seconds.
6. The port's profiling programs (``scripts/profile_*.py``) at
   Whisper-medium width: each ``main`` in process at a cut size
   (``PROFILE_RUNS``: the decode-step ablation at B=8 and 8 steps with
   ``INT8_PALLAS=1``, the pipeline at batch 4 with ``PROF_INT8=1`` and
   ``--reuse``, the probe's DTW at its 1024-row chunk, the others at
   batches of 2-4 and one or two timed calls), its stdout captured: it
   must print exactly one JSON line of positive, finite readings, capture
   no graph in a timed call, and report the launches its timed calls ran,
   derived from what they executed (encoder layers, captures, DTW calls,
   int8 decode steps) and from the kernels the program calls itself;
   kernels 1, 2, 3a, 3b, 4, 6 and 7 each launch in the phase. Then the
   decode-step program's all-on stripped step against
   ``whisper.decode_step``'s logits, bit for bit, over float K/V and
   int8 K/V in each int8 mode. Logs each line with the card's name.
7. Two gloo ranks on the one card, the device named (``cuda:0``): this
   script started again as ``chip_smoke.py --mesh-worker RANK 2 INIT JOB``
   (the kernels already built), medium width, 8 utterances, ground-truth
   transcripts. Tensor parallelism over 2 ranks and data parallelism over
   2, in float32 compute, give the one-process run's words and boundaries
   (bf16 logged); the int8 encoder under a model axis of 2 gives encoder
   states bit-equal to one rank's; each rank's launch counts are exact; a
   model axis decodes eagerly, a data axis replays graphs. Per-rank wall
   and stages are printed ("gloo, one card": a check of function, no
   measure of NCCL).
8. The asset-day programs (``scripts/calibrate_kv_guard``,
   ``verify_kernels_on_device``, ``asset_gates``): the guard calibration in
   process at Whisper-medium width through the real asset path (a bf16
   ``.pt`` of medium with the toy vocabulary and a tokenizer directory from
   ``rehearse_asset_day.make_assets``, read by the CLI loader), 16
   utterances at batch 8, 32 steps, ``--mode int8`` then ``both``, each
   with its keys and exact launch counts of kernels 1 and 7 (the int8
   pass through kernel 7 in the decode graph), and after the int8 run the
   guard's promise: ``decode`` guarded at the recommended margin gives
   every utterance the exact decode's tokens. Then, in processes side by
   side, ``verify_kernels_on_device`` at its JAX sizes (exit 0, a PASS
   line a check, the launches of kernels 1, 2, 3a, 3b, 6 and 7 its checks
   made), ``asset_gates --rehearse --only 2,2b,3,4,5,6`` (each gate a
   process of the port on the card: rc 0 and a metrics line each) and,
   where ``transformers`` and ``safetensors`` import, the runbook's gate 1,
   ``rehearse_asset_day`` (the port's chain on the card against the HF
   twin on the CPU: both utterances matched). Gate 7 needs
   ``openai-whisper`` and the reference repository (logged). Logs the flip
   rate, the recommended margin, the predicted flag rates, the
   calibration's seconds and the phase's.
9. A JSON line of per-kernel numbers, then
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import glob
import inspect
import json
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense)
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12

N_UTTS = 16
BATCH = 8
DECODE_LEN = 32

# n_valid values the encoder kernels are held at, T=1500: the ragged tails
# of their 64-key tiles down to a single valid key
ENCODER_N_VALID = (1, 63, 64, 65, 1000, 1500)
# (batch, frames) the cross-attention kernel is held at: the full window,
# the bucket, an aligned neighbour of the window, an odd count (rows
# misaligned for every copy width), one frame, and the window for one file
# (api.align on one utterance: 16 blocks, one per head)
CROSS_CASES = ((8, 1500), (8, 384), (8, 1536), (8, 131), (8, 1), (1, 1500))
# of them, those timed: the window, the bucket, F=1536, whose rows are
# 16-byte aligned where F=1500's are not, and one file's window
CROSS_TIMED = ((8, 1500), (8, 384), (8, 1536), (1, 1500))
# a timed call reads inputs rotated over this many bytes of distinct copies,
# twice the 50 MB L2, so that each launch reads them from HBM
ROTATE_BYTES = 100e6


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str = "", iters: int = 20, warmup: int = 3):
    """Mean device time per call of ``fn``, in ms: the device activity whose
    name holds ``kernel`` (all of it when empty), from a ``torch.profiler``
    trace of ``iters`` calls. Unlike CUDA events around back-to-back calls,
    this leaves out the host time of a wrapper that launches a short kernel.
    None when the trace holds no device time.

    A trace can lose records: after a phase of many untraced launches it
    can hold fewer launches than were made, and a sum over ``iters`` calls
    then reads low. So each activity's time is its mean per recorded launch
    times its launches per call (its records over ``iters``, rounded up),
    and a count that is not a multiple of ``iters`` is logged."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for evt in prof.key_averages():
        total = (getattr(evt, "self_device_time_total", None)
                 or getattr(evt, "self_cuda_time_total", 0.0))
        if kernel in evt.key and total > 0 and evt.count > 0:
            if evt.count % iters:
                log(f"  the trace holds {evt.count} records of {evt.key[:60]}"
                    f" for {iters} calls")
            us += total / evt.count * math.ceil(evt.count / iters)
    return us / 1e3 if us > 0 else None


def launch_ms(fn, kernel, iters: int = 20, warmup: int = 3):
    """The device times in ms, sorted, of the launches of the kernel named
    ``kernel`` in a ``torch.profiler`` trace of ``iters`` calls of ``fn``
    after warmup, each launch's own record. Only launches that began inside
    the trace count: a trace can hand back records of launches made before
    it, which time other inputs. ``kernel`` may be a tuple of the names of
    the kernels that one call launches, in order: then each time is one
    call's span on the device, from its first launch's start to its last
    one's end (a launch may start before the one it depends on ends), and a
    call whose records the trace lost in part is left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    records = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and any(n in e.name for n in names)
                     and e.time_range.start >= 0)
    times, call = [], None
    for start, end, name in records:
        if names[0] in name:
            call = []
        if call is None or names[len(call)] not in name:
            call = None
            continue
        call.append((start, end))
        if len(call) == len(names):
            times.append((max(e for _, e in call) - call[0][0]) / 1e3)
            call = None
    return sorted(times)


def kernel_ms(fn, kernel, bound_ms: float, tries: int = 3, iters: int = 20):
    """(ms, method): the device time of one launch of the kernel named
    ``kernel`` (or of one call's launches of the kernels a tuple names),
    which ``fn`` launches once a call: the median of its launches' own
    records in a trace of ``iters`` calls (:func:`launch_ms`), ``"trace"``.
    A trace that holds records of fewer than half the calls, or of more
    launches than calls, is taken again, up to ``tries`` times; only then
    the CUDA-event time of the whole call (host time included) stands in,
    ``"events"``. A traced time below the card's bound for the work is
    impossible: it is taken again too, and fails the run if no trace reads
    at or above the bound, since then the bound or its byte count is
    wrong."""
    import statistics

    label = kernel if isinstance(kernel, str) else "+".join(kernel)
    below = []
    for _ in range(tries):
        times = launch_ms(fn, kernel, iters)
        if not iters // 2 <= len(times) <= iters:
            log(f"  the trace holds {len(times)} records of {label} for "
                f"{iters} calls: tracing again")
            continue
        ms = statistics.median(times)
        if ms >= bound_ms:
            return ms, "trace"
        below.append(ms)
        log(f"  {label}: traced {ms:.4g} ms ({len(times)} launches, "
            f"{times[0]:.4g} to {times[-1]:.4g} ms) is below its bound "
            f"{bound_ms:.4g} ms: tracing again")
    check(not below, f"{label}: every trace read below its bound "
          f"{bound_ms:.4g} ms ({', '.join(f'{ms:.4g}' for ms in below)} ms)")
    log(f"  {tries} traces held too few or too many records of {label}: "
        f"CUDA events of the whole call")
    return cuda_ms(fn), "events"


def library_ms(fn, bound_ms: float, tries: int = 3):
    """(ms, method): the device time per call of a PyTorch call, all its
    device work (:func:`device_ms`), ``"trace"``. A trace that holds none,
    or less than the bound (it missed some of the call's kernels), is taken
    again, up to ``tries`` times, as :func:`kernel_ms` does; only when no
    trace was usable, the CUDA-event time of the whole call (host time
    included), ``"events"``."""
    readings = []
    for _ in range(tries):
        ms = device_ms(fn)
        if ms is not None and ms >= bound_ms:
            if readings:
                log(f"  library call traced at {ms:.4g} ms after "
                    f"{len(readings)} unusable traces")
            return ms, "trace"
        readings.append(ms)
        log(f"  traced device time {ms} ms of the library call is missing "
            f"or below the bound {bound_ms:.4g} ms: tracing again")
    log(f"  {tries} traces of the library call unusable ({readings}): CUDA "
        f"events of the whole call")
    return cuda_ms(fn), "events"


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# the decoder's row-invariant kernels: their launches are derived exactly
# on the main path (``decoder_launches``); a path that derives only its
# other kernels leaves them None in its expected counts. The calls of
# ``dec_attn`` that stage a cache unaligned (an odd length) are never
# derived: they follow the cache's length
DECODER_KERNELS = ("dec_attn", "dec_attn_unaligned", "rows_linear")


def expect_base() -> dict:
    """Expected launch counts to fill in: 0 for every kernel, None (not
    derived here) for the decoder's two."""
    from whisper_char_alignment_tpu_torch.ops import _lib

    out = dict.fromkeys(_lib.LAUNCHES, 0)
    out.update(dict.fromkeys(DECODER_KERNELS))
    return out


def launches_match(counts: dict, expect: dict) -> bool:
    """``counts`` equal to ``expect`` for every kernel it derives (not
    None), and over the same kernels."""
    return counts.keys() == expect.keys() and all(
        v is None or counts[k] == v for k, v in expect.items())


def decoder_launches(dims, seen: dict) -> dict:
    """The decoder kernels' launches of a run from what it executed
    (:func:`spying`): a decode step runs 8 linears a layer (self q, k, v,
    out; cross q, out; the MLP's two) and the lm head, and its attention
    twice a layer over float cross K/V, once over int8 (the cross step
    runs kernel 7 or ``mxu``); a prefill the same layers once over its
    prompt, the lm head where it reads logits; ``precompute_cross_kv`` 2
    linears a layer; ``decode_text`` 8 linears a layer, 10 when it projects
    the encoder states itself, the lm head where it returns logits, and
    its attention twice a layer. The encoder runs neither."""
    layers = dims.n_text_layer
    steps = seen["all_steps"]  # greedy, beam and sampling steps alike
    return dict(
        rows_linear=steps * (8 * layers + 1) + seen["prefill_linears"]
        + 2 * layers * seen["precomputes"] + seen["text_linears"],
        dec_attn=layers * (2 * steps - seen["int8_steps"])
        + seen["prefill_attn"] + 2 * layers * seen["texts"])


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_phase():
    import torch
    import torch.nn.functional as F

    from whisper_char_alignment_tpu_torch.ops import (dtw_cuda,
                                                      encoder_attn_cuda)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    # -- encoder attention ---------------------------------------------------
    variants = (  # (row, wrapper, plain version, TPU kernel it replaces)
        ("encoder_attn", encoder_attn_cuda.encoder_self_attention,
         encoder_attn_cuda.encoder_self_attention_plain,
         "whisper_char_alignment_tpu/ops/encoder_attn_pallas.py:112"),
        ("encoder_attn_kt", encoder_attn_cuda.encoder_self_attention_kt,
         encoder_attn_cuda.encoder_self_attention_kt_plain,
         "whisper_char_alignment_tpu/ops/encoder_attn_pallas.py:74"))
    tols = ((torch.float32, 2e-5), (torch.bfloat16, 2e-2))

    def encoder_inputs(shape):
        scale = shape[-1] ** -0.25
        q, k, v = (torch.randn(shape, generator=gen, device=dev)
                   for _ in range(3))
        return q * scale, k * scale, v

    def hold_encoder(name, fn, plain, args, n_valid, dtype, tol) -> float:
        out = fn(*args, n_valid)
        ref = plain(*args, n_valid)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        lim = tol + (tol * ref.float().abs()
                     if dtype == torch.bfloat16 else 0.0)
        check(bool((err <= lim).all()),
              f"{name} {dtype} {tuple(args[0].shape)} n_valid={n_valid}: max "
              f"err {err.max().item():.3g}")
        return err.max().item()

    # edges at a small B*H: the other head dims
    for hd in (16, 32, 128):
        args32 = encoder_inputs((1, 4, 1500, hd))
        for dtype, tol in tols:
            args = [x.to(dtype).contiguous() for x in args32]
            for name, fn, plain, _ in variants:
                errs = [hold_encoder(name, fn, plain, args, n_valid, dtype,
                                     tol) for n_valid in (1000, 1500)]
                log(f"{name} {str(dtype)[6:]} (1,4,1500,{hd}) n_valid=1000, "
                    f"1500: max abs err {max(errs):.3g} (tol {tol})")

    b, h, t, hd = 8, 16, 1500, 64
    q32, k32, v32 = encoder_inputs((b, h, t, hd))
    for dtype, tol in tols:
        q, k, v = (x.to(dtype).contiguous() for x in (q32, k32, v32))
        ops = 4 * b * h * t * t * hd
        nbytes = 4 * b * h * t * hd * q.element_size()
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        bound = max(ops / peak, nbytes / HBM_BYTES_PER_S) * 1e3
        sdpa_ms, sdpa_method = library_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0), bound)
        for name, fn, plain, replaces in variants:
            # ragged tails of the 64-key tiles, down to one valid key
            worst = 0.0
            for n_valid in ENCODER_N_VALID:
                err = hold_encoder(name, fn, plain, (q, k, v), n_valid, dtype,
                                   tol)
                worst = max(worst, err)
                log(f"{name} {str(dtype)[6:]} n_valid={n_valid}: max abs "
                    f"err {err:.3g} (tol {tol})")
            ms, method = kernel_ms(lambda: fn(q, k, v, t),
                                   "encoder_attn_kernel", bound)
            call_ms = cuda_ms(lambda: fn(q, k, v, t))
            plain_ms = cuda_ms(lambda: plain(q, k, v, t), iters=3, warmup=1)
            log(f"{name} {str(dtype)[6:]} (8,16,1500,64): kernel {ms:.4f} ms"
                f" ({method}; whole call {call_ms:.4f} ms), "
                f"plain {plain_ms:.4f} ms, sdpa {sdpa_ms:.4f} ms "
                f"({sdpa_method}), bound {bound:.4f} ms ({ops / 1e9:.1f} "
                f"GFLOP, {ops / ms / 1e9:.1f} TFLOP/s)")
            if dtype == torch.bfloat16:
                rows[name] = dict(
                    name=name, route="cuda",
                    source="whisper_char_alignment_tpu_torch/csrc/encoder_attn.cu",
                    replaces=replaces, max_abs_err=worst, ms=ms,
                    ms_method=method, plain_ms=plain_ms, bound_ms=bound,
                    bound_by="operations"
                    if ops / peak > nbytes / HBM_BYTES_PER_S else "bytes",
                    library_ms=sdpa_ms, library_ms_method=sdpa_method)
    # T=1536: K^T rows 16-byte aligned (at T=1500 every other one is 8 bytes
    # off, and the kKT tile copies are 8 bytes wide)
    args = [x.to(torch.bfloat16) for x in encoder_inputs((b, h, 1536, hd))]
    aligned = {name: device_ms(lambda: fn(*args, 1536), "encoder_attn_kernel")
               for name, fn, _, _ in variants}
    log(f"encoder attention bf16 (8,16,1536,64), K^T rows aligned: "
        f"traced ms {aligned}")
    del q32, k32, v32, q, k, v, args

    rows.update(qkpost_rows(gen))

    # -- DTW -----------------------------------------------------------------
    dtw_edges(gen)
    b, n, m = 16, 120, 1500
    n_len = torch.randint(1, n + 1, (b,), generator=gen, device=dev,
                          dtype=torch.int32)
    m_len = torch.randint(1, m + 1, (b,), generator=gen, device=dev,
                          dtype=torch.int32)
    n_len[0], m_len[0] = n, m
    n_len[1], m_len[1] = 1, 1
    n_len[2], m_len[2] = n, 1
    n_len[3], m_len[3] = 1, m
    tied = -torch.randint(0, 3, (b, n, m), generator=gen, device=dev).float()
    rand = -torch.rand((b, n, m), generator=gen, device=dev)
    for label, x in (("tied", tied), ("random", rand)):
        hold_dtw(x, n_len, m_len, f"(16,120,1500) {label}")
    tr_bound, bt_bound, tr_by, bt_by = dtw_bounds(n_len, m_len, n, m)
    ms_tr, method_tr = kernel_ms(lambda: dtw_cuda.dtw_trace(rand),
                                 "dtw_trace_kernel", tr_bound)
    plain_tr = cuda_ms(lambda: dtw_cuda.dtw_trace_plain(rand), iters=3,
                       warmup=1)
    tr = dtw_cuda.dtw_trace(rand)
    ms_bt, method_bt = kernel_ms(
        lambda: dtw_cuda.dtw_backtrace_jump(tr, n_len, m_len),
        "dtw_backtrace_kernel", bt_bound)
    plain_bt = cuda_ms(lambda: dtw_cuda.dtw_jump_frames_plain(
        tr, n_len, m_len), iters=3, warmup=1)
    d = n + m - 1
    walk = int((n_len + m_len).max())
    lat = dtw_cuda.chain_step_latency(dev)
    log(f"dtw chain steps on this card (one warp, 65536 dependent steps): "
        f"shuffle {lat['shfl_cycles']:.1f} cycles = {lat['shfl_ns']:.2f} ns,"
        f" shared-memory load {lat['lds_cycles']:.1f} cycles = "
        f"{lat['lds_ns']:.2f} ns")
    log(f"dtw trace (16,120,1500): kernel {ms_tr:.4f} ms ({method_tr}), "
        f"{ms_tr * 1e6 / d:.1f} ns per diagonal over {d} dependent "
        f"diagonals; chain floor {d * lat['shfl_ns'] / 1e6:.4f} ms ({d} x "
        f"one shuffle); plain {plain_tr:.4f} ms, bound {tr_bound:.5f} ms")
    log(f"dtw backtrace (16,120,1500): kernel {ms_bt:.4f} ms ({method_bt}), "
        f"{ms_bt * 1e6 / walk:.1f} ns per walk step over the longest walk "
        f"of {walk} steps; chain floor {walk * lat['lds_ns'] / 1e6:.4f} ms "
        f"({walk} x one shared-memory load); plain {plain_bt:.4f} ms, bound "
        f"{bt_bound:.6f} ms")
    rows["dtw_trace"] = dict(
        name="dtw_trace", route="cuda",
        source="whisper_char_alignment_tpu_torch/csrc/dtw.cu",
        replaces="whisper_char_alignment_tpu/ops/dtw_pallas.py:171",
        max_abs_err=0.0, ms=ms_tr, ms_method=method_tr, plain_ms=plain_tr,
        bound_ms=tr_bound, bound_by=tr_by, library_ms=None)
    rows["dtw_backtrace"] = dict(
        name="dtw_backtrace", route="cuda",
        source="whisper_char_alignment_tpu_torch/csrc/dtw.cu",
        replaces="whisper_char_alignment_tpu/ops/dtw_pallas.py:290",
        max_abs_err=0.0, ms=ms_bt, ms_method=method_bt, plain_ms=plain_bt,
        bound_ms=bt_bound, bound_by=bt_by, library_ms=None)
    # row 5 (dtw_trace_batch) is the wavefront of row 3a returning its trace
    # diagonals: the same kernel, measured above
    rows["dtw_trace_batch"] = dict(
        rows["dtw_trace"], name="dtw_trace_batch",
        replaces="whisper_char_alignment_tpu/ops/dtw_pallas.py:320")
    del tied, rand, tr

    rows.update(cross_attn_rows(gen))
    rows.update(mel_rows(gen))
    rows.update(int8_rows(gen))
    rows.update(decoder_rows(gen))
    return rows


# median widths the QK post-process kernel is held and timed at: the main
# path's 3, the CLI's default 7 (long form, /transcribe), 15 and 17, the
# widest window of its own width (31), then padded register windows at 33
# (the first) and 101
QKPOST_WIDTHS = (3, 7, 15, 17, 31, 33, 101)
# the kernel rows of the JSON line: width -> row name
QKPOST_ROWS = {3: "qkpost", 7: "qkpost_w7", 17: "qkpost_w17",
               33: "qkpost_rank", 101: "qkpost_w101"}


def qkpost_bound(width: int, frame_len, token_len, shape):
    """(bound ms, "bytes" or "operations", bytes, bytes read, operations)
    of the QK post-process at ``width``, counting what these inputs need.

    Bytes: only rows < token_len x frames < frame_len are read (a row past
    token_len is all zeros, a frame past frame_len exactly 0, exp(-inf)),
    the whole (B, H, T, F) f32 output is written, and the two length
    arrays are read. Operations: 5 per valid element (scale, max, exp, sum,
    divide), plus ceil(log2 w) comparisons per element this run filters
    (items past the w//2 pass-through): the least any comparison-based
    sliding median spends placing each entering value in its sorted window.
    A median network's w (w - 1) / 2 is the work of one design, not of the
    function."""
    b, h, t, f = shape
    fl = frame_len.long().cpu()
    tl = token_len.long().cpu().clamp(max=t)
    valid = h * tl * fl
    read = int(valid.sum()) * 4
    nbytes = read + b * h * t * f * 4 + 2 * b * 4
    filtered = int((valid * (fl > width // 2)).sum())
    ops = 5 * int(valid.sum()) + filtered * math.ceil(math.log2(width))
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_F32
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations", nbytes, read,
            ops)


def qkpost_rows(gen):
    """The QK post-process kernel at (8, 16, 96, 1500), ragged and edge
    lengths, at every ``QKPOST_WIDTHS`` width against its plain version,
    each timed beside its bound; the ``QKPOST_ROWS`` widths give rows: 3
    (the smoke's main path), 7 (long form and /transcribe), 17 (the CLI
    run's), 33 (the CLI's default-timing run's, the first padded window)
    and 101 (a /align request's ``medfilt_width``)."""
    import torch

    from whisper_char_alignment_tpu_torch.ops import qkpost_cuda

    dev = torch.device("cuda")
    shape = b, h, t, f = 8, 16, 96, 1500
    qk = torch.randn(shape, generator=gen, device=dev) * 3.0
    frame_len = torch.tensor([1, 3, 4, 2, 750, 1499, 1500, 333],
                             dtype=torch.int32, device=dev)
    token_len = torch.tensor([96, 1, 50, 95, 96, 10, 70, 33],
                             dtype=torch.int32, device=dev)
    rows = {}
    for width in QKPOST_WIDTHS:
        out = qkpost_cuda.qk_postprocess(qk, frame_len, token_len, width)
        ref = qkpost_cuda.qk_postprocess_plain(qk, frame_len, token_len,
                                               width)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        check(err <= 1e-6, f"qkpost width {width}: max err {err:.3g}")
        del out, ref
        bound, bound_by, nbytes, read, ops = qkpost_bound(
            width, frame_len, token_len, shape)
        call = lambda: qkpost_cuda.qk_postprocess(  # noqa: E731
            qk, frame_len, token_len, width)
        ms, method = kernel_ms(call, "qkpost_kernel", bound)
        plain_ms = cuda_ms(lambda: qkpost_cuda.qk_postprocess_plain(
            qk, frame_len, token_len, width), iters=3, warmup=1)
        window = ("exact" if width <= qkpost_cuda.EXACT_WIDTH else "padded"
                  if width <= qkpost_cuda.PAD_WIDTH else "shared-memory")
        log(f"qkpost (8,16,96,1500) w={width} ({window} window): max abs "
            f"err {err:.3g} (tol 1e-6); kernel {ms:.4f} ms ({method}), plain "
            f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}; "
            f"{read / 1e6:.2f} MB read, {nbytes / 1e6:.2f} MB in all, "
            f"{ops / 1e6:.1f} M operations; {bound / ms:.1%} of it)")
        name = QKPOST_ROWS.get(width)
        if name:
            rows[name] = dict(
                name=name, route="cuda",
                source="whisper_char_alignment_tpu_torch/csrc/qkpost.cu",
                replaces="whisper_char_alignment_tpu/ops/qkpost_pallas.py:111",
                max_abs_err=err, ms=ms, ms_method=method, plain_ms=plain_ms,
                bound_ms=bound, bound_by=bound_by, library_ms=None)
    return rows


# (N + 1, M) the DTW kernels are held at: the wavefront's warp edges (a
# warp of 32 rows, one per lane, up to 256 rows; 449 = the decoder's
# 448-token context, at 2 rows per lane) by M = 1, 2, 90 and 1501 (rows off
# a 16-byte boundary) and 1500; then the edges of 2 rows per lane (257) and
# of 8 (1025), and 4096 rows, the kernel's limit
DTW_SHAPES = tuple((n1, m) for n1 in (2, 32, 33, 64, 65, 128, 129, 449)
                   for m in (1, 2, 90, 1500, 1501)) + (
    (256, 90), (257, 90), (1024, 7), (1025, 90), (4096, 3))


def dtw_bounds(n_len, m_len, n: int, m: int):
    """The DTW kernels' bounds in ms and what sets each: the wavefront reads
    each item's n_b x m_b costs and writes the trace; the backtrace reads
    one trace byte per walk step and writes the jump frames."""
    b = len(n_len)
    cells = int((n_len.long().clamp(min=0) * m_len.long()).sum())
    tr_bytes = cells * 4 + b * (n + m - 1) * (n + 1)
    tr_ops = cells * 5  # 4 comparisons + 1 add per cell
    steps = int((n_len.clamp(min=0) + m_len).sum())
    bt_bytes = steps + b * (n + 1) * 4 + 2 * b * 4
    bt_ops = steps * 4
    return (max(tr_bytes / HBM_BYTES_PER_S, tr_ops / PEAK_F32) * 1e3,
            max(bt_bytes / HBM_BYTES_PER_S, bt_ops / PEAK_F32) * 1e3,
            "bytes" if tr_bytes / HBM_BYTES_PER_S >= tr_ops / PEAK_F32
            else "operations",
            "bytes" if bt_bytes / HBM_BYTES_PER_S >= bt_ops / PEAK_F32
            else "operations")


def hold_dtw(x, n_len, m_len, label: str) -> None:
    """Both DTW kernels on ``x`` and the walks (n_len, m_len) against their
    plain versions: trace and jump frames bit-equal."""
    import torch

    from whisper_char_alignment_tpu_torch.ops import dtw_cuda

    tr = dtw_cuda.dtw_trace(x)
    jf = dtw_cuda.dtw_backtrace_jump(tr, n_len, m_len)
    tr_ref = dtw_cuda.dtw_trace_plain(x)
    jf_ref = dtw_cuda.dtw_jump_frames_plain(tr_ref, n_len, m_len)
    torch.cuda.synchronize()
    check(torch.equal(tr, tr_ref), f"dtw trace {label} differs")
    check(torch.equal(jf, jf_ref), f"dtw jump frames {label} differ")


def dtw_edges(gen) -> None:
    """The DTW kernels at every ``DTW_SHAPES`` entry on tied and random
    costs, each batch holding the full grid, a pad row (n < 0), n = 0,
    m = 1, one frame, walks that end one diagonal before, at and after a
    backtrace window edge where M allows, and a random length."""
    import torch

    from whisper_char_alignment_tpu_torch.ops import dtw_cuda

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    for n1, m in DTW_SHAPES:
        n = n1 - 1
        w = dtw_cuda.backtrace_window(n)
        pairs = [(n, m), (-2, m), (0, m), (n, 1), (1, 1)]
        pairs += [(n, k * w + e + 1 - n) for k in (1, 2) for e in (-1, 0, 1)
                  if 1 <= k * w + e + 1 - n <= m]
        pairs.append((int(torch.randint(1, n + 1, (), generator=gen,
                                        device=dev)),
                      int(torch.randint(1, m + 1, (), generator=gen,
                                        device=dev))))
        n_len, m_len = (torch.tensor(v, dtype=torch.int32, device=dev)
                        for v in zip(*pairs))
        b = len(pairs)
        tied = -torch.randint(0, 3, (b, n, m), generator=gen,
                              device=dev).float()
        rand = torch.randn((b, n, m), generator=gen, device=dev)
        for label, x in (("tied", tied), ("random", rand)):
            hold_dtw(x, n_len, m_len, f"(N+1={n1}, M={m}) {label}")
    log(f"dtw edges: trace and jump frames bit-equal at {len(DTW_SHAPES)} "
        f"(N+1, M) shapes x tied/random, with pad rows, n=0, m=1 and walks "
        f"cut at backtrace window edges ({time.perf_counter() - t0:.1f} s)")


def dtw_main_shape(inputs) -> None:
    """Both DTW kernels on the inputs the default main path gave
    ``dtw_jump_frames`` in its first batch (B, N = T - sot_len, M = 1500):
    bit-equal to their plain versions, then timed."""
    from whisper_char_alignment_tpu_torch.ops import dtw_cuda

    x, n_len, m_len = inputs
    b, n, m = x.shape
    hold_dtw(x, n_len, m_len, f"main-path shape {tuple(x.shape)}")
    tr_bound, bt_bound, _, _ = dtw_bounds(n_len, m_len, n, m)
    ms_tr, method_tr = kernel_ms(lambda: dtw_cuda.dtw_trace(x),
                                 "dtw_trace_kernel", tr_bound)
    tr = dtw_cuda.dtw_trace(x)
    ms_bt, method_bt = kernel_ms(
        lambda: dtw_cuda.dtw_backtrace_jump(tr, n_len, m_len),
        "dtw_backtrace_kernel", bt_bound)
    walk = int((n_len.clamp(min=0) + m_len).max())
    log(f"dtw at the main path's shape {tuple(x.shape)} (n {n_len.tolist()},"
        f" m {m_len.tolist()}): trace {ms_tr:.4f} ms ({method_tr}, "
        f"{ms_tr * 1e6 / (n + m - 1):.1f} ns per diagonal, bound "
        f"{tr_bound:.5f} ms), backtrace {ms_bt:.4f} ms ({method_bt}, "
        f"{ms_bt * 1e6 / max(walk, 1):.1f} ns per step of the longest walk "
        f"of {walk}, bound {bt_bound:.6f} ms); bit-equal")


def rotated(fn, args, nbytes: int):
    """A call of ``fn`` on distinct copies of ``args`` in turn, enough of
    them (``ROTATE_BYTES`` in all) that no launch finds its inputs in the
    50 MB L2, and the number of copies."""
    import itertools
    import math

    n = max(2, math.ceil(ROTATE_BYTES / nbytes))
    copies = itertools.cycle([args] + [tuple(a.clone() for a in args)
                                       for _ in range(n - 1)])
    return lambda: fn(*next(copies)), n


def cross_attn_rows(gen):
    """The decode cross-attention kernel over int8 and bf16 K/V at the full
    window (F=1500), at the bucket the second main path takes (F=384), at
    the other ``CROSS_CASES`` and at one file's window (B=1), against the
    plain version; those of ``CROSS_TIMED`` timed with inputs rotated out of
    L2 (``rotated``), beside the L2-warm time."""
    import torch
    import torch.nn.functional as F

    from whisper_char_alignment_tpu_torch.models import whisper as wm
    from whisper_char_alignment_tpu_torch.ops import cross_attn_cuda as ca

    dev = torch.device("cuda")
    h, hd = 16, 64
    k_scale = hd ** -0.25
    rows = {}
    for b, f in CROSS_CASES:
        shape = f"({b},{h},{hd},{f})"
        q = (torch.randn((b, h, 1, hd), generator=gen, device=dev)
             * k_scale).to(torch.bfloat16)
        kf, vf = (torch.randn((b, h, hd, f), generator=gen, device=dev)
                  for _ in range(2))
        (k8, k_s), (v8, v_s) = (wm.quantize_cross_kv(kf),
                                wm.quantize_cross_kv(vf))
        kb, vb = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
        cases = (("cross_attn_int8", ca.cross_attn_step_int8,
                  ca.cross_attn_step_int8_plain, (q, k8, k_s, v8, v_s),
                  "whisper_char_alignment_tpu/ops/cross_attn_pallas.py:63"),
                 ("cross_attn", ca.cross_attn_step, ca.cross_attn_step_plain,
                  (q, kb, vb),
                  "whisper_char_alignment_tpu/ops/cross_attn_pallas.py:94"))
        for name, fn, plain, args, replaces in cases:
            step = lambda *a: fn(*a, k_scale=k_scale)  # noqa: E731
            out = step(*args)
            ref = plain(*args, k_scale=k_scale)
            torch.cuda.synchronize()
            err = (out - ref).abs()
            check(bool((err <= 2e-5 + 2e-5 * ref.abs()).all()),
                  f"{name} {shape}: max err {err.max().item():.3g}")
            if (b, f) not in CROSS_TIMED:  # an edge: held, not timed
                log(f"{name} {shape}: max abs err "
                    f"{err.max().item():.3g} (tol 2e-5 + 2e-5 rel)")
                continue
            in_bytes = sum(x.numel() * x.element_size() for x in args)
            nbytes = in_bytes + out.numel() * 4
            ops = 4 * b * h * hd * f + 8 * b * h * f  # two products, softmax
            bound = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_F32) * 1e3
            cold, n_copies = rotated(step, args, in_bytes)
            ms, method = kernel_ms(cold, "cross_attn_kernel", bound)
            # the same inputs on every launch (L2-warm): no bound check,
            # since L2 may serve faster than HBM
            warm = device_ms(lambda: step(*args), "cross_attn_kernel")
            call_ms = cuda_ms(cold)
            plain_ms = cuda_ms(lambda: plain(*args, k_scale=k_scale))
            lib_ms = lib_method = None
            if name == "cross_attn":  # SDPA on K/V laid out (B, H, F, hd)
                kt, vt = (x.transpose(-1, -2).contiguous() for x in (kb, vb))
                sdpa, _ = rotated(
                    lambda q_, k_, v_: F.scaled_dot_product_attention(
                        q_, k_, v_, scale=k_scale), (q, kt, vt), in_bytes)
                lib_ms, lib_method = library_ms(sdpa, bound)
            log(f"{name} {shape}: max abs err {err.max().item():.3g} "
                f"(tol 2e-5 + 2e-5 rel); kernel {ms:.4f} ms ({method}, "
                f"inputs rotated over {n_copies} copies; L2-warm {warm} ms; "
                f"whole call {call_ms:.4f} ms), plain {plain_ms:.4f} ms, "
                f"bound {bound:.5f} ms ({nbytes / 1e6:.1f} MB, "
                f"{nbytes / ms / 1e6:.0f} GB/s)"
                + (f", sdpa {lib_ms:.4f} ms ({lib_method}, rotated)"
                   if lib_ms else ""))
            # the int8 row at the bucket the main path takes, the bf16 row
            # (off every path) at the full window
            if (name, b, f) in (("cross_attn_int8", 8, 384),
                                ("cross_attn", 8, 1500)):
                rows[name] = dict(
                    name=name, route="cuda",
                    source="whisper_char_alignment_tpu_torch/csrc/cross_attn.cu",
                    replaces=replaces, max_abs_err=err.max().item(), ms=ms,
                    ms_method=method, plain_ms=plain_ms, bound_ms=bound,
                    bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                    >= ops / PEAK_F32 else "operations",
                    library_ms=lib_ms, library_ms_method=lib_method)
        if (b, f) not in ((8, 384), (8, 1500)):
            continue
        # the int8 step the mxu mode takes instead of the kernel (plain
        # PyTorch on the int8 codes), as the decode loop calls it
        mxu = lambda: wm._cross_attn_step_int8_mxu(  # noqa: E731
            q, (k8, k_s), (v8, v_s), k_scale, torch.bfloat16)
        log(f"mxu int8 step {shape}: device {device_ms(mxu)} ms (all "
            f"its kernels, traced), whole call {cuda_ms(mxu):.4f} ms")
    return rows


# rows_linear at the main path's shapes (label, M, N, K, bias, out_dtype):
# a decode step of 8 utterances (32: B=32; 40: beam 5 of 8) through the
# attention's and the MLP's linears and the lm head, the capture's rows
# (8 x 96) and the cross K/V's (8 x 1500), at Whisper-medium width
LINEAR_CASES = (("mlp fc1", 8, 4096, 1024, True, None),
                ("q/k/v/out", 8, 1024, 1024, True, None),
                ("q/k/v/out M=32", 32, 1024, 1024, True, None),
                ("q/k/v/out M=40", 40, 1024, 1024, True, None),
                ("mlp fc2", 8, 1024, 4096, True, None),
                ("lm head", 8, 51865, 1024, False, "float32"),
                ("capture rows", 768, 1024, 1024, True, None),
                ("cross K/V rows", 12000, 1024, 1024, True, None))


def decoder_rows(gen):
    """The decoder's two row-invariant kernels at the main path's shapes
    (a decode step of 8 utterances at Whisper-medium width: 16 heads of 64,
    1500 frames; linears 1024 and 4096 wide and the 51865-token lm head),
    against their plain versions, and their rows bit-equal alone and among
    others there: an item alone against its batch of 8, a row alone against
    a 5-row window, a row's linear alone against 8 rows. ``dec_attn``'s row
    of the kernels line is the cross-attention step over bf16 K/V (8, 16,
    64, 1500), its two launches timed as one span with inputs rotated out of
    L2, beside SDPA (the step at B=1, the self step, a 5-row window and the
    capture's cross and self attention are logged the same way);
    ``rows_linear``'s the MLP's first linear (4096 x 1024) at 8 rows, also
    rotated, beside ``F.linear``; every other shape of ``LINEAR_CASES`` is
    held, timed under the name of the kernel its rows take, and logged."""
    import torch
    import torch.nn.functional as F

    from whisper_char_alignment_tpu_torch.models import whisper as wm
    from whisper_char_alignment_tpu_torch.ops import (dec_attn_cuda,
                                                      rows_linear_cuda)

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    h, hd = 16, 64
    scale = hd ** -0.25
    rows = {}

    def randn(*shape, dtype=bf16, mul=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * mul).to(dtype)

    def bound_of(nbytes, ops, peak):
        by_bytes = nbytes / HBM_BYTES_PER_S >= ops / peak
        return (max(nbytes / HBM_BYTES_PER_S, ops / peak) * 1e3,
                "bytes" if by_bytes else "operations")

    # -- dec_attn: (label, B, P, S, K/V laid out as the cache or as a
    # transposed projection, masked, K scaled, scores kept)
    # the benchmark's self steps: caches 35 and 99 columns long (staged
    # unaligned), beside 40 and 104 (16-byte rows); its cross steps
    cases = (("cross step", 8, 1, 1500, "cache", False, True, False),
             ("cross step B=1", 1, 1, 1500, "cache", False, True, False),
             ("self step", 8, 1, 48, "cache", True, True, False),
             ("self step B=32 S=35", 32, 1, 35, "cache", True, True, False),
             ("self step B=32 S=40", 32, 1, 40, "cache", True, True, False),
             ("self step B=16 S=99", 16, 1, 99, "cache", True, True, False),
             ("self step B=16 S=104", 16, 1, 104, "cache", True, True,
              False),
             ("cross step B=16", 16, 1, 1500, "cache", False, True, False),
             ("cross step B=32", 32, 1, 1500, "cache", False, True, False),
             ("window", 1, 5, 448, "cache", True, True, False),
             ("capture cross", 8, 96, 1500, "proj", False, False, True),
             ("capture self", 8, 96, 96, "proj", True, False, False))
    for label, b, p, s_, layout, masked, scaled, scores in cases:
        q = randn(b, p, h, hd, mul=scale).transpose(1, 2)
        if layout == "cache":
            k, v = randn(b, h, hd, s_), randn(b, h, hd, s_)
        else:
            k, v = (randn(b, h, s_, hd).transpose(-1, -2) for _ in range(2))
        start = max(0, s_ - 3 - p)
        mask = (wm._position_mask(torch.arange(start, start + p, device=dev),
                                  s_) if masked else None)
        ks = scale if scaled else None

        def call(q_, k_, v_, mask=mask, ks=ks, scores=scores):
            return dec_attn_cuda.dec_attn(q_, k_, v_, dtype=bf16, mask=mask,
                                          k_scale=ks, scores=scores)

        out, sc = call(q, k, v)
        ref, ref_sc = dec_attn_cuda.dec_attn_plain(q, k, v, dtype=bf16,
                                                   mask=mask, k_scale=ks)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        check(bool((err <= 2e-2 + 2e-2 * ref.float().abs()).all()),
              f"dec_attn {label}: max err {err.max().item():.3g}")
        if scores:
            sc_err = (sc - ref_sc).abs().max().item()
            check(sc_err <= 1e-5 * (1 + ref_sc.abs().max().item()),
                  f"dec_attn {label}: scores err {sc_err:.3g}")
        alone = call(q[b - 1:], k[b - 1:], v[b - 1:])[0]
        check(bits_equal(alone, out[b - 1:]),
              f"dec_attn {label}: the last item alone differs")
        r = p - 1
        one = call(q[:, :, r:r + 1], k, v,
                   mask=None if mask is None else mask[r:r + 1])[0]
        check(bits_equal(one, out[:, :, r:r + 1]),
              f"dec_attn {label}: the last row alone differs")
        in_bytes = sum(t.numel() * t.element_size() for t in (q, k, v))
        # the bound reads only the keys some row sees: the columns past the
        # last visible one add nothing
        seen = (s_ if mask is None else
                int((mask > float("-inf")).any(0).nonzero().max()) + 1)
        nbytes = (q.numel() * 2 + (k.numel() + v.numel()) * 2 * seen // s_
                  + out.numel() * 2
                  + (0 if mask is None else mask.numel() * 4)
                  + (sc.numel() * 4 if scores else 0))
        ops = 4 * b * h * p * seen * hd
        bound, by = bound_of(nbytes, ops, PEAK_BF16)
        cold, n_copies = rotated(call, (q, k, v), in_bytes)
        # past one chunk of keys a call is two launches (scores, then P.V
        # and the chunk fold), timed together
        launches = dec_attn_cuda.kernels(s_)
        ms, method = kernel_ms(cold, launches, bound)
        plain_ms = cuda_ms(lambda: dec_attn_cuda.dec_attn_plain(
            q, k, v, dtype=bf16, mask=mask, k_scale=ks))
        # SDPA on K/V laid out (B, H, S, hd), K scaled as the kernel scales
        # it: the same weights, without the scores
        kt = ((k.float() * scale).to(bf16) if scaled else k)
        kt, vt = (x.transpose(-1, -2).contiguous() for x in (kt, v))
        am = None if mask is None else mask.to(bf16)
        sdpa, _ = rotated(lambda q_, k_, v_: F.scaled_dot_product_attention(
            q_, k_, v_, attn_mask=am, scale=1.0), (q.contiguous(), kt, vt),
            in_bytes)
        lib_ms, lib_method = library_ms(sdpa, bound)
        log(f"dec_attn {label} (B={b}, H={h}, P={p}, S={s_}, hd={hd}, "
            f"{layout}{', scores' if scores else ''}): max abs err "
            f"{err.max().item():.3g} (tol 2e-2 + 2e-2 rel); item and row "
            f"alone bit-equal; kernel {ms:.4f} ms ({' + '.join(launches)}, "
            f"{method}, rotated over {n_copies} copies), plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms ({lib_method}), bound "
            f"{bound:.5f} ms ({by}, {nbytes / 1e6:.1f} MB, "
            f"{ops / 1e6:.1f} MFLOP)")
        if label == "cross step":
            rows["dec_attn"] = dict(
                name="dec_attn", route="cuda",
                source="whisper_char_alignment_tpu_torch/csrc/dec_attn.cu",
                replaces="whisper_char_alignment_tpu/models/whisper.py:756 "
                "(no pallas_call: the decode step's attention einsums, XLA "
                "dots)", max_abs_err=err.max().item(), ms=ms,
                ms_method=method, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib_ms,
                library_ms_method=lib_method)

    # -- rows_linear at the main path's shapes, each rotated out of L2
    for label, m, n, k, bias, out_name in LINEAR_CASES:
        out_dtype = None if out_name is None else getattr(torch, out_name)
        x = randn(m, k)
        w = randn(n, k, mul=k ** -0.5)
        bb = randn(n) if bias else None

        def call(x_, w_, b_=None, out_dtype=out_dtype):
            return rows_linear_cuda.rows_linear(x_, w_, b_, out_dtype)

        args = (x, w) if bb is None else (x, w, bb)
        y = call(*args)
        ref = rows_linear_cuda.rows_linear_plain(x, w, bb, out_dtype)
        torch.cuda.synchronize()
        tol = 1e-2 if out_dtype is None else 1e-4
        scale_row = ref.float().abs().amax(dim=-1, keepdim=True).clamp_min(
            1e-3)
        err = ((y.float() - ref.float()).abs() / scale_row).max().item()
        check(err <= tol, f"rows_linear {label}: max err {err:.3g} of the "
              f"row's largest (tol {tol})")
        for i in (0, m - 1):
            check(bits_equal(call(x[i:i + 1], w, bb), y[i:i + 1]),
                  f"rows_linear {label}: row {i} alone differs")
        in_bytes = sum(t.numel() * t.element_size() for t in args)
        nbytes = in_bytes + y.numel() * y.element_size()
        ops = 2 * m * n * k
        bound, by = bound_of(nbytes, ops, PEAK_BF16)
        cold, n_copies = rotated(call, args, in_bytes)
        kernel = rows_linear_cuda.kernel_name(m, n, k, bf16)
        ms, method = kernel_ms(cold, kernel, bound)
        plain_ms = cuda_ms(lambda: rows_linear_cuda.rows_linear_plain(
            x, w, bb, out_dtype))
        # the library call on the same inputs: bf16 out for the lm head
        # (its f32 product would need a cast of the whole embedding)
        lib, _ = rotated(lambda *a: F.linear(*a), args, in_bytes)
        lib_ms, lib_method = library_ms(lib, bound)
        seg_chunks, n_seg = rows_linear_cuda.plan(n, k, bf16)
        log(f"rows_linear {label} (M={m}, N={n}, K={k}; {n_seg} segments of "
            f"{seg_chunks * rows_linear_cuda.CHUNK[bf16]}, {kernel} mode "
            f"{rows_linear_cuda.route(m, n, k, bf16)}): max err {err:.3g} of "
            f"the row's largest; rows alone bit-equal; kernel {ms:.4f} ms "
            f"({method}, rotated over {n_copies} copies, "
            f"{ops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"F.linear {lib_ms:.4f} ms ({lib_method}), bound {bound:.5f} ms "
            f"({by}, {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP)")
        if label == "mlp fc1":
            rows["rows_linear"] = dict(
                name="rows_linear", route="cuda",
                source="whisper_char_alignment_tpu_torch/csrc/rows_linear.cu",
                replaces="whisper_char_alignment_tpu/models/whisper.py:139 "
                "(no pallas_call: _linear's jnp.dot, an XLA dot)",
                max_abs_err=err, ms=ms, ms_method=method, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=lib_ms,
                library_ms_method=lib_method)
    return rows


def mel_rows(gen):
    """The two mel kernels on 8 windows of 30 s whose first 2-7 s hold a
    tone in noise and the rest silence, as the runner pads utterances:
    ``log_mel`` against its plain version, the clip kernel alone bit-equal
    to ``clip_and_scale``; the spectrum kernel timed in ``log_mel`` calls
    on audio rotated out of L2, the clip kernel on rotated log10 spectra
    (in the call it reads what the spectrum kernel just wrote, from L2),
    each beside its bound, with the L2-warm times, the whole call, the
    plain version and Whisper's own frontend in PyTorch (``torch.stft``
    and the rest: a composite yardstick the port never calls)."""
    import numpy as np
    import torch

    from whisper_char_alignment_tpu_torch.audio.mel import mel_filterbank
    from whisper_char_alignment_tpu_torch.ops import mel_cuda

    dev = torch.device("cuda")
    b, n = 8, 480000
    live = torch.randint(32000, 112001, (b,), generator=gen, device=dev)
    t = torch.arange(n, device=dev) / 16000.0
    audio = (0.1 * torch.randn((b, n), generator=gen, device=dev)
             + 0.4 * torch.sin(2 * np.pi * 440.0 * t))
    audio = torch.where(t[None] * 16000 < live[:, None], audio, 0.0)
    n_frames = n // 160
    n_tiles = -(-n_frames // mel_cuda.TILE_FRAMES)
    window = torch.hann_window(400, device=dev)
    rows = {}
    for n_mels in (80, 128):
        out = mel_cuda.log_mel(audio, n_mels)
        ref = mel_cuda.log_mel_plain(audio, n_mels)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        check(err <= 1e-4, f"mel n_mels={n_mels}: max err {err:.3g}")
        # the clip kernel alone, on the plain log10 spectrum and its tile
        # maxima taken in PyTorch: bit-equal
        log10_ref = mel_cuda.log10_mel_plain(audio, n_mels).contiguous()
        tiles_ref = torch.nn.functional.pad(
            log10_ref, (0, n_tiles * mel_cuda.TILE_FRAMES - n_frames),
            value=-float("inf")).reshape(b, n_mels, n_tiles, -1).amax(
                dim=(1, 3)).contiguous()
        clipped = mel_cuda.mel_clip(log10_ref.clone(), tiles_ref)
        check(torch.equal(clipped, mel_cuda.clip_and_scale(log10_ref)),
              f"mel clip n_mels={n_mels}: not bit-equal to clip_and_scale")
        _, tiles = mel_cuda.log10_mel_kernel(audio, n_mels)
        tile_err = (tiles - tiles_ref).abs().max().item()
        check(tile_err <= 4e-4, f"mel tile maxima n_mels={n_mels}: max err "
              f"{tile_err:.3g}")

        fb_nonzeros = int(mel_cuda._tables(n_mels)[2].size)
        # the function's own work per frame: window, a real 400-point FFT
        # (2.5 N log2 N), power, the filterbank's nonzeros, the log
        fft = 2.5 * 400 * np.log2(400)
        rest = 400 + 201 * 3 + 2 * fb_nonzeros + 4 * n_mels
        ops = b * n_frames * (fft + rest)
        out_bytes = 4 * b * n_mels * n_frames
        nbytes = 4 * b * n + out_bytes
        bound = max(ops / PEAK_F32, nbytes / HBM_BYTES_PER_S) * 1e3
        clip_bytes = 2 * out_bytes + 4 * b * n_tiles
        clip_ops = 3 * b * n_mels * n_frames
        clip_bound = max(clip_ops / PEAK_F32,
                         clip_bytes / HBM_BYTES_PER_S) * 1e3

        call = lambda a: mel_cuda.log_mel(a, n_mels)  # noqa: E731
        cold, n_copies = rotated(call, (audio,), 4 * b * n)
        ms, method = kernel_ms(cold, "mel_spectrum_kernel", bound)
        warm = device_ms(lambda: call(audio), "mel_spectrum_kernel")
        warm_clip = device_ms(lambda: call(audio), "mel_clip_kernel")
        clip_cold, clip_copies = rotated(mel_cuda.mel_clip,
                                         (log10_ref.clone(), tiles_ref),
                                         out_bytes)
        clip_ms, clip_method = kernel_ms(clip_cold, "mel_clip_kernel",
                                         clip_bound)
        call_ms = cuda_ms(cold)
        call_warm_ms = cuda_ms(lambda: call(audio))
        plain_ms = cuda_ms(lambda: mel_cuda.log_mel_plain(audio, n_mels))
        clip_plain_ms = cuda_ms(lambda: mel_cuda.clip_and_scale(log10_ref))

        fb = torch.from_numpy(mel_filterbank(n_mels)).to(dev)

        def composite(a):  # Whisper's log_mel_spectrogram, batched
            spec = torch.stft(a, 400, 160, window=window, center=True,
                              pad_mode="reflect", return_complex=True)
            mel = fb @ (spec[..., :-1].abs() ** 2)
            log_spec = torch.clamp(mel, min=1e-10).log10()
            log_spec = torch.maximum(
                log_spec, log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0)
            return (log_spec + 4.0) / 4.0

        comp_err = (composite(audio) - ref).abs().max().item()
        comp_cold, _ = rotated(composite, (audio,), 4 * b * n)
        lib_ms, lib_method = library_ms(comp_cold, bound)
        log(f"mel (8, 480000) n_mels={n_mels}: max abs err {err:.3g} (tol "
            f"1e-4); tile maxima max err {tile_err:.3g}; clip kernel "
            f"bit-equal. Spectrum kernel {ms:.4f} ms ({method}, audio "
            f"rotated over {n_copies} copies; L2-warm {warm} ms), bound "
            f"{bound:.5f} ms ({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP; "
            f"{nbytes / ms / 1e6:.0f} GB/s); clip kernel {clip_ms:.4f} ms "
            f"({clip_method}, rotated over {clip_copies} copies; in the call,"
            f" L2-warm, {warm_clip} ms), bound {clip_bound:.5f} ms "
            f"({clip_bytes / 1e6:.1f} MB); whole call {call_ms:.4f} ms "
            f"(CUDA events, rotated; L2-warm {call_warm_ms:.4f} ms); plain "
            f"{plain_ms:.4f} ms (clip_and_scale alone {clip_plain_ms:.4f} "
            f"ms); composite torch.stft frontend {lib_ms:.4f} ms "
            f"({lib_method}, rotated; max abs diff from plain "
            f"{comp_err:.3g})")
        if n_mels == 80:  # Whisper-medium's
            rows["mel"] = dict(
                name="mel", route="cuda",
                source="whisper_char_alignment_tpu_torch/csrc/mel.cu",
                replaces="whisper_char_alignment_tpu/ops/mel_pallas.py:80",
                max_abs_err=err, ms=ms, ms_method=method, plain_ms=plain_ms,
                bound_ms=bound,
                bound_by="operations" if ops / PEAK_F32
                >= nbytes / HBM_BYTES_PER_S else "bytes", library_ms=lib_ms,
                library_ms_method=f"{lib_method}, composite: torch.stft "
                "frontend")
            rows["mel_clip"] = dict(
                name="mel_clip", route="cuda",
                source="whisper_char_alignment_tpu_torch/csrc/mel.cu",
                replaces="whisper_char_alignment_tpu/ops/mel_pallas.py:105",
                max_abs_err=0.0, ms=clip_ms, ms_method=clip_method,
                plain_ms=clip_plain_ms, bound_ms=clip_bound,
                bound_by="operations" if clip_ops / PEAK_F32
                >= clip_bytes / HBM_BYTES_PER_S else "bytes",
                library_ms=None)
    return rows


# Whisper-medium's six encoder linears at B=8 (M = 8 x 1500 rows): q, k, v
# and out (1024 -> 1024), fc1 (1024 -> 4096), fc2 (4096 -> 1024)
INT8_M = 8 * 1500
INT8_SHAPES = ((1024, 1024), (1024, 4096), (4096, 1024))
PEAK_INT8 = 1979e12


def int8_rows(gen):
    """The int8 encoder linear's two kernels at Whisper-medium's shapes, in
    bf16 (and once in f32): the row quantize and the epilogue bit-equal to
    their plain versions (a zero row; a row max given from elsewhere, as a
    row-split tensor-parallel layer passes it; with and without a bias),
    each timed against its byte bound, beside the int8 product
    (``torch._int_mm``, its int32 result equal to an exact float64 product)
    and bf16 ``F.linear`` at the same shape, as yardsticks."""
    import torch
    import torch.nn.functional as F

    from whisper_char_alignment_tpu_torch.ops import int8_cuda

    dev = torch.device("cuda")
    m = INT8_M
    rows, quant, deq = {}, {}, {}
    for k, n in INT8_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn((m, k), generator=gen, device=dev) * 3).to(dtype)
            x[7] = 0
            codes, xs = int8_cuda.quantize_rows(x)
            want = int8_cuda.quantize_rows_plain(x)
            check(torch.equal(codes, want[0]) and torch.equal(xs, want[1]),
                  f"int8 quantize ({m}, {k}) {dtype}: not bit-equal")
            amax = x.float().abs().amax(dim=-1, keepdim=True) * 1.25
            got = int8_cuda.quantize_rows(x, amax)
            want = int8_cuda.quantize_rows_plain(x, amax)
            check(torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                               want[1]),
                  f"int8 quantize ({m}, {k}) {dtype} with a given row max: "
                  "not bit-equal")
            w8 = torch.randint(-127, 128, (n, k), dtype=torch.int8,
                               device=dev, generator=gen)
            y = int8_cuda.int_mm(codes, w8)
            check(torch.equal(y.double(), codes.double() @ w8.double().t()),
                  f"int8 product ({m}, {k}) x ({k}, {n}): not exact")
            s = torch.rand(n, generator=gen, device=dev) * 1e-2
            b = torch.randn(n, generator=gen, device=dev).to(dtype)
            for bias in (None, b):
                got = int8_cuda.dequantize(y, xs, s, bias, dtype)
                check(torch.equal(got, int8_cuda.dequantize_plain(
                    y, xs, s, bias, dtype)), f"int8 epilogue ({m}, {n}) "
                      f"{dtype} bias={bias is not None}: not bit-equal")
            if dtype != torch.bfloat16:
                continue
            isz = x.element_size()
            q_bytes = m * k * (isz + 1) + 4 * m
            q_bound = q_bytes / HBM_BYTES_PER_S * 1e3
            d_bytes = m * n * (4 + isz) + 4 * m + 4 * n + isz * n
            d_bound = d_bytes / HBM_BYTES_PER_S * 1e3
            if k not in quant:
                ms, method = kernel_ms(lambda: int8_cuda.quantize_rows(x),
                                       "int8_quant_kernel", q_bound)
                plain = cuda_ms(lambda: int8_cuda.quantize_rows_plain(x))
                quant[k] = dict(ms=ms, method=method, plain=plain,
                                bound=q_bound)
                log(f"int8 quantize ({m}, {k}) bf16: bit-equal; {ms:.4f} ms "
                    f"({method}) against its byte bound {q_bound:.4f} ms "
                    f"({q_bytes / 1e6:.1f} MB, {q_bytes / ms / 1e6:.0f} "
                    f"GB/s); plain {plain:.4f} ms")
            if n not in deq:
                ms, method = kernel_ms(
                    lambda: int8_cuda.dequantize(y, xs, s, b, dtype),
                    "int8_dequant_kernel", d_bound)
                plain = cuda_ms(lambda: int8_cuda.dequantize_plain(
                    y, xs, s, b, dtype))
                deq[n] = dict(ms=ms, method=method, plain=plain,
                              bound=d_bound)
                log(f"int8 epilogue ({m}, {n}) bf16 + bias: bit-equal; "
                    f"{ms:.4f} ms ({method}) against its byte bound "
                    f"{d_bound:.4f} ms ({d_bytes / 1e6:.1f} MB, "
                    f"{d_bytes / ms / 1e6:.0f} GB/s); plain {plain:.4f} ms")
            wf = torch.randn((n, k), generator=gen, device=dev).to(dtype)
            mm_bound = max(2 * m * k * n / PEAK_INT8,
                           (m * k + k * n + 4 * m * n) / HBM_BYTES_PER_S) * 1e3
            lin_bound = max(2 * m * k * n / PEAK_BF16,
                            isz * (m * k + k * n + m * n)
                            / HBM_BYTES_PER_S) * 1e3
            mm_ms, mm_method = library_ms(lambda: int8_cuda.int_mm(codes, w8),
                                          mm_bound)
            lin_ms, lin_method = library_ms(lambda: F.linear(x, wf),
                                            lin_bound)
            log(f"int8 product ({m}, {k}) x ({k}, {n}): torch._int_mm "
                f"{mm_ms:.4f} ms ({mm_method}; bound {mm_bound:.4f} ms at "
                f"1979 TOP/s) beside bf16 F.linear {lin_ms:.4f} ms "
                f"({lin_method}; bound {lin_bound:.4f} ms); exact")
    # the rows time the shapes five of the six layers give each kernel
    for name, table, key, replaces in (
            ("int8_quant", quant, 1024, "_int8_rowwise, fused by XLA"),
            ("int8_dequant", deq, 1024, "_linear_int8's epilogue, fused by "
             "XLA")):
        r = table[key]
        rows[name] = dict(
            name=name, route="cuda",
            source="whisper_char_alignment_tpu_torch/csrc/int8_linear.cu",
            replaces=f"whisper_char_alignment_tpu/models/whisper.py:148 "
            f"(no pallas_call: {replaces})", max_abs_err=0.0, ms=r["ms"],
            ms_method=r["method"], plain_ms=r["plain"], bound_ms=r["bound"],
            bound_by="bytes", library_ms=None)
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def oracle_recompute(pipe, batch) -> int:
    """Recompute each utterance's boundaries from its aggregated matrix with
    the NumPy DTW oracle; they must be equal. Returns how many were held."""
    import numpy as np

    from whisper_char_alignment_tpu_torch import constants
    from whisper_char_alignment_tpu_torch.align import timing
    from whisper_char_alignment_tpu_torch.ops.dtw import dtw_np
    from whisper_char_alignment_tpu_torch.text import retokenize

    held = 0
    for a in pipe.align_batch(batch, return_matrix=True):
        if a.skipped or a.matrix is None or len(a.words) < 2:
            continue
        check(bool(np.isfinite(a.matrix).all()), f"{a.fid}: non-finite matrix")
        text_tokens = retokenize.encode(a.transcription, pipe.tokenizer,
                                        pipe.cfg.aligned_unit_type)
        _, _, wb = timing.words_and_boundaries(text_tokens, pipe.tokenizer,
                                               pipe.cfg.aligned_unit_type)
        check(a.matrix.shape[0] == len(text_tokens) + 1,
              f"{a.fid}: matrix rows {a.matrix.shape[0]}")
        ti, tj = dtw_np(-np.asarray(a.matrix, np.float64))
        first = np.pad(np.diff(ti), (1, 0), constant_values=1).astype(bool)
        jump_times = tj[first] / constants.TOKENS_PER_SECOND
        check(np.array_equal(a.start_times, jump_times[wb[:-1]])
              and np.array_equal(a.end_times, jump_times[wb[1:]]),
              f"{a.fid}: device DTW differs from the NumPy oracle")
        held += 1
    return held


def tiny_vs_cpu() -> str:
    """A tiny f32 model on the card against the same weights on the CPU
    (plain versions): encoder states and capture attention."""
    import torch

    from whisper_char_alignment_tpu_torch.config import tiny_test_dims
    from whisper_char_alignment_tpu_torch.models import whisper as wm

    dims = tiny_test_dims(n_vocab=512, n_audio_ctx=300, n_text_ctx=48,
                          state=128, head=2, layers=2)
    gen = torch.Generator().manual_seed(1)
    cpu = wm.init_params(wm.Whisper(dims, device="cpu"), gen)
    gpu = wm.cast_params(cpu, torch.float32, torch.device("cuda"))
    mel = torch.randn((2, 80, 600), generator=gen)
    xa_c = wm.encode_audio(cpu, mel, device="cpu")
    xa_g = wm.encode_audio(gpu, mel.cuda())
    e_err = (xa_g.cpu() - xa_c).abs().max().item()
    check(e_err <= 2e-4, f"tiny encoder GPU vs CPU: {e_err:.3g}")
    tokens = torch.randint(0, 512, (2, 20), generator=gen)
    fl = torch.tensor([300, 123], dtype=torch.int32)
    tl = torch.tensor([20, 9], dtype=torch.int32)
    _, a_c = wm.decode_text(cpu, tokens, xa_c, medfilt_width=7, frame_len=fl,
                            token_len=tl, return_logits=False, device="cpu")
    _, a_g = wm.decode_text(gpu, tokens.cuda(), xa_c.cuda(), medfilt_width=7,
                            frame_len=fl.cuda(), token_len=tl.cuda(),
                            return_logits=False)
    a_err = (a_g.cpu() - a_c).abs().max().item()
    check(a_err <= 1e-5, f"tiny capture attention GPU vs CPU: {a_err:.3g}")
    return f"encoder max err {e_err:.3g} (tol 2e-4), attention {a_err:.3g} (tol 1e-5)"


@contextlib.contextmanager
def spying(seen: dict):
    """Count, while the block runs, the decode steps by the kind of their
    cross K/V (int8 or float) and the frames they span, and the capture
    passes that reuse the decode loop's K/V, keep each batch's decode
    results (a ``DecodeFuture`` until read: :func:`results_of`) and a copy
    of the first batch's DTW inputs: the four module functions the runner
    reaches are wrapped and restored after. A replayed CUDA graph calls no
    Python, so the steps are read from the graph runner's replay record
    around each graphed loop: the steps its replays ran plus the warm-up
    step of a graph captured in the block (each launches its kernels)."""
    from whisper_char_alignment_tpu_torch.align import timing
    from whisper_char_alignment_tpu_torch.models import decode_graph, decoding
    from whisper_char_alignment_tpu_torch.models import whisper as wm

    loop, attentions, decode, jump = (decode_graph.graphed_loop,
                                      timing.get_attentions, decoding.decode,
                                      timing.dtw_jump_frames)
    prefill, precompute, text = (wm.decode_prefill, wm.precompute_cross_kv,
                                 wm.decode_text)

    def counted_prefill(model, tokens, cache, cross_kv, logits_at=None,
                        **kw):
        float_kv = not isinstance(cross_kv[0], tuple)
        n = model.dims.n_text_layer
        seen["prefill_linears"] += 8 * n + (logits_at is not None)
        seen["prefill_attn"] += n * (1 + float_kv)
        return prefill(model, tokens, cache, cross_kv, logits_at=logits_at,
                       **kw)

    def counted_precompute(*a, **kw):
        seen["precomputes"] += 1
        return precompute(*a, **kw)

    def counted_text(*a, **kw):
        call = inspect.signature(text).bind(*a, **kw)
        call.apply_defaults()
        args = call.arguments
        n = args["model"].dims.n_text_layer
        seen["texts"] += 1
        seen["text_linears"] += (n * (8 + 2 * (args["cross_kv"] is None))
                                 + bool(args["return_logits"]))
        return text(*a, **kw)

    def counted_loop(*args, **kwargs):
        before = decode_graph.replay_record()
        out = loop(*args, **kwargs)
        after = decode_graph.replay_record()
        ck = out[4][0]
        int8 = isinstance(ck, tuple)
        steps = (after["steps"] - before["steps"]
                 + after["warmup_steps"] - before["warmup_steps"])
        seen["int8_steps" if int8 else "float_steps"] += steps
        seen["replays"] += after["replays"] - before["replays"]
        seen["captures"] += after["captures"] - before["captures"]
        seen["frames"].add((ck[0] if int8 else ck).shape[-1])
        return out

    def counted_attentions(*args, **kwargs):
        seen["capture_passes"] += 1
        seen["reused"] += kwargs.get("cross_kv") is not None
        return attentions(*args, **kwargs)

    def kept_decode(*args, **kwargs):
        out = decode(*args, **kwargs)
        seen["results"].append(out[0] if isinstance(out, tuple) else out)
        return out

    def kept_jump(x, n, m):
        if seen["dtw_inputs"] is None:
            seen["dtw_inputs"] = (x.clone(), n.clone(), m.clone())
        return jump(x, n, m)

    (decode_graph.graphed_loop, timing.get_attentions, decoding.decode,
     timing.dtw_jump_frames) = (counted_loop, counted_attentions, kept_decode,
                                kept_jump)
    wm.decode_prefill, wm.precompute_cross_kv, wm.decode_text = (
        counted_prefill, counted_precompute, counted_text)
    rec0 = decode_graph.replay_record()
    try:
        yield
    finally:
        rec1 = decode_graph.replay_record()
        # every loop's steps (beam and sampling too): replayed and warm-up
        seen["all_steps"] += (rec1["steps"] - rec0["steps"]
                              + rec1["warmup_steps"] - rec0["warmup_steps"])
        (decode_graph.graphed_loop, timing.get_attentions, decoding.decode,
         timing.dtw_jump_frames) = (loop, attentions, decode, jump)
        wm.decode_prefill, wm.precompute_cross_kv, wm.decode_text = (
            prefill, precompute, text)


def results_of(kept):
    """A kept decode's results: a ``DecodeFuture`` (the runner's
    ``async_results``) is read here."""
    from whisper_char_alignment_tpu_torch.models import decoding

    return kept.result() if isinstance(kept, decoding.DecodeFuture) else kept


def new_seen() -> dict:
    return dict(int8_steps=0, float_steps=0, replays=0, captures=0,
                frames=set(), capture_passes=0, reused=0, results=[],
                dtw_inputs=None, prefill_linears=0, prefill_attn=0,
                precomputes=0, texts=0, text_linears=0, all_steps=0)


def check_alignments(results, dataset, n: int) -> None:
    import numpy as np

    check(len(results) == n, f"{len(results)} results")
    by_fid = {dataset.entries[i][0]: dataset[i] for i in range(len(dataset))}
    for r in results:
        check(not r.skipped and len(r.words) >= 2, f"{r.fid} not aligned")
        dur = by_fid[r.fid].duration / 16000
        s, e = np.asarray(r.start_times), np.asarray(r.end_times)
        check(bool(np.isfinite(s).all() and np.isfinite(e).all()),
              f"{r.fid}: non-finite times")
        check(bool((s <= e).all()), f"{r.fid}: a start after its end")
        check(bool((np.diff(s) >= 0).all() and (np.diff(e) >= 0).all()),
              f"{r.fid}: times decrease")
        check(bool(s.min() >= 0 and e.max() <= dur + 1e-9),
              f"{r.fid}: times outside [0, {dur:.2f}]")


def drive(label: str, pipe, dataset, expected, card: str):
    """One main-path run: a warmup batch, then ``run_dataset`` with the
    launch counts set to 0 just before and read just after, which must equal
    ``expected(seen)``; then the alignment checks and the NumPy DTW oracle
    on the first batch. Returns (counts, seen)."""
    import torch

    from whisper_char_alignment_tpu_torch.data.dataset import batch_iter
    from whisper_char_alignment_tpu_torch.ops import _lib

    t0 = time.perf_counter()
    pipe.align_batch([dataset[i] for i in range(BATCH)])
    log(f"[{label}] warmup batch: {time.perf_counter() - t0:.2f} s")

    seen = new_seen()
    pipe.timers.reset()
    pipe.decode_shapes.clear()
    pipe.capture_shapes.clear()
    _lib.reset_launches()
    torch.cuda.synchronize()
    with spying(seen):
        t0 = time.perf_counter()
        results = list(pipe.run_dataset(dataset, progress=False))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = _lib.launch_counts()
    expect = expected(seen)
    log(f"[{label}] launch counts: {counts} (expected {expect}); decode "
        f"steps int8 {seen['int8_steps']} float {seen['float_steps']} "
        f"({seen['replays']} graph replays, {seen['captures']} captures) "
        f"over {sorted(seen['frames'])} frames; capture passes "
        f"{seen['capture_passes']}, reusing the decode K/V {seen['reused']}")
    check(launches_match(counts, expect),
          f"[{label}] launch counts differ from the path's")
    check_alignments(results, dataset, len(dataset))
    stages = {k: round(v, 4) for k, v in pipe.stage_seconds.items()}
    seen["stages"] = stages
    seen.update(wall=wall, decode_shapes=list(pipe.decode_shapes),
                capture_shapes=list(pipe.capture_shapes))
    log(f"[{label}] main path on {card}: {len(dataset)} utterances aligned in"
        f" {wall:.3f} s -> {len(dataset) / wall:.3f} utts/s; stage seconds "
        f"{json.dumps(stages)}")
    first = next(iter(batch_iter(dataset, BATCH, prefetch=0)))
    held = oracle_recompute(pipe, first)
    check(held > 0, f"[{label}] no utterance held against the DTW oracle")
    log(f"[{label}] NumPy DTW oracle: {held} utterances' boundaries equal")
    return counts, seen


@contextlib.contextmanager
def environ(**values: str):
    """Set environment values while the block runs; restore them after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cross_mode_phase(pipe, dataset, card: str) -> None:
    """The decode stage of the int8 + bucket pipeline on one batch under the
    ``mxu`` step (plain PyTorch on the int8 codes) and under the
    cross-attention kernel (``pallas``), alternately: mxu, pallas, pallas,
    mxu, twice. Device seconds per batch for each (graph replays)."""
    batch = [dataset[i] for i in range(BATCH)]
    secs = {"mxu": [], "pallas": []}
    texts = {}
    for mode in ("mxu", "pallas", "pallas", "mxu") * 2:
        before = pipe.stage_seconds["decode dispatch"]
        with environ(WCA_CROSS_ATTN=mode):
            texts[mode] = pipe.transcribe_batch(batch)[0]
        secs[mode].append(pipe.stage_seconds["decode dispatch"] - before)
    same = sum(a == b for a, b in zip(texts["mxu"], texts["pallas"]))
    mean = {k: sum(v) / len(v) for k, v in secs.items()}
    log(f"[cross mode] int8 + bucket decode stage on {card}, s per batch: "
        f"mxu {[round(x, 4) for x in secs['mxu']]} (mean {mean['mxu']:.4f}),"
        f" kernel {[round(x, 4) for x in secs['pallas']]} (mean "
        f"{mean['pallas']:.4f}); kernel/mxu {mean['pallas'] / mean['mxu']:.3f};"
        f" {same} of {BATCH} transcripts equal across the two")


def guarded_phase(model, tok, dataset, card: str) -> None:
    """One batch with both margin guards (int8 K/V and a 128-frame bucket),
    set between the batch's own margins so that some rows are flagged and
    some are not. A first pass of the same pipeline with both guards at 0
    (nothing flagged) gives the int8 + bucket tokens and their margins; the
    exact (full-window, unquantized) decode of the same encoder states gives
    the exact tokens. In the guarded run the launch counts must be exact and
    the pipeline's own decode must give each row it flags the exact tokens
    and each other row the int8 + bucket tokens."""
    import numpy as np

    from whisper_char_alignment_tpu_torch.config import AlignConfig
    from whisper_char_alignment_tpu_torch.models import decoding
    from whisper_char_alignment_tpu_torch.ops import _lib
    from whisper_char_alignment_tpu_torch.runner import AlignmentPipeline

    cfg = AlignConfig.recommended(
        model="medium", batch_size=BATCH, use_gt_transcript=True,
        decode_kv_int8_guarded=True, decode_frame_bucket=128,
        decode_frame_bucket_guarded=True)
    pipe = AlignmentPipeline(model, tok, cfg, compute_dtype=model.dtype)
    pipe.options = decoding.DecodingOptions(language="en",
                                            sample_len=DECODE_LEN)
    batch = [dataset[i] for i in range(BATCH)]

    probe = new_seen()
    with environ(WCA_KV_INT8_GUARD_MARGIN="0", WCA_BUCKET_GUARD_MARGIN="0"), \
            spying(probe):
        _, mel, xa = pipe.transcribe_batch(batch)
    check(probe["int8_steps"] > 0 and probe["float_steps"] == 0,
          "[guarded] the guard-0 pass did not take int8 steps alone")
    perturbed = results_of(probe["results"][0])[:BATCH]
    exact = decoding.decode(pipe.model, tok, mel, pipe.options, xa=xa,
                            device=pipe.device.type)
    margins = np.unique([r.min_margin for r in perturbed])
    check(len(margins) >= 2 and bool(np.isfinite(margins).all()),
          f"[guarded] margins {margins} cannot be split")
    mid = len(margins) // 2
    guard = float(margins[mid - 1] + margins[mid]) / 2
    # each guard half the total: the decode flags rows below their sum
    half = repr(guard / 2)

    seen = new_seen()
    with environ(WCA_KV_INT8_GUARD_MARGIN=half, WCA_BUCKET_GUARD_MARGIN=half):
        check(pipe.active_guard_margin() == guard,
              f"[guarded] active guard {pipe.active_guard_margin()} != {guard}")
        _lib.reset_launches()
        with spying(seen):
            results = pipe.align_batch(batch)
        counts = _lib.launch_counts()
        flag_rate = pipe.flag_rate()
    expect = expect_base()
    layers = model.dims.n_text_layer
    expect.update(encoder_attn=model.dims.n_audio_layer, qkpost=layers,
                  dtw_trace=1, dtw_backtrace=1, mel=1, mel_clip=1,
                  cross_attn_int8=layers * seen["int8_steps"])
    expect.update(decoder_launches(model.dims, seen))
    log(f"[guarded] launch counts: {counts} (expected {expect}); decode "
        f"steps int8 {seen['int8_steps']}, exact re-decode "
        f"{seen['float_steps']}")
    check(launches_match(counts, expect),
          "[guarded] launch counts differ from the path's")
    check_alignments(results, dataset, BATCH)
    own = results_of(seen["results"][0])[:BATCH]
    check(len(pipe.min_margins) == BATCH
          and bool(np.isfinite(pipe.min_margins).all()),
          f"[guarded] margins not tracked: {pipe.min_margins}")
    flagged = [m < guard for m in pipe.min_margins]
    check(0 < sum(flagged) < BATCH,
          f"[guarded] {sum(flagged)} of {BATCH} rows flagged at guard {guard}")
    check(seen["float_steps"] > 0, "[guarded] flagged rows were not re-decoded")
    for i, flag in enumerate(flagged):
        want = exact[i] if flag else perturbed[i]
        check(own[i].tokens == want.tokens,
              f"[guarded] row {i} ({'flagged' if flag else 'kept'}) differs "
              f"from the {'exact' if flag else 'int8 + bucket'} decode")
    differ = sum(e.tokens != p.tokens for e, p in zip(exact, perturbed))
    log(f"[guarded] on {card}: guard {guard:.6g} (half from each), flag rate "
        f"{flag_rate}, min margins {[round(m, 4) for m in pipe.min_margins]}"
        f" (guard-0 pass: {[round(r.min_margin, 4) for r in perturbed]}); "
        f"{sum(flagged)} of {BATCH} rows flagged, each with the exact "
        f"decode's tokens, the others with the int8 + bucket decode's; the "
        f"two decodes differ in {differ} rows")


def graph_phase(model, tok, dataset, card: str) -> dict:
    """Each decode mode of the main path on one batch of its encoder
    states, through the captured CUDA graph and through the eager loop on
    the card (``decoding._decode_loop``, the graph's plain version): the
    float loop whose K/V the capture pass reuses, int8 K/V with a 128-frame
    bucket through the cross-attention kernel and through the ``mxu`` step,
    and the guarded pair (both guards, set so that every row is re-decoded
    exactly). Tokens, ``n_steps``, log-probabilities, no-speech
    probabilities and margins must be bit-equal. Logs each mode's decode
    time graphed and eager (host clock around a synchronised call, the
    graph already captured), the device-busy share of each from a trace,
    and one step's device time (CUDA events over replays of the captured
    chunk) against the step's byte floor. Returns the logged numbers."""
    import math

    import torch

    from whisper_char_alignment_tpu_torch import constants
    from whisper_char_alignment_tpu_torch.config import AlignConfig
    from whisper_char_alignment_tpu_torch.models import decode_graph, decoding
    from whisper_char_alignment_tpu_torch.runner import AlignmentPipeline
    from whisper_char_alignment_tpu_torch.scripts.profile_decode_step import \
        step_floor
    from whisper_char_alignment_tpu_torch.utils import profiling

    cfg = AlignConfig.recommended(model="medium", batch_size=BATCH,
                                  use_gt_transcript=True)
    pipe = AlignmentPipeline(model, tok, cfg, compute_dtype=model.dtype)
    opts = decoding.DecodingOptions(language="en", sample_len=DECODE_LEN)
    batch = [dataset[i] for i in range(BATCH)]
    _, mel, xa = pipe.transcribe_batch(batch)
    frames = max(u.duration // constants.AUDIO_SAMPLES_PER_TOKEN for u in batch)
    bucket = min(model.dims.n_audio_ctx, -(-int(frames) // 128) * 128)
    modes = (("float", "xla", {}),
             ("int8+bucket kernel", "pallas",
              dict(kv_int8=True, kv_frames=bucket)),
             ("int8+bucket mxu", "mxu", dict(kv_int8=True, kv_frames=bucket)),
             ("guarded pair", "pallas",
              dict(kv_frames=bucket, kv_int8_guard=1e9, kv_frames_guard=0.0)))
    eager = lambda dev: decoding._decode_loop  # noqa: E731

    def decode(kw, loop=None):
        with contextlib.ExitStack() as stack:
            if loop is not None:
                stack.enter_context(patched(decoding, _loop_for=loop))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = decoding.decode(model, tok, mel, opts, xa=xa, **kw)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

    out = {}
    for label, cross, kw in modes:
        with environ(WCA_CROSS_ATTN=cross):
            decode(kw)  # captures the mode's graphs
            decode_graph.reset_record()
            graphed, g_s = decode(kw)
            record = decode_graph.replay_record()
            plain, e_s = decode(kw, eager)
            for i, (a, b) in enumerate(zip(graphed, plain)):
                same = (a.tokens == b.tokens and a.n_steps == b.n_steps
                        and a.avg_logprob == b.avg_logprob
                        and a.no_speech_prob == b.no_speech_prob
                        and (a.min_margin == b.min_margin
                             or (math.isnan(a.min_margin)
                                 and math.isnan(b.min_margin))))
                check(same, f"[graph] {label} row {i}: the graphed decode "
                      f"differs from the eager loop: {a} != {b}")
            g_busy, e_busy = {}, {}
            with profiling.busy_window(g_busy):
                decode(kw)
            with profiling.busy_window(e_busy):
                decode(kw, eager)
            # the last graph captured or replayed: this mode's first decode
            entry = next(reversed(decode_graph._GRAPHS[model].values()))
            nbytes, floor_ms = step_floor(model, entry.cross_kv,
                                          entry.state.cache)
            step_ms = graph_step_ms(entry)
        n_steps = graphed[0].n_steps
        out[label] = dict(graphed_s=g_s, eager_s=e_s, step_ms=step_ms,
                          floor_ms=floor_ms, busy_graphed=g_busy["share"],
                          busy_eager=e_busy["share"], record=record)
        log(f"[graph] {label} on {card}: graphed == eager loop, bit for bit, "
            f"over {BATCH} rows ({n_steps} positions, {record['replays']} "
            f"replays of {decode_graph.CHUNK_STEPS} steps); decode "
            f"{g_s * 1e3:.1f} ms graphed, {e_s * 1e3:.1f} ms eager "
            f"({e_s / g_s:.2f}x); device busy {g_busy['share']:.4f} of "
            f"{g_busy['window_s'] * 1e3:.1f} ms graphed, "
            f"{e_busy['share']:.4f} of {e_busy['window_s'] * 1e3:.1f} ms "
            f"eager (traced; {g_busy['records']} and {e_busy['records']} "
            f"device records); one step {step_ms:.4f} ms (CUDA events over "
            f"10 replays) against its byte floor {floor_ms:.4f} ms "
            f"({nbytes / 1e6:.1f} MB; {step_ms / floor_ms:.1f}x)")
    return out


def depth_phase(model, tok, dataset, card: str) -> None:
    """``run_dataset`` of the default pipeline at ``pipeline_depth`` 1 and 2
    (graphs captured by the earlier phases): the same words and boundaries
    in the same order; utts/s and the device-busy share of each run, from a
    trace of the whole run (a second run, untraced, gives the utts/s)."""
    import numpy as np
    import torch

    from whisper_char_alignment_tpu_torch.config import AlignConfig
    from whisper_char_alignment_tpu_torch.models import decoding
    from whisper_char_alignment_tpu_torch.runner import AlignmentPipeline
    from whisper_char_alignment_tpu_torch.utils import profiling

    runs = {}
    for depth in (1, 2, 2, 1):
        cfg = AlignConfig.recommended(model="medium", batch_size=BATCH,
                                      use_gt_transcript=True,
                                      pipeline_depth=depth)
        pipe = AlignmentPipeline(model, tok, cfg, compute_dtype=model.dtype)
        pipe.options = decoding.DecodingOptions(language="en",
                                                sample_len=DECODE_LEN)
        busy = {}
        torch.cuda.synchronize()
        if depth in runs:  # the second run of a depth is traced
            with profiling.busy_window(busy):
                results = list(pipe.run_dataset(dataset, progress=False))
            runs[depth]["busy"] = busy
            continue
        t0 = time.perf_counter()
        results = list(pipe.run_dataset(dataset, progress=False))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[depth] = dict(results=results, wall=wall,
                           stages={k: round(v, 4) for k, v in
                                   pipe.stage_seconds.items()})
    one, two = runs[1]["results"], runs[2]["results"]
    check([r.fid for r in one] == [r.fid for r in two], "[depth] order")
    for a, b in zip(one, two):
        check(a.words == b.words and np.array_equal(a.start_times,
                                                    b.start_times)
              and np.array_equal(a.end_times, b.end_times),
              f"[depth] {a.fid}: depths 1 and 2 differ")
    for depth in (1, 2):
        r = runs[depth]
        log(f"[depth {depth}] run_dataset on {card}: {len(dataset)} "
            f"utterances in {r['wall']:.3f} s -> "
            f"{len(dataset) / r['wall']:.3f} utts/s; device busy "
            f"{r['busy']['share']:.4f} of {r['busy']['window_s']:.3f} s "
            f"(traced run); stage device seconds {json.dumps(r['stages'])}")
    log(f"[depth] depths 1 and 2 give the same words and boundaries of all "
        f"{len(one)} utterances in the same order")


@contextlib.contextmanager
def loop_runs(runs: list, eager: bool = False):
    """Keep the raw outputs of every beam, sampling and speculative loop run
    while the block runs, each run through the graph runner or, with
    ``eager``, the eager loop (``decoding.run_eager``, the graph's plain
    version)."""
    from whisper_char_alignment_tpu_torch.models import decode_graph, decoding

    inner = decoding.run_eager if eager else decode_graph.replay

    def run(*args, **kwargs):
        out = inner(*args, **kwargs)
        runs.append(out)
        return out

    with patched(decoding, runner_for=lambda dev: run):
        yield


def same_bits(a, b) -> bool:
    import torch

    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def bits_equal(a, b) -> bool:
    """Two tensors equal bit for bit (signed zeros and NaNs too)."""
    import torch

    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(ints[a.element_size()]),
        b.contiguous().view(ints[b.element_size()])))


def same_results(got, want) -> bool:
    """Two decodes' results equal in every field the loop gives, bit for
    bit (NaN equal to NaN)."""
    import math

    def key(r):
        return (r.tokens, r.n_steps, r.avg_logprob, r.language,
                "nan" if math.isnan(r.no_speech_prob) else r.no_speech_prob)

    return [key(r) for r in got] == [key(r) for r in want]


def graph_step_ms(entry, reps: int = 10) -> float:
    """One step of a captured chunk by CUDA events over ``reps`` replays
    after one untimed replay (steps past the loop's end run every kernel,
    their writes gated)."""
    import torch

    from whisper_char_alignment_tpu_torch.models import decode_graph

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    entry.graph.replay()
    start.record()
    for _ in range(reps):
        entry.graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * decode_graph.CHUNK_STEPS)


def graph_entry(model, kind: str):
    """The graph of loop ``kind`` ("greedy", "beam", ...) used last."""
    from whisper_char_alignment_tpu_torch.models import decode_graph

    return next(e for k, e in reversed(decode_graph._GRAPHS[model].items())
                if k[0] == kind)


def modes_phase(model, tok, dataset, card: str) -> dict:
    """The decoding modes at Whisper-medium width on one batch of 8
    encoder states, each through its captured CUDA graph and through its
    eager loop on the card (``decoding.run_eager``, the plain version), the
    raw loop outputs bit-equal: beam 5 with patience None and 2.0, length
    penalty None and 0.6, with and without timestamps; sampling at
    temperatures 0.7 and 1.0 with best_of 5 through one graph (the same
    generator seed on both sides, so the same noise); a prompt plus a
    prefix with ``language=None`` and per-row prompts through the greedy
    and the beam graph, the detected codes equal to an eager
    ``detect_language`` on the same encoder states. Logs each decode's time
    graphed and eager, one beam and one sampling step against its byte
    floor (CUDA events over replays of the captured chunk) and the
    device-busy share of a traced beam decode. Returns the numbers."""
    import torch

    from whisper_char_alignment_tpu_torch.config import AlignConfig
    from whisper_char_alignment_tpu_torch.models import decode_graph, decoding
    from whisper_char_alignment_tpu_torch.runner import AlignmentPipeline
    from whisper_char_alignment_tpu_torch.scripts.profile_decode_step import \
        step_floor
    from whisper_char_alignment_tpu_torch.utils import profiling

    cfg = AlignConfig.recommended(model="medium", batch_size=BATCH,
                                  use_gt_transcript=True)
    pipe = AlignmentPipeline(model, tok, cfg, compute_dtype=model.dtype)
    _, mel, xa = pipe.transcribe_batch([dataset[i] for i in range(BATCH)])

    def timed(opts, eager=False, greedy=False):
        runs = []
        with contextlib.ExitStack() as stack:
            if greedy and eager:
                stack.enter_context(patched(
                    decoding, _loop_for=lambda dev: decoding._decode_loop))
            if not greedy:
                stack.enter_context(loop_runs(runs, eager))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = decoding.decode(model, tok, mel, opts, xa=xa)
            torch.cuda.synchronize()
        return res, runs, time.perf_counter() - t0

    def hold(label, opts, greedy=False):
        """The decode graphed (its graph captured by an untimed first
        decode) and eager; returns (results, graphed s, eager s, graphs
        captured)."""
        before = decode_graph.replay_record()
        decoding.decode(model, tok, mel, opts, xa=xa)
        captured = (decode_graph.replay_record()["captures"]
                    - before["captures"])
        before = decode_graph.replay_record()
        graphed, g_runs, g_s = timed(opts, greedy=greedy)
        after = decode_graph.replay_record()
        record = {k: after[k] - before[k] for k in after}
        eager, e_runs, e_s = timed(opts, eager=True, greedy=greedy)
        check(record["captures"] == 0 and record["replays"] > 0,
              f"[modes] {label}: no replay of a captured graph {record}")
        check(same_results(graphed, eager)
              and all(same_bits(a, b) for a, b in zip(g_runs, e_runs)),
              f"[modes] {label}: the graphed decode differs from the eager "
              f"loop")
        log(f"[modes] {label} on {card}: graphed == eager loop, bit for bit"
            f"{' (raw loop outputs too)' if g_runs else ''}, over {BATCH} "
            f"audios ({graphed[0].n_steps} positions, {record['replays']} "
            f"replays of {decode_graph.CHUNK_STEPS} steps); decode "
            f"{g_s * 1e3:.1f} ms graphed, {e_s * 1e3:.1f} ms eager "
            f"({e_s / g_s:.2f}x); result lengths "
            f"{[len(r.tokens) for r in graphed]}")
        return graphed, g_s, e_s, captured

    out = {}
    beams = ((None, None, False), (2.0, None, False), (None, 0.6, True),
             (2.0, 0.6, True))
    for patience, alpha, no_ts in beams:
        label = (f"beam 5, patience {patience}, length penalty {alpha}, "
                 f"{'without' if no_ts else 'with'} timestamps")
        opts = decoding.DecodingOptions(
            language="en", sample_len=DECODE_LEN, beam_size=5,
            patience=patience, length_penalty=alpha, without_timestamps=no_ts)
        _, g_s, e_s, _ = hold(label, opts)
        if patience or alpha or no_ts:
            continue
        out.update(beam_graphed_s=g_s, beam_eager_s=e_s)
        entry = graph_entry(model, "beam")
        nbytes, floor_ms = step_floor(model, entry.cross_kv,
                                      entry.state.cache)
        step_ms = graph_step_ms(entry)
        busy = {}
        with profiling.busy_window(busy):
            decoding.decode(model, tok, mel, opts, xa=xa)
        out.update(beam_step_ms=step_ms, beam_floor_ms=floor_ms,
                   beam_busy=busy["share"])
        log(f"[modes] beam 5 on {card}: one step {step_ms:.4f} ms (CUDA "
            f"events over 10 replays) against its byte floor {floor_ms:.4f} "
            f"ms ({nbytes / 1e6:.1f} MB: decoder weights, the cross K/V "
            f"repeated per beam, the cache; {step_ms / floor_ms:.2f}x); a "
            f"traced beam decode busy {busy['share']:.4f} of "
            f"{busy['window_s'] * 1e3:.1f} ms ({busy['records']} device "
            f"records)")

    captures = []
    for temperature in (0.7, 1.0):
        _, g_s, e_s, captured = hold(
            f"sampling at {temperature}, best_of 5",
            decoding.DecodingOptions(language="en", sample_len=DECODE_LEN,
                                     temperature=temperature, best_of=5))
        captures.append(captured)
        out[f"sample_{temperature}_graphed_s"] = g_s
        out[f"sample_{temperature}_eager_s"] = e_s
    check(captures == [1, 0], f"[modes] sampling graphs captured per "
          f"temperature: {captures}, not one for both")
    entry = graph_entry(model, "sample")
    nbytes, floor_ms = step_floor(model, entry.cross_kv, entry.state.cache)
    step_ms = graph_step_ms(entry)
    out.update(sample_step_ms=step_ms, sample_floor_ms=floor_ms)
    log(f"[modes] sampling on {card}: temperatures 0.7 and 1.0 replayed one "
        f"captured graph; one step {step_ms:.4f} ms against its byte floor "
        f"{floor_ms:.4f} ms ({nbytes / 1e6:.1f} MB; "
        f"{step_ms / floor_ms:.2f}x)")

    codes = [c for c, _ in decoding.detect_language(model, tok, xa=xa)]
    rows = [[300 + 7 * i + j for j in range(5)] for i in range(mel.shape[0])]
    for label, kw, greedy in (
            ("greedy, language=None, prompt + prefix",
             dict(language=None, prompt="the quick fox", prefix="and"), True),
            ("greedy, per-row prompts", dict(language="en", prompt=rows),
             True),
            ("beam 5, language=None, prompt + prefix",
             dict(language=None, prompt="the quick fox", prefix="and",
                  beam_size=5), False),
            ("beam 5, per-row prompts",
             dict(language="en", prompt=rows, beam_size=5), False)):
        res = hold(label, decoding.DecodingOptions(
            sample_len=DECODE_LEN, **kw), greedy=greedy)[0]
        if kw["language"] is None:
            check([r.language for r in res] == codes,
                  f"[modes] {label}: languages {[r.language for r in res]} "
                  f"!= an eager detect's {codes}")
    log(f"[modes] language=None decoded each row in the language an eager "
        f"detect_language on the same encoder states gives: {codes}")
    return out


def speculative_phase(model, tok, dataset, card: str) -> dict:
    """``decode_speculative`` at Whisper-medium width on one utterance,
    drafted by a ``MODEL_DIMS["tiny"]`` model (random weights from
    ``torch.Generator`` seed 1), ``draft_k`` 4: the graphed rounds
    bit-equal to the eager rounds on the card, and the result equal to the
    graphed greedy decode of the same target, bit for bit (tokens, text,
    avg_logprob, no-speech probability), in bf16 and in float32: the
    window's rows are computed as a step's (``dec_attn``,
    ``rows_linear``). Logs ``n_rounds`` / ``n_steps`` and one round's
    device time beside one greedy B=1 step's (CUDA events over replays of
    each captured chunk)."""
    import torch

    from whisper_char_alignment_tpu_torch.config import MODEL_DIMS, AlignConfig
    from whisper_char_alignment_tpu_torch.models import decoding
    from whisper_char_alignment_tpu_torch.models import whisper as wm
    from whisper_char_alignment_tpu_torch.runner import AlignmentPipeline

    cfg = AlignConfig.recommended(model="medium", batch_size=BATCH,
                                  use_gt_transcript=True)
    pipe = AlignmentPipeline(model, tok, cfg, compute_dtype=model.dtype)
    mel = pipe.transcribe_batch([dataset[0]])[1][0]
    gen = torch.Generator(device=model.device).manual_seed(1)
    draft = wm.init_params(wm.Whisper(MODEL_DIMS["tiny"], device=model.device,
                                      dtype=model.dtype), gen)
    opts = decoding.DecodingOptions(language="en", sample_len=DECODE_LEN)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        target = wm.cast_params(model, dtype)
        small = wm.cast_params(draft, dtype)
        greedy = decoding.decode(target, tok, mel, opts)
        runs, eager_runs = [], []
        with loop_runs(runs):
            spec, info = decoding.decode_speculative(
                target, small, tok, mel, opts, draft_k=4, return_info=True)
        with loop_runs(eager_runs, eager=True):
            plain, plain_info = decoding.decode_speculative(
                target, small, tok, mel, opts, draft_k=4, return_info=True)
        check(info == plain_info and same_results([spec], [plain])
              and same_bits(runs[0], eager_runs[0]),
              f"[speculative {name}] the graphed rounds differ from the "
              f"eager rounds")
        fields = ("tokens", "text", "language", "avg_logprob",
                  "no_speech_prob")
        differ = [f for f in fields
                  if getattr(spec, f) != getattr(greedy, f)]
        check(not differ, f"[speculative {name}] differs from the greedy "
              f"decode in {differ}: {spec} against {greedy}")
        round_ms = graph_step_ms(graph_entry(target, "speculative"))
        step_ms = graph_step_ms(graph_entry(target, "greedy"))
        out[name] = dict(info=info, round_ms=round_ms, greedy_step_ms=step_ms)
        log(f"[speculative {name}] on {card}: graphed rounds == eager rounds,"
            f" bit for bit; {info['n_rounds']} rounds for {info['n_steps']} "
            f"positions ({len(spec.tokens)} tokens, "
            f"{len(spec.tokens) / max(info['n_rounds'], 1):.2f} a round); "
            f"equal to the greedy decode bit for bit ({', '.join(fields)}); "
            f"one round {round_ms:.4f} ms (4 tiny draft steps + a 5-row "
            f"medium window) against one greedy B=1 step {step_ms:.4f} ms "
            f"(CUDA events over 10 replays)")
        del target, small
    return out


def rows_phase(model, tok, card: str) -> dict:
    """Every row of the decoder and the audio side computed in bits that
    do not depend on what shares its call (the JAX package's bit-identity
    promises), at Whisper-medium width in bf16:

    1. ``scripts/diagnose_rows`` on the main path's model: every op of
       every case bit-equal (``decode_step`` alone and in batches of 4, 8
       and 16; a 5-token window against 5 steps; a 4-token prompt against
       4 steps; the encoder and the cross K/V of one utterance alone and
       among 4, 8 and 16; the capture of a transcript padded by a token
       bucket), and each suspect op on its own; the table is logged.
    2. ``align_batch`` of one utterance alone (padded to the batch) against
       the same utterance last in a batch of 8 and in a batch of 16 that
       hold a longer transcript, so the capture's token bucket differs: the
       decode's tokens, text, logprob and no-speech probability, the words,
       transcription and boundaries equal, and the capture's attention rows
       of its tokens bit-equal. Returns the diagnosis summary."""
    import numpy as np
    import torch

    from whisper_char_alignment_tpu_torch.config import AlignConfig
    from whisper_char_alignment_tpu_torch.data.dataset import TIMIT
    from whisper_char_alignment_tpu_torch.data.synthetic import \
        make_timit_corpus
    from whisper_char_alignment_tpu_torch.models import decoding
    from whisper_char_alignment_tpu_torch.models import whisper as wm
    from whisper_char_alignment_tpu_torch.runner import AlignmentPipeline
    from whisper_char_alignment_tpu_torch.scripts import diagnose_rows
    from whisper_char_alignment_tpu_torch.text import retokenize

    t0 = time.perf_counter()
    result = diagnose_rows.diagnose(model)
    diagnose_rows.log_tables(result, card)
    summary = diagnose_rows.summary(result)
    for name, table in result["cases"].items():
        first = diagnose_rows.first_difference(table)
        check(first is None, f"[rows] {name}: {first}")
    for row in result["suspects"]:
        check(row["bit_equal"], f"[rows] suspect {row}")
    log(f"[rows] diagnosis on {card}: {len(result['cases'])} cases, "
        f"{sum(len(t) for t in result['cases'].values())} ops, every op "
        f"bit-equal; {len(result['suspects'])} suspects bit-equal "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    texts, decodes = [], []
    text_fn, decode_fn = wm.decode_text, decoding.decode

    def kept_text(*a, **kw):
        out = text_fn(*a, **kw)
        texts.append((out[1], kw["token_len"].clone()))
        return out

    def kept_decode(*a, **kw):
        out = decode_fn(*a, **kw)
        decodes.append(out)
        return out

    def run(pipe, utts):
        """(u's alignment, its decode result, its capture rows)."""
        texts.clear()
        decodes.clear()
        results = pipe.align_batch(utts)
        (stack, token_len), = texts
        (dec,) = decodes
        dec = results_of(dec[0] if isinstance(dec, tuple) else dec)
        i = len(utts) - 1
        n = int(token_len[i])
        return results[i], dec[i], stack[:, i, :, :n].clone(), n

    with tempfile.TemporaryDirectory(prefix="smoke_rows_",
                                     dir=os.path.join(HERE, "build")) as d:
        dataset = TIMIT(make_timit_corpus(d, n_utts=16, seconds=(2.0, 7.0),
                                          words_per_utt=(3, 30), seed=3))
        utts = [dataset[i] for i in range(len(dataset))]
        n_tok = [len(retokenize.encode(retokenize.remove_punctuation(u.text),
                                       tok, "char")) for u in utts]
        k = int(np.argmin(n_tok))
        u = utts[k]
        others = sorted((x for j, x in enumerate(utts) if j != k),
                        key=lambda x: -len(x.text))
        with patched(wm, decode_text=kept_text), \
                patched(decoding, decode=kept_decode):
            for b in (BATCH, 2 * BATCH):
                cfg = AlignConfig.recommended(model="medium", batch_size=b,
                                              use_gt_transcript=True)
                pipe = AlignmentPipeline(model, tok, cfg,
                                         compute_dtype=torch.bfloat16)
                pipe.options = decoding.DecodingOptions(
                    language="en", sample_len=DECODE_LEN)
                pipe.capture_shapes.clear()
                solo = run(pipe, [u])
                among = run(pipe, others[:b - 1] + [u])
                buckets = [c[0] for c in pipe.capture_shapes]
                check(buckets[0] < buckets[1], f"[rows] batch {b}: token "
                      f"buckets {buckets} (alone, among): the batch does not "
                      f"pad the capture further")
                ra, rb = solo[0], among[0]
                check(ra.words == rb.words
                      and ra.transcription == rb.transcription
                      and np.array_equal(ra.start_times, rb.start_times)
                      and np.array_equal(ra.end_times, rb.end_times),
                      f"[rows] batch {b}: the alignment differs alone and "
                      f"among others: {ra} against {rb}")
                da, db = solo[1], among[1]
                check((da.tokens, da.text, da.avg_logprob, da.no_speech_prob)
                      == (db.tokens, db.text, db.avg_logprob,
                          db.no_speech_prob),
                      f"[rows] batch {b}: the decode differs: {da} against "
                      f"{db}")
                check(solo[3] == among[3] and bits_equal(solo[2], among[2]),
                      f"[rows] batch {b}: the capture's attention rows "
                      f"differ")
                log(f"[rows] align_batch at batch {b} on {card}: one "
                    f"utterance ({n_tok[k]} characters) alone and last among "
                    f"{b - 1} others (up to {max(n_tok)} characters): token "
                    f"buckets {buckets}; decode, words, boundaries equal and "
                    f"the capture's {solo[3]} attention rows bit-equal")
    log(f"[rows] align_batch phase in {time.perf_counter() - t0:.1f} s")
    return summary


@contextlib.contextmanager
def patched(obj, **attrs):
    """Set attributes of ``obj`` while the block runs; restore them after."""
    saved = {k: getattr(obj, k) for k in attrs}
    for k, v in attrs.items():
        setattr(obj, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(obj, k, v)


@contextlib.contextmanager
def dtw_calls(calls: list):
    """Keep, while the block runs, a copy of each call of the DTW kernels'
    entry (``timing.dtw_jump_frames``): its costs, lengths and jump
    frames."""
    from whisper_char_alignment_tpu_torch.align import timing

    jump = timing.dtw_jump_frames

    def kept(x, n, m):
        out = jump(x, n, m)
        calls.append((x.clone(), n.clone(), m.clone(), out.clone()))
        return out

    with patched(timing, dtw_jump_frames=kept):
        yield


def hold_jump_frames(call, rows, label: str) -> int:
    """The jump frames of ``rows`` of one DTW call against the NumPy DTW
    oracle on each row's own costs (rows of a pad item, n < 1, are
    skipped); returns the rows held."""
    import numpy as np

    from whisper_char_alignment_tpu_torch.ops.dtw import dtw_np

    x, n, m, jump = call
    held = 0
    for r in rows:
        nr, mr = int(n[r]), int(m[r])
        if nr < 1:
            continue
        ti, tj = dtw_np(x[r, :nr, :mr].cpu().numpy())
        first = np.pad(np.diff(ti), (1, 0), constant_values=1).astype(bool)
        got = jump[r].cpu().numpy()
        check(np.array_equal(got[:nr], tj[first])
              and bool((got[nr:] == -1).all()),
              f"{label} row {r}: jump frames differ from the NumPy DTW "
              f"oracle")
        held += 1
    return held


def cli_base_args(scp: str) -> list:
    """The CLIs' flags for the smoke's medium runs: the README recipe's
    units and scoring, bf16, batch 8, the ground-truth transcript and 32
    decode steps."""
    return ["--dataset", "TIMIT", "--scp", scp, "--model", "medium",
            "--batch_size", str(BATCH), "--compute_dtype", "bfloat16",
            "--use_gt_transcript", "--decode_sample_len", str(DECODE_LEN),
            "--aligned_unit_type", "char", "--strict", "--tolerance", "0.05",
            "--profile"]


# the CLI's README recipe at median width 17
RECIPE_W17 = ["--medfilt_width", "17", "--aggr", "topk", "--topk", "10",
              "--save_prediction"]


def cli_phase(model, tok, scp: str, n_utts: int, card: str):
    """``infer_ali`` at Whisper-medium width through ``cli.infer_ali.main``,
    with the model loader replaced by the smoke's medium model, twice: the
    README recipe at median width 17 (a register window) with
    ``--save_prediction``, then ``--default_whisper_timing`` at width 33
    (a padded window). Each run's launch counts are set to 0 just before it
    and must be exact after it; every batch's jump frames equal the NumPy
    DTW oracle; ``eval_ali`` on the written pkl gives the CLI's own
    precision, recall and F1. Returns each run's counts, and the width-17
    run's metrics and pkl records."""
    import numpy as np
    import torch

    from whisper_char_alignment_tpu_torch.cli import (common, eval_ali,
                                                      infer_ali)
    from whisper_char_alignment_tpu_torch.ops import _lib

    n_batches = -(-n_utts // BATCH)
    runs = (("recipe w=17", "qkpost", RECIPE_W17),
            ("default timing w=33", "qkpost_rank",
             ["--default_whisper_timing", "--medfilt_width", "33"]))
    made, pipeline = [], infer_ali.AlignmentPipeline

    def keep_pipeline(*args, **kwargs):
        made.append(pipeline(*args, **kwargs))
        return made[-1]

    out = {}
    with patched(common, load_model_and_tokenizer=lambda args, device=None:
                 (model, tok)), \
            patched(infer_ali, AlignmentPipeline=keep_pipeline):
        for label, qk_counter, extra in runs:
            out_dir = tempfile.mkdtemp(prefix="cli_", dir=os.path.dirname(scp))
            calls = []
            _lib.reset_launches()
            torch.cuda.synchronize()
            with dtw_calls(calls):
                t0 = time.perf_counter()
                metrics = infer_ali.main(cli_base_args(scp) + extra
                                         + ["--output_dir", out_dir])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            counts = _lib.launch_counts()
            expect = expect_base()
            expect.update(encoder_attn=model.dims.n_audio_layer * n_batches,
                          dtw_trace=n_batches, dtw_backtrace=n_batches)
            expect[qk_counter] = model.dims.n_text_layer * n_batches
            log(f"[cli {label}] launch counts: {counts} (expected {expect})")
            check(launches_match(counts, expect),
                  f"[cli {label}] launch counts differ from the path's")
            check(len(calls) == n_batches, f"[cli {label}] {len(calls)} DTWs")
            held = sum(hold_jump_frames(c, range(c[0].shape[0]),
                                        f"[cli {label}] batch {i}")
                       for i, c in enumerate(calls))
            check(held == n_utts, f"[cli {label}] {held} rows held")
            stages = {k: round(v, 4)
                      for k, v in made[-1].stage_seconds.items()}
            log(f"[cli {label}] on {card}: {n_utts} utterances in {wall:.3f} s"
                f" ({n_utts / wall:.3f} utts/s, model load excluded); "
                f"metrics {metrics}; stage seconds {json.dumps(stages)}; "
                f"jump frames of all {held} utterances equal the NumPy DTW "
                f"oracle")
            if "--save_prediction" in extra:
                (pkl,) = glob.glob(os.path.join(out_dir, "*-predictions.pkl"))
                with open(pkl, "rb") as f:
                    records = pickle.load(f)
                check(len(records) == n_utts
                      and all(np.isfinite(r["ends_hat"]).all()
                              and len(r["predwords"]) >= 2
                              for r in records.values()),
                      f"[cli {label}] predictions pkl: {len(records)} records")
                rescored = eval_ali.main(["--pred", pkl, "--tolerance", "0.05"])
                check(all(rescored[k] == metrics[k]
                          for k in ("precision", "recall", "f1")),
                      f"[cli {label}] eval_ali {rescored} != the CLI's "
                      f"{metrics}")
                log(f"[cli {label}] eval_ali on the pkl: {rescored}, the "
                    f"CLI's own precision, recall and F1")
                recipe = dict(metrics=metrics, records=records)
            out[qk_counter] = counts
    return out, recipe


def checkpoint_phase(model, tok, dataset, scp: str, recipe: dict,
                     default_seen: dict, card: str) -> None:
    """The rest of the JAX package's surface on the card, at Whisper-medium
    width:

    (a) the smoke's bf16 model written by ``convert.save_openai_pt`` and the
    smoke tokenizer's ranks as a ``multilingual.tiktoken`` file, then
    ``infer_ali --checkpoint --tokenizer_dir`` on them with
    :data:`RECIPE_W17`, the real loader unpatched (a pass-through times
    it): the tokenizer it built gives the smoke's ids, the launch counts are
    exact, the jump frames equal the NumPy DTW oracle, and words,
    boundaries and P/R/F1 equal the in-memory run of :func:`cli_phase`
    (bf16 read into float32 and cast back to bf16 is exact);
    (b) ``whisper.forward`` on one batch of 8: 24 launches of the encoder
    kernel and none of the QK post-process; ``qk_to_attention`` over its 24
    layers: 24 of the post-process, equal bit for bit to ``decode_text``'s
    in-layer post-process at width 3 on the same tokens and states;
    (c) both native host libraries built by g++ and loaded; the corpus's
    WAVs decode natively equal to the NumPy parser and its transcripts BPE
    natively equal to the pure-Python merge;
    (d) the default main-path run's ``mfu_summary`` (``utils/flops``),
    logged only."""
    import base64

    import numpy as np
    import torch

    from whisper_char_alignment_tpu_torch.audio import _wavio_native, wav
    from whisper_char_alignment_tpu_torch.audio.mel import (
        log_mel_spectrogram, pad_or_trim)
    from whisper_char_alignment_tpu_torch.cli import common, infer_ali
    from whisper_char_alignment_tpu_torch.models import convert
    from whisper_char_alignment_tpu_torch.models import whisper as wm
    from whisper_char_alignment_tpu_torch.ops import _lib
    from whisper_char_alignment_tpu_torch.text import bpe, retokenize
    from whisper_char_alignment_tpu_torch.utils import flops, native

    t_phase = time.perf_counter()
    dims = model.dims
    n_utts = len(dataset)
    n_batches = -(-n_utts // BATCH)
    # (a) the --checkpoint path
    loads, made = [], []
    real_load, pipeline = (common.load_model_and_tokenizer,
                           infer_ali.AlignmentPipeline)

    def timed_load(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_load(*args, **kwargs)
        torch.cuda.synchronize()
        loads.append((time.perf_counter() - t0, out))
        return out

    def keep_pipeline(*args, **kwargs):
        made.append(pipeline(*args, **kwargs))
        return made[-1]

    with tempfile.TemporaryDirectory(prefix="smoke_ckpt_",
                                     dir=os.path.join(HERE, "build")) as d:
        path = os.path.join(d, "medium.pt")
        t0 = time.perf_counter()
        convert.save_openai_pt(path, model)
        write_s = time.perf_counter() - t0
        with open(os.path.join(d, "multilingual.tiktoken"), "wb") as f:
            for k, v in tok.bpe.ranks.items():
                f.write(base64.b64encode(k) + b" " + str(v).encode() + b"\n")
        calls = []
        _lib.reset_launches()
        torch.cuda.synchronize()
        with patched(common, load_model_and_tokenizer=timed_load), \
                patched(infer_ali, AlignmentPipeline=keep_pipeline), \
                dtw_calls(calls):
            t0 = time.perf_counter()
            metrics = infer_ali.main(
                cli_base_args(scp) + RECIPE_W17
                + ["--checkpoint", path, "--tokenizer_dir", d,
                   "--output_dir", os.path.join(d, "out")])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = _lib.launch_counts()
        size = os.path.getsize(path)
        (pkl,) = glob.glob(os.path.join(d, "out", "*-predictions.pkl"))
        with open(pkl, "rb") as f:
            records = pickle.load(f)
    (load_s, (loaded_model, cli_tok)), = loads
    check(made[-1].tokenizer is cli_tok, "[checkpoint] the CLI's tokenizer")
    check(loaded_model.dtype == torch.float32
          and made[-1].model.dtype == torch.bfloat16,
          f"[checkpoint] loaded {loaded_model.dtype}, ran "
          f"{made[-1].model.dtype}")
    specials = ("eot", "sot", "translate", "transcribe", "sot_lm",
                "sot_prev", "no_speech", "no_timestamps", "timestamp_begin",
                "n_vocab", "sot_sequence", "all_language_tokens",
                "non_speech_tokens")
    texts = [dataset[i].text for i in range(n_utts)]
    check(all(getattr(cli_tok, a) == getattr(tok, a) for a in specials)
          and cli_tok.bpe.ranks == tok.bpe.ranks
          and all(cli_tok.encode(" " + t) == tok.encode(" " + t)
                  and retokenize.encode(t, cli_tok, "char")
                  == retokenize.encode(t, tok, "char") for t in texts),
          "[checkpoint] the CLI's tokenizer gives other ids than the "
          "smoke's")
    expect = expect_base()
    expect.update(encoder_attn=dims.n_audio_layer * n_batches,
                  qkpost=dims.n_text_layer * n_batches,
                  dtw_trace=n_batches, dtw_backtrace=n_batches)
    log(f"[checkpoint] launch counts: {counts} (expected {expect})")
    check(launches_match(counts, expect), "[checkpoint] launch counts differ "
          "from the path's")
    held = sum(hold_jump_frames(c, range(c[0].shape[0]),
                                f"[checkpoint] batch {i}")
               for i, c in enumerate(calls))
    check(len(calls) == n_batches and held == n_utts,
          f"[checkpoint] {len(calls)} DTWs, {held} rows held")
    check(metrics == recipe["metrics"],
          f"[checkpoint] metrics {metrics} != the in-memory run's "
          f"{recipe['metrics']}")
    want = recipe["records"]
    check(sorted(records) == sorted(want) and all(
        records[i]["predwords"] == want[i]["predwords"]
        and np.array_equal(records[i]["starts_hat"], want[i]["starts_hat"])
        and np.array_equal(records[i]["ends_hat"], want[i]["ends_hat"])
        for i in want), "[checkpoint] words or boundaries differ from the "
          "in-memory run's")
    log(f"[checkpoint] on {card}: medium bf16 .pt of {size / 1e9:.3f} GB "
        f"written in {write_s:.2f} s, read onto the card (float32) in "
        f"{load_s:.2f} s by the CLI's loader; infer_ali --checkpoint "
        f"{wall:.2f} s, model load included; the tokenizer from "
        f"--tokenizer_dir gives the smoke's ids; metrics {metrics} and the "
        f"words and boundaries of all {n_utts} utterances equal the "
        f"in-memory run's; jump frames equal the NumPy DTW oracle")
    del loads, made, loaded_model

    # (b) forward and qk_to_attention
    dev = model.device
    batch = [dataset[i] for i in range(BATCH)]
    audio = np.stack([pad_or_trim(u.audio) for u in batch])
    mel = log_mel_spectrogram(torch.from_numpy(audio).to(dev))
    rows = [[*tok.sot_sequence, tok.no_timestamps,
             *retokenize.encode(retokenize.remove_punctuation(u.text), tok,
                                "char"), tok.eot] for u in batch]
    t_max = max(len(r) for r in rows)
    tokens = torch.tensor([r + [tok.eot] * (t_max - len(r)) for r in rows],
                          device=dev)
    token_len = torch.tensor([len(r) for r in rows], dtype=torch.int32,
                             device=dev)
    frame_len = torch.tensor([u.duration // 320 for u in batch],
                             dtype=torch.int32, device=dev)
    _lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, qk = wm.forward(model, mel, tokens, device=dev.type)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    fwd_counts = _lib.launch_counts()
    # decode_text projects the encoder states itself (10 linears a layer)
    # and returns logits
    check(fwd_counts == dict(dict.fromkeys(fwd_counts, 0),
                             encoder_attn=dims.n_audio_layer,
                             rows_linear=10 * dims.n_text_layer + 1,
                             dec_attn=2 * dims.n_text_layer),
          f"[forward] launch counts {fwd_counts}")
    check(tuple(logits.shape) == (BATCH, t_max, dims.n_vocab)
          and tuple(qk.shape) == (dims.n_text_layer, BATCH, dims.n_text_head,
                                  t_max, dims.n_audio_ctx)
          and logits.dtype == qk.dtype == torch.float32
          and bool(torch.isfinite(logits).all() and torch.isfinite(qk).all()),
          "[forward] logits or QK of the wrong shape, type or not finite")
    _lib.reset_launches()
    attn = torch.stack([wm.qk_to_attention(qk[i], frame_len, token_len, 3,
                                           1.0)
                        for i in range(dims.n_text_layer)])
    qk_counts = _lib.launch_counts()
    check(qk_counts == dict(dict.fromkeys(qk_counts, 0),
                            qkpost=dims.n_text_layer),
          f"[forward] qk_to_attention launch counts {qk_counts}")
    xa = wm.encode_audio(model, mel, device=dev.type)
    _, capture = wm.decode_text(model, tokens, xa, medfilt_width=3,
                                frame_len=frame_len, token_len=token_len,
                                return_logits=False, device=dev.type)
    check(torch.equal(attn, capture), "[forward] qk_to_attention of forward's"
          " QK differs from decode_text's in-layer post-process")
    log(f"[forward] on {card}: forward of {BATCH} x {t_max} tokens in "
        f"{fwd_s:.3f} s with {fwd_counts['encoder_attn']} encoder kernel "
        f"launches and no QK post-process; qk_to_attention over its "
        f"{dims.n_text_layer} layers ({qk_counts['qkpost']} launches) equals "
        f"decode_text's in-layer post-process bit for bit")
    del logits, qk, attn, capture, xa

    # (c) the native host hooks
    built = native.loaded()
    check(set(built) >= {"wavio.cc", "bpe.cc"},
          f"[native] loaded {sorted(built)}: a library did not build")
    decoder = _wavio_native.get()
    check(decoder is not None and tok.bpe._get_native() is not None,
          "[native] a native path is off")
    for _, wav_path in dataset.entries:
        got, rate = decoder.load(wav_path)
        with open(wav_path, "rb") as f:
            want_audio, want_rate = wav._parse_wav(f.read())
        check(rate == want_rate and np.array_equal(got, want_audio),
              f"[native] {wav_path} decodes otherwise than the NumPy parser")
    slow = bpe.ByteBPE(tok.bpe.ranks)
    slow._native_tried = True  # the pure-Python merge
    for t in texts:
        check(tok.bpe.encode_ordinary(t) == slow.encode_ordinary(t)
              and tok.bpe.encode_ordinary(" " + t)
              == slow.encode_ordinary(" " + t),
              f"[native] BPE of {t!r} differs from the pure-Python merge")
    log(f"[native] g++ build seconds {json.dumps(built)} (None: a library "
        f"newer than its source reused) in {native.BUILD_DIR}; {n_utts} "
        f"WAVs and transcripts equal to the Python paths")

    # (d) the default main-path run's FLOP roll-up, logged only
    total = dict(mel=0, encoder=0, decode=0, capture=0)
    for b_pad, _, kv_frames in default_seen["decode_shapes"]:
        total["mel"] += flops.mel_flops(dims) * b_pad
        total["encoder"] += flops.encoder_flops(dims) * b_pad
        total["decode"] += flops.decode_flops(
            dims, prompt_len=len(tok.sot_sequence), steps=DECODE_LEN,
            kv_frames=kv_frames) * b_pad
    for t_bucket, b_pad, _, reused in default_seen["capture_shapes"]:
        total["capture"] += flops.capture_flops(
            dims, t_tokens=t_bucket, reuse_cross_kv=reused) * b_pad
    rate = n_utts / default_seen["wall"]
    summary = flops.mfu_summary(sum(total.values()) / n_utts, rate,
                                flops.device_peak_tflops())
    log(f"[mfu] default main path on {card}: {json.dumps(summary)} at "
        f"{rate:.3f} utts/s; GFLOP per utterance by stage "
        f"{json.dumps({k: round(v / n_utts / 1e9, 2) for k, v in total.items()})}"
        f" (matmul FLOPs at the padded shapes; logged, not a claim)")
    log(f"[checkpoint] phase done in {time.perf_counter() - t_phase:.1f} s")


def probe_phase(model, tok, card: str) -> dict:
    """``probe_oracle`` at Whisper-medium width through
    ``cli.probe_oracle.main`` on one batch of 8 synthetic utterances of
    18-24 words over 8-10 s: exact launch counts (one capture, and the
    per-head DTW of 8 utterances x 384 heads in 3 launches of 8 layers x 8
    utterances x 16 heads = 1024 rows, frames cut to 512), the jump frames
    of 32 sampled rows of each launch equal to the NumPy DTW oracle, and
    both DTW kernels timed at that launch's shape. Returns the counts."""
    import torch

    from whisper_char_alignment_tpu_torch.cli import common, probe_oracle
    from whisper_char_alignment_tpu_torch.data.synthetic import \
        make_timit_corpus
    from whisper_char_alignment_tpu_torch.ops import _lib, dtw_cuda

    dims = model.dims
    with tempfile.TemporaryDirectory(prefix="smoke_probe_",
                                     dir=os.path.join(HERE, "build")) as d:
        scp = make_timit_corpus(d, n_utts=BATCH, seconds=(8.0, 10.0),
                                words_per_utt=(18, 24), seed=1)
        argv = cli_base_args(scp) + ["--hit_within", "10", "--output_dir",
                                     os.path.join(d, "out")]
        calls = []
        _lib.reset_launches()
        torch.cuda.synchronize()
        with patched(common, load_model_and_tokenizer=lambda args,
                     device=None: (model, tok)), dtw_calls(calls):
            t0 = time.perf_counter()
            results = probe_oracle.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    counts = _lib.launch_counts()
    heads = BATCH * dims.n_text_head  # rows of one layer
    layers = max(1, probe_oracle.ROWS_PER_LAUNCH // heads)
    n_launch = -(-dims.n_text_layer // layers)
    expect = expect_base()
    expect.update(encoder_attn=dims.n_audio_layer, qkpost=dims.n_text_layer,
                  dtw_trace=n_launch, dtw_backtrace=n_launch)
    log(f"[probe] launch counts: {counts} (expected {expect})")
    check(launches_match(counts, expect),
          "[probe] launch counts differ from the path's")
    check(len(calls) == n_launch
          and calls[0][0].shape[0] == heads * min(layers, dims.n_text_layer),
          f"[probe] DTW launches {[tuple(c[0].shape) for c in calls]}")
    gen = torch.Generator().manual_seed(0)
    held = 0
    for i, call in enumerate(calls):
        sample = torch.randperm(call[0].shape[0], generator=gen)[:32]
        held += hold_jump_frames(call, sample.tolist(), f"[probe] launch {i}")
    x, n_len, m_len, _ = calls[0]
    b, n, m = x.shape
    tr_bound, bt_bound, _, _ = dtw_bounds(n_len, m_len, n, m)
    ms_tr, method_tr = kernel_ms(lambda: dtw_cuda.dtw_trace(x),
                                 "dtw_trace_kernel", tr_bound)
    tr = dtw_cuda.dtw_trace(x)
    ms_bt, method_bt = kernel_ms(
        lambda: dtw_cuda.dtw_backtrace_jump(tr, n_len, m_len),
        "dtw_backtrace_kernel", bt_bound)
    walk = int((n_len.clamp(min=0) + m_len).max())
    log(f"[probe] on {card}: {results} in {wall:.3f} s; {held} sampled rows "
        f"of the {n_launch} DTW launches equal the NumPy DTW oracle; DTW at "
        f"the probe's launch shape {tuple(x.shape)}: trace {ms_tr:.4f} ms "
        f"({method_tr}, {ms_tr * 1e6 / (n + m - 1):.1f} ns per diagonal, "
        f"bound {tr_bound:.5f} ms), backtrace {ms_bt:.4f} ms ({method_bt}, "
        f"{ms_bt * 1e6 / max(walk, 1):.1f} ns per step of the longest walk "
        f"of {walk}, bound {bt_bound:.6f} ms)")
    return counts


def tiny_cli_phase() -> str:
    """``infer_ali --test_model`` on ``sample/test.scp`` on the card and
    with ``WCA_PLATFORM=cpu``: the words and boundaries of the two
    predictions pkls are equal."""
    import numpy as np

    from whisper_char_alignment_tpu_torch.cli import infer_ali

    argv = ["--scp", "sample/test.scp", "--test_model", "--save_prediction",
            "--use_gt_transcript", "--decode_sample_len", "8", "--aggr",
            "topk", "--topk", "2", "--aligned_unit_type", "char", "--strict",
            "--medfilt_width", "17"]
    records = {}
    cwd = os.getcwd()
    os.chdir(HERE)  # the scp names sample/test.wav
    try:
        with tempfile.TemporaryDirectory(
                prefix="smoke_tiny_", dir=os.path.join(HERE, "build")) as d:
            for platform in ("gpu", "cpu"):
                out_dir = os.path.join(d, platform)
                with environ(WCA_PLATFORM=platform):
                    infer_ali.main(argv + ["--output_dir", out_dir])
                (pkl,) = glob.glob(os.path.join(out_dir, "*-predictions.pkl"))
                with open(pkl, "rb") as f:
                    records[platform] = pickle.load(f)
    finally:
        os.chdir(cwd)
    card, cpu = records["gpu"], records["cpu"]
    check(sorted(card) == sorted(cpu) == [0], "[tiny cli] records differ")
    for key in ("predwords", "starts_hat", "ends_hat"):
        check(np.array_equal(card[0][key], cpu[0][key]),
              f"[tiny cli] {key}: card {card[0][key]} != CPU {cpu[0][key]}")
    return (f"words {card[0]['predwords']}, ends "
            f"{np.asarray(card[0]['ends_hat']).tolist()} equal on the card "
            f"and the CPU")


# ---------------------------------------------------------------------------
# phase 4: long-form transcription, its CLI, and the HTTP server
# ---------------------------------------------------------------------------

# the long-form options the smoke holds: the decode budget per rung (random
# weights fail the published gates, so every window climbs all six rungs)
LONG_SAMPLE_LEN = 64
LONG_SECONDS = 65.0


def vocab_tokenizer(n_vocab: int):
    """The toy tokenizer with its text vocabulary padded to the model's: as
    in Whisper's own tokenizer, the specials and the 1501 timestamps are the
    top ids of the model's vocabulary (with the bare toy vocabulary, the
    medium model's ids past it would read as timestamps far beyond 30 s and
    end a window's seek loop at once). The filler tokens are words, a space
    and five letters, so a random transcript reads as words."""
    from whisper_char_alignment_tpu_torch.text.bpe import ByteBPE, toy_ranks
    from whisper_char_alignment_tpu_torch.text.tokenizer import (
        N_TIMESTAMPS, WhisperTokenizer)

    ranks = toy_ranks()
    n_text = n_vocab - 2 - 99 - 6 - N_TIMESTAMPS
    k = 0
    while len(ranks) < n_text:
        word = bytes(97 + (k // 26 ** i) % 26 for i in range(5))
        ranks[b" " + word] = len(ranks)
        k += 1
    tok = WhisperTokenizer(ByteBPE(ranks))
    check(tok.n_vocab == n_vocab, f"padded tokenizer: {tok.n_vocab} ids")
    return tok


def speech_like(seconds: float, seed: int):
    """Synthetic speech-like audio at 16 kHz: a gliding 110-190 Hz voice
    with five harmonics under a 4 Hz syllable envelope, phrases broken by
    pauses, and a little noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    t = np.arange(n) / 16000.0
    pitch = 150.0 + 40.0 * np.sin(2 * np.pi * 0.3 * t + rng.uniform(0, 6.3))
    phase = 2 * np.pi * np.cumsum(pitch) / 16000.0
    voice = sum(np.sin(k * phase) / k for k in range(1, 6))
    syllables = np.clip(np.sin(2 * np.pi * 4.0 * t + rng.uniform(0, 6.3)),
                        0.0, None)
    phrases = np.sin(2 * np.pi * t / 5.0 + rng.uniform(0, 6.3)) > -0.6
    return (0.1 * voice * syllables * phrases
            + rng.normal(0, 0.005, n)).astype(np.float32)


@contextlib.contextmanager
def long_form_spies(log_: dict):
    """Record, while the block runs, what the long-form path executed: each
    encoder run (``whisper.encode_audio``), each seek-loop request run
    solo (kind, window seed, temperature), each decode (rows), each
    teacher-forced capture (``timing.get_attentions``), each word-timing
    window, each DTW call (kept for the NumPy oracle) and each CUDA graph
    capture with its host seconds."""
    from whisper_char_alignment_tpu_torch import transcribe as T
    from whisper_char_alignment_tpu_torch.align import timing
    from whisper_char_alignment_tpu_torch.models import decode_graph, decoding
    from whisper_char_alignment_tpu_torch.models import whisper as wm

    encode, execute, decode, attentions, words = (
        wm.encode_audio, T._execute_request, decoding.decode,
        timing.get_attentions, T._window_word_timings)
    captured = decode_graph._Captured
    for k in ("encodes", "captures", "word_s", "graph_s"):
        log_.setdefault(k, 0)
    for k in ("requests", "decodes", "dtw", "graphs"):
        log_.setdefault(k, [])

    def counted_encode(*a, **kw):
        log_["encodes"] += 1
        return encode(*a, **kw)

    def counted_request(model, tok, req, device=None):
        opts = req.get("options")
        log_["requests"].append((req["kind"], req.get("seed"),
                                 None if opts is None else opts.temperature))
        return execute(model, tok, req, device)

    def counted_decode(model, tok, mel, options=None, **kw):
        log_["decodes"].append(mel.shape[0] if mel.ndim == 3 else 1)
        return decode(model, tok, mel, options, **kw)

    def counted_attentions(*a, **kw):
        log_["captures"] += 1
        return attentions(*a, **kw)

    def timed_words(*a, **kw):
        t0 = time.perf_counter()
        out = words(*a, **kw)
        log_["word_s"] += time.perf_counter() - t0
        return out

    class TimedCapture(captured):
        def __init__(self, *a, **kw):
            t0 = time.perf_counter()
            super().__init__(*a, **kw)
            log_["graph_s"] += time.perf_counter() - t0
            log_["graphs"].append(time.perf_counter() - t0)

    with patched(wm, encode_audio=counted_encode), \
            patched(T, _execute_request=counted_request,
                    _window_word_timings=timed_words), \
            patched(decoding, decode=counted_decode), \
            patched(timing, get_attentions=counted_attentions), \
            patched(decode_graph, _Captured=TimedCapture), \
            dtw_calls(log_["dtw"]):
        yield


def expected_long_form(dims, log_: dict) -> dict:
    """The launch counts of a long-form run from what it executed: the
    encoder kernel once a layer per encoder run (each decode request, each
    detect request, each word-timing capture: the JAX package encodes
    each call too), the QK post-process once a decoder layer per capture,
    the DTW kernels once per capture; nothing else."""
    from whisper_char_alignment_tpu_torch.ops import _lib

    out = expect_base()
    out.update(encoder_attn=dims.n_audio_layer * log_["encodes"],
               qkpost=dims.n_text_layer * log_["captures"],
               dtw_trace=log_["captures"], dtw_backtrace=log_["captures"])
    return out


def hold_long_form(label: str, dims, log_: dict, counts: dict) -> int:
    """The run's launch counts against its requests, and every DTW call's
    jump frames against the NumPy DTW oracle. Returns the rows held."""
    expect = expected_long_form(dims, log_)
    log(f"[{label}] launch counts: {counts} (expected {expect})")
    check(launches_match(counts, expect),
          f"[{label}] launch counts differ from the path's")
    check(len(log_["dtw"]) == log_["captures"],
          f"[{label}] {len(log_['dtw'])} DTW calls for {log_['captures']} "
          f"captures")
    return sum(hold_jump_frames(c, range(c[0].shape[0]), f"[{label}] DTW {i}")
               for i, c in enumerate(log_["dtw"]))


def same_json(a, b) -> bool:
    """Two results equal in every field, floats bit for bit (``repr``)."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def windows_of(log_: dict) -> dict:
    """Rungs per window: the solo decode requests by their window's seek."""
    rungs = {}
    for kind, seed, _ in log_["requests"]:
        if kind == "decode":
            seek = seed & 0xFFFFFFFF
            rungs[seek] = rungs.get(seek, 0) + 1
    return rungs


def transcribe_phase(model, tok, card: str) -> int:
    """``transcribe`` at Whisper-medium width on 65 s of speech-like audio
    (three windows): the published ladder (0.0 ... 1.0; random weights
    climb all of it), conditioning on previous text, ``language=None`` (the
    detect request runs), word timestamps, ``sample_len`` 64. With
    ``word_aggr="default"`` the graphed run equals the eager loops' run
    (``decoding._decode_loop`` and ``run_eager``) in every field, floats
    bit for bit; with ``"topk"`` (graphed) its decodes equal the default
    run's. Each run's launch counts are set to 0 before it and equal after
    it the counts of what it executed; every word-timing DTW equals the
    NumPy oracle. Logs windows, rungs per window, graph captures and their
    seconds, the decode/word-timing split and the real-time factor. Returns
    the graphed run's QK post-process launches (median width 7)."""
    import torch

    from whisper_char_alignment_tpu_torch import transcribe as T
    from whisper_char_alignment_tpu_torch.models import decode_graph, decoding
    from whisper_char_alignment_tpu_torch.ops import _lib

    audio = speech_like(LONG_SECONDS, seed=3)
    kwargs = dict(language=None, sample_len=LONG_SAMPLE_LEN,
                  word_timestamps=True, condition_on_previous_text=True,
                  model_name="medium")
    dims = model.dims

    def run(aggr, eager=False):
        log_ = {}
        with contextlib.ExitStack() as stack:
            stack.enter_context(long_form_spies(log_))
            if eager:
                stack.enter_context(patched(
                    decoding, _loop_for=lambda dev: decoding._decode_loop,
                    runner_for=lambda dev: decoding.run_eager))
            before = decode_graph.replay_record()
            _lib.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = T.transcribe(model, tok, audio, word_aggr=aggr, **kwargs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            after = decode_graph.replay_record()
        counts = _lib.launch_counts()
        log_["record"] = {k: after[k] - before[k] for k in after}
        return out, counts, wall, log_

    results = {}
    for label, aggr, eager in (("graphed", "default", False),
                               ("eager", "default", True),
                               ("graphed topk", "topk", False)):
        out, counts, wall, log_ = run(aggr, eager)
        held = hold_long_form(f"transcribe {label}", dims, log_, counts)
        rungs = windows_of(log_)
        n_detect = sum(k == "detect" for k, _, _ in log_["requests"])
        check(n_detect == 1 and len(rungs) >= 3
              and all(r == 6 for r in rungs.values()),
              f"[transcribe {label}] detect {n_detect}, rungs per window "
              f"{rungs}: not three windows climbing the whole ladder")
        check(held >= 1 and out["segments"]
              and any(s.get("words") for s in out["segments"]),
              f"[transcribe {label}] no word timings ({held} DTW rows)")
        results[label] = (out, counts, wall, log_)
        rec = log_["record"]
        log(f"[transcribe {label}] on {card}: {LONG_SECONDS:.0f} s of audio, "
            f"{len(rungs)} windows (seeks {sorted(rungs)}), rungs per window "
            f"{list(rungs.values())}, language {out['language']}, "
            f"{len(out['segments'])} segments, "
            f"{sum(len(s.get('words', [])) for s in out['segments'])} words; "
            f"wall {wall:.3f} s -> real-time factor "
            f"{LONG_SECONDS / wall:.2f} audio s per s; word timings "
            f"{log_['word_s']:.3f} s of it; graph captures {rec['captures']} "
            f"({log_['graph_s']:.3f} s: "
            f"{[round(s, 3) for s in log_['graphs']]}), replays "
            f"{rec['replays']}; encoder runs {log_['encodes']}, captures "
            f"{log_['captures']}; {held} DTW rows equal the NumPy oracle")
    graphed, eager = results["graphed"][0], results["eager"][0]
    check(same_json(graphed, eager), "[transcribe] the graphed long-form "
          "result differs from the eager loops'")
    topk = results["graphed topk"][0]
    check([s["tokens"] for s in topk["segments"]]
          == [s["tokens"] for s in graphed["segments"]]
          and [s["avg_logprob"] for s in topk["segments"]]
          == [s["avg_logprob"] for s in graphed["segments"]],
          "[transcribe] the topk run's decodes differ from the default's")
    g_wall, e_wall = results["graphed"][2], results["eager"][2]
    log(f"[transcribe] graphed == eager loops in every field, floats bit for "
        f"bit ({len(graphed['segments'])} segments); wall {g_wall:.3f} s "
        f"graphed (captures included), {e_wall:.3f} s eager "
        f"({e_wall / g_wall:.2f}x); topk run's decodes equal the default's")
    return results["graphed"][1]["qkpost"]


def batched_phase(model, model32, tok, card: str) -> None:
    """``transcribe_batched`` on 4 speech-like audios of 35-40 s (two
    windows each) with ``condition_on_previous_text=False``, temperature 0
    (random weights fail every gate, so with the ladder each window's five
    fallback rungs would run solo and hide the batching) and word
    timestamps, against each audio's solo ``transcribe``, with the random
    bf16 weights and the same weights computed in float32 (``model32``):
    every result equal to its solo run in every field, floats bit for bit
    (the batched decode's rows are the solo decode's: ``dec_attn``,
    ``rows_linear``). The old kernels' launch counts exact in both; logs
    the shared decodes and the wall against the solo runs."""
    import torch

    from whisper_char_alignment_tpu_torch import transcribe as T
    from whisper_char_alignment_tpu_torch.ops import _lib

    audios = [speech_like(s, seed=10 + k)
              for k, s in enumerate((35.0, 37.0, 38.5, 40.0))]
    kwargs = dict(language="en", sample_len=LONG_SAMPLE_LEN, temperature=0.0,
                  condition_on_previous_text=False, word_timestamps=True,
                  model_name="medium")

    def run(m, label):
        T.transcribe_batched(m, tok, audios, **kwargs)  # captures its graphs
        T.transcribe(m, tok, audios[0], **kwargs)
        solo, solo_s = [], 0.0
        for a in audios:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solo.append(T.transcribe(m, tok, a, **kwargs))
            torch.cuda.synchronize()
            solo_s += time.perf_counter() - t0
        log_ = {}
        with long_form_spies(log_):
            _lib.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batched = T.transcribe_batched(m, tok, audios, **kwargs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = _lib.launch_counts()
        held = hold_long_form(label, m.dims, log_, counts)
        shared = [r for r in log_["decodes"] if r > 1]
        check(shared, f"[{label}] no shared decode: {log_['decodes']}")
        return solo, solo_s, batched, wall, log_, held, shared

    def decoded(r):
        return (r["text"], r["language"],
                [(x["id"], x["seek"], x["start"], x["end"], x["text"],
                  x["tokens"], x["temperature"],
                  [(w["word"], w["start"], w["end"])
                   for w in x.get("words", [])]) for x in r["segments"]])

    for m in (model32, model):
        label = ("transcribe_batched "
                 + ("f32" if m.dtype == torch.float32 else "bf16"))
        solo, solo_s, batched, wall, log_, held, shared = run(m, label)
        for k, (s_, b) in enumerate(zip(solo, batched)):
            check(decoded(s_) == decoded(b) and same_json(s_, b),
                  f"[{label}] audio {k}'s result differs from its solo run")
        log(f"[{label}] on {card}: {len(audios)} audios "
            f"({sum(a.size for a in audios) / 16000:.1f} s), "
            f"{len(log_['decodes'])} decodes, {len(shared)} shared (rows "
            f"{shared}); wall {wall:.3f} s against {solo_s:.3f} s for the "
            f"solo runs ({solo_s / wall:.2f}x); every result equal to its "
            f"solo run in every field, floats bit for bit; segments "
            f"{[len(r['segments']) for r in solo]}; {held} DTW rows equal "
            f"the NumPy oracle")


def transcribe_cli_phase(model, tok, card: str) -> None:
    """``cli.transcribe`` at Whisper-medium width on the card (the model
    loader replaced by the smoke's model; bf16; 20 s of speech-like audio,
    one window, the published ladder and decode budget, word timestamps):
    all five output formats written, exact launch counts, DTW held. Then
    ``--test_model`` on ``sample/test.wav`` on the card and with
    ``WCA_PLATFORM=cpu`` (temperature 0 alone: the card's and the CPU's
    generators draw different noise): txt, srt, vtt and tsv byte-equal,
    the json equal with float fields within 1e-4."""
    import torch

    from whisper_char_alignment_tpu_torch.audio.wav import save as wav_save
    from whisper_char_alignment_tpu_torch.cli import common
    from whisper_char_alignment_tpu_torch.cli import transcribe as tcli
    from whisper_char_alignment_tpu_torch.ops import _lib

    exts = ("txt", "srt", "vtt", "tsv", "json")
    with tempfile.TemporaryDirectory(prefix="smoke_transcribe_",
                                     dir=os.path.join(HERE, "build")) as d:
        wav = os.path.join(d, "talk.wav")
        wav_save(wav, speech_like(20.0, seed=4), 16000)
        log_ = {}
        with patched(common, load_model_and_tokenizer=lambda args,
                     device=None: (model, tok)), long_form_spies(log_):
            _lib.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = tcli.main([wav, "--model", "medium", "--compute_dtype",
                            "bfloat16", "--word_timestamps",
                            "--output_format", "all", "--output_dir",
                            os.path.join(d, "out")])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = _lib.launch_counts()
        check(rc == 0, f"[cli transcribe] exit {rc}")
        held = hold_long_form("cli transcribe", model.dims, log_, counts)
        written = {e: os.path.getsize(os.path.join(d, "out", f"talk.{e}"))
                   for e in exts}
        with open(os.path.join(d, "out", "talk.json")) as f:
            result = json.load(f)
        check(result["segments"] and all(written.values()),
              f"[cli transcribe] outputs {written}")
        log(f"[cli transcribe] on {card}: 20 s in {wall:.3f} s (model load "
            f"excluded), rungs per window {list(windows_of(log_).values())}, "
            f"{len(result['segments'])} segments; files {written} bytes; "
            f"{held} DTW rows equal the NumPy oracle")

        argv = ["sample/test.wav", "--test_model", "--model", "tiny-test",
                "--language", "en", "--word_timestamps", "--temperature",
                "0", "--temperature_increment_on_fallback", "2",
                "--output_format", "all"]
        cwd = os.getcwd()
        os.chdir(HERE)  # argv names sample/test.wav
        try:
            for platform in ("gpu", "cpu"):
                with environ(WCA_PLATFORM=platform):
                    check(tcli.main(argv + ["--output_dir",
                                            os.path.join(d, platform)]) == 0,
                          f"[tiny cli transcribe] {platform} exit")
        finally:
            os.chdir(cwd)
        for e in exts[:4]:
            paths = [os.path.join(d, p, f"test.{e}") for p in ("gpu", "cpu")]
            blobs = [open(p, "rb").read() for p in paths]
            check(blobs[0] == blobs[1], f"[tiny cli transcribe] {e}: card "
                  f"{blobs[0][:200]!r} != CPU {blobs[1][:200]!r}")
        card_j, cpu_j = (json.load(open(os.path.join(d, p, "test.json")))
                         for p in ("gpu", "cpu"))
        worst = 0.0

        def walk(a, b):
            nonlocal worst
            if isinstance(b, float):
                worst = max(worst, abs(a - b))
            elif isinstance(b, dict):
                check(sorted(a) == sorted(b), "[tiny cli transcribe] keys")
                for k in b:
                    walk(a[k], b[k])
            elif isinstance(b, list):
                check(len(a) == len(b), "[tiny cli transcribe] lengths")
                for x, y in zip(a, b):
                    walk(x, y)
            else:
                check(a == b, f"[tiny cli transcribe] {a!r} != {b!r}")

        walk(card_j, cpu_j)
        check(worst <= 1e-4, f"[tiny cli transcribe] json floats differ by "
              f"{worst:.3g}")
        log(f"[tiny cli transcribe] --test_model on sample/test.wav: txt, "
            f"srt, vtt and tsv byte-equal on the card and the CPU, json "
            f"equal with floats within {worst:.3g} (tolerance 1e-4): "
            f"{card_j['text']!r}, {len(card_j['segments'])} segments")


def _wav_bytes(audio) -> bytes:
    """A 16 kHz WAV file's bytes (the port's own writer)."""
    from whisper_char_alignment_tpu_torch.audio.wav import save as wav_save

    with tempfile.NamedTemporaryFile(suffix=".wav",
                                     dir=os.path.join(HERE, "build")) as f:
        wav_save(f.name, audio, 16000)
        with open(f.name, "rb") as g:
            return g.read()


def serve_align_phase(model, tok, card: str) -> None:
    """/align in the compute dtype of ``model`` (bf16 here; the f32 server
    is :func:`serve_phase`): ``serve(...)`` at batch 8 with its /align
    warmup, 8 requests of 3-7 s posted alone, then all 8 at once in one
    micro-batch, each batched response equal to its solo one (words,
    transcription, boundaries), the old kernels' launch counts exact."""
    import threading
    import urllib.request

    import torch

    from whisper_char_alignment_tpu_torch import api
    from whisper_char_alignment_tpu_torch.cli import serve as serve_mod
    from whisper_char_alignment_tpu_torch.ops import _lib

    label = f"serve /align {str(model.dtype)[6:]}"
    m = api.Model(model=model, tokenizer=tok, name="medium")
    srv = serve_mod.serve(m, port=0, compute_dtype=model.dtype,
                          batch_size=BATCH, linger_ms=5.0,
                          config_overrides=dict(decode_sample_len=DECODE_LEN))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/align"

    def post(body):
        req = urllib.request.Request(url, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            return json.loads(r.read())

    try:
        serve_mod.warmup(m, batcher=srv.batcher)
        bodies = [_wav_bytes(speech_like(3.0 + 4.0 * k / 7, seed=20 + k))
                  for k in range(BATCH)]
        log_ = {}
        with long_form_spies(log_):
            _lib.reset_launches()
            srv.batcher.linger_s = 0.0  # posted one at a time
            solo = [post(b) for b in bodies]
            launches0 = srv.batcher.n_launches
            srv.batcher.linger_s = 10.0  # the batch leaves when it is full
            outs = [None] * BATCH
            threads = [threading.Thread(
                target=lambda i=i: outs.__setitem__(i, post(bodies[i])))
                for i in range(BATCH)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            torch.cuda.synchronize()
            counts = _lib.launch_counts()
        check(srv.batcher.n_launches - launches0 == 1,
              f"[{label}] {BATCH} requests ran in "
              f"{srv.batcher.n_launches - launches0} batches, not one")
        held = hold_long_form(label, model.dims, log_, counts)
        aligned = sum(len(o["words"]) >= 2 for o in solo)
        same = [o == s_ for o, s_ in zip(outs, solo)]
        check(all(same) and aligned >= 1,
              f"[{label}] batched responses equal to their solo ones: "
              f"{same} ({aligned} with words)")
    finally:
        srv.shutdown()
        srv.batcher.close()
        srv.tbatcher.close()
        thread.join(timeout=60)
    log(f"[{label}] on {card}: {BATCH} /align of 3-7 s posted alone, then "
        f"in one batch: every batched response equal to its solo one "
        f"({aligned} with words); {held} DTW rows equal the NumPy oracle")


def serve_phase(model, tok, card: str) -> int:
    """The HTTP server at Whisper-medium width on the card, in process, on
    ``model`` (the random bf16 weights computed in float32; the bf16
    /align is :func:`serve_align_phase`):
    ``serve(...)`` on 127.0.0.1, port 0, batch 8, /align decodes of 32
    steps, ``warmup`` and ``warmup_transcribe`` (the traffic's recipe)
    before traffic. /healthz; 8 /align requests of 3-7 s each posted alone,
    then all 8 at once: one micro-batch, each response equal to its solo
    one; 4 /transcribe requests of 9-25 s at once (their first windows in
    one shared decode of 4 rows), each equal to the solo ``transcribe``; a
    413 for an oversized body. No graph of a warmed shape is captured after
    the warmups, and the launch counts are exact. Then one /align at
    ``medfilt_width=101``, its launch counts exact. Logs /align req/s
    and p50/p95 latency, the /transcribe wall and peak device memory.
    Returns the width-101 request's QK post-process launches."""
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    import torch

    from whisper_char_alignment_tpu_torch import api
    from whisper_char_alignment_tpu_torch import transcribe as T
    from whisper_char_alignment_tpu_torch.audio.resample import \
        load_resampled_bytes
    from whisper_char_alignment_tpu_torch.cli import serve as serve_mod
    from whisper_char_alignment_tpu_torch.models import decode_graph
    from whisper_char_alignment_tpu_torch.ops import _lib

    recipe = dict(language="en", sample_len=LONG_SAMPLE_LEN, temperature=0.0,
                  without_timestamps=True, word_timestamps=True)
    query = ("language=en&sample_len=%d&temperature=0&without_timestamps=1"
             "&word_timestamps=1" % LONG_SAMPLE_LEN)
    torch.cuda.reset_peak_memory_stats()
    m = api.Model(model=model, tokenizer=tok, name="medium")
    srv = serve_mod.serve(m, port=0, compute_dtype=model.dtype,
                          batch_size=BATCH, linger_ms=5.0,
                          config_overrides=dict(decode_sample_len=DECODE_LEN))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def post(route, body):
        t0 = time.perf_counter()
        req = urllib.request.Request(f"{url}/{route}", data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            return json.loads(r.read()), time.perf_counter() - t0

    def wave(route, bodies):
        outs, errors = [None] * len(bodies), []

        def client(i):
            try:
                outs[i] = post(route, bodies[i])
            except Exception as e:  # surfaced by the check below
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(bodies))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        check(not errors and all(o is not None for o in outs),
              f"[serve] {route}: {errors}")
        return [o[0] for o in outs], [o[1] for o in outs], wall

    try:
        t0 = time.perf_counter()
        serve_mod.warmup(m, batcher=srv.batcher)
        serve_mod.warmup_transcribe(m, batch_size=BATCH,
                                    tbatcher=srv.tbatcher, **recipe)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        warmed = decode_graph.replay_record()
        warm_keys = set(decode_graph._GRAPHS[model])
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        check(health == {"ok": True, "model": "medium"},
              f"[serve] /healthz {health}")

        log_ = {}
        align_bodies = [_wav_bytes(speech_like(3.0 + 4.0 * k / 7, seed=20 + k))
                        for k in range(BATCH)]
        tr_bodies = [_wav_bytes(speech_like(s, seed=30 + k))
                     for k, s in enumerate((9.0, 14.0, 19.0, 25.0))]
        with long_form_spies(log_):
            _lib.reset_launches()
            launches0 = srv.batcher.n_launches
            srv.batcher.linger_s = 0.0  # requests posted one at a time
            solo = [post("align", b)[0] for b in align_bodies]
            launches1 = srv.batcher.n_launches
            # a batch leaves as soon as it is full: the linger only bounds
            # the wait for all 8 clients
            srv.batcher.linger_s = 10.0
            outs, lat, wall = wave("align", align_bodies)
            align_batches = srv.batcher.n_launches - launches0
            check(srv.batcher.n_launches - launches1 == 1,
                  f"[serve] 8 /align requests ran in "
                  f"{srv.batcher.n_launches - launches1} batches, not one")
            aligned = sum(len(o["words"]) >= 2 for o in solo)
            check(outs == solo and aligned >= 1,
                  "[serve] a batched /align response differs from its solo "
                  "one, or none holds words")
            t_launch0 = srv.tbatcher.n_launches
            # 4 requests never fill a batch of 8: the dispatcher lingers
            # 2 s for them; the batch's own run is timed
            srv.tbatcher.linger_s = 2.0
            run_batch, t_run = srv.tbatcher._run_batch, []

            def timed_batch(batch):
                t0 = time.perf_counter()
                out = run_batch(batch)
                torch.cuda.synchronize()
                t_run.append(time.perf_counter() - t0)
                return out

            with patched(srv.tbatcher, _run_batch=timed_batch):
                t_outs, _, _ = wave(f"transcribe?{query}", tr_bodies)
            t_wall = sum(t_run)
            check(srv.tbatcher.n_launches - t_launch0 == 1,
                  "[serve] the 4 /transcribe requests ran in "
                  f"{srv.tbatcher.n_launches - t_launch0} batches")
            torch.cuda.synchronize()
            counts = _lib.launch_counts()
        after = decode_graph.replay_record()
        # a later window of a request is conditioned on the earlier ones'
        # text (random weights emit timestamp pairs that end a window
        # early): its prompt length is a shape no warmup can know
        new_keys = [k for k in decode_graph._GRAPHS[model]
                    if k not in warm_keys]
        warm_begins = {k[1].sample_begin for k in warm_keys}
        recaptured = after["captures"] - warmed["captures"] - len(new_keys)
        check(recaptured == 0 and all(k[1].sample_begin not in warm_begins
                                      for k in new_keys),
              f"[serve] {after['captures'] - warmed['captures']} graphs "
              f"captured after the warmups, {recaptured} of a warmed shape")
        t_decodes = log_["decodes"][align_batches:]
        n_decodes = len(t_decodes)
        check(log_["decodes"][:align_batches] == [BATCH] * align_batches
              and t_decodes[:1] == [4], f"[serve] decodes "
              f"{log_['decodes']}: the /transcribe wave's first is not one "
              f"of 4 rows")
        # each /align batch encodes and captures once; each /transcribe
        # decode and each of its word-timing captures encodes once
        word_caps = log_["captures"] - align_batches
        check(align_batches == BATCH + 1 and 1 <= word_caps
              and log_["encodes"] == align_batches + n_decodes + word_caps,
              f"[serve] encoder runs {log_['encodes']}, captures "
              f"{log_['captures']} for {align_batches} /align batches and "
              f"{n_decodes} decodes")
        held = hold_long_form("serve", model.dims, log_, counts)
        solo_tr = [T.transcribe(model, tok, load_resampled_bytes(b),
                                model_name="medium", **recipe)
                   for b in tr_bodies]
        tr_json = [json.loads(json.dumps(s)) for s in solo_tr]
        bit_equal = t_outs == tr_json
        worst = 0.0
        for o, s in zip(t_outs, tr_json):
            check(all(x[k] == y[k] for x, y in zip(o["segments"],
                                                    s["segments"])
                      for k in ("seek", "start", "end", "text", "tokens"))
                  and o["text"] == s["text"]
                  and len(o["segments"]) == len(s["segments"])
                  and [[(w["word"], w["start"], w["end"])
                        for w in x.get("words", [])] for x in o["segments"]]
                  == [[(w["word"], w["start"], w["end"])
                       for w in x.get("words", [])] for x in s["segments"]],
                  "[serve] a /transcribe response differs from the solo "
                  "transcribe")
            for x, y in zip(o["segments"], s["segments"]):
                for k in ("avg_logprob", "compression_ratio",
                          "no_speech_prob"):
                    worst = max(worst, abs(x[k] - y[k]))
        check(bit_equal, f"[serve] /transcribe floats differ from the "
              f"solo transcribe by up to {worst:.3g}")

        old_cap = serve_mod.MAX_BODY_BYTES
        serve_mod.MAX_BODY_BYTES = 1024
        try:
            post("align", b"\0" * 4096)
            status = 200
        except urllib.error.HTTPError as e:
            status = e.code
        finally:
            serve_mod.MAX_BODY_BYTES = old_cap
        check(status == 413, f"[serve] oversized body answered {status}")
        peak = torch.cuda.max_memory_allocated()

        # one /align request at medfilt_width=101: the QK post-process's
        # padded window on a user's path
        wide_log = {}
        srv.batcher.linger_s = 0.0
        with long_form_spies(wide_log):
            _lib.reset_launches()
            k = next(i for i, o in enumerate(solo) if len(o["words"]) >= 2)
            wide = post("align?medfilt_width=101", align_bodies[k])[0]
            torch.cuda.synchronize()
            wide_counts = _lib.launch_counts()
        expect = expected_long_form(model.dims, wide_log)
        expect["qkpost_rank"], expect["qkpost"] = expect["qkpost"], 0
        log(f"[serve] /align?medfilt_width=101 launch counts: {wide_counts} "
            f"(expected {expect})")
        check(launches_match(wide_counts, expect)
              and wide_log["captures"] == 1,
              "[serve] /align at width 101: launch counts differ from the "
              "path's")
        # the decode is the width-3 response's; only the times may differ
        check(wide["words"] == solo[k]["words"]
              and wide["transcription"] == solo[k]["transcription"]
              and len(wide["end_times"]) == len(solo[k]["end_times"])
              and all(math.isfinite(x) for x in wide["end_times"]),
              f"[serve] /align at width 101: {wide} against the width-3 "
              f"response {solo[k]}")
        held += hold_jump_frames(wide_log["dtw"][0],
                                 range(wide_log["dtw"][0][0].shape[0]),
                                 "[serve] /align at width 101")
    finally:
        srv.shutdown()
        srv.batcher.close()
        srv.tbatcher.close()
        thread.join(timeout=60)
    lat_ms = np.asarray(lat) * 1e3
    log(f"[serve] on {card}: warmups {warm_s:.3f} s ({warmed['captures']} "
        f"graphs captured in this process so far); /healthz {health}; 8 "
        f"concurrent /align of 3-7 s in one batch, each equal to its solo "
        f"response ({aligned} with words): {BATCH / wall:.3f} req/s, latency p50 "
        f"{np.percentile(lat_ms, 50):.1f} ms, p95 "
        f"{np.percentile(lat_ms, 95):.1f} ms; 4 concurrent /transcribe of "
        f"9-25 s in one batch, decodes of rows {t_decodes}: wall "
        f"{t_wall:.3f} s, each equal to the solo transcribe, floats bit for "
        f"bit; 413 for "
        f"an oversized body; no capture of a warmed shape after the warmups "
        f"({len(new_keys)} of prompted later windows); {held} DTW rows "
        f"equal the NumPy oracle; peak device memory {peak / 2**30:.2f} GiB")
    return wide_counts["qkpost_rank"]


def long_form_phases(model, tok, card: str) -> dict:
    """The long-form and serving paths (phase 4), each with its launch
    counts set to 0 just before it and read just after, with the toy
    tokenizer padded to the model's vocabulary. Returns the QK
    post-process launches of the graphed ``transcribe`` (width 7) and of
    the /align request at width 101, by kernel row."""
    import torch

    from whisper_char_alignment_tpu_torch.models import whisper as wm

    t0 = time.perf_counter()
    tok = vocab_tokenizer(model.dims.n_vocab)
    # the same random bf16 weights computed in float32, where a batched
    # decode and a solo one agree to rounding (batched_phase)
    model32 = wm.cast_params(model, torch.float32)
    w7 = transcribe_phase(model, tok, card)
    batched_phase(model, model32, tok, card)
    transcribe_cli_phase(model, tok, card)
    w101 = serve_phase(model32, tok, card)
    serve_align_phase(model, tok, card)
    log(f"[long form] phases done in {time.perf_counter() - t0:.1f} s")
    return {"qkpost_w7": w7, "qkpost_w101": w101}


# ---------------------------------------------------------------------------
# phase 5: the port's benchmark programs
# ---------------------------------------------------------------------------

# the keys of each program's one JSON line: the JAX script's, and the three
# every line of the port carries
BENCH_COMMON_KEYS = {"device", "launches", "graph_captures_timed"}
BENCH_KEYS = {
    "bench": {"metric", "value", "unit", "vs_baseline", "n_utts", "batch",
              "passes", "pipeline_depth", "sort_by_duration",
              "reuse_cross_kv", "decode_len", "decode_frame_bucket",
              "decode_frame_bucket_guarded", "mfu", "decode_sweep",
              "stage_split_s", "best_pass_wall_s"},
    "bench_serve": {"metric", "value", "unit", "vs_baseline",
                    "serial_req_per_sec", "speedup_vs_serial",
                    "p50_serial_ms", "p50_concurrent_ms", "n_reqs",
                    "clients", "batch", "decode_len", "audio_seconds",
                    "batcher_launches", "batcher_reqs", "p95_concurrent_ms",
                    "concurrent_samples", "peak_device_mem_gib"},
    "bench_transcribe_longform": {"metric", "value", "unit", "min_wall_s",
                                  "median_wall_s", "segments",
                                  "seconds_audio"},
    "measure_latency": {"metric", "value", "unit", "transcribe_median_ms",
                        "samples"},
    "bench_probe": {"metric", "value", "unit", "hit_rate"},
}


def check_payload(name: str, payload: dict) -> None:
    """A program's one line: every key of its contract, a positive rate."""
    missing = (BENCH_KEYS[name] | BENCH_COMMON_KEYS) - set(payload)
    check(not missing, f"[{name}] payload lacks {sorted(missing)}")
    check(isinstance(payload["value"], (int, float)) and payload["value"] > 0,
          f"[{name}] value {payload['value']}")


@contextlib.contextmanager
def bench_spies(log_: dict):
    """Count, while the block runs, the encoder runs
    (``whisper.encode_audio``), the teacher-forced captures
    (``timing.get_attentions``), the calls of the DTW kernels' entry
    (``timing.dtw_jump_frames``, the first one's inputs and jump frames
    kept for the NumPy oracle), and the decode steps whose cross K/V are
    int8, read from the graph runner's replay record around each graphed
    loop (replayed steps plus a capture's warm-up step, which launch the
    kernels)."""
    from whisper_char_alignment_tpu_torch.align import timing
    from whisper_char_alignment_tpu_torch.models import decode_graph
    from whisper_char_alignment_tpu_torch.models import whisper as wm

    encode, attentions, jump, loop = (wm.encode_audio, timing.get_attentions,
                                      timing.dtw_jump_frames,
                                      decode_graph.graphed_loop)
    log_.update(encodes=0, captures=0, dtw=0, int8_steps=0, first_dtw=None)

    def counted_encode(*a, **kw):
        log_["encodes"] += 1
        return encode(*a, **kw)

    def counted_attentions(*a, **kw):
        log_["captures"] += 1
        return attentions(*a, **kw)

    def counted_jump(x, n, m):
        out = jump(x, n, m)
        log_["dtw"] += 1
        if log_["first_dtw"] is None:
            log_["first_dtw"] = (x.clone(), n.clone(), m.clone(), out.clone())
        return out

    def counted_loop(*a, **kw):
        before = decode_graph.replay_record()
        out = loop(*a, **kw)
        after = decode_graph.replay_record()
        if isinstance(out[4][0], tuple):  # int8 codes and scales
            log_["int8_steps"] += (after["steps"] - before["steps"]
                                   + after["warmup_steps"]
                                   - before["warmup_steps"])
        return out

    with patched(wm, encode_audio=counted_encode), \
            patched(timing, get_attentions=counted_attentions,
                    dtw_jump_frames=counted_jump), \
            patched(decode_graph, graphed_loop=counted_loop):
        yield


def bench_expected(dims, log_: dict, dtw_per_capture: int = 1) -> dict:
    """A program's launch counts from what it executed: the encoder kernel
    once a layer per encoder run, the QK post-process once a decoder layer
    per capture, the DTW kernels ``dtw_per_capture`` times per capture (the
    probe's per-head DTW: one launch per group of layers), the int8
    cross-attention once a decoder layer per int8 decode step; nothing
    else."""
    from whisper_char_alignment_tpu_torch.ops import _lib

    out = expect_base()
    out.update(encoder_attn=dims.n_audio_layer * log_["encodes"],
               qkpost=dims.n_text_layer * log_["captures"],
               dtw_trace=dtw_per_capture * log_["captures"],
               dtw_backtrace=dtw_per_capture * log_["captures"],
               cross_attn_int8=dims.n_text_layer * log_["int8_steps"])
    return out


def bench_run(name: str, fn, dims, card: str, dtw_per_capture: int = 1):
    """One program's ``run`` in process: launch counts set to 0 before it
    and, after it, equal to the counts of what it executed; its payload
    checked (keys, a positive rate, no graph captured in a timed pass);
    the first DTW call's jump frames equal to the NumPy DTW oracle. Returns
    (payload, the spies' log)."""
    import torch

    from whisper_char_alignment_tpu_torch.ops import _lib

    log_ = {}
    _lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with bench_spies(log_):
        payload = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _lib.launch_counts()
    expect = bench_expected(dims, log_, dtw_per_capture)
    log(f"[{name}] launch counts: {counts} (expected {expect}; "
        f"{log_['encodes']} encoder runs, {log_['captures']} captures, "
        f"{log_['dtw']} DTW calls, {log_['int8_steps']} int8 decode steps)")
    check(launches_match(counts, expect),
          f"[{name}] launch counts differ from the path's")
    check(log_["dtw"] == dtw_per_capture * log_["captures"],
          f"[{name}] {log_['dtw']} DTW calls for {log_['captures']} captures")
    check_payload(name.split()[0], payload)
    check(payload["graph_captures_timed"] == 0,
          f"[{name}] {payload['graph_captures_timed']} decode graphs "
          "captured inside timed passes")
    if log_["first_dtw"] is not None:
        call = log_["first_dtw"]
        sample = range(min(32, call[0].shape[0]))
        hold_jump_frames(call, sample, f"[{name}] DTW")
    log(f"[{name}] on {card} in {seconds:.1f} s: {json.dumps(payload)}")
    return payload, log_


def bench_phase(model, tok, card: str, device: str = "cuda") -> None:
    """The port's five benchmark programs at Whisper-medium width: each
    module's ``run`` in process on the smoke's bf16 model at cut sizes
    (bench: 16 utterances, batch 8, one pass, the sweep at 32 steps only;
    bench_serve: 8 requests from 4 clients, /align and /transcribe at
    temperature 0; measure_latency: 3 calls; the long form: 35 s, one
    timed call; the probe: 8 utterances, one pass), each with exact launch
    counts, its payload's keys, no graph captured in a timed pass, and
    bench's NumPy DTW recompute; then ``python -m
    whisper_char_alignment_tpu_torch.bench`` in a subprocess (16
    utterances, batch 8, one pass, no sweep): exactly one JSON line on its
    stdout."""
    import torch

    from whisper_char_alignment_tpu_torch import bench
    from whisper_char_alignment_tpu_torch.cli import probe_oracle
    from whisper_char_alignment_tpu_torch.scripts import (
        bench_probe, bench_serve, bench_transcribe_longform, measure_latency)

    t_phase = time.perf_counter()
    dims = model.dims
    dev = torch.device(device)
    n_batches = -(-N_UTTS // BATCH)

    s = bench.Settings(n_utts=N_UTTS, batch=BATCH, passes=1,
                       sweep_lens=(DECODE_LEN,), sweep_passes=1)
    out, log_ = bench_run("bench", lambda: bench.run(
        model, tok, device=dev, settings=s), dims, card)
    per_batch = expect_base()
    per_batch.update(encoder_attn=dims.n_audio_layer * n_batches,
                     qkpost=dims.n_text_layer * n_batches,
                     dtw_trace=n_batches, dtw_backtrace=n_batches)
    cells = out["decode_sweep"]["cells"]
    run_cells = [c for c in cells if c.get("source") != "headline"]
    # warmup + passes for the headline and each cell, and the recompute
    batches = n_batches * (1 + s.passes) * (1 + len(run_cells)) + 1
    check(launches_match(out["launches"], per_batch),
          f"[bench] the reported pass's launches {out['launches']}")
    check(len(cells) == 3 and len(run_cells) == 2
          and log_["captures"] == log_["encodes"] == batches
          and log_["int8_steps"] > 0 and out["dtw_oracle_fid"],
          f"[bench] {len(cells)} sweep cells, {log_['captures']} captures, "
          f"{log_['encodes']} encoder runs for {batches} batches")
    check([c["flag_rate"] for c in run_cells] == [0.0, 1.0],
          f"[bench] sweep flag rates {[c['flag_rate'] for c in run_cells]}")

    for endpoint in ("align", "transcribe"):
        ss = bench_serve.Settings(n_reqs=8, clients=4, batch=BATCH,
                                  endpoint=endpoint, temperature="0")
        name = f"bench_serve {endpoint}"
        out, log_ = bench_run(name, lambda: bench_serve.run(
            model, tok, device=dev, settings=ss), dims, card)
        check(out["batcher_reqs"] >= 2 * ss.n_reqs
              and (endpoint == "transcribe" and log_["captures"] == 0
                   or log_["captures"] == out["batcher_launches"]),
              f"[{name}] {out['batcher_reqs']} requests in "
              f"{out['batcher_launches']} batches, {log_['captures']} "
              "captures")
        log(f"[{name}] peak device memory {out['peak_device_mem_gib']} GiB")

    ls = measure_latency.Settings(iters=3)
    out, log_ = bench_run("measure_latency", lambda: measure_latency.run(
        model, tok, device=dev, settings=ls), dims, card)
    check(log_["captures"] == 1 + ls.iters,
          f"[measure_latency] {log_['captures']} captures")

    ts = bench_transcribe_longform.Settings(seconds_audio=35.0, iters=1)
    out, log_ = bench_run(
        "bench_transcribe_longform", lambda: bench_transcribe_longform.run(
            model, vocab_tokenizer(dims.n_vocab), device=dev, settings=ts),
        dims, card)
    check(out["segments"] >= 1 and log_["captures"] == 0,
          f"[bench_transcribe_longform] {out['segments']} segments")

    ps = bench_probe.Settings(n_utts=BATCH, batch=BATCH, passes=1)
    heads = ps.batch * dims.n_text_head
    layers = max(1, probe_oracle.ROWS_PER_LAUNCH // heads)
    n_launch = -(-dims.n_text_layer // layers)
    out, log_ = bench_run("bench_probe", lambda: bench_probe.run(
        model, tok, device=dev, settings=ps), dims, card,
        dtw_per_capture=n_launch)
    check(out["launches"]["dtw_trace"] == n_launch
          and out["launches"]["encoder_attn"] == dims.n_audio_layer,
          f"[bench_probe] the reported pass's launches {out['launches']}")

    # the one-line contract of the full-width entry point in a process of
    # its own (the kernel library already built)
    env = dict(os.environ, WCA_BENCH_UTTS=str(N_UTTS),
               WCA_BENCH_BATCH=str(BATCH), WCA_BENCH_PASSES="1",
               WCA_BENCH_SWEEP="0")
    env.pop("WCA_PLATFORM", None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "whisper_char_alignment_tpu_torch.bench"],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
    lines = [l for l in proc.stdout.splitlines() if l.strip()]
    check(proc.returncode == 0 and len(lines) == 1,
          f"[bench subprocess] exit {proc.returncode}, {len(lines)} stdout "
          f"lines; stderr: {proc.stderr[-3000:]}")
    payload = json.loads(lines[0])
    check_payload("bench", payload)
    check(payload["graph_captures_timed"] == 0 and payload["n_utts"] == N_UTTS
          and launches_match(payload["launches"], per_batch),
          f"[bench subprocess] {lines[0]}")
    log(f"[bench subprocess] one line in {time.perf_counter() - t0:.1f} s "
        f"on {card}: {lines[0]}")
    log(f"[benchmark programs] phase done in "
        f"{time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 6: the port's profiling programs
# ---------------------------------------------------------------------------

# each program at full Whisper-medium width at a cut batch, steps and
# iterations: (module attributes, environment, argv or None). INT8_PALLAS and
# PROF_INT8 put kernel 7 on the decode-step and pipeline paths
PROFILE_RUNS = {
    "profile_decode_step": (dict(B=8, STEPS=8), dict(INT8_PALLAS="1"), None),
    "profile_guarded_decode": (dict(B=4, STEPS=8), {}, None),
    "profile_beam_decode": (dict(B=2, STEPS=8), {}, None),
    "profile_prefill": (dict(B=2, STEPS=4, PROMPT=32, ITERS=1), {}, None),
    "profile_speculative": (dict(DECODE_LEN=16, KS=[2], REPS=1), {}, None),
    "profile_encoder": (dict(B=2), {}, None),
    "profile_kernels": ({}, {}, ["--batch", "2", "--iters", "2"]),
    "profile_probe_dtw": ({}, {}, ["--iters", "2"]),
    "profile_pipeline": ({}, dict(PROF_INT8="1"),
                         ["--batch", "4", "--tokens", "32", "--decode_len",
                          "8", "--iters", "1", "--reuse"]),
    "profile_e2e_overheads": (dict(B=4, ITERS=1), {}, None),
}
# the spies' counters that the timed calls' launches follow
SPIED = ("enc_layers", "captures", "dtw", "int8_steps")


def profile_direct(name: str, dims, attrs: dict, argv) -> dict:
    """The launches a program makes in its timed calls by calling kernel
    wrappers itself, outside the functions the spies count: the
    decode-step script's own graph (kernel 7 in its two int8-pallas
    variants, 3 calls of STEPS replays each), the kernels and probe-DTW
    scripts' direct calls, and the encoder script's layers (kernel 1 in
    its five fused-attention variants, the int8 kernels 6 times a layer in
    its two int8 variants; 5 calls each)."""
    layers, text_layers = dims.n_audio_layer, dims.n_text_layer
    iters = int(argv[argv.index("--iters") + 1]) if argv else None
    if name == "profile_decode_step":
        return {"cross_attn_int8": 2 * 3 * attrs["STEPS"] * text_layers}
    if name == "profile_kernels":
        return dict.fromkeys(("mel", "mel_clip", "encoder_attn",
                              "encoder_attn_kt"), iters)
    if name == "profile_probe_dtw":
        # trace alone, trace + plain backtrace, the kernels, the chunk and
        # the bf16 chunk; the backtrace kernel in the last three
        return {"dtw_trace": 5 * iters, "dtw_backtrace": 3 * iters}
    if name == "profile_encoder":
        return {"encoder_attn": 5 * layers * 5,
                "int8_quant": 2 * 6 * layers * 5,
                "int8_dequant": 2 * 6 * layers * 5}
    return {}


@contextlib.contextmanager
def profile_spies(log_: dict, timed_log: dict):
    """:func:`bench_spies`, with each encoder run's layers counted (the
    speculative decode encodes with its draft too), and the counters'
    increments inside the programs' timed calls kept in ``timed_log``:
    ``Readings.time`` makes its warm call here, outside the counted
    window, then times as it does."""
    from whisper_char_alignment_tpu_torch.models import whisper as wm
    from whisper_char_alignment_tpu_torch.scripts import _profile

    time_ = _profile.Readings.time
    timed_log.update(dict.fromkeys(SPIED, 0))

    def spied_time(self, name, fn, iters, warm=True, **kw):
        if warm:
            fn()
        before = {k: log_[k] for k in SPIED}
        out = time_(self, name, fn, iters, warm=False, **kw)
        for k in SPIED:
            timed_log[k] += log_[k] - before[k]
        return out

    with bench_spies(log_):
        encode = wm.encode_audio
        log_["enc_layers"] = 0

        def counted(model, *a, **kw):
            log_["enc_layers"] += len(model.encoder.blocks)
            return encode(model, *a, **kw)

        with patched(wm, encode_audio=counted), \
                patched(_profile.Readings, time=spied_time):
            yield


def stripped_step_check(model, card: str) -> None:
    """``profile_decode_step.step_logits``, the all-on stripped step, equal
    to ``whisper.decode_step``'s logits bit for bit on the card, over float
    K/V and over int8 K/V in each int8 mode (the kernel's included), at
    Whisper-medium width, B=8, a position with earlier cache columns
    filled."""
    import torch

    from whisper_char_alignment_tpu_torch.models import whisper as wm
    from whisper_char_alignment_tpu_torch.scripts import profile_decode_step

    dims = model.dims
    gen = torch.Generator(device="cuda").manual_seed(3)
    xa = torch.randn((BATCH, dims.n_audio_ctx, dims.n_audio_state),
                     generator=gen, device="cuda").to(model.dtype)
    cache = wm.init_kv_cache(dims, BATCH, 40, dtype=model.dtype,
                             device="cuda")
    for t in cache.values():
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    tok = torch.randint(0, dims.n_vocab, (BATCH,), generator=gen,
                        device="cuda")
    pos = torch.tensor([20], device="cuda")
    kvs = {False: wm.precompute_cross_kv(model, xa)}
    kvs[True] = wm.precompute_cross_kv(model, xa, quantize=True)
    for impl, mode in profile_decode_step.CROSS_MODES.items():
        kv = kvs[impl != "bf16"]
        got = profile_decode_step.step_logits(model, tok, pos, cache, kv,
                                              impl)
        want, _ = wm.decode_step(model, tok[:, None], pos,
                                 {k: v.clone() for k, v in cache.items()},
                                 kv, cross_mode=mode)
        check(torch.equal(got, want),
              f"[profiling programs] the stripped step ({impl}) differs from "
              f"decode_step: max abs diff "
              f"{(got - want).abs().max().item():.3g}")
    log(f"[profiling programs] the all-on stripped step equals decode_step's "
        f"logits bit for bit on {card} (B={BATCH}, float K/V and int8 K/V "
        f"through {', '.join(profile_decode_step.CROSS_MODES.values())})")


def profile_phase(model, tok, card: str) -> None:
    """The ten profiling programs (``scripts/profile_*.py``) at
    Whisper-medium width, each ``main`` in process at a cut size
    (:data:`PROFILE_RUNS`; a program that builds a model of the smoke
    model's dims gets the smoke model), stdout captured: each must return,
    print exactly one JSON line whose readings are positive and finite,
    capture no graph in a timed call, and report launches equal to what
    its timed calls ran (:func:`profile_spies`, :func:`profile_direct`).
    Kernels 1, 2, 3a, 3b, 4, 6 and 7 must each launch in the phase. Then
    the decode-step script's stripped step against ``decode_step``."""
    import importlib
    import io

    import torch

    from whisper_char_alignment_tpu_torch import bench
    from whisper_char_alignment_tpu_torch.ops import _lib

    t_phase = time.perf_counter()
    dims = model.dims
    seen = dict.fromkeys(_lib.LAUNCHES, 0)

    def build(d, device):
        return model if d == dims else bench.build_model(d, device)

    for name, (attrs, env, argv) in PROFILE_RUNS.items():
        mod = importlib.import_module(
            f"whisper_char_alignment_tpu_torch.scripts.{name}")
        log_, timed_log = {}, {}
        out = io.StringIO()
        builder = ({"build_model": build} if hasattr(mod, "build_model")
                   else {})
        t0 = time.perf_counter()
        with profile_spies(log_, timed_log), patched(mod, **attrs, **builder), \
                environ(WCA_CROSS_ATTN="auto", **env), \
                contextlib.redirect_stdout(out):
            _lib.reset_launches()
            mod.main(argv) if argv is not None else mod.main()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        lines = [l for l in out.getvalue().splitlines() if l.strip()]
        check(len(lines) == 1, f"[{name}] {len(lines)} stdout lines")
        payload = json.loads(lines[0])
        readings = payload["readings"]
        check(readings and all(isinstance(v, (int, float)) and math.isfinite(v)
                               and v > 0 for v in readings.values()),
              f"[{name}] readings {readings}")
        check(payload["graph_captures_timed"] == 0,
              f"[{name}] {payload['graph_captures_timed']} graphs captured "
              "in timed calls")
        expect = expect_base()
        expect.update(encoder_attn=timed_log["enc_layers"],
                      qkpost=dims.n_text_layer * timed_log["captures"],
                      dtw_trace=timed_log["dtw"],
                      dtw_backtrace=timed_log["dtw"],
                      cross_attn_int8=dims.n_text_layer
                      * timed_log["int8_steps"])
        for k, v in profile_direct(name, dims, attrs, argv).items():
            expect[k] += v
        log(f"[{name}] timed launches {payload['launches']} (expected "
            f"{expect}; timed: {timed_log})")
        check(launches_match(payload["launches"], expect),
              f"[{name}] launch counts differ from the timed calls' path")
        for k, v in payload["launches"].items():
            seen[k] += v
        log(f"[{name}] on {card} in {seconds:.1f} s: {lines[0]}")
    wanted = ("encoder_attn", "encoder_attn_kt", "qkpost", "dtw_trace",
              "dtw_backtrace", "mel", "mel_clip", "cross_attn_int8")
    check(all(seen[k] > 0 for k in wanted),
          f"[profiling programs] a kernel never launched: {seen}")
    stripped_step_check(model, card)
    log(f"[profiling programs] phase done in "
        f"{time.perf_counter() - t_phase:.1f} s; timed launches {seen}")


def main_path_phase(card: str):
    import torch

    from whisper_char_alignment_tpu_torch.config import (MODEL_DIMS,
                                                         AlignConfig)
    from whisper_char_alignment_tpu_torch.data.dataset import TIMIT
    from whisper_char_alignment_tpu_torch.data.synthetic import make_timit_corpus
    from whisper_char_alignment_tpu_torch.models import decoding
    from whisper_char_alignment_tpu_torch.models import whisper as wm
    from whisper_char_alignment_tpu_torch.ops import _lib
    from whisper_char_alignment_tpu_torch.runner import AlignmentPipeline
    from whisper_char_alignment_tpu_torch.text.tokenizer import \
        get_test_tokenizer

    log(f"tiny model, card vs CPU: {tiny_vs_cpu()}")

    dims = MODEL_DIMS["medium"]
    tok = get_test_tokenizer()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = wm.init_params(wm.Whisper(dims, device="cuda",
                                      dtype=torch.bfloat16), gen)
    torch.cuda.synchronize()
    log(f"medium model ({sum(p.numel() for p in model.parameters()) / 1e6:.0f}M"
        f" params, bf16) built in {time.perf_counter() - t0:.1f} s")
    n_batches = -(-N_UTTS // BATCH)

    def expected(**extra):
        def fn(seen):
            out = expect_base()
            out.update(encoder_attn=dims.n_audio_layer * n_batches,
                       qkpost=dims.n_text_layer * n_batches,
                       dtw_trace=n_batches, dtw_backtrace=n_batches)
            out.update(decoder_launches(dims, seen))
            out.update({k: v(seen) for k, v in extra.items()})
            return out
        return fn

    def pipeline(**over):
        cfg = AlignConfig.recommended(model="medium", batch_size=BATCH,
                                      use_gt_transcript=True, **over)
        pipe = AlignmentPipeline(model, tok, cfg,
                                 compute_dtype=torch.bfloat16)
        pipe.options = decoding.DecodingOptions(language="en",
                                                sample_len=DECODE_LEN)
        return pipe

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke_corpus_",
                                     dir=os.path.join(HERE, "build")) as d:
        scp = make_timit_corpus(d, n_utts=N_UTTS, seconds=(2.0, 7.0),
                                words_per_utt=(6, 10), seed=0)
        dataset = TIMIT(scp)
        default_pipe = pipeline()
        counts, seen = drive("default", default_pipe, dataset, expected(),
                             card)
        check(seen["int8_steps"] == 0 and seen["reused"] == n_batches,
              "[default] the capture pass did not reuse the decode K/V")
        counts_int8 = int8_encoder_phase(default_pipe, seen["stages"],
                                         pipeline, dataset, expected, card)

        with environ(WCA_CROSS_ATTN="pallas", WCA_MEL_IMPL="pallas"):
            quant = expected(
                mel=lambda seen: n_batches,
                mel_clip=lambda seen: n_batches,
                cross_attn_int8=lambda seen: dims.n_text_layer
                * seen["int8_steps"])
            quant_pipe = pipeline(decode_kv_int8=True,
                                  decode_frame_bucket=128)
            counts2, seen2 = drive("int8+bucket", quant_pipe, dataset, quant,
                                   card)
            check(seen2["int8_steps"] > 0 and seen2["float_steps"] == 0
                  and all(f % 128 == 0 and f < dims.n_audio_ctx
                          for f in seen2["frames"]),
                  "[int8+bucket] the decode did not take bucketed int8 K/V")
            check(seen2["reused"] == 0 and seen2["capture_passes"] == n_batches,
                  "[int8+bucket] the capture pass reused int8/bucketed K/V")
            cross_mode_phase(quant_pipe, dataset, card)
            guarded_phase(model, tok, dataset, card)
        graph_phase(model, tok, dataset, card)
        depth_phase(model, tok, dataset, card)
        # the decoding modes on the main path: the capture pass recomputes
        # the cross K/V, which beam search and sampling do not return
        mode_counts = {}
        for label, extra in (("beam 5", dict(beam_size=5)),
                             ("sampling 0.7 x 5",
                              dict(temperature=0.7, best_of=5))):
            pipe = pipeline()
            pipe.options = decoding.DecodingOptions(
                language="en", sample_len=DECODE_LEN, **extra)
            mode_counts[label], seen_m = drive(label, pipe, dataset,
                                               expected(), card)
            check(seen_m["reused"] == 0 and seen_m["float_steps"] == 0
                  and seen_m["capture_passes"] == n_batches,
                  f"[{label}] the capture pass did not recompute the K/V")
        modes_phase(model, tok, dataset, card)
        speculative_phase(model, tok, dataset, card)
        rows_phase(model, tok, card)
        cli_counts, recipe = cli_phase(model, tok, scp, len(dataset), card)
        checkpoint_phase(model, tok, dataset, scp, recipe, seen, card)
    cli_counts["probe"] = probe_phase(model, tok, card)
    log(f"tiny model CLI, card vs CPU: {tiny_cli_phase()}")
    cli_counts["long_form"] = long_form_phases(model, tok, card)
    bench_phase(model, tok, card)
    profile_phase(model, tok, card)
    return counts, counts2, counts_int8, cli_counts, seen["dtw_inputs"]


def int8_encoder_phase(default_pipe, default_stages, pipeline, dataset,
                       expected, card: str) -> dict:
    """The main path with the int8 encoder (``encoder_int8``): 16/16
    aligned, DTW equal to the NumPy oracle, and exactly 6 launches of each
    int8 kernel per encoder layer and run (q, k and v quantize the same
    rows separately, as JAX does). The encoder stage beside the bf16 run's,
    and the int8 encoder states' error against the bf16 ones on one
    batch."""
    from whisper_char_alignment_tpu_torch.config import MODEL_DIMS
    from whisper_char_alignment_tpu_torch.models import whisper as wm

    dims = MODEL_DIMS["medium"]
    runs = -(-len(dataset) // BATCH)
    per_run = 6 * dims.n_audio_layer
    pipe = pipeline(encoder_int8=True)
    check(wm.encoder_is_int8(pipe.model), "[int8 encoder] not quantized")
    counts, seen = drive("int8 encoder", pipe, dataset, expected(
        int8_quant=lambda seen: per_run * runs,
        int8_dequant=lambda seen: per_run * runs), card)
    # each run's own stages (the oracle's batch after it is not counted)
    bf16_s = default_stages["encoder"]
    int8_s = seen["stages"]["encoder"]
    log(f"[int8 encoder] encoder stage {int8_s:.4f} s against bf16 "
        f"{bf16_s:.4f} s per {len(dataset)} utterances ({int8_s / bf16_s:.3f}"
        f"x) on {card}")
    batch = [dataset[i] for i in range(BATCH)]
    xa = default_pipe.transcribe_batch(batch)[2].float()
    xa8 = pipe.transcribe_batch(batch)[2].float()
    diff = (xa8 - xa).abs()
    big, mean = diff.max().item(), diff.mean().item()
    log(f"[int8 encoder] states against bf16: max abs diff {big:.4g} "
        f"({big / xa.abs().max().item():.4g} of the largest state), mean "
        f"{mean:.4g} ({mean / xa.abs().mean().item():.4g} of the mean)")
    return counts


MESH_UTTS = 8
# (label, (n_data, n_model), compute dtype, AlignConfig overrides): f32
# runs are held equal to one process, bf16 ones logged, the int8 run's
# encoder states held bit-equal to one rank's
MESH_RUNS = (("tp2 f32", (1, 2), "float32", {}),
             ("dp2 f32", (2, 1), "float32", {}),
             ("tp2 bf16", (1, 2), "bfloat16", {}),
             ("dp2 bf16", (2, 1), "bfloat16", {}),
             ("int8 tp2 bf16", (1, 2), "bfloat16", dict(encoder_int8=True)))


def mesh_pipeline(model, tok, dtype: str, mesh=None, **over):
    import torch

    from whisper_char_alignment_tpu_torch.config import AlignConfig
    from whisper_char_alignment_tpu_torch.models import decoding
    from whisper_char_alignment_tpu_torch.runner import AlignmentPipeline

    cfg = AlignConfig.recommended(model="medium", batch_size=BATCH,
                                  use_gt_transcript=True, **over)
    pipe = AlignmentPipeline(model, tok, cfg, mesh=mesh, device=model.device,
                             compute_dtype=getattr(torch, dtype))
    pipe.options = decoding.DecodingOptions(language="en",
                                            sample_len=DECODE_LEN)
    return pipe


def mesh_run(pipe, scp: str) -> dict:
    """One ``run_dataset`` with the launch counts and the graph runner's
    record from just before to just after."""
    import torch

    from whisper_char_alignment_tpu_torch.data.dataset import TIMIT
    from whisper_char_alignment_tpu_torch.models import decode_graph
    from whisper_char_alignment_tpu_torch.ops import _lib

    sync = (torch.cuda.synchronize if pipe.device.type == "cuda"
            else lambda: None)
    _lib.reset_launches()
    replays = decode_graph.replay_record()["replays"]
    sync()
    t0 = time.perf_counter()
    results = list(pipe.run_dataset(TIMIT(scp), progress=False))
    sync()
    return dict(results=[(r.fid, r.words, r.start_times, r.end_times)
                         for r in results],
                wall=time.perf_counter() - t0, counts=_lib.launch_counts(),
                replays=decode_graph.replay_record()["replays"] - replays,
                stages={k: round(v, 4) for k, v in pipe.stage_seconds.items()})


def mesh_worker(rank: int, world: int, init: str, job_path: str) -> int:
    """One gloo rank of the mesh phase on the named card ``cuda:0``: every
    run of ``MESH_RUNS`` on the medium model of seed 0, its results, launch
    counts, graph replays, wall and stages (and the int8 run's encoder
    states of the job's mel) pickled for the parent."""
    import torch

    from whisper_char_alignment_tpu_torch.config import MODEL_DIMS
    from whisper_char_alignment_tpu_torch.models import whisper as wm
    from whisper_char_alignment_tpu_torch.parallel import distributed
    from whisper_char_alignment_tpu_torch.parallel.mesh import make_mesh
    from whisper_char_alignment_tpu_torch.text.tokenizer import \
        get_test_tokenizer

    with open(job_path, "rb") as f:
        job = pickle.load(f)
    distributed.initialize(init, world, rank, backend="gloo")
    try:
        dev = torch.device(job["device"])
        model = wm.init_params(
            wm.Whisper(MODEL_DIMS[job["model"]], device=dev,
                       dtype=torch.bfloat16),
            torch.Generator(device=dev).manual_seed(0))
        out = {}
        for label, (n_data, n_model), dtype, over in MESH_RUNS:
            mesh = make_mesh(n_data, n_model, device=dev)
            pipe = mesh_pipeline(model, get_test_tokenizer(), dtype, mesh,
                                 **over)
            out[label] = mesh_run(pipe, job["scp"])
            out[label]["place"] = (mesh.data_index, mesh.model_index)
            if over.get("encoder_int8"):
                out[label]["states"] = wm.encode_audio(
                    pipe.model, job["mel"].to(dev), device=dev.type).cpu()
            del pipe
        with open(f"{job['out']}.{rank}", "wb") as f:
            pickle.dump(out, f)
    finally:
        distributed.shutdown()
    return 0


def mesh_phase(card: str, device: str = "cuda:0",
               model_name: str = "medium") -> None:
    """Two gloo ranks on the one card (device named ``cuda:0``), medium
    width, 8 utterances, ground-truth transcripts: tensor parallelism over
    2 ranks and data parallelism over 2, in float32 compute, give the
    one-process run's words and boundaries (bf16 logged); the int8 encoder
    under a model axis of 2 gives encoder states bit-equal to one rank's;
    each rank's launch counts are exact; a model axis runs the decode
    eagerly, a data axis replays its graphs. The kernels are already built
    (phase 1), so the ranks load the library and run no nvcc. Gloo on one
    card checks function only: its times say nothing of NCCL on several."""
    import numpy as np
    import torch

    from whisper_char_alignment_tpu_torch.config import MODEL_DIMS
    from whisper_char_alignment_tpu_torch.data.dataset import TIMIT
    from whisper_char_alignment_tpu_torch.data.synthetic import make_timit_corpus
    from whisper_char_alignment_tpu_torch.models import whisper as wm
    from whisper_char_alignment_tpu_torch.ops import _lib
    from whisper_char_alignment_tpu_torch.text.tokenizer import \
        get_test_tokenizer

    t_phase = time.perf_counter()
    dims = MODEL_DIMS[model_name]
    tok = get_test_tokenizer()
    dev = torch.device(device)
    check(dev.type == "cpu" or _lib.build_info.get("path") is not None,
          "kernels not built")
    model = wm.init_params(wm.Whisper(dims, device=dev, dtype=torch.bfloat16),
                           torch.Generator(device=dev).manual_seed(0))
    with tempfile.TemporaryDirectory(prefix="smoke_corpus_mesh_",
                                     dir=os.path.join(HERE, "build")) as d:
        scp = make_timit_corpus(os.path.join(d, "corpus"), n_utts=MESH_UTTS,
                                seconds=(2.0, 7.0), words_per_utt=(6, 10),
                                seed=1)
        int8_one = mesh_pipeline(model, tok, "bfloat16", encoder_int8=True)
        ds = TIMIT(scp)
        mel = int8_one.transcribe_batch([ds[i] for i in range(len(ds))])[1]
        mel = mel.cpu()
        job = dict(scp=scp, mel=mel, out=os.path.join(d, "rank"),
                   device=device, model=model_name)
        job_path = os.path.join(d, "job.pkl")
        with open(job_path, "wb") as f:
            pickle.dump(job, f)
        init = "file://" + os.path.join(d, "rendezvous")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-worker",
             str(r), "2", init, job_path]) for r in range(2)]
        try:
            # the one-process runs meanwhile, on the same card
            one = {}
            for label, _, dtype, over in MESH_RUNS:
                key = (dtype, bool(over))
                if key not in one:
                    pipe = mesh_pipeline(model, tok, dtype, **over)
                    one[key] = mesh_run(pipe, scp)
                    del pipe
            states = wm.encode_audio(int8_one.model, mel.to(dev),
                                     device=dev.type).cpu()
            for p in procs:
                p.wait(timeout=600)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        check(all(p.returncode == 0 for p in procs),
              f"mesh ranks exited with {[p.returncode for p in procs]}")
        ranks = []
        for r in range(2):
            with open(f"{job['out']}.{r}", "rb") as f:
                ranks.append(pickle.load(f))

    def same(a, b) -> int:
        """How many of the results differ (fid order, words, times)."""
        check(len(a) == len(b) == MESH_UTTS, f"{len(a)}, {len(b)} results")
        return sum(not (x[0] == y[0] and x[1] == y[1]
                        and np.array_equal(x[2], y[2])
                        and np.array_equal(x[3], y[3])) for x, y in zip(a, b))

    def expected(int8: bool) -> dict:
        if dev.type == "cpu":  # a rehearsal: plain versions, no graphs
            return dict.fromkeys(_lib.LAUNCHES, 0)
        out = expect_base()
        out.update(encoder_attn=dims.n_audio_layer, qkpost=dims.n_text_layer,
                   dtw_trace=1, dtw_backtrace=1)
        if int8:
            out.update(int8_quant=6 * dims.n_audio_layer,
                       int8_dequant=6 * dims.n_audio_layer)
        return out

    for key, run in one.items():
        log(f"[mesh] one process {key[0]}{' int8' if key[1] else ''}: "
            f"{run['wall']:.3f} s, stages {json.dumps(run['stages'])}")
    for label, (n_data, n_model), dtype, over in MESH_RUNS:
        ref = one[(dtype, bool(over))]
        for r, out in enumerate(ranks):
            run = out[label]
            n_diff = same(run["results"], ref["results"])
            log(f"[mesh] {label} rank {r} (data {run['place'][0]}, model "
                f"{run['place'][1]}), gloo, one card: {run['wall']:.3f} s, "
                f"{run['replays']} graph replays, stages "
                f"{json.dumps(run['stages'])}; {MESH_UTTS - n_diff}/"
                f"{MESH_UTTS} results equal to one process's")
            check(launches_match(run["counts"], expected(bool(over))),
                  f"[mesh] {label} rank {r}: launch counts {run['counts']}")
            check(dev.type == "cpu" or (run["replays"] == 0) == (n_model > 1),
                  f"[mesh] {label} rank {r}: {run['replays']} graph replays")
            if dtype == "float32":
                check(n_diff == 0, f"[mesh] {label} rank {r}: {n_diff} "
                      "results differ from one process's")
            if "states" in run:
                check(torch.equal(run["states"], states),
                      f"[mesh] {label} rank {r}: encoder states not "
                      "bit-equal to one rank's")
                log(f"[mesh] {label} rank {r}: int8 encoder states bit-equal"
                    " to one rank's")
    log(f"[mesh] phase done in {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 8: the asset-day programs
# ---------------------------------------------------------------------------

ASSET_UTTS = 16
# the keys of calibrate()'s dict: the JAX script's line but ``source``
# (its main adds that from its flags), and the three the port adds
CALIBRATE_KEYS = {"metric", "mode", "recommended_guard_margin", "basis",
                  "n_utts", "flip_rate_unguarded", "predicted_flag_rate",
                  "predicted_flag_rate_at_default", "margin_percentiles",
                  "deployable_hint", "cross_attn", "device", "launches"}
# verify_kernels_on_device's launches: kernel 1 in the medium encoder's 24
# layers, kernel 2 at widths 3 and 7, kernel 7 on two softmaxes, one DTW
# call, one log-mel call
VERIFY_LAUNCHES = {"encoder_attn": 24, "qkpost": 2, "cross_attn_int8": 2,
                   "dtw_trace": 1, "dtw_backtrace": 1, "mel": 1,
                   "mel_clip": 1}
# the runbook's gates the phase runs through asset_gates (gate 1's command
# runs as a process of its own beside it; gate 7 needs openai-whisper)
RUNBOOK_GATES = ("2 TIMIT F1@50ms (recommended recipe)",
                 "2b eval_ali re-score of gate 2's pkl at 0.1s",
                 "3 TIMIT subword/mean recipe",
                 "4 LibriSpeech vs Kaldi alignments", "5 probe_oracle sweep",
                 "6 default whisper timing baseline")


def child_env(device: str) -> dict:
    """The environment of a program the phase starts: on the card unless
    the phase runs on the CPU, no operator's assets."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("WCA_PLATFORM", "WCA_CHECKPOINT", "WCA_TOKENIZER_DIR")}
    if device == "cpu":
        env["WCA_PLATFORM"] = "cpu"
    return env


def calibration_part(card: str, dims, device: str, work: str) -> None:
    """``calibrate_kv_guard`` through the real asset path: a bf16 ``.pt`` of
    ``dims`` and a tokenizer directory (``make_assets``), read back by the
    CLI loader and cast to bf16 as the program's real path does; then
    ``calibrate`` on 16 synthetic utterances at batch 8, decode_len 32,
    ``--mode int8`` and ``--mode both``, each with exact launch counts
    (kernel 1 a layer per encoder run, kernel 7 a decoder layer per int8
    step the graph runner replayed or warmed up), its keys and n_utts.
    The guard's promise after the int8 run: ``decode`` with
    ``kv_int8_guard`` at the recommended margin gives every utterance the
    exact decode's tokens (skipped, and logged, where the largest flipped
    margin is 0: a tie no bound catches)."""
    import argparse

    import torch

    from whisper_char_alignment_tpu_torch.cli import common
    from whisper_char_alignment_tpu_torch.data.dataset import TIMIT
    from whisper_char_alignment_tpu_torch.data.synthetic import \
        make_timit_corpus
    from whisper_char_alignment_tpu_torch.models import decoding
    from whisper_char_alignment_tpu_torch.models import whisper as wm
    from whisper_char_alignment_tpu_torch.ops import _lib
    from whisper_char_alignment_tpu_torch.scripts import \
        calibrate_kv_guard as cal
    from whisper_char_alignment_tpu_torch.scripts import rehearse_asset_day

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    assets = rehearse_asset_day.make_assets(
        os.path.join(work, "assets"), dims, seed=0, formats=("pt",),
        dtype=torch.bfloat16, device=dev)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ns = argparse.Namespace(model="medium", test_model=False,
                            checkpoint=assets["pt"],
                            tokenizer_dir=assets["tokenizer_dir"])
    model, tok = common.load_model_and_tokenizer(ns, dev)
    model = wm.cast_params(model, torch.bfloat16)
    sync()
    load_s = time.perf_counter() - t0
    log(f"[asset day] the .pt (width {dims.n_audio_state}, bf16, toy "
        f"vocabulary, "
        f"{os.path.getsize(assets['pt']) / 1e9:.3f} GB) written in "
        f"{write_s:.2f} s, read by the CLI loader in {load_s:.2f} s")
    check(tok.n_vocab == model.dims.n_vocab == dims.n_vocab,
          f"[asset day] tokenizer {tok.n_vocab} ids, model "
          f"{model.dims.n_vocab}")
    dataset = TIMIT(make_timit_corpus(os.path.join(work, "corpus"),
                                      n_utts=ASSET_UTTS, seconds=(2.0, 5.0)))
    measured = []
    measure = cal.measure

    def kept_measure(*a, **kw):
        measured.append(measure(*a, **kw))
        return measured[-1]

    for mode in ("int8", "both"):
        log_ = {}
        _lib.reset_launches()
        sync()
        t0 = time.perf_counter()
        with bench_spies(log_), patched(cal, measure=kept_measure), \
                environ(WCA_CROSS_ATTN="auto"):
            line = cal.calibrate(model, tok, dataset, mode=mode,
                                 batch_size=BATCH, decode_len=DECODE_LEN)
        sync()
        wall = time.perf_counter() - t0
        expect = bench_expected(dims, log_)
        if dev.type == "cpu":  # a rehearsal: plain versions only
            expect = dict.fromkeys(expect, 0)
        log(f"[asset day] calibrate --mode {mode}: launches "
            f"{line['launches']} (expected {expect}; {log_['encodes']} "
            f"encoder runs, {log_['int8_steps']} int8 decode steps)")
        check(launches_match(line["launches"], expect)
              and line["launches"] == _lib.launch_counts(),
              f"[asset day] calibrate --mode {mode}: launch counts differ "
              "from the path's")
        # (the CPU runs the eager loop, which the graph runner's record
        # does not see)
        check((log_["int8_steps"] > 0 or dev.type == "cpu")
              and log_["encodes"] == 2,
              f"[asset day] calibrate --mode {mode}: {log_}")
        missing = CALIBRATE_KEYS - set(line)
        check(not missing, f"[asset day] calibrate lacks {sorted(missing)}")
        check(line["n_utts"] == ASSET_UTTS and line["mode"] == mode,
              f"[asset day] calibrate: {line['n_utts']} utterances")
        check(line["cross_attn"] == ("kernel" if dev.type == "cuda"
                                     else "xla"),
              f"[asset day] the int8 pass ran {line['cross_attn']}")
        flipped = [m for m, f in zip(measured[-1].margins,
                                     measured[-1].flipped) if f]
        log(f"[asset day] calibrate --mode {mode} on {card}, width "
            f"{dims.n_audio_state}, {dims.n_audio_layer} + "
            f"{dims.n_text_layer} layers, {ASSET_UTTS} utterances at batch "
            f"{BATCH}, {DECODE_LEN} steps, bf16, in {wall:.2f} s: flip rate "
            f"{line['flip_rate_unguarded']}, recommended margin "
            f"{line['recommended_guard_margin']} ({line['basis']}; largest "
            f"flipped margin {max(flipped, default=None)}), predicted flag "
            f"rate {line['predicted_flag_rate']} (at the default "
            f"{line['predicted_flag_rate_at_default']}), margin percentiles "
            f"{line['margin_percentiles']}")
        if mode != "int8":
            continue
        if flipped and max(flipped) <= 0.0:
            log("[asset day] the largest flipped margin is 0: a tie no bound"
                " catches; the guard's promise is not checked")
            continue
        bound = line["recommended_guard_margin"]
        opts = cal.options(DECODE_LEN)
        n_held = 0
        with environ(WCA_CROSS_ATTN="auto"):
            for _, n_live, mel in cal.padded_batches(model, dataset, BATCH):
                exact = decoding.decode(model, tok, mel, opts, device=dev)
                guarded = decoding.decode(model, tok, mel, opts, device=dev,
                                          kv_int8=True, kv_int8_guard=bound)
                n_held += sum(e.tokens == g.tokens for e, g in
                              zip(exact[:n_live], guarded[:n_live]))
        check(n_held == ASSET_UTTS, f"[asset day] the guard at {bound} gave "
              f"{ASSET_UTTS - n_held} utterances other tokens than the exact "
              "decode")
        log(f"[asset day] the guard at the recommended {bound} gives all "
            f"{ASSET_UTTS} utterances the exact decode's tokens")


def verify_part(out: str, rc: int) -> None:
    """``verify_kernels_on_device``'s output: exit 0, one PASS line a check
    (two widths of kernel 2, kernel 7 and the ``mxu`` step on two
    softmaxes), no FAIL, and a last line with the launches of kernels 1,
    2, 3a, 3b, 6 and 7 the checks made."""
    from whisper_char_alignment_tpu_torch.ops import _lib

    lines = out.splitlines()
    for line in lines:
        log(f"[asset day] verify: {line}")
    check(rc == 0, f"[asset day] verify_kernels_on_device exited {rc}")
    check(sum(l.startswith("PASS  ") for l in lines) == 10
          and not any(l.startswith("FAIL") for l in lines),
          "[asset day] verify_kernels_on_device: PASS/FAIL lines")
    payload = json.loads(lines[-1])
    expect = dict.fromkeys(_lib.LAUNCHES, 0)
    if payload["device"] != "cpu":  # its prefill check runs the decoder
        expect = expect_base()
        expect.update(VERIFY_LAUNCHES)
    check(launches_match(payload["launches"], expect),
          f"[asset day] verify launches {payload['launches']}, expected "
          f"{expect}")


def runbook_part(board_path: str, rc: int) -> None:
    """``asset_gates --rehearse --only 2,2b,3,4,5,6``: exit 0, and rc 0 and a
    metrics dict for each of the six gates in its artifact."""
    check(rc == 0, f"[asset day] asset_gates exited {rc}")
    with open(board_path) as f:
        board = json.load(f)
    for gate in RUNBOOK_GATES:
        check(board.get(gate, {}).get("rc") == 0
              and board[gate].get("metrics"),
              f"[asset day] gate {gate}: {board.get(gate)}")
        log(f"[asset day] gate {gate}: {json.dumps(board[gate]['metrics'])}")


def twin_part(out: str, rc: int) -> None:
    """``rehearse_asset_day`` (the runbook's gate 1): the port's chain on
    the card against the HF twin on the CPU, both on real-format files of
    one random tiny model: exit 0, both utterances matched (zero word
    mismatches, boundaries within 20 ms)."""
    for line in out.splitlines():
        if line.startswith(("format parity", "utt ", "rehearsal:", "FAIL")):
            log(f"[asset day] twin: {line}")
    check(rc == 0 and "rehearsal: 2/2 utterances matched" in out,
          f"[asset day] rehearse_asset_day exited {rc}")


def asset_day_phase(card: str, dims=None, device: str = "cuda") -> None:
    """The asset-day programs on the card: the guard calibration in process
    at Whisper-medium width (:func:`calibration_part`), then, side by side
    in their own processes, ``verify_kernels_on_device`` at its JAX sizes
    (:func:`verify_part`), the runbook's rehearsal of gates 2, 2b, 3, 4, 5
    and 6, each gate a process of the port on the card
    (:func:`runbook_part`), and gate 1's command, ``rehearse_asset_day``
    (:func:`twin_part`), where ``transformers`` and ``safetensors`` import.
    Gate 7 needs ``openai-whisper``; ``parity_vs_reference`` and
    ``measure_cpu_baseline`` are held by the tests on the CPU."""
    import importlib.util

    from whisper_char_alignment_tpu_torch.scripts import rehearse_asset_day

    t_phase = time.perf_counter()
    dims = dims or rehearse_asset_day.rehearsal_dims(medium=True)
    absent = [p for p in ("transformers", "safetensors", "whisper")
              if importlib.util.find_spec(p) is None]
    twin = not {"transformers", "safetensors"} & set(absent)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke_asset_day_",
                                     dir=os.path.join(HERE, "build")) as d:
        calibration_part(card, dims, device, d)
        t0 = time.perf_counter()
        board = os.path.join(d, "board.json")
        package = "whisper_char_alignment_tpu_torch.scripts"
        commands = {
            "verify": [f"{package}.verify_kernels_on_device"],
            "runbook": [f"{package}.asset_gates", "--rehearse", "--only",
                        "2,2b,3,4,5,6", "--rehearse_dir",
                        os.path.join(d, "gates"), "--artifact", board]}
        if twin:
            commands["twin"] = [f"{package}.rehearse_asset_day", "--out_dir",
                                os.path.join(d, "twin")]
        procs = {k: subprocess.Popen(
            [sys.executable, "-m", *argv], cwd=HERE, env=child_env(device),
            stdout=subprocess.PIPE, text=True,
            stderr=subprocess.STDOUT if k == "twin" else None)
            for k, argv in commands.items()}
        try:
            outs = {k: p.communicate(timeout=600)[0]
                    for k, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        verify_part(outs["verify"], procs["verify"].returncode)
        for line in outs["runbook"].splitlines():
            if line.startswith(("$ ", "=== ")):
                log(f"[asset day] runbook: {line}")
        runbook_part(board, procs["runbook"].returncode)
        if twin:
            twin_part(outs["twin"], procs["twin"].returncode)
        log(f"[asset day] {', '.join(commands)} side by side on {card} in "
            f"{time.perf_counter() - t0:.1f} s")
    log(f"[asset day] packages absent here: {absent or 'none'}; "
        f"{'gate 1 (the HF twin) ran as its own process; ' if twin else ''}"
        f"not run: {'' if twin else 'gate 1 (needs transformers and safetensors), '}"
        "gate 7 (needs openai-whisper and the reference repository)")
    log(f"[asset day] phase done in {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.path.insert(0, HERE)
        return mesh_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                           sys.argv[5])
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable ({e})", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        from whisper_char_alignment_tpu_torch.ops import _lib
        from whisper_char_alignment_tpu_torch.utils.device import \
            resolve_device
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})",
              file=sys.stderr)
        return 1
    resolve_device(None)  # real f32: no TF32 in matmuls or convolutions

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = (smi.stdout.strip().splitlines()[0] if smi.returncode == 0
            else f"nvidia-smi failed: {smi.stderr.strip()}")
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _lib.library()
    log(f"kernel library built in {time.perf_counter() - t0:.1f} s "
        f"({_lib.build_info.get('path')})")
    for line in str(_lib.build_info.get("log", "")).splitlines():
        if any(w in line for w in ("registers", "==", "spill",
                                   "Function properties")):
            log(f"  {line.strip()}")

    rows = kernel_phase()
    counts, counts2, counts_int8, cli_counts, dtw_inputs = main_path_phase(
        card)
    check(dtw_inputs is not None, "the default main path ran no DTW")
    dtw_main_shape(dtw_inputs)
    mesh_phase(card)
    asset_day_phase(card)
    # each row's launches come from the run whose path holds its kernel: the
    # default run, the int8 + bucket run for the mel and cross-attention
    # kernels, the CLI's width-17 run for the QK post-process at 17, its
    # default-timing run (width 33) for the padded windows, the graphed
    # long-form run (width 7) and the /align request at width 101; row 5 is
    # row 3a's kernel
    for name, row in rows.items():
        run, counter = counts, name
        if name.startswith(("mel", "cross_attn")):
            run = counts2
        elif name.startswith("int8"):
            run = counts_int8
        elif name == "dtw_trace_batch":
            counter = "dtw_trace"
        elif name in ("qkpost_w17", "qkpost_rank"):
            counter = "qkpost" if name == "qkpost_w17" else name
            run = cli_counts[counter]
        elif name in ("qkpost_w7", "qkpost_w101"):
            run = cli_counts["long_form"]
        row["launches"] = run[counter]
    # ms_method: "trace" (the kernel's traced device time) or "events" (the
    # whole call by CUDA events, where three traces held no record of it)
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "ms_method", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_ms_method"]
    print(json.dumps({"kernels": [{k: r.get(k) for k in keys}
                                  for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
