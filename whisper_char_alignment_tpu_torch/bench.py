"""Headline benchmark of the port: end-to-end corpus alignment throughput,
utts/sec on one GPU (port of the repository's root ``bench.py``).

    python -m whisper_char_alignment_tpu_torch.bench           # on the card
    WCA_PLATFORM=cpu WCA_BENCH_TINY=1 python -m whisper_char_alignment_tpu_torch.bench

Drives the production path (``runner.AlignmentPipeline``, the code behind
``cli/infer_ali``) over a synthetic TIMIT-style corpus written at start:
host WAV decode -> batched log-mel -> the encoder -> the greedy decode (a
replayed CUDA graph) -> host punctuation normalization and char
re-tokenization -> the teacher-forced capture with the QK post-process in
each layer -> top-10 head selection -> batched DTW -> word times.
Whisper-medium shapes by default, random bf16 weights from a
``torch.Generator`` seeded 0 (the run time does not depend on the weights),
the README recipe (char units, topk=10, medfilt 3), the ground-truth
transcript aligned (with random weights the decoded one is one garbage
word; the decode still runs and is timed).

Prints ONE JSON line to stdout, the JAX script's keys (``metric``,
``value``, ``unit``, ``vs_baseline``, the run's configuration, ``mfu``,
``decode_sweep``, ``stage_split_s``, ``best_pass_wall_s``) plus
``device`` (the card's name and power limit as ``nvidia-smi`` gives them,
or ``"cpu"``), ``launches`` (the kernel launches of the reported pass,
``ops/_lib``) and ``graph_captures_timed`` (decode graphs captured inside
timed passes; 0 when every warmup captured what its passes replay).
Everything else goes to stderr.

- ``mfu``: analytic matmul FLOPs per utterance (``utils/flops.py``, at the
  padded shapes each batch ran) x measured throughput / the card's bf16
  peak.
- ``decode_sweep``: measured exact-vs-guarded decode rates at transcript
  lengths 32 and 224. ``guarded_track`` is the guards' best case (margin 0:
  tracking only, nothing flagged), ``guarded_redecode`` the worst (margin
  inf: every utterance re-decoded exactly); a deployment lands at track +
  flag_rate x (redecode - track). Each cell also carries its own
  ``launches``, ``graph_captures_timed`` and ``peak_device_mem_gib``.
- ``stage_split_s``: device seconds by stage of the reported pass
  (``utils/profiling.StageTimers``: CUDA events, read after the pass's
  closing synchronize).
- ``vs_baseline``: null unless ``WCA_BENCH_BASELINE`` (utts/sec) is set.
  The JAX script's default denominator is a model of a CPU reference built
  on another host, which says nothing about this card.

Runs on ``cuda`` unless ``WCA_PLATFORM=cpu``; without a card it exits
non-zero and prints no JSON line.

Knobs (env, the JAX script's names and defaults): WCA_BENCH_UTTS (96),
WCA_BENCH_BATCH (16), WCA_BENCH_DECODE_LEN (32: a real transcript's length;
random weights never emit eot), WCA_BENCH_PASSES (3), WCA_BENCH_SWEEP (1),
WCA_BENCH_SWEEP_LENS ("32,224"), WCA_BENCH_SWEEP_BUCKET (128),
WCA_BENCH_SWEEP_PASSES (2), WCA_BENCH_BUCKET (0), WCA_BENCH_BUCKET_GUARDED
(0), WCA_BENCH_DEPTH (2), WCA_BENCH_SORT (1), WCA_BENCH_UNIT (char),
WCA_BENCH_AGGR (topk), WCA_BENCH_ENC_INT8 (0), WCA_BENCH_REUSE_KV (1),
WCA_BENCH_MODEL (medium), WCA_BENCH_BASELINE (unset), WCA_BENCH_TINY=1
(tiny dims, CPU-friendly).

The other benchmark programs (``scripts/``) share this module's helpers:
:func:`platform_device`, :func:`device_label`, :func:`build_model`,
:func:`timed`, :func:`log`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import constants
from .align import timing
from .config import MODEL_DIMS, AlignConfig, ModelDims, tiny_test_dims
from .data.dataset import TIMIT, batch_iter
from .data.synthetic import make_timit_corpus
from .models import decode_graph, decoding, whisper as wmodel
from .ops import _lib
from .ops.dtw import dtw_np
from .runner import AlignmentPipeline
from .text import retokenize
from .text.tokenizer import get_test_tokenizer
from .utils import flops as flops_mod
from .utils.profiling import StageTimers


# -- helpers shared by the benchmark programs ---------------------------------

def log(msg) -> None:
    print(msg, file=sys.stderr, flush=True)


def env_flag(name: str, default: str) -> bool:
    """An integer environment flag (``int()``: a malformed value raises
    instead of leaving the option off)."""
    return bool(int(os.environ.get(name, default)))


def platform_device() -> torch.device:
    """The device ``WCA_PLATFORM`` selects (``cli/common.apply_platform_env``):
    the card unless ``cpu``. Without a card, exit non-zero with
    ``resolve_device``'s message: a benchmark never falls back to the CPU."""
    from .cli import common

    try:
        return common.apply_platform_env()
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from e


def device_label(device: torch.device) -> str:
    """``"cpu"``, or the card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (its
    first line), or the card's name alone where ``nvidia-smi`` fails."""
    if device.type == "cpu":
        return "cpu"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        smi = None
    if smi is not None and smi.returncode == 0 and smi.stdout.strip():
        return smi.stdout.strip().splitlines()[0]
    return torch.cuda.get_device_name(device)


def build_model(dims: ModelDims, device: torch.device) -> wmodel.Whisper:
    """Random bf16 weights drawn from a ``torch.Generator`` seeded 0 on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(0)
    return wmodel.init_params(
        wmodel.Whisper(dims, device=device, dtype=torch.bfloat16), gen)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_mem_gib(device: torch.device) -> Optional[float]:
    """``torch.cuda.max_memory_allocated`` in GiB (None on the CPU)."""
    if device.type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated(device) / 2**30, 3)


def reset_peak_mem(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


@contextlib.contextmanager
def timed(device: torch.device):
    """Yield a dict that receives, when the block ends, ``wall_s`` (host
    seconds from a synchronize before the block to one after it),
    ``launches`` (kernel launches counted in the block, by kernel) and
    ``captures`` (decode graphs captured in it)."""
    out: dict = {}
    synchronize(device)
    launches0 = _lib.launch_counts()
    captures0 = decode_graph.RECORD["captures"]
    t0 = time.monotonic()
    yield out
    synchronize(device)
    out["wall_s"] = time.monotonic() - t0
    after = _lib.launch_counts()
    out["launches"] = {k: after[k] - launches0[k] for k in after}
    out["captures"] = decode_graph.RECORD["captures"] - captures0


def add_counts(a: Dict[str, int], b: Dict[str, int]) -> Dict[str, int]:
    return {k: a.get(k, 0) + b.get(k, 0) for k in {**a, **b}}


# -- the headline benchmark ---------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Settings:
    """The bench's knobs (:meth:`from_env` reads the JAX script's names)."""
    tiny: bool = False
    n_utts: int = 96
    batch: int = 16
    decode_len: int = 32
    passes: int = 3
    bucket: int = 0
    bucket_guarded: bool = False
    sweep: bool = True
    sweep_passes: int = 2
    sweep_lens: Tuple[int, ...] = (32, 224)
    sweep_bucket: int = 128
    depth: int = 2
    sort: bool = True
    unit: str = "char"
    aggr: str = "topk"
    enc_int8: bool = False
    reuse_kv: bool = True
    model: str = "medium"
    baseline: Optional[float] = None

    @classmethod
    def from_env(cls) -> "Settings":
        env = os.environ.get
        tiny = env("WCA_BENCH_TINY") == "1"
        baseline = env("WCA_BENCH_BASELINE")
        return cls(
            tiny=tiny,
            n_utts=int(env("WCA_BENCH_UTTS", "16" if tiny else "96")),
            batch=int(env("WCA_BENCH_BATCH", "4" if tiny else "16")),
            decode_len=int(env("WCA_BENCH_DECODE_LEN",
                               "8" if tiny else "32")),
            passes=max(1, int(env("WCA_BENCH_PASSES", "3"))),
            bucket=int(env("WCA_BENCH_BUCKET", "0")),
            bucket_guarded=env_flag("WCA_BENCH_BUCKET_GUARDED", "0"),
            sweep=env_flag("WCA_BENCH_SWEEP", "1"),
            sweep_passes=max(1, int(env("WCA_BENCH_SWEEP_PASSES",
                                        "1" if tiny else "2"))),
            sweep_lens=tuple(int(x) for x in env(
                "WCA_BENCH_SWEEP_LENS", "8" if tiny else "32,224").split(",")),
            sweep_bucket=int(env("WCA_BENCH_SWEEP_BUCKET",
                                 "64" if tiny else "128")),
            depth=int(env("WCA_BENCH_DEPTH", "2")),
            sort=env("WCA_BENCH_SORT", "1") == "1",
            unit=env("WCA_BENCH_UNIT", "char"),
            aggr=env("WCA_BENCH_AGGR", "topk"),
            enc_int8=env("WCA_BENCH_ENC_INT8", "0") == "1",
            reuse_kv=env("WCA_BENCH_REUSE_KV", "1") == "1",
            model=env("WCA_BENCH_MODEL", "medium"),
            baseline=None if baseline is None else float(baseline))


def _check(cond: bool, what) -> None:
    # raised, not asserted: the checks stay under python -O
    if not cond:
        raise AssertionError(what)


def check_alignments(alignments, max_seconds: float) -> int:
    """Loud correctness gates on the benched outputs (a perf run must not
    silently produce garbage): per-word interval sanity and monotonicity.
    Returns the alignments checked; raises AssertionError."""
    n_checked = 0
    for a in alignments:
        if a.skipped or len(a.end_times) == 0:
            continue
        starts, ends = np.asarray(a.start_times), np.asarray(a.end_times)
        # words include the trailing eot group: one interval per words[:-1]
        _check(len(starts) == len(ends) == len(a.words) - 1, a.fid)
        _check(bool(np.all(starts <= ends + 1e-9)), (a.fid, starts, ends))
        _check(bool(np.all(np.diff(ends) >= -1e-9)), (a.fid, ends))
        # each word starts where the previous one ends (jump-time contract)
        _check(bool(np.allclose(starts[1:], ends[:-1])), a.fid)
        _check(bool(ends[-1] <= max_seconds + 0.02 and starts[0] >= 0.0),
               a.fid)
        n_checked += 1
    _check(n_checked > 0, "no live alignments to check")
    return n_checked


def recompute_one_on_cpu(pipeline, batch, cfg, tok) -> str:
    """Recompute one utterance's boundaries with the NumPy DTW oracle
    (``ops/dtw.dtw_np``) from the aggregated matrix and hold them to the
    device pipeline's within 1e-9 s. Returns the utterance's fid."""
    outs = pipeline.align_batch(batch, return_matrix=True)
    for a in outs:
        if a.skipped or a.matrix is None or len(a.words) < 2:
            continue
        text_tokens = retokenize.encode(a.transcription, tok,
                                        cfg.aligned_unit_type)
        _, _, wb = timing.words_and_boundaries(text_tokens, tok,
                                               cfg.aligned_unit_type)
        if wb is None:
            continue
        ti, tj = dtw_np(-np.asarray(a.matrix, np.float64))
        first_visit = np.pad(np.diff(ti), (1, 0),
                             constant_values=1).astype(bool)
        jump_times = tj[first_visit] / constants.TOKENS_PER_SECOND
        np.testing.assert_allclose(a.start_times, jump_times[wb[:-1]],
                                   atol=1e-9)
        np.testing.assert_allclose(a.end_times, jump_times[wb[1:]],
                                   atol=1e-9)
        return a.fid
    raise AssertionError("no utterance eligible for the CPU DTW recompute")


def make_cfg(model_name: str, settings: Settings, *, bucket: int = 0,
             bucket_guarded: bool = False,
             kv_int8_guarded: bool = False) -> AlignConfig:
    """The README recipe with the bench's knobs; the decode mode (exact /
    bucketed / guarded) varies per measurement."""
    return AlignConfig.recommended(
        model=model_name, batch_size=settings.batch,
        # the ground-truth text gives the alignment stage a realistic
        # char-token workload; the decode still runs at full cost
        use_gt_transcript=True,
        decode_frame_bucket=bucket,
        decode_frame_bucket_guarded=bucket_guarded,
        decode_kv_int8_guarded=kv_int8_guarded,
        aligned_unit_type=settings.unit,
        aggr=settings.aggr,
        # duration-homogeneous batches: identical per-utterance results,
        # only the output order changes
        sort_by_duration=settings.sort,
        pipeline_depth=settings.depth,
        encoder_int8=settings.enc_int8,
        reuse_cross_kv=settings.reuse_kv)


class Passes(NamedTuple):
    """What :func:`run_passes` measured: the best pass's wall, results,
    aligned count and kernel launches, and the decode graphs captured in
    all timed passes."""
    wall: float
    results: list
    n_aligned: int
    launches: Dict[str, int]
    graph_captures_timed: int


def run_passes(pipeline, dataset, max_seconds: float, n_passes: int,
               label: str = "") -> Passes:
    """A warmup pass, then ``n_passes`` timed passes; the best (least wall)
    is reported. Each pass resets the pipeline's stage timers, and the
    pipeline ends holding the reported pass's. A pass's wall ends in a
    synchronize; its stage seconds are read after it."""
    device = pipeline.device
    t0 = time.monotonic()
    warm = list(pipeline.run_dataset(dataset, progress=False))
    log(f"{label}warmup: {time.monotonic() - t0:.1f}s")
    n_ok = check_alignments(warm, max_seconds)
    log(f"{label}correctness: {n_ok}/{len(warm)} alignments pass interval "
        "checks")
    best = None
    best_timers = None
    captures = 0
    results = warm
    for _ in range(n_passes):
        pipeline.timers = StageTimers(device)
        with timed(device) as m:
            results = list(pipeline.run_dataset(dataset, progress=False))
        check_alignments(results, max_seconds)
        captures += m["captures"]
        log(f"{label}pass: {m['wall_s']:.2f}s ({m['captures']} graph "
            "captures)")
        if best is None or m["wall_s"] < best["wall_s"]:
            best = m
            best_timers = pipeline.timers
    pipeline.timers = best_timers
    n_aligned = sum(1 for a in results if not a.skipped)
    return Passes(best["wall_s"], results, n_aligned, best["launches"],
                  captures)


@contextlib.contextmanager
def guard_margins(value: str):
    """Pin both guard thresholds (logit units, read by
    ``models/decoding.default_guard_margin`` and
    ``default_bucket_guard_margin``) for an envelope measurement: '0' =
    track-only best case (nothing flags), 'inf' = 100%-re-decode worst case.
    The environment is restored after."""
    keys = ("WCA_KV_INT8_GUARD_MARGIN", "WCA_BUCKET_GUARD_MARGIN")
    old = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ[k] = value
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def measure_decode_sweep(model, tok, model_name: str, dataset,
                         max_seconds: float, headline: Optional[float],
                         settings: Settings, device: torch.device) -> dict:
    """The measured {exact, guarded-best, guarded-worst} x sweep_lens grid.
    'guarded' composes both guards (int8 K/V and the frame bucket at
    ``sweep_bucket``): the deployable quantized and bucketed mode. With
    random weights the flag rate is an artifact of the margin bound, so the
    sweep pins the two ends: margin 0 (nothing flags) and margin inf (every
    utterance re-decoded exactly). Each cell is a pipeline of its own on
    ``model``, whose decode graphs it shares; its warmup pass captures what
    its timed passes replay."""
    cells = []
    for dlen in settings.sweep_lens:
        for mode in ("exact", "guarded_track", "guarded_redecode"):
            if (mode == "exact" and dlen == settings.decode_len
                    and settings.bucket == 0 and headline is not None):
                cells.append({"decode_len": dlen, "mode": mode,
                              "utts_per_sec": headline, "flag_rate": None,
                              "source": "headline"})
                continue
            guarded = mode != "exact"
            cfg = make_cfg(model_name, settings,
                           bucket=settings.sweep_bucket if guarded else 0,
                           bucket_guarded=guarded, kv_int8_guarded=guarded)
            margin = "0" if mode == "guarded_track" else "inf"
            reset_peak_mem(device)
            with guard_margins(margin) if guarded else contextlib.nullcontext():
                pipeline = AlignmentPipeline(model, tok, cfg, device=device,
                                             compute_dtype=torch.bfloat16)
                pipeline.options = decoding.DecodingOptions(
                    language="en", sample_len=dlen)
                p = run_passes(pipeline, dataset, max_seconds,
                               settings.sweep_passes,
                               label=f"sweep[{mode}@{dlen}] ")
                rate = pipeline.flag_rate()
            cells.append({
                "decode_len": dlen, "mode": mode,
                "utts_per_sec": round(p.n_aligned / p.wall, 3),
                "flag_rate": None if rate is None else round(rate, 3),
                # a string: float('inf') would serialize as the
                # non-standard JSON literal Infinity
                "guard_margin": margin if guarded else None,
                "launches": p.launches,
                "graph_captures_timed": p.graph_captures_timed,
                "peak_device_mem_gib": peak_mem_gib(device),
            })
            del pipeline
            log(f"sweep[{mode}@{dlen}]: {cells[-1]['utts_per_sec']} utts/s "
                f"flag_rate={cells[-1]['flag_rate']} graph captures timed "
                f"{p.graph_captures_timed} peak "
                f"{cells[-1]['peak_device_mem_gib']} GiB")
    return {
        "config": {"bucket": settings.sweep_bucket,
                   "guards": ["decode_kv_int8_guarded",
                              "decode_frame_bucket_guarded"],
                   "n_utts": settings.n_utts, "batch": settings.batch,
                   "passes": settings.sweep_passes},
        "note": ("deployable guarded rate = track + flag_rate x (redecode "
                 "- track); flag_rate is checkpoint/data dependent"),
        "cells": cells,
    }


def stage_flops(pipeline, dims, tok, decode_len: int
                ) -> Tuple[Dict[str, int], int]:
    """(total matmul FLOPs by stage, utterances counted) over the padded
    shapes the pipeline's batches ran (its ``decode_shapes`` and
    ``capture_shapes`` telemetry), by ``utils/flops``."""
    prompt_len = len(tok.sot_sequence)
    total = {"mel": 0, "encoder": 0, "decode": 0, "capture": 0}
    n_utts = 0
    for b_pad, n_live, kv_frames in pipeline.decode_shapes:
        n_utts += n_live
        total["mel"] += flops_mod.mel_flops(dims) * b_pad
        total["encoder"] += flops_mod.encoder_flops(dims) * b_pad
        total["decode"] += flops_mod.decode_flops(
            dims, prompt_len=prompt_len,
            steps=pipeline.options.sample_len or decode_len,
            kv_frames=kv_frames) * b_pad
    for t_bucket, b_pad, n_live, reused in pipeline.capture_shapes:
        total["capture"] += flops_mod.capture_flops(
            dims, t_tokens=t_bucket, reuse_cross_kv=reused) * b_pad
    return total, n_utts


def mfu_rollup(pipeline, dims, tok, throughput: float, decode_len: int,
               device: Optional[torch.device] = None) -> Optional[dict]:
    """Analytic matmul FLOPs at the padded shapes each batch ran, rolled
    into TFLOP/s and % of the card's bf16 peak (None on the CPU).
    Elementwise work (QK post-process, DTW, softmax) is excluded: counting
    it would overstate MFU."""
    total, n_utts = stage_flops(pipeline, dims, tok, decode_len)
    if n_utts == 0:
        return None
    per_utt = {k: v / n_utts for k, v in total.items()}
    peak = (flops_mod.device_peak_tflops(device)
            if device is not None and device.type == "cuda" else None)
    out = flops_mod.mfu_summary(sum(per_utt.values()), throughput, peak)
    out["stage_flops_per_utt_g"] = {k: round(v / 1e9, 2)
                                    for k, v in per_utt.items()}
    for k, v in per_utt.items():
        log(f"mfu stage {k:>8s}: {v / 1e9:8.2f} GFLOP/utt -> "
            f"{v * throughput / 1e12:6.2f} TFLOP/s")
    log(f"mfu e2e: {out['tflops_per_sec']} TFLOP/s, {out['mfu_pct']}% of "
        f"{out['peak_bf16_tflops']} bf16 peak")
    return out


def run(model: wmodel.Whisper, tokenizer, *, device=None,
        settings: Optional[Settings] = None,
        model_name: str = "medium") -> dict:
    """Measure ``model`` (built, in bf16 on ``device``) and return the one
    line's payload. The corpus is written to a temporary directory, removed
    after."""
    settings = settings or Settings.from_env()
    device = torch.device(device or model.device)
    dims = model.dims
    with tempfile.TemporaryDirectory(prefix="wca_bench_corpus_") as corpus_dir:
        seconds = (1.0, 2.0) if settings.tiny else (2.0, 7.0)
        scp = make_timit_corpus(corpus_dir, n_utts=settings.n_utts,
                                seconds=seconds, words_per_utt=(6, 10),
                                seed=0)
        dataset = TIMIT(scp)
        max_seconds = seconds[1]

        cfg = make_cfg(model_name, settings, bucket=settings.bucket,
                       bucket_guarded=settings.bucket_guarded)
        pipeline = AlignmentPipeline(model, tokenizer, cfg, device=device,
                                     compute_dtype=torch.bfloat16)
        pipeline.options = decoding.DecodingOptions(
            language="en", sample_len=settings.decode_len)
        log(f"corpus: {settings.n_utts} utts x {seconds}s, "
            f"batch={settings.batch}, decode_len={settings.decode_len}, "
            f"dims={model_name}, device={device_label(device)}")
        p = run_passes(pipeline, dataset, max_seconds, settings.passes)
        first_batch = next(iter(batch_iter(dataset, settings.batch,
                                           prefetch=0)))
        fid = recompute_one_on_cpu(pipeline, first_batch, cfg, tokenizer)
        log(f"correctness: device DTW == NumPy oracle recompute for {fid}")

        throughput = p.n_aligned / p.wall
        summary = pipeline.timers.summary()
        for stage, s in summary.items():
            log(f"stage {stage:>16s}: {s['total_s']:.4f}s total, "
                f"{s.get('units_per_s', 0.0):.1f} utts/s")
        log(f"{p.n_aligned} utts in {p.wall:.3f}s -> {throughput:.3f} "
            "utts/sec")
        stage_split = {stage: round(s["total_s"], 4)
                       for stage, s in summary.items()}
        mfu = mfu_rollup(pipeline, dims, tokenizer, throughput,
                         settings.decode_len, device)
        del pipeline
        sweep = None
        if settings.sweep:
            sweep = measure_decode_sweep(model, tokenizer, model_name,
                                         dataset, max_seconds,
                                         round(throughput, 3), settings,
                                         device)
    vs = (round(throughput / settings.baseline, 1)
          if settings.baseline and model_name == "medium" else None)
    return {
        "metric": f"e2e_pipeline_utts_per_sec_per_chip_whisper_{model_name}",
        "value": round(throughput, 3),
        "unit": "utts/sec",
        "vs_baseline": vs,
        "n_utts": p.n_aligned,
        "batch": settings.batch,
        "passes": settings.passes,
        "pipeline_depth": cfg.pipeline_depth,
        "sort_by_duration": cfg.sort_by_duration,
        "reuse_cross_kv": cfg.reuse_cross_kv,
        # a real transcript's length; 224 steps are measured by the sweep
        "decode_len": settings.decode_len,
        "decode_frame_bucket": settings.bucket,
        "decode_frame_bucket_guarded": settings.bucket_guarded,
        "mfu": mfu,
        "decode_sweep": sweep,
        "stage_split_s": stage_split,
        "best_pass_wall_s": round(p.wall, 4),
        "dtw_oracle_fid": fid,
        "device": device_label(device),
        "launches": p.launches,
        "graph_captures_timed": p.graph_captures_timed + sum(
            c.get("graph_captures_timed", 0)
            for c in (sweep or {}).get("cells", [])),
    }


def main() -> None:
    settings = Settings.from_env()
    if settings.bucket_guarded and settings.bucket <= 0:
        # before the model is built, naming the bench's variables
        raise SystemExit(
            "WCA_BENCH_BUCKET_GUARDED=1 guards the frame-bucketed decode: "
            "set WCA_BENCH_BUCKET to the bucket multiple (e.g. 128) too")
    device = platform_device()
    tok = get_test_tokenizer()
    if settings.tiny:
        dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=128,
                              n_text_ctx=96, state=32, head=4, layers=2)
        model_name = "tiny-test"
    else:
        # any published size; the toy tokenizer's specials lie inside the
        # model's vocabulary, over which the decode runs
        model_name = settings.model
        if model_name not in MODEL_DIMS:
            raise SystemExit(f"unknown WCA_BENCH_MODEL={model_name!r}; "
                             f"choose from {sorted(MODEL_DIMS)}")
        dims = MODEL_DIMS[model_name]
    log(f"device: {device_label(device)}")
    model = build_model(dims, device)
    payload = run(model, tok, device=device, settings=settings,
                  model_name=model_name)
    print(json.dumps(payload), flush=True)


if __name__ == "__main__":
    main()
