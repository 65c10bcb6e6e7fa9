#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py    # needs one CUDA card

Phases (any failure exits non-zero and prints no final line):

1. Print the card's name and power limit (``nvidia-smi``), build the kernel
   library from ``whisper_char_alignment_tpu_torch/csrc`` and print the build
   time.
2. Kernel vs plain version on the card at the main path's shapes: encoder
   attention (B=8, H=16, T=1500, hd=64) in f32 and bf16, the QK post-process
   (B=8, H=16, T=96, F=1500) at widths 3 and 7 with ragged and edge lengths,
   the DTW wavefront and backtrace (B=16, N<=120, M=1500) on tied integer and
   random costs (bit-equal). Each kernel is timed with CUDA events (warmed
   up, mean over 20 launches) beside its plain version, its bound, and, for
   the encoder attention, ``scaled_dot_product_attention``.
3. The port's main path: ``AlignmentPipeline.run_dataset`` at Whisper-medium
   width (random weights from torch.Generator seed 0, bf16, toy tokenizer,
   16 synthetic utterances of 2-7 s), with launch counts that must be exact,
   alignment sanity checks, and a NumPy DTW recompute of one batch. A tiny
   f32 model is also held against the CPU path (plain versions).
4. A JSON line of per-kernel numbers, then
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
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


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_phase():
    import torch
    import torch.nn.functional as F

    from whisper_char_alignment_tpu_torch.ops import (_lib, dtw_cuda,
                                                      encoder_attn_cuda,
                                                      qkpost_cuda)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    # -- encoder attention ---------------------------------------------------
    b, h, t, hd = 8, 16, 1500, 64
    scale = hd ** -0.25
    q32, k32, v32 = (torch.randn((b, h, t, hd), generator=gen, device=dev)
                     for _ in range(3))
    q32, k32 = q32 * scale, k32 * scale
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        q, k, v = (x.to(dtype).contiguous() for x in (q32, k32, v32))
        worst = 0.0
        for n_valid in (t, 1000):
            out = encoder_attn_cuda.encoder_self_attention(q, k, v, n_valid)
            ref = encoder_attn_cuda.encoder_self_attention_plain(
                q, k, v, n_valid)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            lim = tol + (tol * ref.float().abs() if dtype == torch.bfloat16
                         else 0.0)
            check(bool((err <= lim).all()),
                  f"encoder attention {dtype} n_valid={n_valid}: max err "
                  f"{err.max().item():.3g}")
            worst = max(worst, err.max().item())
            log(f"encoder_attn {str(dtype)[6:]} n_valid={n_valid}: max abs "
                f"err {err.max().item():.3g} (tol {tol})")
        ms = cuda_ms(lambda: encoder_attn_cuda.encoder_self_attention(
            q, k, v, t))
        plain_ms = cuda_ms(lambda: encoder_attn_cuda.encoder_self_attention_plain(
            q, k, v, t), iters=3, warmup=1)
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=1.0))
        ops = 4 * b * h * t * t * hd
        nbytes = 4 * b * h * t * hd * q.element_size()
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        bound = max(ops / peak, nbytes / HBM_BYTES_PER_S) * 1e3
        log(f"encoder_attn {str(dtype)[6:]} (8,16,1500,64): kernel {ms:.4f} ms"
            f", plain {plain_ms:.4f} ms, sdpa {sdpa_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({ops / 1e9:.1f} GFLOP)")
        if dtype == torch.bfloat16:
            rows["encoder_attn"] = dict(
                name="encoder_attn", route="cuda",
                source="whisper_char_alignment_tpu_torch/csrc/encoder_attn.cu",
                replaces="whisper_char_alignment_tpu/ops/encoder_attn_pallas.py:112",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound,
                bound_by="operations" if ops / peak > nbytes / HBM_BYTES_PER_S
                else "bytes",
                library_ms=sdpa_ms)
    del q32, k32, v32, q, k, v

    # -- QK post-process -----------------------------------------------------
    b, h, t, f = 8, 16, 96, 1500
    qk = torch.randn((b, h, t, f), generator=gen, device=dev) * 3.0
    frame_len = torch.tensor([1, 3, 4, 2, 750, 1499, 1500, 333],
                             dtype=torch.int32, device=dev)
    token_len = torch.tensor([96, 1, 50, 95, 96, 10, 70, 33],
                             dtype=torch.int32, device=dev)
    worst = 0.0
    for width in (3, 7):
        out = qkpost_cuda.qk_postprocess(qk, frame_len, token_len, width)
        ref = qkpost_cuda.qk_postprocess_plain(qk, frame_len, token_len, width)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        worst = max(worst, err)
        check(err <= 1e-6, f"qkpost width {width}: max err {err:.3g}")
        log(f"qkpost width={width}: max abs err {err:.3g} (tol 1e-6)")
    ms = cuda_ms(lambda: qkpost_cuda.qk_postprocess(qk, frame_len, token_len, 3))
    plain_ms = cuda_ms(lambda: qkpost_cuda.qk_postprocess_plain(
        qk, frame_len, token_len, 3), iters=5, warmup=1)
    nbytes = 2 * b * h * t * f * 4 + 2 * b * 4
    ops = b * h * t * f * 8  # 3 compare-exchanges, scale, exp, sum, divide
    bound = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_F32) * 1e3
    log(f"qkpost (8,16,96,1500) w=3: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.0f} MB)")
    rows["qkpost"] = dict(
        name="qkpost", route="cuda",
        source="whisper_char_alignment_tpu_torch/csrc/qkpost.cu",
        replaces="whisper_char_alignment_tpu/ops/qkpost_pallas.py:111",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops / PEAK_F32
        else "operations", library_ms=None)
    del qk

    # -- DTW -----------------------------------------------------------------
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
        tr = dtw_cuda.dtw_trace(x)
        tr_ref = dtw_cuda.dtw_trace_plain(x)
        jf = dtw_cuda.dtw_backtrace_jump(tr, n_len, m_len)
        jf_ref = dtw_cuda.dtw_jump_frames_plain(tr_ref, n_len, m_len)
        torch.cuda.synchronize()
        check(torch.equal(tr, tr_ref), f"dtw trace ({label}) differs")
        check(torch.equal(jf, jf_ref), f"dtw jump frames ({label}) differ")
        log(f"dtw {label}: trace and jump frames bit-equal")
    ms_tr = cuda_ms(lambda: dtw_cuda.dtw_trace(rand))
    plain_tr = cuda_ms(lambda: dtw_cuda.dtw_trace_plain(rand), iters=3,
                       warmup=1)
    tr = dtw_cuda.dtw_trace(rand)
    ms_bt = cuda_ms(lambda: dtw_cuda.dtw_backtrace_jump(tr, n_len, m_len))
    plain_bt = cuda_ms(lambda: dtw_cuda.dtw_jump_frames_plain(
        tr, n_len, m_len), iters=3, warmup=1)
    cells = int((n_len.long() * m_len.long()).sum())
    d = n + m - 1
    tr_bytes = cells * 4 + b * d * (n + 1)
    tr_ops = cells * 5  # 4 comparisons + 1 add per cell
    tr_bound = max(tr_bytes / HBM_BYTES_PER_S, tr_ops / PEAK_F32) * 1e3
    steps = int((n_len + m_len).sum())
    bt_bytes = steps + b * (n + 1) * 4 + 2 * b * 4
    bt_bound = max(bt_bytes / HBM_BYTES_PER_S, steps * 4 / PEAK_F32) * 1e3
    log(f"dtw trace (16,120,1500): kernel {ms_tr:.4f} ms, plain {plain_tr:.4f}"
        f" ms, bound {tr_bound:.5f} ms; {d} dependent diagonal steps")
    log(f"dtw backtrace: kernel {ms_bt:.4f} ms, plain {plain_bt:.4f} ms, "
        f"bound {bt_bound:.6f} ms; longest walk "
        f"{int((n_len + m_len).max())} dependent steps")
    rows["dtw_trace"] = dict(
        name="dtw_trace", route="cuda",
        source="whisper_char_alignment_tpu_torch/csrc/dtw.cu",
        replaces="whisper_char_alignment_tpu/ops/dtw_pallas.py:171",
        max_abs_err=0.0, ms=ms_tr, plain_ms=plain_tr, bound_ms=tr_bound,
        bound_by="bytes" if tr_bytes / HBM_BYTES_PER_S >= tr_ops / PEAK_F32
        else "operations", library_ms=None)
    rows["dtw_backtrace"] = dict(
        name="dtw_backtrace", route="cuda",
        source="whisper_char_alignment_tpu_torch/csrc/dtw.cu",
        replaces="whisper_char_alignment_tpu/ops/dtw_pallas.py:290",
        max_abs_err=0.0, ms=ms_bt, plain_ms=plain_bt, bound_ms=bt_bound,
        bound_by="bytes" if bt_bytes / HBM_BYTES_PER_S >= steps * 4 / PEAK_F32
        else "operations", library_ms=None)
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


def main_path_phase(card: str):
    import numpy as np
    import torch

    from whisper_char_alignment_tpu_torch.config import (MODEL_DIMS,
                                                         AlignConfig)
    from whisper_char_alignment_tpu_torch.data.dataset import TIMIT, batch_iter
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

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke_corpus_",
                                     dir=os.path.join(HERE, "build")) as d:
        scp = make_timit_corpus(d, n_utts=N_UTTS, seconds=(2.0, 7.0),
                                words_per_utt=(6, 10), seed=0)
        dataset = TIMIT(scp)
        cfg = AlignConfig.recommended(model="medium", batch_size=BATCH,
                                      use_gt_transcript=True)
        pipe = AlignmentPipeline(model, tok, cfg, compute_dtype=torch.bfloat16)
        pipe.options = decoding.DecodingOptions(language="en",
                                                sample_len=DECODE_LEN)
        warm = [dataset[i] for i in range(BATCH)]
        t0 = time.perf_counter()
        pipe.align_batch(warm)
        log(f"warmup batch: {time.perf_counter() - t0:.2f} s")

        pipe.stage_seconds.clear()
        _lib.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = list(pipe.run_dataset(dataset, progress=False))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _lib.launch_counts()

        n_batches = -(-N_UTTS // BATCH)
        expect = {"encoder_attn": dims.n_audio_layer * n_batches,
                  "qkpost": dims.n_text_layer * n_batches,
                  "dtw_trace": n_batches, "dtw_backtrace": n_batches}
        log(f"launch counts on the main path: {counts} (expected {expect})")
        check(counts == expect, "launch counts differ from the main path's")
        check(len(results) == N_UTTS, f"{len(results)} results")
        by_fid = {dataset.entries[i][0]: dataset[i] for i in range(N_UTTS)}
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
        stages = {k: round(v, 4) for k, v in pipe.stage_seconds.items()}
        log(f"main path on {card}: {N_UTTS} utterances aligned in {wall:.3f} s"
            f" -> {N_UTTS / wall:.3f} utts/s; stage seconds "
            f"{json.dumps(stages)}")

        first = next(iter(batch_iter(dataset, BATCH, prefetch=0)))
        held = oracle_recompute(pipe, first)
        check(held > 0, "no utterance held against the NumPy DTW oracle")
        log(f"NumPy DTW oracle: {held} utterances' boundaries equal")
    return counts


def main() -> int:
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
        if "registers" in line or "==" in line or "spill" in line:
            log(f"  {line.strip()}")

    rows = kernel_phase()
    counts = main_path_phase(card)
    for name, row in rows.items():
        row["launches"] = counts[name]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
