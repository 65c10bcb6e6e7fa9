"""The probe sweep's head-DTW stage, decomposed on the card (port of the
repository's ``scripts/profile_probe_dtw.py``).

    python -m whisper_char_alignment_tpu_torch.scripts.profile_probe_dtw [--rows 1024] [--tokens 128] [--frames 512] [--iters 5]

The probe (``cli/probe_oracle``) aligns every (utterance, head) map in
launches of up to 1024 rows: column-normalize the f32 maps
(``align/timing._safe_col_normalize``), then the DTW wavefront (kernel 3a,
``csrc/dtw.cu`` ``dtw_trace_kernel``) and the backtrace to jump frames
(kernel 3b, ``dtw_backtrace_kernel``). This times each part at the probe's
chunk shape, random maps, rows of ``tokens - 2`` text rows and
``frames - 8`` frames:

  "col-normalize only"                  the normalization
  "wavefront trace (skew+kernel)"       kernel 3a (``ops/dtw_cuda.dtw_trace``)
  "trace + diag-sync scan backtrace"    kernel 3a, then the plain batched
                                        backtrace (``ops/dtw.dtw_jump_frames_batch``)
  "fused wavefront+backtrace kernels"   kernels 3a + 3b (``dtw_cuda.dtw_jump_frames``)
  "full chunk (norm+fused kernels)"     :func:`full_chunk`
  "full chunk bf16 stream"              :func:`full_chunk_bf16`

Lines of the JAX script the port leaves out, and why:
- "skew only": the Pallas wavefront reads the costs skewed into diagonals
  by an XLA pass first; the CUDA wavefront reads the (rows, N, M) costs in
  place, so there is no skew to time (the "(skew+kernel)" line is the
  kernel alone).
- "trace + per-row backtrace (old)": a second JAX backtrace (a scan per
  row under ``vmap``), replaced there by the diagonal one; the port has only
  the diagonal backtrace, timed in the line above it.
- the ``max_sub`` sweep ("full chunk, max_sub=W") and its bit-equality
  line: ``max_sub`` is the rows a TPU grid step takes in sublanes; the CUDA
  wavefront gives each warp 32 rows and each lane 1, 2 or 8 of them by the
  text rows N, with no knob.

The bf16 stream: the JAX variant feeds the wavefront bf16 costs (column
norms accumulated in f32, the quotient in bf16; the kernel upcasts per
diagonal). The CUDA kernels take float32 costs only, so the port normalizes
the same way, upcasts the bf16 quotient to f32 before the kernels, and
reports how many rows' jump frames differ from the f32 chunk's
(``bf16_mismatch_rows``): the same numbers at the f32 stream's bytes.

Each line's warm call runs it once; the reading is the least of ``--iters``
timed calls. The lines (least and median) go to stderr, then ONE JSON line:
the readings (ms), ``bf16_mismatch_rows``, ``rows``, ``device``,
``launches`` and ``graph_captures_timed``. Runs on ``cuda`` unless
``WCA_PLATFORM=cpu``; without a card it exits non-zero and prints no line.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..align import timing
from ..bench import device_label, log, platform_device
from ..ops import dtw as dtw_ops
from ..ops import dtw_cuda
from ._profile import Readings


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1024)
    ap.add_argument("--tokens", type=int, default=128,
                    help="text rows per map (token bucket minus sot/eot)")
    ap.add_argument("--frames", type=int, default=512,
                    help="frame-sliced width (probe f_slice)")
    ap.add_argument("--iters", type=int, default=5)
    return ap.parse_args(argv)


def full_chunk(x, n, m):
    """One probe chunk: column-normalized maps (rows, T, F) f32, then the
    wavefront and backtrace kernels on their negation -> (rows, T + 1)
    int32 jump frames."""
    xn = timing._safe_col_normalize(x)
    return dtw_cuda.dtw_jump_frames(-xn, n, m)


def full_chunk_bf16(x, n, m):
    """:func:`full_chunk` from bf16 maps: f32 column norms, a bf16
    quotient, upcast to f32 for the kernels."""
    norm = (x.float() ** 2).sum(-2, keepdim=True).sqrt()
    xn = x / torch.where(norm == 0, 1.0, norm).to(torch.bfloat16)
    return dtw_cuda.dtw_jump_frames(-xn.float(), n, m)


def main(argv=None) -> None:
    args = parse_args(argv)
    b, t, f = args.rows, args.tokens, args.frames
    device = platform_device()
    log(f"devices: {device_label(device)}  rows={b} tokens={t} frames={f}")
    rng = np.random.default_rng(0)
    maps = torch.from_numpy(rng.random((b, t, f)).astype(np.float32)).to(
        device)
    n_rows = torch.full((b,), t - 2, dtype=torch.int32, device=device)
    m_cols = torch.full((b,), f - 8, dtype=torch.int32, device=device)
    r = Readings("profile_probe_dtw", device)

    def timed(name, fn):
        r.time(name, fn, args.iters, width=44, median=True)

    timed("col-normalize only",
          lambda: timing._safe_col_normalize(maps).sum())
    timed("wavefront trace (skew+kernel)",
          lambda: dtw_cuda.dtw_trace(-maps).to(torch.int32).sum())
    timed("trace + diag-sync scan backtrace",
          lambda: dtw_ops.dtw_jump_frames_batch(dtw_cuda.dtw_trace(-maps),
                                                n_rows, m_cols))
    timed("fused wavefront+backtrace kernels",
          lambda: dtw_cuda.dtw_jump_frames(-maps, n_rows, m_cols))
    timed("full chunk (norm+fused kernels)",
          lambda: full_chunk(maps, n_rows, m_cols))
    maps_bf = maps.to(torch.bfloat16)
    timed("full chunk bf16 stream",
          lambda: full_chunk_bf16(maps_bf, n_rows, m_cols))
    jf32 = full_chunk(maps, n_rows, m_cols).cpu()
    jf16 = full_chunk_bf16(maps_bf, n_rows, m_cols).cpu()
    bad = int((jf32 != jf16).any(dim=-1).sum())
    log(f"bf16-stream jump-frame mismatches: {bad}/{jf32.shape[0]} rows")
    r.extra.update(bf16_mismatch_rows=bad, rows=b)
    r.emit()


if __name__ == "__main__":
    main()
