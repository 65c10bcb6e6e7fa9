"""DTW on the card: the wavefront and backtrace kernels.

The two CUDA kernels of ``csrc/dtw.cu`` replace the Pallas kernels of
``whisper_char_alignment_tpu/ops/dtw_pallas.py``: ``_dtw_trace_raw`` (the
cost/trace wavefront, :func:`dtw_trace`) and ``dtw_jump_frames_pallas`` (the
backtrace, :func:`dtw_backtrace_jump`). Their plain versions are the
diagonal loops of ``ops/dtw.py``, vectorised over batch and rows:
:func:`dtw_trace_plain` and :func:`dtw_jump_frames_plain`. Traces and jump
frames are bit-equal between the two.
"""

from __future__ import annotations

import torch

from . import _lib
from .dtw import dtw_jump_frames_batch, dtw_trace as _dtw_trace

dtw_trace_plain = _dtw_trace
dtw_jump_frames_plain = dtw_jump_frames_batch

# the wavefront takes up to 16 warps of 256 text rows (csrc/dtw.cu)
_MAX_ROWS = 16 * 256 - 1
# bytes of trace the backtrace stages per window (kBtWindowBytes in dtw.cu)
_BT_WINDOW_BYTES = 16384


def backtrace_window(n_rows: int) -> int:
    """Trace diagonals per window of the backtrace kernel at N = ``n_rows``
    (as csrc/dtw.cu computes it): the walk crosses a window edge every this
    many diagonals down from n_b + m_b."""
    return max(2, _BT_WINDOW_BYTES // (n_rows + 1))


def dtw_trace(x: torch.Tensor) -> torch.Tensor:
    """(B, N, M) float32 costs -> (B, N + M - 1, N + 1) int8 trace diagonals
    (kernel 3a on CUDA tensors, :func:`dtw_trace_plain` on CPU tensors)."""
    if x.ndim != 3:
        raise ValueError(f"x must be (B, N, M), got {tuple(x.shape)}")
    b, n, m = x.shape
    if min(b, n, m) < 1:
        raise ValueError(f"empty cost batch {tuple(x.shape)}")
    if _lib.require_cuda_or_cpu(x) == "cpu":
        return dtw_trace_plain(x)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be contiguous float32 (bf16 costs move paths)")
    if n > _MAX_ROWS:
        raise ValueError(f"{n} text rows exceed the kernel's {_MAX_ROWS}")
    trace = torch.empty((b, n + m - 1, n + 1), dtype=torch.int8,
                        device=x.device)
    lib = _lib.library()
    _lib.count("dtw_trace")
    rc = lib.wca_dtw_trace(x.data_ptr(), trace.data_ptr(), b, n, m,
                           _lib.stream_of(x))
    _lib.check(rc, "dtw_trace")
    return trace


def dtw_backtrace_jump(trace: torch.Tensor, n: torch.Tensor,
                       m: torch.Tensor) -> torch.Tensor:
    """(B, D, N + 1) int8 trace + per-item (n, m) -> (B, N + 1) int32 jump
    frames, rows >= n at -1 (kernel 3b on CUDA tensors,
    :func:`dtw_jump_frames_plain` on CPU tensors). n in [0, N], m in [0, M]."""
    if trace.ndim != 3:
        raise ValueError(f"trace must be (B, D, N+1), got {tuple(trace.shape)}")
    b, n_diags, n1 = trace.shape
    for name, v in (("n", n), ("m", m)):
        if v.shape != (b,):
            raise ValueError(f"{name} must be ({b},), got {tuple(v.shape)}")
    if _lib.require_cuda_or_cpu(trace, n, m) == "cpu":
        return dtw_jump_frames_plain(trace, n, m)
    if trace.dtype != torch.int8 or not trace.is_contiguous():
        raise ValueError("trace must be contiguous int8")
    if n.dtype != torch.int32 or m.dtype != torch.int32:
        raise ValueError("n and m must be int32")
    _lib.require_aligned("dtw_backtrace", trace)  # 16-byte window copies
    n_rows = n1 - 1
    m_cols = n_diags - n_rows + 1
    jump = torch.empty((b, n1), dtype=torch.int32, device=trace.device)
    lib = _lib.library()
    _lib.count("dtw_backtrace")
    rc = lib.wca_dtw_backtrace(trace.data_ptr(), n.contiguous().data_ptr(),
                               m.contiguous().data_ptr(), jump.data_ptr(), b,
                               n_rows, m_cols, _lib.stream_of(trace))
    _lib.check(rc, "dtw_backtrace")
    return jump


def dtw_jump_frames(x: torch.Tensor, n: torch.Tensor,
                    m: torch.Tensor) -> torch.Tensor:
    """(B, N, M) f32 costs -> (B, N + 1) int32 first-visit frames: the
    wavefront then the backtrace."""
    return dtw_backtrace_jump(dtw_trace(x), n, m)


def chain_step_latency(device: torch.device, steps: int = 65536) -> dict:
    """Latency of one dependent step of each kind that lies on the kernels'
    chains, measured on the card by one warp over ``steps`` steps: a warp
    shuffle (the wavefront's) and a shared-memory load (the walk's), in
    clock cycles and nanoseconds. Not a kernel of the port: no count."""
    out = torch.zeros(5, dtype=torch.float64, device=device)
    rc = _lib.library().wca_dtw_chain_probe(
        out.data_ptr(), steps, torch.cuda.current_stream(device).cuda_stream)
    _lib.check(rc, "dtw_chain_probe")
    shfl_cyc, shfl_ns, lds_cyc, lds_ns, _ = out.tolist()
    return dict(shfl_cycles=shfl_cyc, shfl_ns=shfl_ns, lds_cycles=lds_cyc,
                lds_ns=lds_ns)
