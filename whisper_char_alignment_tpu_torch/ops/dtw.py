"""Monotonic DTW over token x frame cost matrices, in plain PyTorch.

Port of ``whisper_char_alignment_tpu/ops/dtw.py``: the plain versions that the
CUDA kernels of ``ops/dtw_cuda.py`` are held against, and the CPU path.

Exact reference semantics, including the asymmetric tie-break of the
recurrence (diagonal wins only on a strict minimum; otherwise "up" wins only
on a strict minimum; otherwise "left"):

    c0 = cost[i-1, j-1]; c1 = cost[i-1, j]; c2 = cost[i, j-1]
    t = 0 if (c0 < c1 and c0 < c2) else 1 if (c1 < c0 and c1 < c2) else 2

The trace is stored per anti-diagonal: ``trace[i, j] == trace_diags[i + j -
2, i]`` for interior cells (i, j >= 1). Variable sizes: the recurrence at (i,
j) only reads ``x[:i, :j]``, so running the full padded (N_max, M_max)
recurrence and starting the backtrace at the true (n, m) equals slicing the
matrix first. Costs are f32 throughout.
"""

from __future__ import annotations

import numpy as np
import torch

_INT32_MAX = np.iinfo(np.int32).max


def dtw_trace(x: torch.Tensor) -> torch.Tensor:
    """Trace diagonals of cost matrix ``x`` (N, M) or a batch (B, N, M).

    Returns int8 (..., N + M - 1, N + 1): ``trace[i, j] == out[..., i + j - 2,
    i]``, -1 outside the grid. One step per anti-diagonal, vectorised over
    the batch and the text rows."""
    single = x.ndim == 2
    if single:
        x = x[None]
    x = x.float()
    b, n, m = x.shape
    n1, n_diags = n + 1, n + m - 1
    dev = x.device
    inf = torch.tensor(float("inf"), device=dev)
    i_vec = torch.arange(n1, device=dev)
    d_vec = torch.arange(2, n + m + 1, device=dev)[:, None]  # grid diagonals
    j_mat = d_vec - i_vec[None, :]  # (D, N+1)
    valid = (i_vec[None, :] >= 1) & (j_mat >= 1) & (j_mat <= m)
    # skewed input: xs[:, d - 2, i] = x[:, i - 1, d - i - 1]
    xs = x[:, (i_vec - 1).clamp(0, n - 1)[None, :].expand(n_diags, n1),
           (j_mat - 1).clamp(0, m - 1)]
    trace = torch.empty((b, n_diags, n1), dtype=torch.int8, device=dev)
    prev2 = torch.full((b, n1), float("inf"), device=dev)
    prev2[:, 0] = 0.0  # diagonal 0: cost[0, 0] = 0
    prev = torch.full((b, n1), float("inf"), device=dev)  # diagonal 1
    inf_col = torch.full((b, 1), float("inf"), device=dev)
    zero8, one8, two8 = (torch.tensor(v, dtype=torch.int8, device=dev)
                         for v in (0, 1, 2))
    for k in range(n_diags):
        c0 = torch.cat([inf_col, prev2[:, :-1]], dim=1)  # cost[i-1, j-1]
        c1 = torch.cat([inf_col, prev[:, :-1]], dim=1)   # cost[i-1, j]
        c2 = prev                                        # cost[i, j-1]
        is0 = (c0 < c1) & (c0 < c2)
        is1 = (c1 < c0) & (c1 < c2)
        t = torch.where(is0, zero8, torch.where(is1, one8, two8))
        c = torch.where(is0, c0, torch.where(is1, c1, c2))
        ok = valid[k][None, :]
        cur = torch.where(ok, xs[:, k] + c, inf)
        trace[:, k] = torch.where(ok, t, torch.tensor(-1, dtype=torch.int8,
                                                      device=dev))
        prev2, prev = prev, cur
    return trace[0] if single else trace


def dtw_backtrace(trace_diags: torch.Tensor, n: int, m: int):
    """Walk one item's trace from (n, m) back to (0, 0).

    Returns ``(text_indices, time_indices, length)``: the path in reverse
    order (end -> start). Boundary rules: at i == 0 move left, at j == 0 move
    up."""
    tr = trace_diags.cpu().numpy()
    i, j = int(n), int(m)
    ti, tj = [], []
    while i > 0 or j > 0:
        ti.append(i - 1)
        tj.append(j - 1)
        t = 2 if i == 0 else (1 if j == 0 else int(tr[i + j - 2, i]))
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return (torch.tensor(ti, dtype=torch.int32),
            torch.tensor(tj, dtype=torch.int32), len(ti))


def dtw_jump_frames_batch(trace_diags: torch.Tensor, n: torch.Tensor,
                          m: torch.Tensor) -> torch.Tensor:
    """First frame at which each item's DTW path enters each text row.

    trace_diags (B, D, N+1) as from :func:`dtw_trace`; n, m (B,). Returns
    (B, N+1) int32: ``jump[b, r] = min{ j-1 : (r+1, j) on b's path }`` for
    rows r < n_b, -1 beyond. The whole batch walks the same grid
    anti-diagonal d = i + j at each step (every move lowers d by 1 or 2, so a
    path visits each diagonal at most once)."""
    b, n_diags, n1 = trace_diags.shape
    dev = trace_diags.device
    n = n.to(device=dev, dtype=torch.long)
    m = m.to(device=dev, dtype=torch.long)
    ar = torch.arange(b, device=dev)
    i_cur = n.clone()
    d_next = n + m
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    # column n1 is a sink for the rows that record nothing this step
    jump = torch.full((b, n1 + 1), _INT32_MAX, dtype=torch.long, device=dev)
    big = torch.tensor(_INT32_MAX, dtype=torch.long, device=dev)
    sink = torch.tensor(n1, dtype=torch.long, device=dev)
    for d in range(n_diags + 1, 0, -1):
        on = ~done & (d_next == d)
        j = d - i_cur
        if d >= 2:
            t_raw = trace_diags[ar, d - 2, i_cur.clamp(0, n1 - 1)].long()
        else:  # cells (0, 1) / (1, 0): boundary rules only
            t_raw = torch.zeros_like(i_cur)
        t = torch.where(i_cur == 0, 2, torch.where(j == 0, 1, t_raw))
        rec = on & (i_cur >= 1)
        jump.scatter_reduce_(1, torch.where(rec, i_cur - 1, sink)[:, None],
                             torch.where(rec, j - 1, big)[:, None], "amin")
        di = ((t == 0) | (t == 1)).long()
        dj = ((t == 0) | (t == 2)).long()
        new_i, new_j = i_cur - di, j - dj
        done = done | (on & (new_i == 0) & (new_j == 0))
        i_cur = torch.where(on, new_i, i_cur)
        d_next = torch.where(on, d - 1 - (t == 0).long(), d_next)
    rows = torch.arange(n1, device=dev)[None, :]
    return torch.where(rows < n[:, None], jump[:, :n1], -1).to(torch.int32)


def dtw(x) -> tuple:
    """Single-matrix convenience matching ``whisper.timing.dtw``: a (N, M)
    cost matrix -> ``(text_indices, time_indices)`` numpy int arrays in path
    order (start -> end)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    n, m = x.shape
    ti, tj, _ = dtw_backtrace(dtw_trace(x), n, m)
    return ti.numpy()[::-1], tj.numpy()[::-1]


def dtw_np(x: np.ndarray) -> tuple:
    """NumPy reference with identical semantics (test oracle), accumulating
    in float32 like the device recurrence. Copy of the JAX package's
    ``ops/dtw.py::dtw_np``."""
    x = np.asarray(x, dtype=np.float32)
    n, m = x.shape
    cost = np.full((n + 1, m + 1), np.inf, dtype=np.float32)
    trace = -np.ones((n + 1, m + 1), dtype=np.int8)
    cost[0, 0] = 0.0
    for j in range(1, m + 1):
        for i in range(1, n + 1):
            c0 = cost[i - 1, j - 1]
            c1 = cost[i - 1, j]
            c2 = cost[i, j - 1]
            if c0 < c1 and c0 < c2:
                c, t = c0, 0
            elif c1 < c0 and c1 < c2:
                c, t = c1, 1
            else:
                c, t = c2, 2
            cost[i, j] = x[i - 1, j - 1] + c
            trace[i, j] = t

    trace[0, :] = 2
    trace[:, 0] = 1
    i, j = n, m
    text_indices, time_indices = [], []
    while i > 0 or j > 0:
        text_indices.append(i - 1)
        time_indices.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return (np.array(text_indices[::-1], dtype=np.int64),
            np.array(time_indices[::-1], dtype=np.int64))
