"""Median filter along the frame axis (port of ``whisper_char_alignment_tpu/ops/medfilt.py``).

The reference applies it to raw cross-attention QK logits *before* the
softmax: odd width >= 3, reflect padding on the last axis, sliding-window
median; inputs whose last axis is <= width//2 are returned unchanged.

These are the building blocks of the QK post-process kernel's plain version
(``ops/qkpost_cuda.qk_postprocess_plain``). Medians are selections by
comparison, so they are bit-equal to the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Indices of ``np.pad(..., (pad, pad), mode="reflect")`` over an axis of
    length ``n``."""
    idx = torch.arange(-pad, n + pad, device=device).abs()
    return torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)


def median_filter(x: torch.Tensor, width: int) -> torch.Tensor:
    """Apply a width-``width`` median filter over the last axis of ``x``."""
    if not (width > 0 and width % 2 == 1):
        raise ValueError("`width` should be an odd positive number")
    pad = width // 2
    f = x.shape[-1]
    if f <= pad:
        return x
    xp = x[..., _reflect_index(f, pad, x.device)]
    windows = torch.stack([xp[..., k:k + f] for k in range(width)], dim=-1)
    return torch.sort(windows, dim=-1).values[..., pad]


def _median_of(slices):
    """Median of ``w`` same-shaped tensors via odd-even transposition
    compare-exchange (elementwise min/max only)."""
    vals = list(slices)
    w = len(vals)
    for p in range(w):
        for i in range(p % 2, w - 1, 2):
            lo = torch.minimum(vals[i], vals[i + 1])
            hi = torch.maximum(vals[i], vals[i + 1])
            vals[i], vals[i + 1] = lo, hi
    return vals[w // 2]


def median_filter_masked(x: torch.Tensor, width: int,
                         valid_len: torch.Tensor) -> torch.Tensor:
    """Per-item masked median filter: for each batch item, behaves exactly as
    if ``x[b, ..., :valid_len[b]]`` had been sliced first (reflect padding at
    the true right edge). Frames >= valid_len pass through unfiltered; items
    with valid_len <= width//2 are returned unchanged.

    x: (B, ..., F); valid_len: (B,) integer. A base pass reflects at the full
    array edges; the ``width//2`` columns at each item's true right edge, the
    only ones whose windows cross it, are then recomputed with per-item
    reflected windows (the JAX function's structure, kept so the two are
    easy to hold side by side)."""
    if not (width > 0 and width % 2 == 1):
        raise ValueError("`width` should be an odd positive number")
    pad = width // 2
    f = x.shape[-1]
    b = x.shape[0]
    lead = (1,) * (x.ndim - 2)
    m = valid_len.to(device=x.device, dtype=torch.long) - 1  # (B,)
    mb = m.reshape((b,) + (1,) * (x.ndim - 1))
    if pad == 0:
        return x

    xp = x[..., _reflect_index(f, pad, x.device)]
    base = _median_of([xp[..., k:k + f] for k in range(width)])

    cols = m[:, None] - torch.arange(pad, device=x.device)[None, :]  # (B, pad)
    win = (cols[:, :, None]
           + (torch.arange(width, device=x.device) - pad)[None, None, :])
    win = win.abs()  # left reflect
    win = torch.where(win > m[:, None, None], 2 * m[:, None, None] - win, win)
    win = win.clamp(0, f - 1).reshape(b, pad * width)
    idx = win.reshape((b,) + lead + (pad * width,)).expand(
        x.shape[:-1] + (pad * width,))
    gathered = torch.gather(x, -1, idx).reshape(x.shape[:-1] + (pad, width))
    fixed = torch.sort(gathered, dim=-1).values[..., pad]  # (..., pad)
    cols_idx = cols.clamp(0, f - 1).reshape((b,) + lead + (pad,)).expand(
        x.shape[:-1] + (pad,))
    out = base.scatter(-1, cols_idx, fixed)

    frame_ids = torch.arange(f, device=x.device).reshape(
        (1,) * (x.ndim - 1) + (f,))
    out = torch.where(frame_ids > mb, x, out)
    return torch.where(mb + 1 <= pad, x, out)


def median_filter_np(x: np.ndarray, width: int) -> np.ndarray:
    """NumPy twin of :func:`median_filter` (test oracle)."""
    assert width > 0 and width % 2 == 1
    pad = width // 2
    x = np.asarray(x)
    if x.shape[-1] <= pad:
        return x
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    windows = np.stack([xp[..., k:k + x.shape[-1]] for k in range(width)],
                       axis=-1)
    return np.sort(windows, axis=-1)[..., pad]
