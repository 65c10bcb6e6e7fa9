"""The decoder's attention, every row computed in one order whatever the
batch, the number of query rows or the key count (``csrc/dec_attn.cu``).

No Pallas site: the JAX package's decoder attention is XLA dots
(``whisper_char_alignment_tpu/models/whisper.py`` ``_attend``).
:func:`attend_plain` is the port's ``_attend`` as it was, and
:func:`dec_attn_plain` the call sites' use of it: the CPU path and the
kernel's oracle. On a card ``torch.matmul`` ran a GEMV for one query row and
a GEMM for a window, a prompt or a batch, so the same row came out in other
bits in a speculative window than in a greedy step, and in a batch than
alone; the kernel sums each row's scores over hd and its P.V over the keys
in an order fixed by hd and the key count alone, and columns masked to -inf
add exactly zero, so a longer cache or a padded transcript changes nothing.

The function: ``k' = dtype(dtype(k) * k_scale)`` (no product without
``k_scale``), scores ``q k'`` in float32 plus the float32 mask, a float32
softmax, the weights rounded to ``dtype``, ``P v`` in float32 rounded to
``dtype``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _lib

MAX_HEAD_DIM = 256
# shared memory a block takes: 8 query rows of scores and q, in float32
_SMEM_LIMIT = 232448


def attend_plain(q, k_t, v_t, dtype, mask=None):
    """q (B, H, T, hd) scaled; k_t, v_t (B, H, hd, S) with k scaled. Scores
    (B, H, T, S) in f32, f32 softmax, probabilities in ``dtype``, P v in f32
    then ``dtype``. Returns (out (B, H, T, hd), scores)."""
    qk = torch.matmul(q.float(), k_t.float())
    if mask is not None:
        qk = qk + mask
    w = torch.softmax(qk, dim=-1).to(dtype)
    out = torch.matmul(w.float(), v_t.float().transpose(-1, -2)).to(dtype)
    return out, qk


def dec_attn_plain(q, k, v, *, dtype: torch.dtype,
                   mask: Optional[torch.Tensor] = None,
                   k_scale: Optional[float] = None,
                   scores: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, H, P, hd) in ``dtype``; k, v (B, H, hd, S) in their stored
    dtype; mask (P, S) float32 or None. K and V are cast to ``dtype`` and K
    multiplied by ``k_scale`` (when given) in ``dtype``, then
    :func:`attend_plain`. Returns (out (B, H, P, hd), scores (B, H, P, S)
    float32); ``scores`` is the kernel's switch, the plain version always
    has them."""
    k = k.to(dtype)
    if k_scale is not None:
        k = k * k_scale
    return attend_plain(q, k, v.to(dtype), dtype, mask)


def _check(q, k, v, dtype, mask) -> str:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError("q must be (B, H, P, hd) and k, v one (B, H, hd, S) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, p, hd = q.shape
    if tuple(k.shape[:3]) != (b, h, hd):
        raise ValueError(f"k and v must be ({b}, {h}, {hd}, S), got "
                         f"{tuple(k.shape)}")
    s = k.shape[-1]
    if mask is not None and tuple(mask.shape) != (p, s):
        raise ValueError(f"mask must be ({p}, {s}), got {tuple(mask.shape)}")
    if q.dtype != dtype:
        raise ValueError(f"q is {q.dtype}, the compute dtype {dtype}")
    tensors = (q, k, v) if mask is None else (q, k, v, mask)
    kind = _lib.require_cuda_or_cpu(*tensors)
    if kind == "cuda":
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype {dtype} is not float32 or "
                             "bfloat16")
        if k.dtype != dtype or v.dtype != dtype:
            raise ValueError(f"k and v must be in the compute dtype {dtype}, "
                             f"got {k.dtype}, {v.dtype}")
        if hd % 8 or hd > MAX_HEAD_DIM:
            raise ValueError(f"head_dim {hd} must be a multiple of 8 up to "
                             f"{MAX_HEAD_DIM}")
        if 8 * (hd + s) * 4 > _SMEM_LIMIT:
            raise ValueError(f"{s} keys exceed a block's shared memory")
        if mask is not None and mask.dtype != torch.float32:
            raise ValueError(f"mask must be float32, got {mask.dtype}")
    return kind


def dec_attn(q, k, v, *, dtype: torch.dtype,
             mask: Optional[torch.Tensor] = None,
             k_scale: Optional[float] = None, scores: bool = False
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`dec_attn_plain`'s function: the CUDA kernel for CUDA tensors
    (one launch; K/V in the compute dtype, read by their strides), the plain
    version for CPU tensors. Returns (out (B, H, P, hd) in ``dtype``, a
    view of a (B, P, H, hd) buffer on the card, and the float32 scores
    (B, H, P, S) when ``scores``, else None)."""
    if _check(q, k, v, dtype, mask) == "cpu":
        return dec_attn_plain(q, k, v, dtype=dtype, mask=mask,
                              k_scale=k_scale)
    b, h, p, hd = q.shape
    s = k.shape[-1]
    if q.stride(-1) != 1:
        q = q.contiguous()
    if mask is not None:
        mask = mask.contiguous()
    out = torch.empty((b, p, h, hd), dtype=dtype, device=q.device)
    sc = (torch.empty((b, h, p, s), dtype=torch.float32, device=q.device)
          if scores else None)
    strides = (ctypes.c_longlong * 11)(*q.stride()[:3], *k.stride(),
                                       *v.stride())
    lib = _lib.library()
    _lib.count("dec_attn")
    rc = lib.wca_dec_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        None if sc is None else sc.data_ptr(), strides, b, h, p, s, hd,
        float(k_scale if k_scale is not None else 1.0),
        int(k_scale is not None), int(k.dtype == torch.bfloat16),
        int(dtype == torch.bfloat16), _lib.stream_of(q))
    _lib.check(rc, "dec_attn")
    return out.transpose(1, 2), sc
