"""The decoder's attention, every row computed in one order whatever the
batch, the number of query rows or the key count (``csrc/dec_attn.cu``).

No Pallas site: the JAX package's decoder attention is XLA dots
(``whisper_char_alignment_tpu/models/whisper.py`` ``_attend``).
:func:`attend_plain` is the port's ``_attend`` as it was, and
:func:`dec_attn_plain` the call sites' use of it: the CPU path and the
kernel's oracle. On a card ``torch.matmul`` ran a GEMV for one query row and
a GEMM for a window, a prompt or a batch, so the same row came out in other
bits in a speculative window than in a greedy step, and in a batch than
alone; the kernel cuts the keys into chunks of :data:`CHUNK` at fixed
positions and the rows into tiles of :data:`TILE_ROWS`, sums each row's
scores over hd and its P.V over a chunk's keys in fixed orders, and folds
the chunks in rising order, so the order depends on hd and the chunk index
alone; a chunk that a row cannot see is skipped, so a longer cache or a
padded transcript changes nothing.

The function: ``k' = dtype(dtype(k) * k_scale)`` (no product without
``k_scale``), scores ``q k'`` in float32 plus the float32 mask, a float32
softmax, the weights rounded to ``dtype``, ``P v`` in float32 rounded to
``dtype``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from . import _lib

MAX_HEAD_DIM = 256
CHUNK = 128      # keys a chunk (csrc/dec_attn.cu kChunk)
TILE_ROWS = 16   # query rows a tile (kTile)
_MIN_TICKETS = 4096
_tickets: Dict[torch.device, torch.Tensor] = {}
_retired: List[torch.Tensor] = []  # outgrown sets a captured graph may hold


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
        if b * h > 65535:
            raise ValueError(f"{b * h} batch items x heads exceed the "
                             "grid's 65535")
        if mask is not None and mask.dtype != torch.float32:
            raise ValueError(f"mask must be float32, got {mask.dtype}")
    return kind


def _tickets_on(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` of the device's tile tickets: zeroed once, and zeroed
    again by each tile's last block, so a captured graph replays them. A
    larger set is made outside a capture (the warm-up's call)."""
    t = _tickets.get(device)
    if t is None or t.numel() < n:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"dec_attn: {n} tile tickets first needed "
                               "inside a CUDA graph capture; warm it up "
                               "first")
        if t is not None:
            _retired.append(t)
        t = _tickets[device] = torch.zeros(max(n, _MIN_TICKETS),
                                           dtype=torch.int32, device=device)
    return t


def _unit_stride(t: torch.Tensor) -> torch.Tensor:
    """K or V as the kernel reads it: stride 1 along hd or along S."""
    return t if 1 in t.stride()[-2:] else t.contiguous()


def _panel_strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """K's or V's strides that ``piece_width`` checks: the item's, the
    head's, and the one between a panel's rows (hd's in the cache layout,
    whose stride along S is 1; else S's)."""
    st = t.stride()
    return st[0], st[1], st[2] if st[3] == 1 else st[3]


def staged_unaligned(t: torch.Tensor, strides) -> bool:
    """Whether the kernel stages ``t``'s panels unaligned
    (``csrc/dec_attn.cu`` ``stage_unaligned``): 2-byte elements whose base or
    one of ``strides`` (in elements: the item's, the head's and the one
    between the panel's rows) keeps no piece of 4 bytes aligned, as
    ``piece_width`` finds; a bf16 cache an odd number of columns long."""
    if t.element_size() != 2:
        return False
    return t.data_ptr() % 4 != 0 or any(s * 2 % 4 for s in strides)


def dec_attn(q, k, v, *, dtype: torch.dtype,
             mask: Optional[torch.Tensor] = None,
             k_scale: Optional[float] = None, scores: bool = False
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`dec_attn_plain`'s function: the CUDA kernels for CUDA tensors
    (one launch within a chunk of keys, else two, counted as one call; K/V
    in the compute dtype, read by their strides), the plain version for CPU
    tensors. Returns (out (B, H,
    P, hd) in ``dtype``, a view of a (B, P, H, hd) buffer on the card, and
    the float32 scores (B, H, P, S) when ``scores``, else None)."""
    if _check(q, k, v, dtype, mask) == "cpu":
        return dec_attn_plain(q, k, v, dtype=dtype, mask=mask,
                              k_scale=k_scale)
    b, h, p, hd = q.shape
    s = k.shape[-1]
    if q.stride(-1) != 1:
        q = q.contiguous()
    k, v = _unit_stride(k), _unit_stride(v)
    if mask is not None:
        mask = mask.contiguous()
    n_chunks = -(-s // CHUNK)
    split = n_chunks > 1
    dev = q.device
    out = torch.empty((b, p, h, hd), dtype=dtype, device=dev)
    # the scores: the output when asked, else (split keys) the workspace
    # between the two launches
    sc = (torch.empty((b, h, p, s), dtype=torch.float32, device=dev)
          if scores or split else None)
    stats = part = tickets = None
    if split:
        stats = torch.empty((b, h, p, n_chunks, 2), dtype=torch.float32,
                            device=dev)
        part = torch.empty((b, h, p, n_chunks, hd), dtype=torch.float32,
                           device=dev)
        tickets = _tickets_on(dev, b * h * -(-p // TILE_ROWS))
    strides = (ctypes.c_longlong * 11)(*q.stride()[:3], *k.stride(),
                                       *v.stride())
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _lib.library()
    _lib.count("dec_attn")
    if (staged_unaligned(q, q.stride()[:3])
            or any(staged_unaligned(t, _panel_strides(t)) for t in (k, v))):
        _lib.count("dec_attn_unaligned")
    rc = lib.wca_dec_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(mask), out.data_ptr(),
        ptr(sc), ptr(stats), ptr(part), ptr(tickets), strides, b, h, p, s,
        hd, float(k_scale if k_scale is not None else 1.0),
        int(k_scale is not None), int(scores), int(k.dtype == torch.bfloat16),
        int(dtype == torch.bfloat16), _lib.stream_of(q))
    _lib.check(rc, "dec_attn")
    return out.transpose(1, 2), sc if scores else None


def kernels(n_keys: int) -> Tuple[str, ...]:
    """The kernels one call launches over ``n_keys`` keys, in order (their
    names' stems): one within a chunk, else the scores launch and the P.V
    launch."""
    if n_keys <= CHUNK:
        return ("dec_attn_one",)
    return ("dec_attn_qk", "dec_attn_pv")
