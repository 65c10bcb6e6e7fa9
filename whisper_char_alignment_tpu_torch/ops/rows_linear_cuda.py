"""A linear layer whose rows do not depend on the rows beside them
(``csrc/rows_linear.cu``).

No Pallas site: the JAX package's linears and tied lm head are XLA dots
(``whisper_char_alignment_tpu/models/whisper.py:139``, ``_linear``).
:func:`rows_linear_plain` is the port's ``F.linear`` call as it was (and,
with ``out_dtype=float32``, ``_logits``' ``F.linear(x.float(),
W.float())``): the CPU path and the kernel's oracle. On a card cuBLAS chose
its kernel and any split of K by the row count M, so a decode step's row
came out in other bits at B = 1 than at B = 16, and in a 5-row speculative
window than in a step.

The contract: a row's bits depend on (N, K) and the dtype only. The kernel
sums each output over K in segments fixed by them (:func:`plan`): each
segment one chain of k16 products from zero in rising k, the segments
added in rising order, then the bias, one rounding. M picks only the
regime (:func:`route`), never the order. bf16 runs on ``wgmma`` fed by
TMA; the instruction probe (:func:`instruction_probe`, a card test) found
every form (``mma.sync``, ``wgmma`` at N = 8 to 128, either operand as A)
bit-equal on an H100, so the regimes take different ones.
- Few rows (bound by the weight's bytes): one warpgroup a tile of 64
  columns by 8, 16, 32 or 64 rows, the weight as A, every chunk of a
  block's K range copied at once. Split, the tile's segments are one
  thread-block cluster: each block pushes its sums into the shared memory
  of the block that folds their columns, which adds them in rank order
  once a barrier there has counted every block (no partials in device
  memory, no ticket). Not split (the lm head), as few blocks as the card
  holds walk the tiles.
- Many rows (bound by operations): 128-row tiles, x as A, a producer
  thread feeding a 4-stage ring and two consumer warpgroups that add each
  segment's chain to a running total in registers; a block an SM walks
  its tiles.
f32 keeps its CUDA-core kernel, split with partials in device memory and a
tile ticket (:func:`_tickets_on`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _lib

BLOCK_N = 64  # a few-row tile's columns, the plan's unit of N
CHUNK = {torch.bfloat16: 64, torch.float32: 16}  # k a pipeline step
# bf16: at most this many segments (a portable cluster), as many as put
# some FOLD_BLOCKS blocks on the card at few rows
CLUSTER = 8
FOLD_BLOCKS = 128
# f32: a segment plan aims at this many blocks on a decode step's rows
TARGET_BLOCKS = 256
# below this many 64 x 64 output tiles the segments run a block each
SPLIT_BELOW_TILES = 66
# an H100's SMs: many rows take 128 x 128 tiles where there are this many
WIDE_TILES = 132
# the C entry's modes (``wca_rows_linear``)
WALK, SPLIT, WIDE_64, WIDE_128 = range(4)
_MAX_TICKETS = 4096
_tickets: Dict[torch.device, torch.Tensor] = {}


def plan(n: int, k: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(chunks a segment, segments) for an (N, K) weight: from N, K and the
    dtype alone, never from the row count, so every row's sum runs in one
    order. bf16: at most :data:`CLUSTER` segments, enough for some
    :data:`FOLD_BLOCKS` blocks of 64 columns; f32: some
    :data:`TARGET_BLOCKS`."""
    n_tiles = -(-n // BLOCK_N)
    n_chunks = -(-k // CHUNK[dtype])
    if dtype == torch.bfloat16:
        n_seg = min(CLUSTER, n_chunks, -(-FOLD_BLOCKS // n_tiles))
    else:
        n_seg = max(1, min(TARGET_BLOCKS // n_tiles, n_chunks))
    seg_chunks = -(-n_chunks // n_seg)
    return seg_chunks, -(-n_chunks // seg_chunks)


def route(m: int, n: int, k: int, dtype: torch.dtype) -> int:
    """The regime of an (M, K) x (N, K) call, by M: :data:`SPLIT` below
    :data:`SPLIT_BELOW_TILES` tiles of 64 x 64 when the plan has segments,
    else :data:`WALK` (f32, or bf16 up to 64 rows), else :data:`WIDE_128`
    where :data:`WIDE_TILES` 128 x 128 tiles fill the card, :data:`WIDE_64`
    where they do not. It never changes a row's bits."""
    _, n_seg = plan(n, k, dtype)
    if n_seg > 1 and -(-m // 64) * -(-n // BLOCK_N) < SPLIT_BELOW_TILES:
        return SPLIT
    if dtype == torch.float32 or m <= 64:
        return WALK
    wide_tiles = -(-m // 128) * -(-n // 128)
    return WIDE_128 if wide_tiles >= WIDE_TILES else WIDE_64


def kernel_name(m: int, n: int, k: int, dtype: torch.dtype) -> str:
    """The name of the kernel that an (M, K) x (N, K) call launches."""
    if dtype == torch.float32:
        return "rows_linear_f32_kernel"
    if route(m, n, k, dtype) in (WIDE_64, WIDE_128):
        return "rows_linear_wide_kernel"
    return "rows_linear_narrow_kernel"


def rows_linear_plain(x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``F.linear(x, weight, bias)``, with x, weight and bias first cast to
    ``out_dtype`` when it is given and differs from x's (the lm head's
    float32 product of bf16 rows and embedding)."""
    if out_dtype is not None and out_dtype != x.dtype:
        x, weight = x.to(out_dtype), weight.to(out_dtype)
        bias = None if bias is None else bias.to(out_dtype)
    return F.linear(x, weight, bias)


def _tickets_on(device: torch.device) -> torch.Tensor:
    """The device's tile tickets for the f32 kernel's split: zeroed once,
    and zeroed again by the kernel's last block of each tile, so a captured
    graph replays them."""
    t = _tickets.get(device)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("rows_linear: first call on a device inside a "
                               "CUDA graph capture; warm it up first")
        t = _tickets[device] = torch.zeros(_MAX_TICKETS, dtype=torch.int32,
                                           device=device)
    return t


def rows_linear(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:func:`rows_linear_plain`'s function: the CUDA kernel for CUDA
    tensors (one launch), the plain version for CPU tensors. x (..., K) and
    weight (N, K) share bfloat16 or float32; bias (N,) in that type or None;
    ``out_dtype`` None (x's type) or float32. K is a multiple of 8 (bf16) or
    4 (f32)."""
    if x.shape[-1] != weight.shape[-1] or weight.ndim != 2:
        raise ValueError(f"x (..., K) and weight (N, K) disagree: "
                         f"{tuple(x.shape)}, {tuple(weight.shape)}")
    n, k = weight.shape
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"bias must be ({n},), got {tuple(bias.shape)}")
    tensors = (x, weight) if bias is None else (x, weight, bias)
    if _lib.require_cuda_or_cpu(*tensors) == "cpu":
        return rows_linear_plain(x, weight, bias, out_dtype)
    dtype = x.dtype
    out_dtype = dtype if out_dtype is None else out_dtype
    if dtype not in CHUNK or weight.dtype != dtype or (
            bias is not None and bias.dtype != dtype):
        raise ValueError("x, weight and bias must share bfloat16 or float32, "
                         f"got {dtype}, {weight.dtype}, "
                         f"{None if bias is None else bias.dtype}")
    if out_dtype not in (dtype, torch.float32):
        raise ValueError(f"out_dtype {out_dtype} must be {dtype} or float32")
    if k % (8 if dtype == torch.bfloat16 else 4):
        raise ValueError(f"K={k} must be a multiple of "
                         f"{8 if dtype == torch.bfloat16 else 4}")
    x2 = x.reshape(-1, k).contiguous()
    weight = weight.contiguous()
    bias = None if bias is None else bias.contiguous()
    _lib.require_aligned("rows_linear", x2, weight)
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out.reshape(*x.shape[:-1], n)
    seg_chunks, n_seg = plan(n, k, dtype)
    mode = route(m, n, k, dtype)
    f32_split = dtype == torch.float32 and mode == SPLIT
    part = (torch.empty((n_seg, m, n), dtype=torch.float32, device=x.device)
            if f32_split else None)
    tickets = _tickets_on(x.device) if f32_split else None
    lib = _lib.library()
    _lib.count("rows_linear")
    rc = lib.wca_rows_linear(
        x2.data_ptr(), weight.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if tickets is None else tickets.data_ptr(), m, n, k, seg_chunks,
        n_seg, mode, int(dtype == torch.bfloat16),
        int(out_dtype == torch.float32), _lib.stream_of(x))
    _lib.check(rc, "rows_linear")
    return out.reshape(*x.shape[:-1], n)


def instruction_probe(x: torch.Tensor, w: torch.Tensor,
                      c0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The tensor-core instruction forms on the same bf16 tiles, on the
    card: x (64, K) and w (128, K) with K = 16 steps (1-8 k16 steps), c0
    (64, 128) float32 carried into every chain or None (chains from zero).
    Returns (8, 64, 128) float32 x w^T (+ c0): ``mma.sync`` m16n8k16;
    ``wgmma`` m64nNk16 with x as A at N = 8, 64, 128; ``wgmma`` with w as
    A (swap-AB) at N = 64, 8, 16, 32. A test tool (no launch count); CUDA
    only."""
    k = x.shape[1]
    if (x.shape != (64, k) or w.shape != (128, k) or k % 16 or
            not 1 <= k // 16 <= 8 or x.dtype != torch.bfloat16 or
            w.dtype != torch.bfloat16 or
            (c0 is not None and (c0.shape != (64, 128) or
                                 c0.dtype != torch.float32))):
        raise ValueError("instruction_probe takes bf16 x (64, 16 s), w (128, "
                         "16 s), s in 1..8, and f32 c0 (64, 128) or None")
    tensors = (x, w) if c0 is None else (x, w, c0)
    if _lib.require_cuda_or_cpu(*tensors) != "cuda":
        raise ValueError("instruction_probe runs on the card only")
    x, w = x.contiguous(), w.contiguous()
    c0 = None if c0 is None else c0.contiguous()
    out = torch.empty((8, 64, 128), dtype=torch.float32, device=x.device)
    rc = _lib.library().wca_rows_linear_probe(
        x.data_ptr(), w.data_ptr(), None if c0 is None else c0.data_ptr(),
        out.data_ptr(), k // 16, _lib.stream_of(x))
    _lib.check(rc, "rows_linear_probe")
    return out
