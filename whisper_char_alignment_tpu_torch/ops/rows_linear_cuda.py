"""A linear layer whose rows do not depend on the rows beside them
(``csrc/rows_linear.cu``).

No Pallas site: the JAX package's linears and tied lm head are XLA dots.
:func:`rows_linear_plain` is the port's ``F.linear`` call as it was (and,
with ``out_dtype=float32``, ``_logits``' ``F.linear(x.float(),
W.float())``): the CPU path and the kernel's oracle. On a card cuBLAS chose
its kernel and any split of K by the row count M, so a decode step's row
came out in other bits at B = 1 than at B = 16, and in a 5-row speculative
window than in a step. The kernel sums each output over K in segments fixed
by (N, K) alone (:func:`plan`), adds the segments in rising order, then the
bias, and rounds once; M only decides whether the segments run in one block
or in one block each (their partials summed, in the same order, by the last
block of the tile), which gives the same bits.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _lib

BLOCK_N = 64
CHUNK = {torch.bfloat16: 64, torch.float32: 16}  # k a pipeline step
# a segment plan aims at this many blocks on a decode step's rows
TARGET_BLOCKS = 256
# below this many output tiles the segments run a block each
SPLIT_BELOW_TILES = 66
_MAX_TICKETS = 4096
_tickets: Dict[torch.device, torch.Tensor] = {}


def plan(n: int, k: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(chunks a segment, segments) for an (N, K) weight: from N and K
    alone, never from the row count, so every row's sum runs in one order."""
    n_tiles = -(-n // BLOCK_N)
    n_chunks = -(-k // CHUNK[dtype])
    n_seg = max(1, min(TARGET_BLOCKS // n_tiles, n_chunks))
    seg_chunks = -(-n_chunks // n_seg)
    return seg_chunks, -(-n_chunks // seg_chunks)


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
    """The device's tile tickets: zeroed once, and zeroed again by the
    kernel's last block of each tile, so a captured graph replays them."""
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
    block_m = 16 if dtype == torch.bfloat16 and m <= 16 else 64
    tiles = -(-m // block_m) * -(-n // BLOCK_N)
    split = n_seg > 1 and tiles < SPLIT_BELOW_TILES
    part = (torch.empty((n_seg, m, n), dtype=torch.float32, device=x.device)
            if split else None)
    tickets = _tickets_on(x.device) if split else None
    lib = _lib.library()
    _lib.count("rows_linear")
    rc = lib.wca_rows_linear(
        x2.data_ptr(), weight.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if tickets is None else tickets.data_ptr(), m, n, k, seg_chunks,
        n_seg, int(split), int(dtype == torch.bfloat16),
        int(out_dtype == torch.float32), _lib.stream_of(x))
    _lib.check(rc, "rows_linear")
    return out.reshape(*x.shape[:-1], n)
