"""The int8 encoder linear: row quantize, int8 product, float epilogue.

The JAX package's ``_linear_int8`` (``whisper_char_alignment_tpu/models/
whisper.py``) quantizes each activation row to int8, takes an
int8 x int8 -> int32 product with the per-output-channel int8 weights and
scales the product back in float. XLA fuses the two element-wise passes;
here they are the two CUDA kernels of ``csrc/int8_linear.cu``
(:func:`quantize_rows`, :func:`dequantize`), and the product is the library
int8 GEMM (:func:`int_mm`, ``torch._int_mm`` on a card), as JAX leaves it to
XLA. Each has its plain PyTorch version beside it: the CPU path and the
kernel's oracle, bit-equal to it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import _lib

# amax / 127 as the JAX package's compiled quantizers evaluate it: XLA turns
# the division by a constant into a product with the float32 reciprocal
RECIP_127 = float(np.float32(1.0 / 127.0))
# the widest row the quantize kernel holds in registers (8 values x 4
# vectors x 256 threads)
MAX_QUANT_K = 8192


def scale_of(amax: torch.Tensor) -> torch.Tensor:
    """``amax / 127`` as XLA evaluates it, and 1.0 where amax is 0."""
    return torch.where(amax == 0, torch.ones_like(amax), amax * RECIP_127)


def quantize_rows_plain(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (M, K) -> (int8 codes (M, K), float32 scales (M, 1)): each row's
    scale is :func:`scale_of` its max |x| (``amax`` (M, 1) float32 when the
    row's max is taken elsewhere, e.g. over a tensor-parallel group), codes
    ``clip(round(x / scale), -127, 127)`` with a true division, round half
    to even (JAX ``_int8_rowwise``)."""
    xf = x.float()
    if amax is None:
        amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = scale_of(amax)
    return (torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8),
            scale)


def quantize_rows(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_rows_plain`'s function: the quantize kernel for CUDA
    tensors (one launch), the plain version for CPU tensors. x (M, K)
    bfloat16 or float32 with K a multiple of 8 up to ``MAX_QUANT_K``."""
    if x.ndim != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    m, k = x.shape
    if amax is not None and amax.shape != (m, 1):
        raise ValueError(f"amax must be ({m}, 1), got {tuple(amax.shape)}")
    tensors = (x,) if amax is None else (x, amax)
    if _lib.require_cuda_or_cpu(*tensors) == "cpu":
        return quantize_rows_plain(x, amax)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    if k % 8 or k > MAX_QUANT_K:
        raise ValueError(f"row width {k}: the kernel takes multiples of 8 up "
                         f"to {MAX_QUANT_K}")
    x = x.contiguous()
    _lib.require_aligned("int8 quantize", x)
    if amax is not None:
        amax = amax.float().contiguous()
    codes = torch.empty((m, k), dtype=torch.int8, device=x.device)
    scales = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    _lib.count("int8_quant")
    rc = _lib.library().wca_int8_quant(
        x.data_ptr(), None if amax is None else amax.data_ptr(),
        codes.data_ptr(), scales.data_ptr(), m, k,
        int(x.dtype == torch.bfloat16), _lib.stream_of(x))
    _lib.check(rc, "int8_quant")
    return codes, scales


def int_mm(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """x8 (M, K) int8 times w8 (N, K) int8 transposed: (M, N) int32, exact.
    On a card ``torch._int_mm`` (cuBLASLt's int8 GEMM; it takes M > 16 and K,
    N multiples of 8, the weight column-major: ``w8.t()`` of a contiguous
    (N, K)); rows of a shorter M are zero-padded to 17 and cut off. On the
    CPU an int32 matmul."""
    if x8.dtype != torch.int8 or w8.dtype != torch.int8:
        raise ValueError("int_mm takes int8 operands")
    if _lib.require_cuda_or_cpu(x8, w8) == "cpu":
        return torch.matmul(x8.to(torch.int32), w8.to(torch.int32).t())
    m, k = x8.shape
    n = w8.shape[0]
    if k % 8 or n % 8:
        raise ValueError(f"int8 product ({m}, {k}) x ({k}, {n}): K and N must "
                         "be multiples of 8")
    if m > 16:
        return torch._int_mm(x8.contiguous(), w8.t())
    pad = torch.zeros((17, k), dtype=torch.int8, device=x8.device)
    pad[:m] = x8
    return torch._int_mm(pad, w8.t())[:m]


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """``a * b + c`` of float32 tensors rounded once to float32 (a fused
    multiply-add), in float64 arithmetic: the product is exact in float64;
    the sum's rounding error (Knuth's TwoSum) settles the one case in which
    rounding the float64 sum to float32 would round twice, a sum that lands
    exactly halfway between two float32 values."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)  # s + err == p + c exactly
    r = s.float()
    rd = r.double()
    inf = torch.tensor(float("inf"), device=r.device)
    other = torch.nextafter(r, torch.where(s > rd, inf, -inf))
    tie = (s != rd) & ((s - rd) == (other.double() - s))
    toward_other = tie & (err != 0) & ((err > 0) == (other.double() > s))
    return torch.where(toward_other, other, r)


def dequantize_plain(y: torch.Tensor, xs: torch.Tensor, s: torch.Tensor,
                     bias: Optional[torch.Tensor], dtype: torch.dtype
                     ) -> torch.Tensor:
    """(M, N) int32 product -> ``dtype``; xs (M, 1) and s (N,) float32. As
    XLA compiles JAX ``_linear_int8``: in bfloat16, ``(float(y) * xs) * s``
    rounded to bfloat16, then ``+ bias`` in bfloat16; in float32 the last
    product and the bias add are one fused multiply-add,
    ``fma(float(y) * xs, s, bias)`` (:func:`fma_f32`; XLA contracts them)."""
    t = y.float() * xs
    if dtype == torch.float32 and bias is not None:
        return fma_f32(t, s.expand_as(t), bias.float().expand_as(t))
    out = (t * s).to(dtype)
    if bias is not None:
        out = out + bias.to(dtype)
    return out


def dequantize(y: torch.Tensor, xs: torch.Tensor, s: torch.Tensor,
               bias: Optional[torch.Tensor], dtype: torch.dtype
               ) -> torch.Tensor:
    """:func:`dequantize_plain`'s function: the epilogue kernel for CUDA
    tensors (one launch), the plain version for CPU tensors. ``dtype`` is
    bfloat16 or float32; N a multiple of 4."""
    if y.ndim != 2 or y.dtype != torch.int32:
        raise ValueError(f"y must be (M, N) int32, got {tuple(y.shape)} "
                         f"{y.dtype}")
    m, n = y.shape
    if xs.shape != (m, 1) or s.shape != (n,):
        raise ValueError(f"scales must be ({m}, 1) and ({n},), got "
                         f"{tuple(xs.shape)} and {tuple(s.shape)}")
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"bias must be ({n},), got {tuple(bias.shape)}")
    tensors = (y, xs, s) if bias is None else (y, xs, s, bias)
    if _lib.require_cuda_or_cpu(*tensors) == "cpu":
        return dequantize_plain(y, xs, s, bias, dtype)
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"output dtype must be bfloat16 or float32, got "
                         f"{dtype}")
    if n % 4:
        raise ValueError(f"{n} output columns: the kernel takes multiples of 4")
    y = y.contiguous()
    xs = xs.float().contiguous()
    s = s.float().contiguous()
    if bias is not None:
        bias = bias.to(dtype).contiguous()
    out = torch.empty((m, n), dtype=dtype, device=y.device)
    _lib.require_aligned("int8 epilogue", y, s, out,
                         *(() if bias is None else (bias,)))
    _lib.count("int8_dequant")
    rc = _lib.library().wca_int8_dequant(
        y.data_ptr(), xs.data_ptr(), s.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), m, n,
        int(dtype == torch.bfloat16), _lib.stream_of(y))
    _lib.check(rc, "int8_dequant")
    return out
