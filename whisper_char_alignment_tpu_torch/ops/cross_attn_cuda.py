"""One decode step's cross-attention over precomputed (B, H, hd, F) K/V.

The CUDA kernel (``csrc/cross_attn.cu``) replaces the Pallas kernels
``whisper_char_alignment_tpu/ops/cross_attn_pallas.py::cross_attn_step_int8``
(int8 K/V with per-frame float32 scales) and ``cross_attn_step`` (float K/V);
both are one kernel body there and one templated kernel here.
:func:`cross_attn_step_int8_plain` and :func:`cross_attn_step_plain` are the
same functions in plain PyTorch: the CPU path and the kernel's oracle.

Every step is float32: ``s = (sum_hd q k) [* k_s] * k_scale``, an f32
softmax ``exp(s - max) / sum``, ``w [* v_s]``, ``o = sum_F v w``. The output
is (B, H, 1, hd) float32; the caller casts it to its compute dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _lib

# head dims the kernel is instantiated for; float F is not limited (frames
# beyond a shared-memory stage's width are walked in chunks), int8 K/V take
# one stage (Whisper's window is 1500 frames)
_HEAD_DIMS = (16, 32, 64, 128)
_MAX_INT8_FRAMES = 3072


def _plain(q, k, v, k_scale: float, k_s=None, v_s=None) -> torch.Tensor:
    qf = q.float()  # (B, H, 1, hd)
    s = (k.float() * qf.transpose(-1, -2)).sum(dim=2)  # (B, H, F)
    if k_s is not None:
        s = s * k_s[:, :, 0, :].float()
    s = s * k_scale
    w = torch.softmax(s, dim=-1)
    if v_s is not None:
        w = w * v_s[:, :, 0, :].float()
    return (v.float() * w[:, :, None, :]).sum(dim=-1)[:, :, None, :]


def cross_attn_step_int8_plain(q, k8, k_s, v8, v_s, *,
                               k_scale: float) -> torch.Tensor:
    """q (B, H, 1, hd) already * hd**-0.25; k8/v8 (B, H, hd, F) int8; k_s/v_s
    (B, H, 1, F) float32. Returns (B, H, 1, hd) float32."""
    return _plain(q, k8, v8, k_scale, k_s, v_s)


def cross_attn_step_plain(q, k, v, *, k_scale: float) -> torch.Tensor:
    """:func:`cross_attn_step_int8_plain` without scales: k/v (B, H, hd, F)
    in any float dtype."""
    return _plain(q, k, v, k_scale)


def _check(q, k, v, k_s: Optional[torch.Tensor],
           v_s: Optional[torch.Tensor]) -> str:
    if k.ndim != 4 or k.shape != v.shape:
        raise ValueError("k and v must share one (B, H, hd, F) shape, got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, hd, f = k.shape
    if tuple(q.shape) != (b, h, 1, hd):
        raise ValueError(f"q must be ({b}, {h}, 1, {hd}), got "
                         f"{tuple(q.shape)}")
    scales = [s for s in (k_s, v_s) if s is not None]
    for s in scales:
        if tuple(s.shape) != (b, h, 1, f):
            raise ValueError(f"scales must be ({b}, {h}, 1, {f}), got "
                             f"{tuple(s.shape)}")
    kind = _lib.require_cuda_or_cpu(q, k, v, *scales)
    if kind == "cuda":
        if hd not in _HEAD_DIMS:
            raise ValueError(f"head_dim {hd} not in {_HEAD_DIMS}")
        if not (k.is_contiguous() and v.is_contiguous()):
            raise ValueError("k and v must be contiguous")
        _lib.require_aligned("cross_attn", k, v)
    return kind


def cross_attn_step_int8(q, k8, k_s, v8, v_s, *,
                         k_scale: float) -> torch.Tensor:
    """The step of :func:`cross_attn_step_int8_plain`: the CUDA kernel for
    CUDA tensors (int8 codes, float32 scales, F up to 3072), the plain
    version for CPU tensors."""
    if _check(q, k8, v8, k_s, v_s) == "cpu":
        return cross_attn_step_int8_plain(q, k8, k_s, v8, v_s,
                                          k_scale=k_scale)
    if k8.dtype != torch.int8 or v8.dtype != torch.int8:
        raise ValueError("k8 and v8 must be int8")
    if k_s.dtype != torch.float32 or v_s.dtype != torch.float32:
        raise ValueError("k_s and v_s must be float32")
    b, h, hd, f = k8.shape
    if f > _MAX_INT8_FRAMES:
        raise ValueError(f"{f} int8 frames exceed the kernel's "
                         f"{_MAX_INT8_FRAMES}")
    qf = q.float().contiguous()
    k_s, v_s = k_s.contiguous(), v_s.contiguous()
    o = torch.empty((b, h, 1, hd), dtype=torch.float32, device=q.device)
    lib = _lib.library()
    _lib.count("cross_attn_int8")
    rc = lib.wca_cross_attn_int8(qf.data_ptr(), k8.data_ptr(), k_s.data_ptr(),
                                 v8.data_ptr(), v_s.data_ptr(), o.data_ptr(),
                                 b * h, hd, f, float(k_scale),
                                 _lib.stream_of(q))
    _lib.check(rc, "cross_attn_int8")
    return o


def cross_attn_step(q, k, v, *, k_scale: float) -> torch.Tensor:
    """The step of :func:`cross_attn_step_plain`: the CUDA kernel for CUDA
    tensors (k/v float32 or bfloat16, one dtype), the plain version for CPU
    tensors."""
    if _check(q, k, v, None, None) == "cpu":
        return cross_attn_step_plain(q, k, v, k_scale=k_scale)
    if k.dtype != v.dtype or k.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("k and v must share float32 or bfloat16, got "
                         f"{k.dtype}, {v.dtype}")
    b, h, hd, f = k.shape
    qf = q.float().contiguous()
    o = torch.empty((b, h, 1, hd), dtype=torch.float32, device=q.device)
    lib = _lib.library()
    _lib.count("cross_attn")
    rc = lib.wca_cross_attn(qf.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), b * h, hd, f, float(k_scale),
                            int(k.dtype == torch.bfloat16), _lib.stream_of(q))
    _lib.check(rc, "cross_attn")
    return o
