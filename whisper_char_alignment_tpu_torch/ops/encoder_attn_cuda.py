"""Encoder self-attention.

The CUDA kernel (``csrc/encoder_attn.cu``) replaces the Pallas kernel
``whisper_char_alignment_tpu/ops/encoder_attn_pallas.py::encoder_self_attention``.
:func:`encoder_self_attention_plain` is the same function in plain PyTorch
(an einsum with an f32 softmax): the CPU path and the kernel's oracle.
"""

from __future__ import annotations

import torch

from . import _lib

_HEAD_DIMS = (16, 32, 64, 128)


def encoder_self_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, n_valid: int) -> torch.Tensor:
    """q/k/v (B, H, T, hd), q and k pre-scaled by hd**-0.25; attends over
    keys < n_valid. Scores and P v accumulate in f32; the probabilities are
    cast to the input dtype before P v."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    t = s.shape[-1]
    if n_valid < t:
        s[..., n_valid:] = float("-inf")
    w = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bhkd->bhqd", w.float(), v.float())
    return o.to(q.dtype)


def encoder_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           n_valid: int) -> torch.Tensor:
    """Self-attention of :func:`encoder_self_attention_plain`: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors.

    q/k/v (B, H, T, hd) contiguous, one dtype (float32 or bfloat16 on the
    card), hd in (16, 32, 64, 128) on the card; 1 <= n_valid <= T."""
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("q, k, v must share one (B, H, T, hd) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share one dtype")
    b, h, t, hd = q.shape
    if not 1 <= n_valid <= t:
        raise ValueError(f"n_valid={n_valid} outside [1, {t}]")
    if _lib.require_cuda_or_cpu(q, k, v) == "cpu":
        return encoder_self_attention_plain(q, k, v, n_valid)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {q.dtype}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {_HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    o = torch.empty_like(q)
    lib = _lib.library()
    _lib.count("encoder_attn")
    rc = lib.wca_encoder_attn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              o.data_ptr(), b * h, t, int(n_valid), hd,
                              int(q.dtype == torch.bfloat16),
                              _lib.stream_of(q))
    _lib.check(rc, "encoder_attn")
    return o
