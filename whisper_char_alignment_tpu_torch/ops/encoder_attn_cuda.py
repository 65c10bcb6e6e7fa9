"""Encoder self-attention.

The CUDA kernel (``csrc/encoder_attn.cu``) replaces the Pallas kernels
``whisper_char_alignment_tpu/ops/encoder_attn_pallas.py::encoder_self_attention``
and, in its K-transposed instantiation, ``encoder_self_attention_kt``.
:func:`encoder_self_attention_plain` is that function in plain PyTorch (an
einsum with an f32 softmax): the CPU path and both kernels' oracle.
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


# the K-transposed kernel computes the same function from K laid out (B, H,
# hd, T); its plain version is the one above
encoder_self_attention_kt_plain = encoder_self_attention_plain


def _check_inputs(q, k, v, n_valid) -> str:
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("q, k, v must share one (B, H, T, hd) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share one dtype")
    if not 1 <= n_valid <= q.shape[2]:
        raise ValueError(f"n_valid={n_valid} outside [1, {q.shape[2]}]")
    kind = _lib.require_cuda_or_cpu(q, k, v)
    if kind == "cuda":
        if q.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"unsupported dtype {q.dtype}")
        if q.shape[3] not in _HEAD_DIMS:
            raise ValueError(f"head_dim {q.shape[3]} not in {_HEAD_DIMS}")
        if not (q.is_contiguous() and k.is_contiguous()
                and v.is_contiguous()):
            raise ValueError("q, k, v must be contiguous")
    return kind


def _launch(name: str, q, k, v, n_valid: int) -> torch.Tensor:
    b, h, t, hd = q.shape
    o = torch.empty_like(q)
    _lib.require_aligned(name, q, k, v, o)
    lib = _lib.library()
    _lib.count(name)
    rc = getattr(lib, "wca_" + name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b * h, t,
        int(n_valid), hd, int(q.dtype == torch.bfloat16), _lib.stream_of(q))
    _lib.check(rc, name)
    return o


def encoder_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           n_valid: int) -> torch.Tensor:
    """Self-attention of :func:`encoder_self_attention_plain`: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors.

    q/k/v (B, H, T, hd) contiguous, one dtype (float32 or bfloat16 on the
    card), hd in (16, 32, 64, 128) on the card; 1 <= n_valid <= T."""
    if _check_inputs(q, k, v, n_valid) == "cpu":
        return encoder_self_attention_plain(q, k, v, n_valid)
    return _launch("encoder_attn", q, k, v, n_valid)


def encoder_self_attention_kt(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, n_valid: int) -> torch.Tensor:
    """The same self-attention through the K-transposed kernel: K is
    transposed to (B, H, hd, T) here, outside the kernel (as the JAX
    wrapper does), and the kernel reads it in that layout. Takes what
    :func:`encoder_self_attention` takes."""
    if _check_inputs(q, k, v, n_valid) == "cpu":
        return encoder_self_attention_kt_plain(q, k, v, n_valid)
    return _launch("encoder_attn_kt", q, k.transpose(-1, -2).contiguous(), v,
                   n_valid)
