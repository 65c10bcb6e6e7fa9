"""Fused QK post-process: median filter -> scaled f32 softmax -> masks.

The CUDA kernel (``csrc/qkpost.cu``) replaces the Pallas kernel
``whisper_char_alignment_tpu/ops/qkpost_pallas.py::qk_postprocess_fused``.
:func:`qk_postprocess_plain` is the same function in plain PyTorch (the
masks of ``whisper_char_alignment_tpu/models/whisper.py::qk_to_attention``
around ``ops/medfilt.median_filter_masked``): the CPU path and the kernel's
oracle.
"""

from __future__ import annotations

import torch

from . import _lib
from .medfilt import median_filter_masked

# widest median whose sorted window has a kernel of its own width
# (kMaxExactWidth in csrc/qkpost.cu); a wider odd width takes a padded
# register window up to PAD_WIDTH and a shared-memory window above, and its
# launches are counted as "qkpost_rank"
EXACT_WIDTH = 31
PAD_WIDTH = 127


def qk_postprocess_plain(qk: torch.Tensor, frame_len: torch.Tensor,
                         token_len: torch.Tensor, width: int,
                         qk_scale: float = 1.0) -> torch.Tensor:
    """qk (B, H, T, F) raw cross-attention logits -> attention maps (B, H, T,
    F) f32: per-item reflected median on the logits, x qk_scale, frames >=
    frame_len -> -inf, f32 softmax over frames, rows >= token_len zeroed."""
    b, _, t, f = qk.shape
    frame_len = frame_len.to(qk.device)
    token_len = token_len.to(qk.device)
    x = median_filter_masked(qk.float(), width, frame_len)
    frame_ok = torch.arange(f, device=qk.device)[None, :] < frame_len[:, None]
    x = torch.where(frame_ok[:, None, None, :], x * qk_scale,
                    torch.tensor(float("-inf"), device=qk.device))
    attn = torch.softmax(x, dim=-1)
    token_ok = torch.arange(t, device=qk.device)[None, :] < token_len[:, None]
    return torch.where(token_ok[:, None, :, None], attn,
                       torch.zeros((), device=qk.device))


def qk_postprocess(qk: torch.Tensor, frame_len: torch.Tensor,
                   token_len: torch.Tensor, width: int,
                   qk_scale: float = 1.0) -> torch.Tensor:
    """The post-process of :func:`qk_postprocess_plain`: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors.

    qk (B, H, T, F) float32 contiguous; frame_len, token_len (B,) int32 on
    the same device, frame_len in [1, F]; width any odd positive number (the
    kernel's sorted windows sit in registers up to ``PAD_WIDTH`` and in
    shared memory above; the kernel raises where its buffers do not fit in
    a block's shared memory: above F=9,680, and at F=1500 above width
    767)."""
    if qk.ndim != 4:
        raise ValueError(f"qk must be (B, H, T, F), got {tuple(qk.shape)}")
    if width <= 0 or width % 2 != 1:
        raise ValueError(f"median width must be odd and positive, got {width}")
    b, h, t, f = qk.shape
    for name, v in (("frame_len", frame_len), ("token_len", token_len)):
        if v.shape != (b,):
            raise ValueError(f"{name} must be ({b},), got {tuple(v.shape)}")
    kind = _lib.require_cuda_or_cpu(qk, frame_len, token_len)
    if kind == "cpu":
        return qk_postprocess_plain(qk, frame_len, token_len, width, qk_scale)
    if qk.dtype != torch.float32 or not qk.is_contiguous():
        raise ValueError("qk must be contiguous float32")
    if frame_len.dtype != torch.int32 or token_len.dtype != torch.int32:
        raise ValueError("frame_len and token_len must be int32")
    frame_len = frame_len.contiguous()
    token_len = token_len.contiguous()
    out = torch.empty_like(qk)
    lib = _lib.library()
    _lib.count("qkpost" if width <= EXACT_WIDTH else "qkpost_rank")
    rc = lib.wca_qkpost(qk.data_ptr(), out.data_ptr(), frame_len.data_ptr(),
                        token_len.data_ptr(), b, h, t, f, width,
                        float(qk_scale), _lib.stream_of(qk))
    _lib.check(rc, "qkpost")
    return out
