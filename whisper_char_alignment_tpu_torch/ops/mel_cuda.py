"""The log-mel frontend as one kernel.

The CUDA kernel (``csrc/mel.cu``) replaces the Pallas kernel
``whisper_char_alignment_tpu/ops/mel_pallas.py::log_mel_pallas`` (its
``_mel_kernel`` and the framing before it): reflect-padded framing, the Hann
window, the 400-tap DFT against the f32 ``_dft_bases``, power, the mel
projection and ``log10(max(., 1e-10))``. :func:`log10_mel_plain` is that part
in plain PyTorch (the default frontend of ``audio/mel.py``): the CPU path and
the kernel's oracle. The per-item (max - 8) clip and (x + 4) / 4 follow in
plain PyTorch for both, as they follow the Pallas kernel in the JAX package;
:func:`log_mel` and :func:`log_mel_plain` are the whole function.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import constants
from ..audio.mel import _dft_bases, clip_and_scale, log10_mel, mel_filterbank
from . import _lib

log10_mel_plain = log10_mel


@functools.lru_cache(maxsize=4)
def _tables(n_mels: int):
    """The kernel's constant inputs, as NumPy arrays: the periodic Hann
    window; column k=1 of the f32 DFT bases (cos_b[n, k] is that column at
    (n k) mod 400); the filterbank and each filter's nonzero bin run
    [lo, hi)."""
    n_fft = constants.N_FFT
    window = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    cos_b, sin_b = _dft_bases(n_fft)
    fb = mel_filterbank(n_mels)
    nz = fb != 0
    lo = np.where(nz.any(1), nz.argmax(1), 0).astype(np.int32)
    hi = np.where(nz.any(1), fb.shape[1] - nz[:, ::-1].argmax(1),
                  0).astype(np.int32)
    return (window, np.ascontiguousarray(cos_b[:, 1]),
            np.ascontiguousarray(sin_b[:, 1]), fb, lo, hi)


@functools.lru_cache(maxsize=8)
def _device_tables(n_mels: int, device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in _tables(n_mels))


def log10_mel_kernel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(B, n_samples) float32 contiguous on a CUDA card -> (B, n_mels,
    n_samples // 160) ``log10(max(mel, 1e-10))``, through the kernel."""
    b, n = audio.shape
    dev = audio.device
    window, cos_c, sin_c, fb, lo, hi = _device_tables(n_mels, dev)
    n_frames = n // constants.HOP_LENGTH
    out = torch.empty((b, n_mels, n_frames), dtype=torch.float32, device=dev)
    lib = _lib.library()
    _lib.count("mel")
    rc = lib.wca_mel(audio.data_ptr(), window.data_ptr(), cos_c.data_ptr(),
                     sin_c.data_ptr(), fb.data_ptr(), lo.data_ptr(),
                     hi.data_ptr(), out.data_ptr(), b, n, n_frames, n_mels,
                     _lib.stream_of(audio))
    _lib.check(rc, "mel")
    return out


def log_mel_plain(audio: torch.Tensor,
                  n_mels: int = constants.N_MELS) -> torch.Tensor:
    """``log_mel_pallas``'s function in plain PyTorch: (B, n_samples)
    float32 -> (B, n_mels, n_samples // 160)."""
    return clip_and_scale(log10_mel_plain(audio.float(), n_mels))


def log_mel(audio: torch.Tensor, n_mels: int = constants.N_MELS
            ) -> torch.Tensor:
    """Whisper's log-mel of (B, n_samples) float32 audio (already padded or
    trimmed), (B, n_mels, n_samples // 160): the kernel for a CUDA tensor,
    :func:`log_mel_plain` for a CPU tensor."""
    if audio.ndim != 2:
        raise ValueError(f"audio must be (B, n_samples), got "
                         f"{tuple(audio.shape)}")
    if audio.shape[1] <= constants.N_FFT // 2:
        raise ValueError(f"{audio.shape[1]} samples: reflect padding needs "
                         f"more than {constants.N_FFT // 2}")
    if _lib.require_cuda_or_cpu(audio) == "cpu":
        return log_mel_plain(audio, n_mels)
    if audio.dtype != torch.float32:
        raise ValueError(f"audio must be float32, got {audio.dtype}")
    return clip_and_scale(log10_mel_kernel(audio.contiguous(), n_mels))
