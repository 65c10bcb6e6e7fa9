"""The log-mel frontend as two kernels.

The CUDA kernels (``csrc/mel.cu``) replace the Pallas kernel
``whisper_char_alignment_tpu/ops/mel_pallas.py::log_mel_pallas`` with the
framing before it and the clip after it. ``mel_spectrum_kernel`` does the
reflect-padded framing, the Hann window, a real 400-point FFT (a 200-point
complex FFT, radices 8, 5, 5, and the split step), power, the mel projection
over each filter's nonzero run and ``log10(max(., 1e-10))``, and writes each
64-frame tile's maximum; ``mel_clip_kernel`` reduces an item's tile maxima
and applies the per-item (max - 8) clip and (x + 4) / 4 in place.

:func:`log_mel_plain` is the same function in plain PyTorch (the default
frontend of ``audio/mel.py``): the CPU path and the kernels' oracle;
:func:`mel_clip_plain` is the clip kernel's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import constants
from ..audio.mel import clip_and_scale, log10_mel, mel_filterbank
from . import _lib

log10_mel_plain = log10_mel

MAX_MELS = 128  # the JAX kernel's mel padding (mel_pallas.py _NMELS_PAD)
TILE_FRAMES = 64  # frames per spectrum block, one tile maximum each

# float offsets into the twiddle table (kTw* in csrc/mel.cu)
TW_R5, TW_R8, TW_40, TW_200, TW_400, TW_FLOATS = 0, 4, 8, 88, 488, 892


def _w(j, n: int) -> np.ndarray:
    """(re, im) of W_n^j = exp(-2 pi i j / n) in float64, as (..., 2)."""
    ang = 2.0 * np.pi * np.asarray(j, np.float64) / n
    return np.stack([np.cos(ang), -np.sin(ang)], axis=-1)


def twiddles() -> np.ndarray:
    """The FFT's constants for the kernel, float64 rounded to float32: the
    radix-5 cos/sin of 2pi/5 and 4pi/5, sqrt(1/2) for radix 8, W_200^{5 n2
    k1} at [n2, k1] (5 x 8), W_200^{n3 q} at [n3, q] (5 x 40) and W_400^k
    for the 201 bins, laid out at the ``TW_*`` offsets."""
    tw = np.zeros(TW_FLOATS, np.float64)
    tw[TW_R5:TW_R5 + 4] = [np.cos(2 * np.pi / 5), np.sin(2 * np.pi / 5),
                           np.cos(4 * np.pi / 5), np.sin(4 * np.pi / 5)]
    tw[TW_R8] = np.sqrt(0.5)
    n2, k1 = np.meshgrid(np.arange(5), np.arange(8), indexing="ij")
    tw[TW_40:TW_200] = _w(5 * n2 * k1, 200).ravel()
    n3, q = np.meshgrid(np.arange(5), np.arange(40), indexing="ij")
    tw[TW_200:TW_400] = _w(n3 * q, 200).ravel()
    tw[TW_400:TW_400 + 402] = _w(np.arange(201), 400).ravel()
    return tw.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _tables(n_mels: int):
    """The kernels' constant inputs, as NumPy arrays: the periodic Hann
    window, the twiddle table, and the filterbank's nonzero runs: each
    filter's weights on [lo, hi) packed in turn, starting at off[m]."""
    n_fft = constants.N_FFT
    window = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    fb = mel_filterbank(n_mels)
    nz = fb != 0
    lo = np.where(nz.any(1), nz.argmax(1), 0).astype(np.int32)
    hi = np.where(nz.any(1), fb.shape[1] - nz[:, ::-1].argmax(1),
                  0).astype(np.int32)
    off = np.concatenate([[0], np.cumsum(hi - lo)]).astype(np.int32)
    packed = np.concatenate([fb[m, lo[m]:hi[m]] for m in range(n_mels)]
                            ).astype(np.float32)
    return window, twiddles(), packed, lo, off


@functools.lru_cache(maxsize=8)
def _device_tables(n_mels: int, device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in _tables(n_mels))


def _check_mels(n_mels: int) -> None:
    if not 0 < n_mels <= MAX_MELS:
        raise ValueError(f"n_mels={n_mels}: the mel kernel takes 1 to "
                         f"{MAX_MELS}")


def log10_mel_kernel(audio: torch.Tensor, n_mels: int, stream=None):
    """(B, n_samples) float32 contiguous on a CUDA card -> the spectrum
    kernel's (B, n_mels, n_samples // 160) ``log10(max(mel, 1e-10))`` and
    its (B, n_tiles) tile maxima, launched on ``stream`` (the current one
    when None)."""
    b, n = audio.shape
    dev = audio.device
    window, tw, packed, lo, off = _device_tables(n_mels, dev)
    n_frames = n // constants.HOP_LENGTH
    n_tiles = -(-n_frames // TILE_FRAMES)
    out = torch.empty((b, n_mels, n_frames), dtype=torch.float32, device=dev)
    tile_max = torch.empty((b, n_tiles), dtype=torch.float32, device=dev)
    lib = _lib.library()
    _lib.count("mel")
    rc = lib.wca_mel(audio.data_ptr(), window.data_ptr(), tw.data_ptr(),
                     packed.data_ptr(), lo.data_ptr(), off.data_ptr(),
                     out.data_ptr(), tile_max.data_ptr(), b, n, n_frames,
                     n_mels, packed.numel(),
                     _lib.stream_of(audio) if stream is None else stream)
    _lib.check(rc, "mel")
    return out, tile_max


def _clip_kernel(log_spec: torch.Tensor, tile_max: torch.Tensor,
                 stream: int) -> torch.Tensor:
    b, n_mels, n_frames = log_spec.shape
    _lib.count("mel_clip")
    rc = _lib.library().wca_mel_clip(log_spec.data_ptr(), tile_max.data_ptr(),
                                     b, n_mels * n_frames, tile_max.shape[1],
                                     stream)
    _lib.check(rc, "mel_clip")
    return log_spec


def mel_clip_plain(log_spec: torch.Tensor,
                   tile_max: torch.Tensor) -> torch.Tensor:
    """The clip kernel's function: ``clip_and_scale`` with each item's
    maximum taken from its tile maxima (B, n_tiles)."""
    floor = tile_max.amax(dim=-1)[:, None, None] - 8.0
    return (torch.maximum(log_spec, floor) + 4.0) / 4.0


def mel_clip(log_spec: torch.Tensor, tile_max: torch.Tensor) -> torch.Tensor:
    """The per-item clip and scale of (B, n_mels, frames) float32 by the
    maximum of each item's tile maxima (B, n_tiles): in place by the kernel
    for CUDA tensors (``log_spec`` is returned), :func:`mel_clip_plain` for
    CPU tensors."""
    if _lib.require_cuda_or_cpu(log_spec, tile_max) == "cpu":
        return mel_clip_plain(log_spec, tile_max)
    if (log_spec.dtype != torch.float32 or tile_max.dtype != torch.float32
            or log_spec.ndim != 3 or tile_max.ndim != 2
            or tile_max.shape[0] != log_spec.shape[0]
            or not (log_spec.is_contiguous() and tile_max.is_contiguous())):
        raise ValueError(f"mel_clip takes contiguous float32 (B, n_mels, "
                         f"frames) and (B, n_tiles), got "
                         f"{tuple(log_spec.shape)} {log_spec.dtype} and "
                         f"{tuple(tile_max.shape)} {tile_max.dtype}")
    return _clip_kernel(log_spec, tile_max, _lib.stream_of(log_spec))


def log_mel_plain(audio: torch.Tensor,
                  n_mels: int = constants.N_MELS) -> torch.Tensor:
    """``log_mel_pallas``'s function in plain PyTorch: (B, n_samples)
    float32 -> (B, n_mels, n_samples // 160)."""
    return clip_and_scale(log10_mel_plain(audio.float(), n_mels))


def log_mel(audio: torch.Tensor, n_mels: int = constants.N_MELS
            ) -> torch.Tensor:
    """Whisper's log-mel of (B, n_samples) float32 audio (already padded or
    trimmed), (B, n_mels, n_samples // 160): the two kernels for a CUDA
    tensor, :func:`log_mel_plain` for a CPU tensor."""
    if audio.ndim != 2:
        raise ValueError(f"audio must be (B, n_samples), got "
                         f"{tuple(audio.shape)}")
    if audio.shape[1] <= constants.N_FFT // 2:
        raise ValueError(f"{audio.shape[1]} samples: reflect padding needs "
                         f"more than {constants.N_FFT // 2}")
    _check_mels(n_mels)
    if _lib.require_cuda_or_cpu(audio) == "cpu":
        return log_mel_plain(audio, n_mels)
    if audio.dtype != torch.float32:
        raise ValueError(f"audio must be float32, got {audio.dtype}")
    stream = _lib.stream_of(audio)
    return _clip_kernel(*log10_mel_kernel(audio.contiguous(), n_mels, stream),
                        stream)
