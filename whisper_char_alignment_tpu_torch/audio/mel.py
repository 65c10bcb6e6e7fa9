"""Log-mel spectrogram frontend (port of ``whisper_char_alignment_tpu/audio/mel.py``).

    pad/trim to 480_000 samples -> centered STFT (N_FFT=400, HOP=160, periodic
    Hann, reflect padding, drop last frame) -> |.|^2 -> Slaney mel filterbank
    -> log10 clamped at 1e-10 -> per-utterance clip at (max - 8) -> (x + 4) / 4

The DFT is two float32 matmuls against cos/sin bases, as the JAX package's
default (``use_fft=False``) path computes it. :func:`wire_to_mel` adds the
runner's int16 wire decode and on-device zero padding
(``whisper_char_alignment_tpu/runner.py::_mel_step_jit``), and with
``WCA_MEL_IMPL=pallas`` runs the mel kernel of ``ops/mel_cuda.py`` instead.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import constants


def pad_or_trim(array, length: int = constants.N_SAMPLES, axis: int = -1):
    """Pad with zeros or trim ``array`` (numpy or torch) to exactly ``length``
    along ``axis``."""
    n = array.shape[axis]
    if n > length:
        sl = [slice(None)] * array.ndim
        sl[axis] = slice(0, length)
        return array[tuple(sl)]
    if n < length:
        if isinstance(array, torch.Tensor):
            shape = list(array.shape)
            shape[axis] = length - n
            return torch.cat([array, array.new_zeros(shape)], dim=axis)
        pad = [(0, 0)] * array.ndim
        pad[axis] = (0, length - n)
        return np.pad(array, pad)
    return array


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    above = f >= min_log_hz
    return np.where(above, min_log_mel
                    + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    f = m * f_sp
    above = m >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), f)


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_mels: int = constants.N_MELS, n_fft: int = constants.N_FFT,
                   sample_rate: int = constants.SAMPLE_RATE) -> np.ndarray:
    """Slaney-scale, Slaney-normalized triangular mel filterbank (n_mels,
    n_fft//2 + 1), float32 (librosa.filters.mel defaults)."""
    fftfreqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    mel_min = _hz_to_mel_slaney(0.0)
    mel_max = _hz_to_mel_slaney(sample_rate / 2)
    mel_pts = np.linspace(mel_min, mel_max, n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _dft_bases(n_fft: int):
    k = np.arange(n_fft // 2 + 1)[:, None]
    n = np.arange(n_fft)[None, :]
    ang = -2.0 * np.pi * k * n / n_fft
    return (np.cos(ang).astype(np.float32).T, np.sin(ang).astype(np.float32).T)


def log10_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """The spectrogram up to its log: (B, n_samples) float32 -> (B, n_mels,
    n_samples // HOP) ``log10(max(mel, 1e-10))``, before the per-item clip.
    Runs where ``audio`` lies."""
    n_fft, hop = constants.N_FFT, constants.HOP_LENGTH
    dev = audio.device
    window = torch.from_numpy(
        np.hanning(n_fft + 1)[:-1].astype(np.float32)).to(dev)  # periodic
    padded = F.pad(audio[:, None, :], (n_fft // 2, n_fft // 2),
                   mode="reflect")[:, 0]
    frames = padded.unfold(-1, n_fft, hop) * window  # (B, 1 + n // hop, n_fft)
    frames = frames[:, :-1]  # whisper drops the final STFT frame

    cos_b, sin_b = (torch.from_numpy(b).to(dev) for b in _dft_bases(n_fft))
    re = frames @ cos_b
    im = frames @ sin_b
    magnitudes = re * re + im * im

    filters = torch.from_numpy(mel_filterbank(n_mels)).to(dev)
    mel_spec = torch.einsum("mf,btf->bmt", filters, magnitudes)
    return torch.log10(mel_spec.clamp(min=1e-10))


def clip_and_scale(log_spec: torch.Tensor) -> torch.Tensor:
    """Whisper's per-item dynamic-range clip at (max - 8), then (x + 4) / 4,
    over (B, n_mels, frames)."""
    log_spec = torch.maximum(
        log_spec, log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return (log_spec + 4.0) / 4.0


def log_mel_spectrogram(audio: torch.Tensor,
                        n_mels: int = constants.N_MELS) -> torch.Tensor:
    """Whisper log-mel spectrogram of 16 kHz ``audio`` (..., n_samples)
    float32, typically already padded to 30 s. Returns (..., n_mels,
    n_samples // HOP): 3000 frames for 30 s input. Runs where ``audio``
    lies."""
    audio = torch.as_tensor(audio, dtype=torch.float32)
    squeeze = audio.ndim == 1
    if squeeze:
        audio = audio[None]
    lead = audio.shape[:-1]
    audio = audio.reshape(-1, audio.shape[-1])
    log_spec = clip_and_scale(log10_mel(audio, n_mels))
    out = log_spec.reshape(lead + log_spec.shape[-2:])
    return out[0] if squeeze else out


def mel_impl() -> str:
    """The frontend ``wire_to_mel`` runs (env ``WCA_MEL_IMPL``): ``xla``
    (default; the matmul DFT above, the JAX package's name for it) or
    ``pallas`` (the mel kernel of ``ops/mel_cuda.py``, the JAX package's
    name for its kernel). Any other value raises."""
    mode = os.environ.get("WCA_MEL_IMPL", "xla")
    if mode not in ("xla", "pallas"):
        raise ValueError(f"WCA_MEL_IMPL={mode!r} is not a known frontend; "
                         "use xla or pallas")
    return mode


def wire_to_mel(wire: torch.Tensor, n_mels: int,
                total_samples: Optional[int] = None,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The runner's mel step: an int16 wire batch (exact for 16-bit PCM) is
    scaled by 1/32768; a batch shorter than ``total_samples`` is zero-padded
    on its device (bit-exact with padding on the host); then the log-mel of
    :func:`mel_impl`'s frontend, cast to the compute dtype."""
    if wire.dtype == torch.int16:
        wire = wire.float() * (1.0 / 32768.0)
    if total_samples is not None and wire.shape[-1] < total_samples:
        wire = F.pad(wire, (0, total_samples - wire.shape[-1]))
    if mel_impl() == "pallas":
        from ..ops.mel_cuda import log_mel

        return log_mel(wire, n_mels=n_mels).to(compute_dtype)
    return log_mel_spectrogram(wire, n_mels=n_mels).to(compute_dtype)
