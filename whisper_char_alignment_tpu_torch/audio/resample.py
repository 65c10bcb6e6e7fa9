"""Sample-rate conversion for non-16 kHz inputs.

Copy of ``whisper_char_alignment_tpu/audio/resample.py`` for the PyTorch port, which
imports nothing of the JAX package; only imports changed.

The reference stack hands resampling to torchaudio/ffmpeg (whisper.load_audio
shells out to ffmpeg with ``-ar 16000``); its own dataset code then asserts
16 kHz (reference dataset.py:45, 106). This framework keeps the dataset path
strictly 16 kHz (parity), and the extension APIs (api.align / api.transcribe /
cli.transcribe) accept any rate through this module: polyphase rational-ratio
resampling with a Kaiser-windowed sinc filter (scipy.signal.resample_poly —
scipy ships as a jax dependency). Host-side work: audio I/O never rides the
device.
"""

from __future__ import annotations

import math

import numpy as np

from .. import constants


def resample(audio: np.ndarray, sr_in: int,
             sr_out: int = constants.SAMPLE_RATE) -> np.ndarray:
    """Resample 1-D float audio from ``sr_in`` to ``sr_out`` Hz (float32).

    Rational polyphase (up/down = sr_out/sr_in reduced by their gcd) with the
    default Kaiser anti-aliasing filter. Identity when the rates match."""
    audio = np.asarray(audio, np.float32).reshape(-1)
    if sr_in == sr_out:
        return audio
    if sr_in <= 0 or sr_out <= 0:
        raise ValueError(f"invalid sample rates: {sr_in} -> {sr_out}")
    from scipy.signal import resample_poly

    g = math.gcd(sr_in, sr_out)
    return resample_poly(audio, sr_out // g, sr_in // g).astype(np.float32)


def load_resampled(path: str) -> np.ndarray:
    """WAV load -> mono -> 16 kHz float32 (the whisper.load_audio contract,
    minus ffmpeg's container zoo: RIFF/WAV only)."""
    from . import wav

    data, sr = wav.load(path)
    data = data.reshape(-1) if data.shape[0] == 1 else data.mean(0)
    return resample(data, sr)


def load_resampled_bytes(raw: bytes) -> np.ndarray:
    """In-memory twin of :func:`load_resampled` for WAV bytes already in RAM
    (the serving path: uploaded request bodies previously round-tripped
    through a temp file just to get a path)."""
    from . import wav

    data, sr = wav._parse_wav(raw)
    data = data.reshape(-1) if data.shape[0] == 1 else data.mean(0)
    return resample(data, sr)
