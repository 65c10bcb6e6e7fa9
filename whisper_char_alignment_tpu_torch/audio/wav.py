"""Host-side WAV decode.

Copy of ``whisper_char_alignment_tpu/audio/wav.py`` for the PyTorch port, which
imports nothing of the JAX package; only imports changed.

Replaces the reference's ``torchaudio.load`` (reference: dataset.py:3, 31, 104;
README.md:99 — only ever used on 16 kHz PCM WAV files). A minimal RIFF/WAVE parser in
NumPy covering PCM 8/16/24/32-bit and IEEE float32/64, returning float32 in [-1, 1)
with shape (channels, samples) to match torchaudio's convention. A C++ fast path
(``cpp/wavio.cc``) is loaded when built; the NumPy path is the always-available
fallback — WAV decode is host work either way.
"""

from __future__ import annotations

import struct

import numpy as np

from . import _wavio_native  # C++ accelerated decoder (optional)


def _parse_wav(data: bytes):
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    fmt_body = b""
    payload = None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        body = data[pos + 8:pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
            fmt_body = body
        elif chunk_id == b"data":
            payload = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or payload is None:
        raise ValueError("missing fmt/data chunk")

    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE
        # the REAL format code is the first 2 bytes of the SubFormat GUID at
        # offset 24 of the fmt body (1 = PCM, 3 = IEEE float). Assuming PCM
        # here silently decoded extensible float WAVs — a common DAW/sox
        # output — into garbage (round-4 review finding).
        if len(fmt_body) >= 26:
            (audio_format,) = struct.unpack("<H", fmt_body[24:26])
        else:
            audio_format = 1  # truncated extensible header: legacy PCM guess

    if audio_format == 1:  # PCM
        if bits == 8:
            x = (np.frombuffer(payload, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(payload, "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(payload, np.uint8).reshape(-1, 3)
            as32 = (raw[:, 0].astype(np.int32)
                    | (raw[:, 1].astype(np.int32) << 8)
                    | (raw[:, 2].astype(np.int32) << 16))
            as32 = np.where(as32 >= 1 << 23, as32 - (1 << 24), as32)
            x = as32.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(payload, "<i4").astype(np.float32) / float(1 << 31)
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        dt = "<f4" if bits == 32 else "<f8"
        x = np.frombuffer(payload, dt).astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format tag {audio_format}")

    n = (len(x) // channels) * channels
    x = x[:n].reshape(-1, channels).T  # (channels, samples)
    return np.ascontiguousarray(x), sample_rate


def load(path: str):
    """Decode a WAV file -> (float32 array (channels, samples), sample_rate)."""
    native = _wavio_native.get()
    if native is not None:
        try:
            return native.load(path)
        except Exception:
            pass  # fall back to the NumPy parser on any native-path failure
    with open(path, "rb") as f:
        return _parse_wav(f.read())


def save(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """Write mono/multi-channel float32 audio as PCM16 WAV (test fixtures)."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None]
    channels, samples = audio.shape
    pcm = np.clip(audio.T * 32768.0, -32768, 32767).astype("<i2").tobytes()
    byte_rate = sample_rate * channels * 2
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(pcm)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, channels, sample_rate, byte_rate,
                            channels * 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(pcm)))
        f.write(pcm)
