"""Loader shim for the C++ BPE core (cpp/bpe.cc via ctypes).

Copy of ``whisper_char_alignment_tpu/text/_bpe_native.py`` for the PyTorch
port, which imports nothing of the JAX package; unchanged.

Failures are non-fatal: ``ByteBPE`` falls back to its pure-Python merge loop.
Disable with ``WCA_DISABLE_NATIVE=1``.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import Dict, List

from ..utils import native as native_lib


def _get_lib():
    # no local cache layer: utils.native.load already caches per source path
    # (a second cache here pinned the first result forever and could disagree
    # with the shared one); the symbol setup below is idempotent
    lib = native_lib.load("bpe.cc", "libbpe.so")
    if lib is None:
        return None
    try:
        lib.bpe_new.restype = ctypes.c_void_p
        lib.bpe_new.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.bpe_free.argtypes = [ctypes.c_void_p]
        lib.bpe_encode.restype = ctypes.c_int32
        lib.bpe_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        return lib
    except Exception:
        return None


class NativeBPE:
    def __init__(self, lib, handle):
        self._lib = lib
        self._handle = handle
        self._buf = (ctypes.c_int32 * 4096)()
        # the fixed output buffer is shared across calls; the pure-Python
        # ByteBPE is thread-safe, so the native path must be too — without
        # this lock two concurrent encode() calls interleave ids silently
        self._buf_lock = threading.Lock()

    def __del__(self):
        try:
            self._lib.bpe_free(self._handle)
        except Exception:
            pass

    def encode_piece(self, piece: bytes) -> "List[int] | None":
        """ids for one pre-token piece, or None when the native core refuses
        (output longer than the fixed id buffer — e.g. a >4096-byte piece with
        no merges). The caller falls back to the pure-Python merge, which has
        no length limit."""
        lib, h, buf = self._lib, self._handle, self._buf
        with self._buf_lock:
            n = lib.bpe_encode(h, piece, len(piece), buf, len(buf))
            if n < 0:
                return None
            return list(buf[:n])

    def encode_pieces(self, pieces: List[bytes]) -> List[int]:
        out: List[int] = []
        for piece in pieces:
            got = self.encode_piece(piece)
            if got is None:
                raise ValueError("native BPE failed")
            out.extend(got)
        return out


def build(ranks: Dict[bytes, int]):
    if native_lib.disabled():
        return None
    lib = _get_lib()
    if lib is None:
        return None
    parts = [struct.pack("<q", len(ranks))]
    for k, v in ranks.items():
        parts.append(struct.pack("<i", len(k)) + k + struct.pack("<i", v))
    blob = b"".join(parts)
    handle = lib.bpe_new(blob, len(blob))
    if not handle:
        return None
    return NativeBPE(lib, handle)
