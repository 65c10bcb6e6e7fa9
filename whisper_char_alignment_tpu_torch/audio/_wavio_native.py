"""Loader shim for the optional C++ WAV decoder (cpp/wavio.cc via ctypes).

Copy of ``whisper_char_alignment_tpu/audio/_wavio_native.py`` for the
PyTorch port, which imports nothing of the JAX package; unchanged.

Build/load plumbing lives in ``utils.native`` (shared with the BPE shim);
failures are non-fatal — callers fall back to the NumPy parser in ``wav.py``.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..utils import native as native_lib

_lock = threading.Lock()
# CDLL id -> _Native wrapper: keyed on the loaded library object so this
# layer can never disagree with utils.native.load's own per-source cache
_wrappers: dict = {}


class _Native:
    def __init__(self, lib):
        self._lib = lib
        lib.wavio_load.restype = ctypes.c_int
        lib.wavio_load.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),  # samples
            ctypes.POINTER(ctypes.c_int32),  # channels
            ctypes.POINTER(ctypes.c_int32),  # sample_rate
        ]
        lib.wavio_free.argtypes = [ctypes.POINTER(ctypes.c_float)]

    def load(self, path: str):
        buf = ctypes.POINTER(ctypes.c_float)()
        samples = ctypes.c_int64()
        channels = ctypes.c_int32()
        rate = ctypes.c_int32()
        rc = self._lib.wavio_load(path.encode(), ctypes.byref(buf),
                                  ctypes.byref(samples), ctypes.byref(channels),
                                  ctypes.byref(rate))
        if rc != 0:
            raise ValueError(f"wavio_load failed with code {rc} for {path}")
        try:
            n = samples.value * channels.value
            arr = np.ctypeslib.as_array(buf, shape=(n,)).copy()
        finally:
            self._lib.wavio_free(buf)
        return arr.reshape(samples.value, channels.value).T.copy(), rate.value


def get():
    """Return the native decoder or None. The env gate is re-checked on every
    call (not just at first load) so tests can force the NumPy path at any
    point."""
    if native_lib.disabled():
        return None
    lib = native_lib.load("wavio.cc", "libwavio.so")  # cached per source path
    if lib is None:
        return None
    with _lock:
        w = _wrappers.get(id(lib))
        if w is None:
            try:
                w = _Native(lib)
            except Exception:
                return None
            _wrappers[id(lib)] = w
        return w
