"""One loader for the port's optional C++ host fast paths (``cpp/*.cc`` via
ctypes).

Copy of ``whisper_char_alignment_tpu/utils/native.py`` for the PyTorch port,
which imports nothing of the JAX package. The sources are the port's own
copies in ``whisper_char_alignment_tpu_torch/cpp/``, the libraries go to
``build/torch_host/`` at the repository root, and :func:`loaded` says which
libraries this process loaded and what their builds took. These are host
code whose output equals the Python paths', not device kernels, so a failed
build falls back as in the JAX package:

- ``WCA_DISABLE_NATIVE=1`` disables every native path (callers fall back to
  their pure-Python implementations).
- The .so is (re)built with g++ when missing OR older than its source, so an
  edited cpp/*.cc can never be silently shadowed by a stale binary.
- All failures (no compiler, sandbox, bad .so) are non-fatal: ``load``
  returns None and the caller falls back.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from typing import Dict, Optional

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PACKAGE, "cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE), "build", "torch_host")

_lock = threading.Lock()
# src path -> ctypes.CDLL | None; an entry means "tried" (None = gave up)
_loaded: dict = {}
# src name -> seconds of the g++ build made by this process, or None when a
# library newer than its source was reused
_build_seconds: Dict[str, Optional[float]] = {}


def _build(src: str, so: str) -> bool:
    # compile to a private temp name and os.replace into place: linking
    # directly onto the live path truncates an inode another process may have
    # dlopen'd (SIGBUS in a running serve), and two concurrent rebuilds would
    # interleave writes; the atomic rename gives every dlopen a whole file
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.build.{os.getpid()}"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def disabled() -> bool:
    """The WCA_DISABLE_NATIVE gate, falsy-aware: '0'/'off'/'false'/'' mean
    ENABLED (a user exporting WCA_DISABLE_NATIVE=0 to re-enable must not
    silently drop to the pure-Python paths)."""
    return os.environ.get("WCA_DISABLE_NATIVE", "") not in ("", "0", "off",
                                                            "false")


def load(src_name: str, so_name: str) -> Optional[ctypes.CDLL]:
    """CDLL for ``cpp/<src_name>`` built at ``build/torch_host/<so_name>``,
    or None.

    The result (including a failed attempt) is cached per source path; the
    symbol setup (restype/argtypes) stays with the caller.
    """
    if disabled():
        return None
    src = os.path.join(SRC_DIR, src_name)
    so = os.path.join(BUILD_DIR, so_name)
    with _lock:
        if src in _loaded:
            return _loaded[src]
        lib = None
        seconds = None
        try:
            if os.path.exists(src):
                stale = (not os.path.exists(so)
                         or os.path.getmtime(so) < os.path.getmtime(src))
                # a failed rebuild (no compiler) must not discard a present,
                # working binary: checkouts give arbitrary sub-second mtime
                # ordering, so a library in sync with its source can look
                # stale
                if stale:
                    t0 = time.perf_counter()
                    if _build(src, so):
                        seconds = time.perf_counter() - t0
                if os.path.exists(so):
                    lib = ctypes.CDLL(so)
        except Exception:
            lib = None
        _loaded[src] = lib
        if lib is not None:
            _build_seconds[src_name] = seconds
        return lib


def loaded() -> Dict[str, Optional[float]]:
    """The native libraries this process loaded, by source name, each with
    the seconds g++ took to build it here (None: a library newer than its
    source was reused). A library that failed to build or load is absent."""
    with _lock:
        return dict(_build_seconds)
