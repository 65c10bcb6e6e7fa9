"""Build, load and count the port's CUDA kernels.

All kernels live in ``csrc/*.cu`` and are built, at first use, into ONE shared
library with a plain C interface that ``ctypes`` loads: each source compiles
in its own ``nvcc`` process (all started together), then one ``nvcc -shared``
links them. The library lands in ``build/torch_kernels/`` at the repository
root, named by a hash of the sources and flags, so an edited source rebuilds
and an unchanged one is reused. Nothing is built when a module is imported.

Every C entry point takes its tensors as raw device pointers plus the current
CUDA stream, launches without synchronising, and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code. There is no
fallback: a build or launch failure raises.

``LAUNCHES`` counts kernel launches by name. A wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels (``reset_launches`` / ``launch_counts``). A CUDA
graph replays kernels without calling their wrappers: the decode graph
(``models/decode_graph.py``) takes back what its capture counted and adds
it again at each replay (``add_launches``), so the counts stay exact.
``dec_attn_unaligned`` is no kernel of its own: it counts the ``dec_attn``
calls whose K or V panels the kernel stages unaligned (a bf16 cache an odd
number of columns long).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {
    "encoder_attn": 0, "encoder_attn_kt": 0, "qkpost": 0, "qkpost_rank": 0,
    "dtw_trace": 0,
    "dtw_backtrace": 0, "cross_attn_int8": 0, "cross_attn": 0, "mel": 0,
    "mel_clip": 0, "int8_quant": 0, "int8_dequant": 0, "dec_attn": 0,
    "dec_attn_unaligned": 0, "rows_linear": 0}

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_i64p = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    # q, k, v, o, batch*heads, T, n_valid, head_dim, is_bf16, stream
    "wca_encoder_attn": [_vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _vp],
    # q, k (bh, hd, T), v, o, batch*heads, T, n_valid, head_dim, is_bf16, stream
    "wca_encoder_attn_kt": [_vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _vp],
    # qk, out, frame_len, token_len, B, H, T, F, width, qk_scale, stream
    "wca_qkpost": [_vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _f, _vp],
    # x, trace, B, N, M, stream
    "wca_dtw_trace": [_vp, _vp, _i, _i, _i, _vp],
    # trace, n, m, jump, B, N, M, stream
    "wca_dtw_backtrace": [_vp, _vp, _vp, _vp, _i, _i, _i, _vp],
    # out (5 float64), steps, stream: latency of the DTW kernels' chain steps
    "wca_dtw_chain_probe": [_vp, _i, _vp],
    # q, k8, k_s, v8, v_s, o, batch*heads, head_dim, F, k_scale, stream
    "wca_cross_attn_int8": [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _f,
                            _vp],
    # q, k, v, o, batch*heads, head_dim, F, k_scale, is_bf16, stream
    "wca_cross_attn": [_vp, _vp, _vp, _vp, _i, _i, _i, _f, _i, _vp],
    # audio, window, twiddles, packed filter runs, lo, off, out, tile_max,
    # B, n_samples, n_frames, n_mels, n_nz, stream
    "wca_mel": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i,
                _vp],
    # x, tile_max, B, per_item, n_tiles, stream
    "wca_mel_clip": [_vp, _vp, _i, _i, _i, _vp],
    # x, amax (or null), codes, scales, M, K, is_bf16, stream
    "wca_int8_quant": [_vp, _vp, _vp, _vp, _i, _i, _i, _vp],
    # y, xs, s, bias (or null), out, M, N, is_bf16, stream
    "wca_int8_dequant": [_vp, _vp, _vp, _vp, _vp, _i, _i, _i, _vp],
    # q, k, v, mask, out, scores, stats, part, tickets (each of the last
    # four null within one chunk of keys; mask null without one), 11
    # strides, B, H, P, S, head_dim, k_scale, has_scale, want_scores,
    # kv_bf16, c_bf16, stream
    "wca_dec_attn": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i64p, _i,
                     _i, _i, _i, _i, _f, _i, _i, _i, _i, _vp],
    # x, w, bias (or null), out, part, tickets (both null but for the f32
    # split), M, N, K, seg_chunks, n_seg, mode, is_bf16, out_f32, stream
    "wca_rows_linear": [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i,
                        _i, _i, _vp],
    # x, w, c0 (or null), out, k16 steps, stream: the instruction probe
    "wca_rows_linear_probe": [_vp, _vp, _vp, _vp, _i, _vp],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_info: Dict[str, object] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def add_launches(counts: Dict[str, int], times: int = 1) -> None:
    """Add ``counts`` ``times`` over (a negative ``times`` takes them back):
    the launches of a captured graph's kernels, at each replay."""
    for k, v in counts.items():
        LAUNCHES[k] += v * times


def _nvcc() -> str:
    cands = [os.environ.get("NVCC"), shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME); the CUDA "
                       "kernels are built from csrc/ at first use")


def _digest(paths) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build() -> Path:
    sources = sorted(CSRC_DIR.glob("*.cu"))
    headers = sorted(CSRC_DIR.glob("*.cuh"))
    out = BUILD_DIR / f"libwca_kernels_{_digest(sources + headers)}.so"
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, cached=True)
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="build_", dir=BUILD_DIR))
    t0 = time.monotonic()
    procs = []
    try:
        objs = []
        for src in sources:
            obj = work / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        failed = []
        for src, p in procs:
            text, _ = p.communicate()
            log.append(f"== {src.name}\n{text}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_so = work / out.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp_so), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (BUILD_DIR / "build.log").write_text("\n".join(log))
        os.replace(tmp_so, out)
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    build_info.update(path=str(out), seconds=time.monotonic() - t0,
                      cached=False, log="\n".join(log))
    return out


def library() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.wca_error_string.argtypes = [ctypes.c_int]
            lib.wca_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def count(name: str) -> None:
    LAUNCHES[name] += 1


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = library().wca_error_string(rc).decode()
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: error {rc} ({msg})")


def require_aligned(name: str, *tensors: torch.Tensor,
                    to: int = 16) -> None:
    """Raise unless every tensor's data starts on a ``to``-byte boundary:
    the kernels copy them with 16-byte vector loads."""
    for t in tensors:
        if t.data_ptr() % to:
            raise ValueError(f"{name}: a {tuple(t.shape)} input starts at "
                             f"{t.data_ptr():#x}, not on a {to}-byte "
                             "boundary")


def require_cuda_or_cpu(*tensors: torch.Tensor) -> str:
    """Device type shared by ``tensors``: 'cpu' selects the plain version,
    'cuda' the kernel; anything else, or a mix, raises."""
    kinds = {t.device for t in tensors}
    if len(kinds) != 1:
        raise ValueError(f"inputs are on several devices: {sorted(map(str, kinds))}")
    kind = next(iter(kinds)).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {kind!r}")
    return kind
