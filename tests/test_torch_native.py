"""The port's native host hooks (``cpp/wavio.cc``, ``cpp/bpe.cc`` through
``utils/native.py``) against its Python paths and the JAX package's.

- WAV: the port's native decoder, its NumPy parser and JAX ``audio/wav``
  (NumPy parser) agree on every format of tests/test_wav.py: PCM 8, 16, 24
  and 32 bits, IEEE float 32 and 64, WAVE_FORMAT_EXTENSIBLE PCM and float,
  stereo; all three reject garbage.
- BPE: the port's native and pure-Python merges and JAX's pure-Python merge
  give the same ids on a seeded fuzz corpus, ``'z' * 5000`` included (past
  the native core's 4096-id buffer: the Python merge takes that piece).
- The ``WCA_DISABLE_NATIVE`` gate is falsy-aware; a library older than its
  source is rebuilt, and a failed rebuild keeps a present library.

g++ is on this machine, so the native paths must load here: none of these
tests skips for want of them."""

import os
import random
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest

from whisper_char_alignment_tpu.audio import wav as jwav
from whisper_char_alignment_tpu.text import bpe as jbpe
from whisper_char_alignment_tpu_torch.audio import _wavio_native, wav
from whisper_char_alignment_tpu_torch.text import _bpe_native, bpe
from whisper_char_alignment_tpu_torch.utils import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def native_enabled(monkeypatch):
    monkeypatch.delenv("WCA_DISABLE_NATIVE", raising=False)


def _riff(path, fmt_body, payload):
    body = (b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
            + b"data" + struct.pack("<I", len(payload)) + payload)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)


def _fmt(tag, bits, channels=1, rate=16000):
    return struct.pack("<HHIIHH", tag, channels, rate,
                       rate * channels * bits // 8, channels * bits // 8, bits)


def _extensible(sub_tag, bits):
    sub = (struct.pack("<H", sub_tag)
           + b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71")
    return (_fmt(0xFFFE, bits) + struct.pack("<HHI", 22, bits, 0) + sub)


def _signal(n=1234, seed=0):
    return np.random.default_rng(seed).uniform(-0.99, 0.99, n)


def _write(path, kind):
    x = _signal()
    if kind == "pcm8":
        _riff(path, _fmt(1, 8), np.round(x * 127 + 128).astype(np.uint8)
              .tobytes())
    elif kind == "pcm16":
        _riff(path, _fmt(1, 16), np.round(x * 32767).astype("<i2").tobytes())
    elif kind == "pcm24":
        v = np.round(x * ((1 << 23) - 1)).astype(np.int64) & 0xFFFFFF
        _riff(path, _fmt(1, 24), b"".join(int(a).to_bytes(3, "little")
                                          for a in v))
    elif kind == "pcm32":
        _riff(path, _fmt(1, 32), np.round(x * 2 ** 31).astype("<i4")
              .tobytes())
    elif kind == "float32":
        _riff(path, _fmt(3, 32), x.astype("<f4").tobytes())
    elif kind == "float64":
        _riff(path, _fmt(3, 64), x.astype("<f8").tobytes())
    elif kind == "extensible_pcm":
        _riff(path, _extensible(1, 16),
              np.round(x * 32767).astype("<i2").tobytes())
    elif kind == "extensible_float":
        _riff(path, _extensible(3, 32), x.astype("<f4").tobytes())
    elif kind == "stereo":
        wav.save(path, np.stack([x, 0.25 * x[::-1]]).astype(np.float32),
                 22050)
    else:
        raise AssertionError(kind)


_KINDS = ["pcm8", "pcm16", "pcm24", "pcm32", "float32", "float64",
          "extensible_pcm", "extensible_float", "stereo"]


@pytest.mark.parametrize("kind", _KINDS)
def test_wav_native_numpy_and_jax_agree(tmp_path, kind):
    path = str(tmp_path / f"{kind}.wav")
    _write(path, kind)
    decoder = _wavio_native.get()
    assert decoder is not None, "the native WAV decoder did not build"
    got_native, sr_native = decoder.load(path)
    with open(path, "rb") as f:
        got_numpy, sr_numpy = wav._parse_wav(f.read())
    with open(path, "rb") as f:
        want, sr = jwav._parse_wav(f.read())
    got_load, sr_load = wav.load(path)  # the hook takes the native path
    assert sr_native == sr_numpy == sr == sr_load
    assert got_native.dtype == got_numpy.dtype == want.dtype == np.float32
    assert got_native.shape == want.shape == (2 if kind == "stereo" else 1,
                                              1234)
    np.testing.assert_array_equal(got_numpy, want)
    np.testing.assert_array_equal(got_load, got_native)
    np.testing.assert_array_equal(got_native, want)


def test_wav_garbage_rejected_everywhere(tmp_path):
    path = str(tmp_path / "g.wav")
    with open(path, "wb") as f:
        f.write(b"not a wav file at all")
    with pytest.raises(ValueError):
        _wavio_native.get().load(path)
    with pytest.raises(ValueError):
        wav.load(path)  # the native path fails, the NumPy parser raises
    with open(path, "rb") as f, pytest.raises(ValueError):
        jwav._parse_wav(f.read())


_POOLS = ["abcdefghijklmnopqrstuvwxyz", "THE QUICK", "0123456789٤٥",
          ".,!?;:'\"-()#@&%$€", " \t\n\r\xa0　\x1c", "日本語中文",
          "éüñßàç", "🙂😀", "'s 't 're 've 'm 'll 'd", "the fox zz"]


def _corpus(n=400, seed=0):
    rng = random.Random(seed)
    texts = ["".join(rng.choice(rng.choice(_POOLS))
                     for _ in range(rng.randrange(0, 60)))
             for _ in range(n)]
    return texts + ["", "the quick brown fox", "z" * 5000, "z" * 4097,
                    "greasy wash water all year " * 50]


def test_bpe_native_python_and_jax_agree():
    ranks = bpe.toy_ranks()
    fast = bpe.ByteBPE(ranks)
    assert fast._get_native() is not None, "the native BPE did not build"
    slow = bpe.ByteBPE(ranks)
    slow._native_tried = True  # the pure-Python merge
    theirs = jbpe.ByteBPE(jbpe.toy_ranks())
    theirs._native_tried = True
    for text in _corpus():
        want = theirs.encode_ordinary(text)
        assert fast.encode_ordinary(text) == want, text[:40]
        assert slow.encode_ordinary(text) == want, text[:40]
    # past the native buffer the core refuses the piece and Python takes it
    assert fast._get_native().encode_piece(b"z" * 5000) is None
    assert fast.decode(fast.encode_ordinary("z" * 5000)) == "z" * 5000


def test_disable_native_gate_is_falsy_aware(monkeypatch):
    for off in ("0", "off", "false", ""):
        monkeypatch.setenv("WCA_DISABLE_NATIVE", off)
        assert not native.disabled()
        assert _wavio_native.get() is not None
        assert _bpe_native.build(bpe.toy_ranks()) is not None
    for on in ("1", "true", "yes"):
        monkeypatch.setenv("WCA_DISABLE_NATIVE", on)
        assert native.disabled()
        assert _wavio_native.get() is None
        assert _bpe_native.build(bpe.toy_ranks()) is None
        assert bpe.ByteBPE(bpe.toy_ranks())._get_native() is None
    assert native.load("wavio.cc", "libwavio.so") is None


@pytest.fixture
def scratch_build(tmp_path, monkeypatch):
    """The native loader pointed at a copy of wavio.cc and an empty build
    directory, with empty caches; the library's path to be."""
    src_dir, build_dir = tmp_path / "cpp", tmp_path / "build"
    src_dir.mkdir()
    shutil.copy(os.path.join(native.SRC_DIR, "wavio.cc"), src_dir)
    monkeypatch.setattr(native, "SRC_DIR", str(src_dir))
    monkeypatch.setattr(native, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native, "_build_seconds", {})
    return str(build_dir / "libwavio.so")


def test_stale_library_is_rebuilt(scratch_build, monkeypatch):
    so = scratch_build
    assert native.load("wavio.cc", "libwavio.so") is not None
    built = native.loaded()["wavio.cc"]
    assert built is not None and built > 0 and os.path.exists(so)
    assert not [f for f in os.listdir(os.path.dirname(so)) if ".build." in f]
    # the same process reuses its loaded library
    assert native.load("wavio.cc", "libwavio.so") is not None
    # a fresh process: a library newer than its source is reused ...
    monkeypatch.setattr(native, "_loaded", {})
    assert native.load("wavio.cc", "libwavio.so") is not None
    assert native.loaded()["wavio.cc"] is None
    # ... one older than its source is rebuilt
    os.utime(so, (1_000_000, 1_000_000))
    monkeypatch.setattr(native, "_loaded", {})
    assert native.load("wavio.cc", "libwavio.so") is not None
    assert native.loaded()["wavio.cc"] is not None
    assert os.path.getmtime(so) > 1_000_000


def test_failed_rebuild_keeps_a_present_library(scratch_build, monkeypatch):
    so = scratch_build
    assert native.load("wavio.cc", "libwavio.so") is not None
    os.utime(so, (1_000_000, 1_000_000))
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native, "_build", lambda src, so: False)
    assert native.load("wavio.cc", "libwavio.so") is not None
    assert native.loaded()["wavio.cc"] is None
    # no library and no compiler: the caller falls back
    os.unlink(so)
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native, "_build_seconds", {})
    assert native.load("wavio.cc", "libwavio.so") is None
    assert native.loaded() == {}


def test_new_modules_import_no_jax():
    mods = ["utils.native", "utils.flops", "audio._wavio_native",
            "text._bpe_native", "models.convert", "models.whisper"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module('whisper_char_alignment_tpu_torch.' + m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('whisper_char_alignment_tpu.')\n"
        "       or m == 'whisper_char_alignment_tpu']\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout
