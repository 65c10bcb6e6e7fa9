"""The guarded int8 K/V decode's cost envelope on the real decode path (port
of the repository's ``scripts/profile_guarded_decode.py``).

    python -m whisper_char_alignment_tpu_torch.scripts.profile_guarded_decode
    MODE=bucket python -m whisper_char_alignment_tpu_torch.scripts.profile_guarded_decode
    WCA_PLATFORM=cpu WCA_PROFILE_TINY=1 python -m whisper_char_alignment_tpu_torch.scripts.profile_guarded_decode

Times ``decoding.decode`` (the encoder, then the greedy loop replayed as a
CUDA graph; Whisper-medium width, random bf16 weights from seed 0) in four
modes:

  exact        the un-quantized decode
  int8         int8 cross K/V (``kv_int8``); under ``WCA_CROSS_ATTN=auto``
               each step's cross-attention on the card is the kernel of
               ``ops/cross_attn_cuda.py``
  guard=0      int8 + margin tracking, no re-decode (the guarded mode's best
               case: its only extra work is the per-step top-2)
  guard=inf    every utterance re-decoded exactly (its worst case: the int8
               pass and a full exact pass, the encoder shared)

A deployment's guarded cost is guard0 + flag_rate x (guardinf - guard0);
the flag rate depends on the checkpoint and the data (random weights say
nothing of it). MODE=bucket measures the same envelope for the guarded
frame-bucket mode: exact / bucket / guard=0 / guard=inf at KV_FRAMES frames
of medium's 1500.

Each mode's warm call captures its decode graphs; the reading is the least
of 3 timed calls. The JAX lines and the ratios to exact go to stderr, then
ONE JSON line: the readings (ms) under the JAX names, ``vs_exact``,
``device``, ``launches`` and ``graph_captures_timed``. Runs on ``cuda``
unless ``WCA_PLATFORM=cpu``; without a card it exits non-zero and prints no
line.

Knobs (env, the JAX script's): B (16), STEPS (32), MODE (int8 | bucket),
KV_FRAMES (512), WCA_PROFILE_TINY=1 (tiny dims, CPU-friendly).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..bench import build_model, device_label, log, platform_device
from ..config import MODEL_DIMS, tiny_test_dims
from ..models import decoding
from ..text.tokenizer import get_test_tokenizer
from ._profile import Readings

TINY = os.environ.get("WCA_PROFILE_TINY") == "1"
B = int(os.environ.get("B", "4" if TINY else "16"))
STEPS = int(os.environ.get("STEPS", "8" if TINY else "32"))


def modes(dims):
    """(name, decode keyword arguments) of each mode MODE selects."""
    if os.environ.get("MODE", "int8") == "bucket":
        kv_frames = int(os.environ.get("KV_FRAMES", "32" if TINY else "512"))
        log(f"mode=bucket kv_frames={kv_frames}/{dims.n_audio_ctx}")
        return [
            ("exact", dict()),
            ("bucket", dict(kv_frames=kv_frames)),
            ("guard=0 (track only)",
             dict(kv_frames=kv_frames, kv_frames_guard=0.0)),
            ("guard=inf (full re-decode)",
             dict(kv_frames=kv_frames, kv_frames_guard=1e9)),
        ]
    return [
        ("exact", dict()),
        ("int8", dict(kv_int8=True)),
        ("guard=0 (track only)", dict(kv_int8_guard=0.0)),
        ("guard=inf (full re-decode)", dict(kv_int8_guard=1e9)),
    ]


def main() -> None:
    device = platform_device()
    tok = get_test_tokenizer()
    dims = (tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=128,
                           n_text_ctx=96, state=32, head=4, layers=2)
            if TINY else MODEL_DIMS["medium"])
    log(f"devices: {device_label(device)}  B={B} steps={STEPS}")
    model = build_model(dims, device)
    mel = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (B, dims.n_mels, 2 * dims.n_audio_ctx)).astype(np.float32)
    ).to(device)
    opts = decoding.DecodingOptions(language="en", sample_len=STEPS)
    r = Readings("profile_guarded_decode", device)
    for name, kw in modes(dims):
        r.time(name, lambda kw=kw: decoding.decode(model, tok, mel, opts,
                                                   device=device, **kw),
               iters=3, width=28)
    base = r.ms["exact"]
    r.extra["vs_exact"] = {name: ms / base for name, ms in r.ms.items()}
    for name, ratio in r.extra["vs_exact"].items():
        log(f"{name:>28}: {ratio:6.2f}x exact")
    r.emit()


if __name__ == "__main__":
    main()
