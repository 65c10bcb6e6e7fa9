"""Long-form transcription end to end: the real-time factor of
``transcribe.transcribe`` (port of the repository's
``scripts/bench_transcribe_longform.py``).

    python -m whisper_char_alignment_tpu_torch.scripts.bench_transcribe_longform
    WCA_PLATFORM=cpu WCA_XFER_TINY=1 python -m whisper_char_alignment_tpu_torch.scripts.bench_transcribe_longform

The seek loop conditions each 30 s window on the rolling transcript
(``condition_on_previous_text``), so every window after the first decodes
behind a prompt, which the decode consumes in one prefill pass. The JAX
script compares that prefill with a step-by-step prompt
(``WCA_DECODE_PREFILL``); the port always prefills and does not read the
variable, so this measures the prefill arm only. Speech-like synthetic
audio (band-limited noise under an amplitude envelope, ``default_rng(7)``),
Whisper-medium shapes with the toy tokenizer's vocabulary, random bf16
weights, greedy at temperature 0 with 48 steps a window and no
log-probability or no-speech gates (the JAX script's options). One warm
call captures the decode graphs, then ``ITERS`` timed calls, each of which
must give the warm call's segment count.

Prints ONE JSON line: ``metric`` ``longform_realtime_factor``, ``value``
(audio seconds per wall second, best of ``ITERS``), ``unit``, the min and
median wall, the segment count, ``seconds_audio``, plus ``device``,
``launches`` (kernel launches of the timed calls) and
``graph_captures_timed``. Everything else goes to stderr. Runs on ``cuda``
unless ``WCA_PLATFORM=cpu``; without a card it exits non-zero and prints no
line.

Knobs (env): SECONDS_AUDIO (90), ITERS (2), WCA_XFER_TINY=1 (tiny dims,
CPU-friendly).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from .. import transcribe as T
from ..bench import (add_counts, build_model, device_label, log,
                     platform_device, timed)
from ..config import MODEL_DIMS, tiny_test_dims
from ..text.tokenizer import get_test_tokenizer


@dataclasses.dataclass(frozen=True)
class Settings:
    seconds_audio: float = 90.0
    iters: int = 2
    tiny: bool = False

    @classmethod
    def from_env(cls) -> "Settings":
        env = os.environ.get
        return cls(seconds_audio=float(env("SECONDS_AUDIO", "90")),
                   iters=max(1, int(env("ITERS", "2"))),
                   tiny=env("WCA_XFER_TINY") == "1")


def speech_like_audio(seconds: float) -> np.ndarray:
    """Band-limited noise under an amplitude envelope, the same on every
    call (the JAX script's audio)."""
    rng = np.random.default_rng(7)
    n = int(16000 * seconds)
    return (rng.normal(0, 0.1, n)
            * (0.5 + 0.5 * np.sin(np.linspace(0, 40 * np.pi, n)))
            ).astype(np.float32)


def run(model, tokenizer, *, device=None,
        settings: Optional[Settings] = None) -> dict:
    """Transcribe the audio with ``model`` (built, on ``device``, computed in
    its own dtype) and return the one line's payload."""
    s = settings or Settings.from_env()
    device = torch.device(device or model.device)
    audio = speech_like_audio(s.seconds_audio)
    kw = dict(language="en", condition_on_previous_text=True,
              temperature=0.0, sample_len=48, logprob_threshold=None,
              no_speech_threshold=None, device=device.type)
    log(f"audio {s.seconds_audio:.0f}s, iters {s.iters}, device "
        f"{device_label(device)}")
    with timed(device) as warm:
        res = T.transcribe(model, tokenizer, audio, **kw)
    n_seg = len(res["segments"])
    log(f"warm call (captures the graphs): {warm['wall_s']:.2f}s, "
        f"{n_seg} segments, {warm['captures']} graph captures")
    walls, launches, captures = [], {}, 0
    for _ in range(s.iters):
        with timed(device) as m:
            r = T.transcribe(model, tokenizer, audio, **kw)
        if len(r["segments"]) != n_seg:
            # same inputs, same arm: the transcript must not change
            raise RuntimeError(f"{len(r['segments'])} segments, the warm "
                               f"call gave {n_seg}")
        walls.append(m["wall_s"])
        launches = add_counts(launches, m["launches"])
        captures += m["captures"]
    best = min(walls)
    median = sorted(walls)[len(walls) // 2]
    rt = s.seconds_audio / best
    log(f"prefill   min {best:6.2f} s  med {median:6.2f} s  ({rt:5.1f}x "
        f"realtime, {n_seg} segments)")
    return {
        "metric": "longform_realtime_factor",
        "value": round(rt, 3),
        "unit": "audio_s/wall_s",
        "min_wall_s": round(best, 4),
        "median_wall_s": round(median, 4),
        "segments": n_seg,
        "seconds_audio": s.seconds_audio,
        "iters": s.iters,
        "arm": "prefill",
        "device": device_label(device),
        "launches": launches,
        "graph_captures_timed": captures,
    }


def main() -> None:
    s = Settings.from_env()
    device = platform_device()
    tok = get_test_tokenizer()
    if s.tiny:
        dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=24,
                              n_text_ctx=448, state=16, head=2, layers=2)
    else:
        # the toy tokenizer's vocabulary, so that every id the random
        # model emits is one the tokenizer reads
        dims = dataclasses.replace(MODEL_DIMS["medium"], n_vocab=tok.n_vocab)
    log(f"device: {device_label(device)}")
    payload = run(build_model(dims, device), tok, device=device, settings=s)
    print(json.dumps(payload), flush=True)


if __name__ == "__main__":
    main()
