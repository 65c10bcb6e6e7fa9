"""Single-utterance latency at Whisper-medium shapes (port of the
repository's ``scripts/measure_latency.py``): ``api.align`` (mel -> greedy
decode -> capture -> head selection -> DTW -> boundaries) at batch 1, warm,
the number an operator of ``cli/serve`` cares about; and
``api.transcribe`` of the same single window.

    python -m whisper_char_alignment_tpu_torch.scripts.measure_latency
    WCA_PLATFORM=cpu LAT_TINY=1 python -m whisper_char_alignment_tpu_torch.scripts.measure_latency

One cold call of each captures its decode graph, then ``LAT_ITERS`` timed
calls of each; each call's wall ends in a synchronize. The median is the
JAX script's (the upper middle of the sorted walls).

Prints ONE JSON line: ``metric`` ``single_utterance_align_latency_ms``,
``value`` (the align median), ``unit``, ``transcribe_median_ms``, the
sample count ``samples`` of each median, plus ``device``, ``launches``
(kernel launches of the timed calls) and ``graph_captures_timed``.
Everything else goes to stderr. Runs on ``cuda`` unless
``WCA_PLATFORM=cpu``; without a card it exits non-zero and prints no line.

Knobs (env): LAT_DECODE_LEN (32), LAT_SECONDS (5), LAT_ITERS (10),
LAT_TINY=1 (tiny dims, CPU-friendly).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from .. import api, constants
from ..bench import (add_counts, build_model, device_label, log,
                     platform_device, timed)
from ..config import MODEL_DIMS, tiny_test_dims
from ..text.tokenizer import get_test_tokenizer


@dataclasses.dataclass(frozen=True)
class Settings:
    tiny: bool = False
    decode_len: int = 32
    seconds: float = 5.0
    iters: int = 10

    @classmethod
    def from_env(cls) -> "Settings":
        env = os.environ.get
        tiny = env("LAT_TINY") == "1"
        return cls(tiny=tiny,
                   decode_len=int(env("LAT_DECODE_LEN", "4" if tiny else "32")),
                   seconds=float(env("LAT_SECONDS", "0.5" if tiny else "5")),
                   iters=max(1, int(env("LAT_ITERS", "3" if tiny else "10"))))


def run(model, tokenizer, *, device=None,
        settings: Optional[Settings] = None) -> dict:
    """Time ``model`` (built, on ``device``, computed in its own dtype) and
    return the one line's payload."""
    s = settings or Settings.from_env()
    device = torch.device(device or model.device)
    m = api.Model(model=model, tokenizer=tokenizer, name="bench")
    audio = (np.random.default_rng(0)
             .normal(0, 0.05, int(constants.SAMPLE_RATE * s.seconds))
             .astype(np.float32))
    log(f"device {device_label(device)}  decode_len={s.decode_len} "
        f"audio={s.seconds:.1f}s")

    def one_align():
        return api.align(m, audio, aligned_unit_type="char",
                         aggregation="topk", topk=10, medfilt_width=3,
                         compute_dtype=model.dtype,
                         decode_sample_len=s.decode_len, device=device)

    def one_transcribe():
        return api.transcribe(m, audio, language="en",
                              sample_len=s.decode_len, temperature=0.0,
                              compression_ratio_threshold=None,
                              logprob_threshold=None,
                              no_speech_threshold=None, device=device)

    launches, captures, medians = {}, 0, {}
    for label, fn in (("align", one_align), ("transcribe", one_transcribe)):
        with timed(device) as cold:
            fn()
        log(f"{label} cold (graph capture): {cold['wall_s']:.1f}s")
        lats = []
        for _ in range(s.iters):
            with timed(device) as t:
                fn()
            lats.append(t["wall_s"])
            launches = add_counts(launches, t["launches"])
            captures += t["captures"]
        lats.sort()
        medians[label] = lats[len(lats) // 2] * 1000
        log(f"{label} warm: min {lats[0] * 1000:.0f} ms  median "
            f"{medians[label]:.0f} ms  max {lats[-1] * 1000:.0f} ms")
    return {
        "metric": "single_utterance_align_latency_ms",
        "value": round(medians["align"], 1),
        "unit": "ms",
        "transcribe_median_ms": round(medians["transcribe"], 1),
        "samples": s.iters,
        "decode_len": s.decode_len,
        "audio_seconds": s.seconds,
        "device": device_label(device),
        "launches": launches,
        "graph_captures_timed": captures,
    }


def main() -> None:
    s = Settings.from_env()
    device = platform_device()
    tok = get_test_tokenizer()
    dims = (tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=128,
                           n_text_ctx=96, state=32, head=4, layers=2)
            if s.tiny else MODEL_DIMS["medium"])
    log(f"device: {device_label(device)}")
    payload = run(build_model(dims, device), tok, device=device, settings=s)
    print(json.dumps(payload), flush=True)


if __name__ == "__main__":
    main()
