"""The decode-option surface on the card (port of the repository's
``scripts/profile_beam_decode.py``): greedy against beam_size=5 and
best_of=5 sampling through the production ``decoding.decode`` (the encoder,
the loop, the results), Whisper-medium width, random bf16 weights from
seed 0.

    python -m whisper_char_alignment_tpu_torch.scripts.profile_beam_decode
    WCA_PLATFORM=cpu WCA_BEAM_TINY=1 python -m whisper_char_alignment_tpu_torch.scripts.profile_beam_decode

Greedy replays the greedy loop's CUDA graph; beam search and sampling
(``models/beam.py``) replay theirs, a per-step cache reorder on the beam
axis inside it. Sampling draws its noise from a generator seeded 1 at each
call (the JAX script's ``PRNGKey(1)``). Each variant's warm call captures
its graph; the reading is the least of 3 timed calls.

The JAX lines (with the ratio to greedy and the decode rate) go to stderr,
then ONE JSON line: the readings (ms) under the JAX names, ``vs_greedy``,
``utts_per_s``, ``device``, ``launches`` and ``graph_captures_timed``. Runs
on ``cuda`` unless ``WCA_PLATFORM=cpu``; without a card it exits non-zero
and prints no line.

Knobs (env, the JAX script's): B (8), STEPS (32), MODEL (medium),
WCA_BEAM_TINY=1 (tiny dims, CPU-friendly).
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

TINY = os.environ.get("WCA_BEAM_TINY") == "1"
B = int(os.environ.get("B", "2" if TINY else "8"))
STEPS = int(os.environ.get("STEPS", "4" if TINY else "32"))

VARIANTS = (
    ("greedy", dict()),
    ("beam_size=5", dict(beam_size=5)),
    ("beam_size=5 patience=2", dict(beam_size=5, patience=2.0)),
    ("best_of=5 t=1.0", dict(best_of=5, temperature=1.0)),
    ("sampling t=1.0", dict(temperature=1.0)),
)


def main() -> None:
    device = platform_device()
    tok = get_test_tokenizer()
    if TINY:
        dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=64,
                              n_text_ctx=48, state=32, head=4, layers=2)
    else:
        dims = MODEL_DIMS[os.environ.get("MODEL", "medium")]
    log(f"devices: {device_label(device)} B={B} steps={STEPS}")
    model = build_model(dims, device)
    mel = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (B, dims.n_mels, 2 * dims.n_audio_ctx)).astype(np.float32)
    ).to(device)
    r = Readings("profile_beam_decode", device)
    r.extra.update(vs_greedy={}, utts_per_s={})
    for name, kw in VARIANTS:
        opts = decoding.DecodingOptions(language="en", sample_len=STEPS, **kw)

        def run(opts=opts):
            gen = torch.Generator(device=device).manual_seed(1)
            return decoding.decode(model, tok, mel, opts, generator=gen,
                                   device=device)

        base = r.ms.get("greedy")

        def suffix(best, base=base):
            ratio = best * 1e3 / (base or best * 1e3)
            return (f"  ({ratio:4.2f}x greedy; {B / best:6.2f} utts/s "
                    "decode)")

        best, _ = r.time(name, run, iters=3, width=24, suffix=suffix)
        r.extra["vs_greedy"][name] = best * 1e3 / r.ms["greedy"]
        r.extra["utts_per_s"][name] = B / best
    r.emit()


if __name__ == "__main__":
    main()
