"""The decode prompt's prefill against stepping through it, on the card
(port of the repository's ``scripts/profile_prefill.py``).

    python -m whisper_char_alignment_tpu_torch.scripts.profile_prefill
    WCA_PLATFORM=cpu WCA_PREFILL_TINY=1 python -m whisper_char_alignment_tpu_torch.scripts.profile_prefill

Two shapes:
  1. the bare sot prompt (the alignment pipeline's decode): the prefill
     takes sample_begin - 1 = 2 positions in one pass;
  2. a long conditioning prompt (transcribe's condition_on_previous_text,
     PROMPT tokens): the prefill takes some 160 positions in one pass.

The port always prefills (``decoding.loop_setup`` calls
``whisper.decode_prefill``), so it has no ``WCA_DECODE_PREFILL`` switch: the
"prefill" arm times ``decoding.decode`` as it is, and the "stepwise" arm
times it with the prompt run as sequential ``whisper.decode_step`` calls,
one a position (:func:`stepwise_prompt`, which puts
:func:`stepwise_prefill` in ``decode_prefill``'s place while it runs). The
rest of the decode (the encoder, the greedy loop's CUDA graph of STEPS
steps) is the same in both arms. Each arm's warm call captures the graph;
the reading is the least of ITERS timed calls.

The JAX lines (least and median) go to stderr, then ONE JSON line: the
readings (ms) under the JAX names (``<shape> prefill`` and ``<shape>
stepwise``), ``device``, ``launches`` and ``graph_captures_timed``. Runs on
``cuda`` unless ``WCA_PLATFORM=cpu``; without a card it exits non-zero and
prints no line.

Knobs (env, the JAX script's): B (8), STEPS (16), PROMPT (160), ITERS (3),
WCA_PREFILL_TINY=1 (tiny dims, CPU-friendly).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from ..bench import build_model, device_label, log, platform_device
from ..config import MODEL_DIMS, tiny_test_dims
from ..models import decoding, whisper as wmodel
from ..text.tokenizer import get_test_tokenizer
from ._profile import Readings

B = int(os.environ.get("B", "8"))
STEPS = int(os.environ.get("STEPS", "16"))
PROMPT = int(os.environ.get("PROMPT", "160"))
ITERS = int(os.environ.get("ITERS", "3"))


@torch.no_grad()
def stepwise_prefill(model, tokens, cache, cross_kv, logits_at=None,
                     cross_mode=None):
    """``whisper.decode_prefill``'s function as sequential
    ``whisper.decode_step`` calls, one a prompt position."""
    logits = None
    for p in range(tokens.shape[1]):
        step, cache = wmodel.decode_step(model, tokens[:, p:p + 1], p, cache,
                                         cross_kv, cross_mode=cross_mode)
        if p == logits_at:
            logits = step
    return logits, cache


@contextlib.contextmanager
def stepwise_prompt():
    """The decode's prompt run step by step while the block runs."""
    prefill = wmodel.decode_prefill
    wmodel.decode_prefill = stepwise_prefill
    try:
        yield
    finally:
        wmodel.decode_prefill = prefill


def main() -> None:
    device = platform_device()
    log(f"devices: {device_label(device)}  B={B} steps={STEPS} "
        f"prompt={PROMPT}")
    tok = get_test_tokenizer()
    if os.environ.get("WCA_PREFILL_TINY") == "1":
        dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=24,
                              n_text_ctx=448, state=16, head=2, layers=2)
    else:
        dims = dataclasses.replace(MODEL_DIMS["medium"], n_vocab=tok.n_vocab)
    model = build_model(dims, device)
    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.normal(
        0, 1, (B, dims.n_mels, 2 * dims.n_audio_ctx)).astype(np.float32)
    ).to(device)
    cond = [int(x) for x in rng.integers(5, tok.eot, PROMPT)]
    r = Readings("profile_prefill", device)
    for name, opts in [
            ("bare sot prompt", decoding.DecodingOptions(
                language="en", sample_len=STEPS)),
            (f"{PROMPT}-token conditioning prompt", decoding.DecodingOptions(
                language="en", sample_len=STEPS, prompt=cond))]:
        for label, arm in (("prefill", contextlib.nullcontext),
                           ("stepwise", stepwise_prompt)):
            def run(opts=opts, arm=arm):
                with arm():
                    return decoding.decode(model, tok, mel, opts,
                                           device=device)

            # the JAX line: name and arm, then least and median
            r.time(f"{name} {label}", run, iters=ITERS, width=46,
                   median=True)
    r.emit()


if __name__ == "__main__":
    main()
