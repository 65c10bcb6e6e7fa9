"""Per-stage profile of the alignment pipeline at Whisper-medium width (port
of the repository's ``scripts/profile_pipeline.py``).

    python -m whisper_char_alignment_tpu_torch.scripts.profile_pipeline [--batch 32] [--tokens 96] [--decode_len 32] [--frames 300] [--iters 5] [--reuse]
    PROF_INT8=1 python -m whisper_char_alignment_tpu_torch.scripts.profile_pipeline --batch 16 --reuse

Stages, each timed alone on the same batch (random bf16 weights from seed
0, 30 s of random audio an utterance, random tokens):
  "mel"                       the plain log-mel (``audio/mel``)
  "encoder"                   ``whisper.encode_audio``: kernel 1 in each
                              encoder layer
  "greedy decode (N)"         ``decoding.decode`` (the encoder, then the
                              greedy loop's CUDA graph of N steps)
  "greedy decode int8 (N)"    with PROF_INT8=1: int8 cross K/V, each step's
                              cross-attention kernel 7 on the card
  "capture (enc+dec+qkpost)"  ``timing.get_attentions`` without logits
                              (``return_logits=False``, as the runner's
                              capture): the encoder, the teacher-forced
                              decoder, kernel 2 in each decoder layer
  "capture (xa reuse)", "capture (xa + cross-KV reuse)"
                              with --reuse: the capture given the encoder
                              states (and the decode's cross K/V)
  "head-select + DTW"         ``timing.force_align_batch`` (top-10 heads,
                              kernels 3a and 3b)
  "FULL PIPELINE"             mel, decode, capture, head-select + DTW in a
                              row, with the utterances a second

Each stage's warm call runs it once (capturing its decode graph); the
reading is the least of ``--iters`` timed calls, each between two
synchronizes. The lines (least and median) go to stderr, then ONE JSON line:
the readings (ms) under the JAX names, ``utts_per_sec``, ``device``,
``launches`` and ``graph_captures_timed``. Runs on ``cuda`` unless
``WCA_PLATFORM=cpu``; without a card it exits non-zero and prints no line.
Knobs: the JAX script's flags and PROF_INT8.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import constants
from ..align import timing
from ..audio.mel import log_mel_spectrogram
from ..bench import build_model, device_label, log, platform_device
from ..config import MODEL_DIMS
from ..models import decoding, whisper as wmodel
from ..text.tokenizer import get_test_tokenizer
from ._profile import Readings

# the sizes table is the single source
DIMS = MODEL_DIMS["medium"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=96)
    ap.add_argument("--decode_len", type=int, default=32)
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--reuse", action="store_true",
                    help="also time the xa / cross-KV reuse capture "
                         "variants (adds the K/V stacks to device memory; "
                         "use --batch 16)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    b, t = args.batch, args.tokens
    device = platform_device()
    log(f"devices: {device_label(device)}  batch={b} tokens={t}")
    dims = DIMS
    tok = get_test_tokenizer()
    model = build_model(dims, device)
    rng = np.random.default_rng(0)
    audio = torch.from_numpy(rng.normal(
        0, .1, (b, constants.N_SAMPLES)).astype(np.float32)).to(device)
    tokens = torch.from_numpy(rng.integers(0, 255, (b, t)).astype(
        np.int32)).to(device)
    tl = torch.full((b,), t - 4, dtype=torch.int32, device=device)
    fl = torch.full((b,), args.frames, dtype=torch.int32, device=device)
    opts = decoding.DecodingOptions(language="en", sample_len=args.decode_len)
    r = Readings("profile_pipeline", device)

    def timed(name, fn):
        return r.time(name, fn, args.iters, width=28, median=True)

    def capture(mel, **kw):
        attn, _ = timing.get_attentions(model, mel, tokens, tl, fl,
                                        medfilt_width=3, qk_scale=1.0,
                                        return_logits=False, device=device,
                                        **kw)
        return attn

    mel = log_mel_spectrogram(audio).to(torch.bfloat16)
    timed("mel", lambda: log_mel_spectrogram(audio).sum())
    timed("encoder",
          lambda: wmodel.encode_audio(model, mel, device=device).sum())
    timed(f"greedy decode ({args.decode_len})",
          lambda: decoding.decode(model, tok, mel, opts, device=device))
    if os.environ.get("PROF_INT8") == "1":
        timed(f"greedy decode int8 ({args.decode_len})",
              lambda: decoding.decode(model, tok, mel, opts, kv_int8=True,
                                      device=device))
    timed("capture (enc+dec+qkpost)", lambda: capture(mel)[..., 0, 0].sum())

    # the production path's variants: the encoder states (and the decode
    # loop's cross K/V) are reused, so the capture pays only the decoder
    if args.reuse:
        xa = wmodel.encode_audio(model, mel, device=device)
        ckv = wmodel.precompute_cross_kv(model, xa)
        timed("capture (xa reuse)",
              lambda: capture(None, xa=xa)[..., 0, 0].sum())
        timed("capture (xa + cross-KV reuse)",
              lambda: capture(None, cross_kv=ckv)[..., 0, 0].sum())
        del xa, ckv

    attn = capture(mel)
    timed("head-select + DTW", lambda: timing.force_align_batch(
        attn, tl, fl, 3, "topk", 10)[0].sum())
    del attn  # the f32 stack (7 GB at B=32) must not stay live across full()

    def full():
        m = log_mel_spectrogram(audio).to(torch.bfloat16)
        decoding.decode(model, tok, m, opts, device=device)
        return timing.force_align_batch(capture(m), tl, fl, 3, "topk",
                                        10)[0]

    def rate(best):
        return f"   -> {b / best:6.2f} utts/sec/chip"

    best, _ = r.time("FULL PIPELINE", full, args.iters, width=28,
                     suffix=rate)
    r.extra["utts_per_sec"] = b / best
    r.emit()


if __name__ == "__main__":
    main()
