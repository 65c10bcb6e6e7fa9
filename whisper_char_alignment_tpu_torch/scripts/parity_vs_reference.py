"""Boundary parity against the PyTorch reference (port of the repository's
``scripts/parity_vs_reference.py``).

Runs the port (``api.load_model`` -> ``api.align`` on the device
``WCA_PLATFORM`` selects) and the reference repository on the same scp and
compares (word, start, end) tuples at a one-mel-frame (20 ms) tolerance, the
north-star parity bound (BASELINE.md). Needs the reference's dependencies
(``openai-whisper``, torch, torchaudio) and real assets (``--checkpoint`` /
``WCA_CHECKPOINT``, ``--tokenizer_dir`` / ``WCA_TOKENIZER_DIR``): without
``openai-whisper`` the program exits 2 with a line naming the package,
before any work. Without ``WCA_PLATFORM=cpu`` and without a card it exits
non-zero and prints nothing on stdout.

    python -m whisper_char_alignment_tpu_torch.scripts.parity_vs_reference \\
        --scp /path/to/test.scp --reference_repo /path/to/whisper-char-alignment \\
        --model medium

Exit 0: every word matched within the tolerance, no word mismatch; 1: a
mismatch; 2: no words were compared (a malformed scp must not report 100%
parity over nothing), or ``openai-whisper`` is missing.
"""

from __future__ import annotations

import argparse
import sys

from ..bench import platform_device, require_package


def run_ours(args, device=None) -> dict:
    """fid -> [(word, start, end), ...] from the port's API."""
    from .. import api
    from ..data.dataset import TIMIT

    model = api.load_model(args.model, checkpoint=args.checkpoint,
                           tokenizer_dir=args.tokenizer_dir, device=device)
    out = {}
    ds = TIMIT(args.scp)
    for i in range(len(ds)):
        u = ds[i]
        res = api.align(model, u.audio,
                        aligned_unit_type=args.aligned_unit_type,
                        aggregation="topk", topk=args.topk,
                        medfilt_width=args.medfilt_width, device=device)
        out[u.fid] = [(w.strip(), float(s), float(e)) for w, s, e in
                      zip(res.words[:-1], res.start_times, res.end_times)]
    return out


def run_reference(args) -> dict:
    """fid -> [(word, start, end), ...] from the reference repository's
    modules and openai-whisper."""
    sys.path.insert(0, args.reference_repo)
    import torch
    import whisper
    from whisper.tokenizer import get_tokenizer

    from timing import get_attentions, force_align  # reference modules
    from retokenize import encode, remove_punctuation

    from ..data.dataset import TIMIT

    model = whisper.load_model(args.model)
    tokenizer = get_tokenizer(model.is_multilingual, language="English")
    options = whisper.DecodingOptions(language="en")
    out = {}
    ds = TIMIT(args.scp)
    for i in range(len(ds)):
        u = ds[i]
        audio = whisper.pad_or_trim(torch.from_numpy(u.audio))
        mel = whisper.log_mel_spectrogram(audio, 80).to(model.device)
        transcription = remove_punctuation(
            whisper.decode(model, mel, options).text)
        text_tokens = encode(transcription, tokenizer, args.aligned_unit_type)
        max_frames = u.duration // 320
        attn_w, _ = get_attentions(
            mel, torch.tensor([*tokenizer.sot_sequence,
                               tokenizer.no_timestamps, *text_tokens,
                               tokenizer.eot]).to(model.device),
            model, tokenizer, max_frames, args.medfilt_width, 1.0)
        words, starts, ends, _, _ = force_align(
            attn_w, text_tokens, tokenizer,
            aligned_unit_type=args.aligned_unit_type, aggregation="topk",
            topk=args.topk)
        out[u.fid] = [(w.strip(), float(s), float(e)) for w, s, e in
                      zip(words[:-1], starts, ends)]
    return out


def compare(ours: dict, ref: dict, tolerance: float) -> int:
    """Print the per-word misses and the summary line; return 0 (every word
    within ``tolerance``, no mismatch), 1 (a mismatch) or 2 (no words
    compared)."""
    n_words = n_match = n_word_mismatch = 0
    worst = 0.0
    for fid in ref:
        a, b = ours.get(fid, []), ref[fid]
        if len(a) != len(b):
            print(f"{fid}: word count differs ({len(a)} vs {len(b)})")
            n_word_mismatch += max(len(a), len(b))
            continue
        for (w1, s1, e1), (w2, s2, e2) in zip(a, b):
            n_words += 1
            if w1.lower() != w2.lower():
                n_word_mismatch += 1
                continue
            d = max(abs(s1 - s2), abs(e1 - e2))
            worst = max(worst, d)
            if d <= tolerance:
                n_match += 1
            else:
                print(f"{fid}: {w1} off by {d * 1000:.0f} ms")
    print(f"\nwords: {n_words}  within {tolerance * 1000:.0f} ms: {n_match} "
          f"({100 * n_match / max(n_words, 1):.2f}%)  word mismatches: "
          f"{n_word_mismatch}  worst boundary delta: {worst * 1000:.0f} ms")
    if n_words == 0:
        # zero comparisons must fail, not pass vacuously: a malformed scp
        # would otherwise let the asset gate report 100% parity over nothing
        print("no words were compared; refusing to report parity",
              file=sys.stderr)
        return 2
    return 0 if n_match == n_words and n_word_mismatch == 0 else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scp", required=True)
    ap.add_argument("--reference_repo", required=True)
    ap.add_argument("--model", default="medium")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--tokenizer_dir", default=None)
    ap.add_argument("--aligned_unit_type", default="char")
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--medfilt_width", type=int, default=3)
    ap.add_argument("--tolerance", type=float, default=0.02,
                    help="1 mel frame (20 ms) per BASELINE.md")
    args = ap.parse_args(argv)
    require_package("whisper", "openai-whisper", "parity_vs_reference",
                    "the reference's model")
    device = platform_device()
    ours = run_ours(args, device)
    ref = run_reference(args)
    return compare(ours, ref, args.tolerance)


if __name__ == "__main__":
    raise SystemExit(main())
