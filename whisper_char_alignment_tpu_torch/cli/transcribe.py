"""Long-form transcription CLI, the ``whisper`` command-line equivalent
(port of ``whisper_char_alignment_tpu/cli/transcribe.py``).

    python -m whisper_char_alignment_tpu_torch.cli.transcribe audio1.wav \\
        audio2.wav --model medium --checkpoint medium.pt --output_dir out \\
        --output_format srt --word_timestamps

Runs :func:`whisper_char_alignment_tpu_torch.transcribe.transcribe` per
audio file on the card (or, with ``WCA_PLATFORM=cpu``, on the CPU) and
writes the requested output formats (txt/srt/vtt/tsv/json/all) through
``utils.writers``. The flags are the JAX CLI's.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..models import whisper as wmodel
from ..transcribe import transcribe
from ..utils.writers import get_writer
from . import common


def str2bool(s: str) -> bool:
    """Published CLI boolean parser: unrecognized spellings are errors, not
    silently truthy."""
    if s in ("True", "true", "1", "yes"):
        return True
    if s in ("False", "false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {s!r}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("audio", nargs="+",
                   help="WAV file(s), any sample rate (resampled to 16 kHz)")
    p.add_argument("--model", type=str, default="medium")
    p.add_argument("--output_dir", "-o", type=str, default=".")
    p.add_argument("--output_format", "-f", type=str, default="all",
                   choices=["txt", "srt", "vtt", "tsv", "json", "all"])
    p.add_argument("--language", type=str, default=None)
    p.add_argument("--task", type=str, default="transcribe",
                   choices=["transcribe", "translate"])
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--temperature_increment_on_fallback", type=float,
                   default=0.2)
    p.add_argument("--compression_ratio_threshold", type=float, default=2.4)
    p.add_argument("--logprob_threshold", type=float, default=-1.0)
    p.add_argument("--no_speech_threshold", type=float, default=0.6)
    p.add_argument("--condition_on_previous_text", type=str2bool,
                   default=True)
    p.add_argument("--initial_prompt", type=str, default=None)
    p.add_argument("--beam_size", type=int, default=None)
    p.add_argument("--best_of", type=int, default=None)
    p.add_argument("--patience", type=float, default=None)
    p.add_argument("--length_penalty", type=float, default=None)
    p.add_argument("--suppress_tokens", type=str, default="-1")
    p.add_argument("--word_timestamps", action="store_true")
    p.add_argument("--word_aggr", type=str, default="default",
                   choices=["default", "topk"],
                   help="word-timing head selection: published alignment "
                        "heads, or the paper's top-k saliency heads")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--n_mels", type=int, default=80)
    common.add_tpu_flags(p)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = common.apply_platform_env()
    model, tok = common.load_model_and_tokenizer(args, device)
    model = wmodel.cast_params(model, common.compute_dtype(args), device)

    # published CLI: the fallback ladder climbs from --temperature by
    # --temperature_increment_on_fallback up to 1.0
    if args.temperature_increment_on_fallback is not None:
        temperature = tuple(
            np.arange(args.temperature, 1.0 + 1e-6,
                      args.temperature_increment_on_fallback).tolist())
    else:
        temperature = args.temperature

    from ..audio.resample import load_resampled

    writer = get_writer(args.output_format, args.output_dir)
    for path in args.audio:
        data = load_resampled(path)  # any-rate WAV -> mono 16 kHz
        result = transcribe(
            model, tok, data, device=device.type,
            temperature=temperature,
            compression_ratio_threshold=args.compression_ratio_threshold,
            logprob_threshold=args.logprob_threshold,
            no_speech_threshold=args.no_speech_threshold,
            condition_on_previous_text=args.condition_on_previous_text,
            initial_prompt=args.initial_prompt,
            word_timestamps=args.word_timestamps,
            word_aggr=args.word_aggr,
            model_name=args.model,
            verbose=args.verbose or None,
            language=args.language, task=args.task,
            beam_size=args.beam_size, best_of=args.best_of,
            patience=args.patience, length_penalty=args.length_penalty,
            suppress_tokens=args.suppress_tokens)
        writer(result, path)
        print(f"{path}: {len(result['segments'])} segments "
              f"({result['language']})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
