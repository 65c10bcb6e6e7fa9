"""Calibrate the guard margins of the guarded decode modes (port of the
repository's ``scripts/calibrate_kv_guard.py``).

--mode int8   (default): WCA_KV_INT8_GUARD_MARGIN for --decode_kv_int8_guarded
--mode bucket : WCA_BUCKET_GUARD_MARGIN for --decode_frame_bucket_guarded
--mode both   : the SUM bound when both guarded modes run together

A guarded mode (``models/decoding.py``) keeps an utterance's
perturbed-decode transcript only when every sampled step's top1-top2
filtered-logit margin exceeds the guard bound; utterances below it
re-decode with the guarded perturbation off. The bound depends on the
checkpoint and the data: this program measures it on a real corpus the day
assets arrive, and rehearses the procedure on random weights:

1. decode each batch twice through ``decoding.decode``: exact, and perturbed
   (int8 and/or frame-bucketed) with margin tracking (guard 0.0 tracks
   margins and flags nothing); the perturbed pass reuses the exact pass's
   encoder states, which are the same either way,
2. compare transcripts: any difference is a "flip" the guard must catch,
3. recommend bound = safety x the largest margin observed on a flipped
   utterance (flips with bigger margins would escape a smaller bound); with
   zero flips the tested default for the mode stands,
4. report the predicted re-decode (flag) rate of the recommended bound from
   the corpus margin distribution. A guarded decode costs the tracked decode
   plus flag_rate x (the exact re-decode), so it beats the exact decode only
   below a flag rate the card's own decode times set (``bench``'s
   ``decode_sweep`` measures the three).

Which arithmetic the int8 pass runs matters: on the card ``WCA_CROSS_ATTN=auto``
takes the int8 cross-attention kernel inside the decode graph, where the
JAX package's ``auto`` takes its int8-product step, so a margin calibrated
by the JAX package says nothing about the port's flips. The line's
``cross_attn`` names the mode that ran. On random weights the recommendation
describes the procedure, not a margin to deploy.

    python -m whisper_char_alignment_tpu_torch.scripts.calibrate_kv_guard --test_model
    python -m whisper_char_alignment_tpu_torch.scripts.calibrate_kv_guard --rehearse --mode both
    WCA_CHECKPOINT=medium.pt WCA_TOKENIZER_DIR=assets \\
        python -m whisper_char_alignment_tpu_torch.scripts.calibrate_kv_guard \\
        --model medium --scp timit_test.scp --dataset TIMIT

``--rehearse`` writes a random tiny checkpoint in the real ``.pt`` format
and a tokenizer directory (``rehearse_asset_day.make_assets``) and loads
them through the production ``--checkpoint``/``--tokenizer_dir`` path
(``cli/common.load_model_and_tokenizer``) before calibrating: the asset-day
procedure end to end, so that the day real weights arrive only the weight
values are new. ``--test_model`` and ``--rehearse`` run in float32, the
real path in bfloat16.

Prints ONE JSON line on stdout, the JAX script's keys plus ``cross_attn``,
``device`` (the card's name and power limit, or ``"cpu"``) and ``launches``
(the kernel launches of the calibration, ``ops/_lib``); logs on stderr.
Runs on ``cuda`` unless ``WCA_PLATFORM=cpu``; without a card it exits
non-zero and prints nothing on stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import List, NamedTuple

import numpy as np
import torch

from .. import constants
from ..audio.mel import log_mel_spectrogram, pad_or_trim
from ..bench import device_label, log, platform_device
from ..cli import common
from ..config import tiny_test_dims
from ..data.dataset import DATASETS, batch_iter
from ..data.synthetic import make_timit_corpus
from ..models import decoding, whisper as wmodel
from ..ops import _lib
from ..parallel.mesh import pad_to_multiple
from ..text.tokenizer import get_test_tokenizer

MODES = ("int8", "bucket", "both")


class Margins(NamedTuple):
    """Per utterance, in corpus order: the perturbed pass's smallest
    sampled-step margin and whether its tokens differ from the exact
    pass's."""
    margins: List[float]
    flipped: List[bool]


def padded_batches(model, dataset, batch_size: int):
    """Yield (utterances, live count, mel) of ``dataset`` in batches of
    ``batch_size``, the mel on the model's device in its dtype. The trailing
    partial batch is padded to the full size with its last utterance: every
    distinct batch size is another greedy graph key
    (``models/decode_graph.py`` keeps 16), so a short last batch would
    capture two more graphs; the production runner pads for the same
    reason."""
    dims = model.dims
    n_samples = 2 * dims.n_audio_ctx * constants.HOP_LENGTH
    for batch in batch_iter(dataset, batch_size):
        n_live = len(batch)
        if n_live < batch_size:
            batch = list(batch) + [batch[-1]] * (batch_size - n_live)
        audio = torch.from_numpy(np.stack(
            [np.asarray(pad_or_trim(u.audio, n_samples)) for u in batch]))
        mel = log_mel_spectrogram(audio.to(model.device),
                                  n_mels=dims.n_mels).to(model.dtype)
        yield batch, n_live, mel


def measure(model, tok, dataset, *, mode: str = "int8", batch_size: int = 16,
            decode_len: int = 32, frame_bucket: int = 128) -> Margins:
    """Decode ``dataset`` exactly and perturbed as ``mode`` says, batch by
    batch, on the model's device and in its dtype."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    device = model.device
    opts = options(decode_len)
    int8 = mode in ("int8", "both")
    bucket = mode in ("bucket", "both")
    out = Margins([], [])
    for batch, n_live, mel in padded_batches(model, dataset, batch_size):
        exact, xa = decoding.decode(model, tok, mel, opts, return_xa=True,
                                    device=device)
        kv_frames = None
        if bucket:
            # the production runner's bucket (runner._dispatch_transcribe):
            # the batch's most true frames rounded up to the bucket
            # multiple, at most the full window
            max_fl = max(max(u.duration // constants.AUDIO_SAMPLES_PER_TOKEN,
                             1) for u in batch)
            kv_frames = min(model.dims.n_audio_ctx,
                            pad_to_multiple(int(max_fl), frame_bucket))
        quant = decoding.decode(
            model, tok, mel, opts, xa=xa, device=device, kv_int8=int8,
            kv_frames=kv_frames,
            # guard 0.0: track margins, flag nothing
            kv_int8_guard=0.0 if int8 else None,
            kv_frames_guard=0.0 if bucket else None)
        for e, q in zip(exact[:n_live], quant[:n_live]):  # skip pad rows
            out.margins.append(float(q.min_margin))
            out.flipped.append(e.tokens != q.tokens)
        log(f"{len(out.margins)} utts: {sum(out.flipped)} flips so far")
    return out


def options(decode_len: int) -> decoding.DecodingOptions:
    """The JAX script's decode options: no timestamps, ``decode_len``
    sampled steps."""
    return decoding.DecodingOptions(without_timestamps=True,
                                    sample_len=decode_len)


def default_margin(mode: str) -> float:
    """The tested default bound of ``mode`` (``both``: the sum)."""
    return {"int8": decoding.DEFAULT_KV_INT8_GUARD_MARGIN,
            "bucket": decoding.DEFAULT_BUCKET_GUARD_MARGIN,
            "both": (decoding.DEFAULT_KV_INT8_GUARD_MARGIN
                     + decoding.DEFAULT_BUCKET_GUARD_MARGIN)}[mode]


def summarize(measured: Margins, mode: str, safety: float) -> dict:
    """The JAX script's recommendation and statistics of ``measured``."""
    margins = np.asarray(measured.margins, np.float64)
    flipped = [m for m, f in zip(measured.margins, measured.flipped) if f]
    n_total = len(margins)
    default = default_margin(mode)
    if flipped:
        bound = safety * max(flipped)
        basis = "safety x max flipped-utterance margin"
    else:
        bound = default
        basis = "no flips observed; tested default stands"
    return {
        "metric": f"kv_{mode}_guard_calibration",
        "mode": mode,
        "recommended_guard_margin": round(float(bound), 4),
        "basis": basis,
        "n_utts": n_total,
        "flip_rate_unguarded": round(len(flipped) / max(n_total, 1), 4),
        "predicted_flag_rate": round(float((margins < bound).mean()), 4),
        "predicted_flag_rate_at_default": round(
            float((margins < default).mean()), 4),
        "margin_percentiles": {p: round(float(np.percentile(margins, p)), 4)
                               for p in (1, 5, 25, 50)},
        "deployable_hint": "guard beats exact decode while track + "
                           "flag_rate x redecode stays under exact "
                           "(bench decode_sweep measures the three)",
    }


def calibrate(model, tok, dataset, *, mode: str = "int8",
              batch_size: int = 16, decode_len: int = 32,
              safety: float = 2.0, frame_bucket: int = 128) -> dict:
    """:func:`measure` then :func:`summarize`, plus ``cross_attn`` (the int8
    pass's cross-attention mode, ``float`` for the bucket alone),
    ``device`` and ``launches`` (the kernel launches it made)."""
    before = _lib.launch_counts()
    measured = measure(model, tok, dataset, mode=mode, batch_size=batch_size,
                       decode_len=decode_len, frame_bucket=frame_bucket)
    after = _lib.launch_counts()
    out = summarize(measured, mode, safety)
    out["cross_attn"] = (wmodel.cross_attn_mode(model.device)
                         if mode in ("int8", "both") else "float")
    out["device"] = device_label(model.device)
    out["launches"] = {k: after[k] - before[k] for k in after}
    return out


def tiny_dims(n_vocab: int):
    """The offline runs' model: the JAX script's tiny dims with heads 16
    wide (state 32 over 2 heads), the narrowest the encoder kernel takes
    (the JAX script's are 8)."""
    return tiny_test_dims(n_vocab=n_vocab, n_audio_ctx=96, n_text_ctx=64,
                          state=32, head=2, layers=2)


def toy_model(device: torch.device):
    """The JAX script's ``--test_model``: the toy tokenizer and a tiny f32
    model (:func:`tiny_dims`, weights from a ``torch.Generator`` seeded 0
    on the CPU)."""
    tok = get_test_tokenizer()
    dims = tiny_dims(tok.n_vocab)
    gen = torch.Generator().manual_seed(0)
    model = wmodel.init_params(wmodel.Whisper(dims, device="cpu"), gen)
    return model.to(device), tok


def rehearsal_model(args, device: torch.device):
    """The JAX script's ``--rehearse``: a tiny f32 checkpoint and tokenizer
    directory written in the real formats, read back by the CLI loader."""
    from .rehearse_asset_day import make_assets, toy_vocab_size

    # the tokenizer directory's vocabulary must equal the checkpoint's
    rdims = tiny_dims(toy_vocab_size())
    assets = make_assets(tempfile.mkdtemp(prefix="wca_calib_assets_"), rdims,
                         formats=("pt",))
    log(f"rehearsal assets (real formats): {assets}")
    ns = argparse.Namespace(model=args.model, test_model=False,
                            checkpoint=assets["pt"],
                            tokenizer_dir=assets["tokenizer_dir"])
    return common.load_model_and_tokenizer(ns, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="medium")
    ap.add_argument("--test_model", action="store_true",
                    help="offline smoke: tiny random model + synthetic corpus")
    ap.add_argument("--rehearse", action="store_true",
                    help="asset-day dry run: real-format synthetic assets "
                         "loaded through the production checkpoint/tokenizer "
                         "path (see module docstring)")
    ap.add_argument("--scp", default=None,
                    help="corpus scp (default: a synthetic TIMIT-style one)")
    ap.add_argument("--dataset", default="TIMIT")
    ap.add_argument("--n_utts", type=int, default=64)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--decode_len", type=int, default=32)
    ap.add_argument("--safety", type=float, default=2.0,
                    help="bound = safety x max flipped-utterance margin")
    ap.add_argument("--mode", choices=MODES, default="int8",
                    help="which guarded perturbation to calibrate")
    ap.add_argument("--frame_bucket", type=int, default=128,
                    help="bucket multiple for --mode bucket/both (the "
                         "--decode_frame_bucket value being deployed)")
    args = ap.parse_args(argv)
    device = platform_device()

    if args.rehearse:
        model, tok = rehearsal_model(args, device)
    elif args.test_model:
        model, tok = toy_model(device)
    else:
        ns = argparse.Namespace(model=args.model, test_model=False,
                                checkpoint=os.environ.get("WCA_CHECKPOINT"),
                                tokenizer_dir=os.environ.get(
                                    "WCA_TOKENIZER_DIR"))
        model, tok = common.load_model_and_tokenizer(ns, device)
        model = wmodel.cast_params(model, torch.bfloat16)

    scp = args.scp
    if scp is None:
        tmp = tempfile.mkdtemp(prefix="wca_calib_")
        scp = make_timit_corpus(tmp, n_utts=args.n_utts, seconds=(2.0, 5.0))
        log(f"synthetic corpus: {args.n_utts} utts under {tmp}")
    out = calibrate(model, tok, DATASETS[args.dataset](scp), mode=args.mode,
                    batch_size=args.batch_size, decode_len=args.decode_len,
                    safety=args.safety, frame_bucket=args.frame_bucket)
    out["source"] = ("rehearsal-assets" if args.rehearse
                     else "test_model" if args.test_model else args.model)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
