"""Shared CLI plumbing: flags, model/tokenizer loading, result dumping.

Port of ``whisper_char_alignment_tpu/cli/common.py``: the same flags with
the same defaults, so a command line of the JAX CLIs runs here unchanged.
There is no compile cache (PyTorch runs eagerly; the CUDA kernels are built
once into ``build/torch_kernels/``). The CLIs run on the card; with
``WCA_PLATFORM=cpu`` (the JAX CLIs' own switch) they run on the CPU, through
every kernel's plain version. Options the port does not carry yet raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import time
from typing import Tuple

import torch

from ..config import AlignConfig, tiny_test_dims
from ..models import convert, whisper as wmodel
from ..text.tokenizer import WhisperTokenizer, get_test_tokenizer, get_tokenizer
from ..utils.device import resolve_device
from ..utils.unported import not_ported


def apply_platform_env() -> torch.device:
    """The device ``WCA_PLATFORM`` selects (JAX ``cli/common.py:27-33``):
    ``cpu`` -> the CPU; unset or ``gpu`` -> the card, which raises when there
    is none. Any other value raises."""
    platform = os.environ.get("WCA_PLATFORM", "gpu") or "gpu"
    if platform not in ("cpu", "gpu"):
        raise ValueError(f"WCA_PLATFORM={platform!r}: the port runs on 'gpu' "
                         "(one CUDA card) or 'cpu'")
    return resolve_device("cpu" if platform == "cpu" else None)


def add_reference_flags(parser: argparse.ArgumentParser) -> None:
    """Every flag of the reference CLIs with identical defaults
    (reference infer_ali.py:151-173)."""
    parser.add_argument("--model", type=str, default="medium")
    parser.add_argument("--dataset", type=str, default="TIMIT",
                        choices=["TIMIT", "LibriSpeech"])
    parser.add_argument("--scp", type=str, default="scp/test.wav.scp")
    parser.add_argument("--output_dir", type=str, required=True,
                        help="Path to the output directory")
    parser.add_argument("--n_mels", type=int, default=80)
    parser.add_argument("--medfilt_width", type=int, default=7)
    parser.add_argument("--aggr", type=str, default="mean",
                        choices=["mean", "topk"])
    parser.add_argument("--topk", type=int, default=15)
    parser.add_argument("--aligned_unit_type", type=str, default="subword",
                        choices=["subword", "char"])
    parser.add_argument("--tolerance", type=float, default=0.02)
    parser.add_argument("--plot", action="store_true")
    parser.add_argument("--strict", action="store_true")


def add_tpu_flags(parser: argparse.ArgumentParser) -> None:
    """Flags honored by every CLI (model source / dtype / quantization)."""
    parser.add_argument("--checkpoint", type=str, default=None,
                        help=".pt/.npz/.safetensors weights "
                             "(env WCA_CHECKPOINT)")
    parser.add_argument("--tokenizer_dir", type=str, default=None,
                        help="dir with *.tiktoken or vocab.json "
                             "(env WCA_TOKENIZER_DIR)")
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--test_model", action="store_true",
                        help="random tiny model + toy tokenizer (offline smoke)")
    parser.add_argument("--encoder_int8", action="store_true",
                        help="int8 encoder projections/MLP (not ported yet: "
                             "raises)")


def add_pipeline_flags(parser: argparse.ArgumentParser) -> None:
    """Batched-pipeline flags (infer_ali / probe_oracle only)."""
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--data_parallel", type=int, default=0,
                        help="devices on the batch mesh axis (0 = all; "
                             "above 1 not ported yet: raises)")
    parser.add_argument("--tensor_parallel", type=int, default=0,
                        help="devices on the 'model' mesh axis (0/1 = off; "
                             "above 1 not ported yet: raises)")
    parser.add_argument("--decode_frame_bucket", type=int, default=0,
                        help="bucket decode cross-attention K/V to the batch's "
                             "true frames rounded up to this multiple (0 = full "
                             "30s window, reference-exact)")
    parser.add_argument("--sort_by_duration", action="store_true",
                        help="batch length-sorted utterances (file-size proxy) "
                             "so short utterances don't pay the longest "
                             "transcript's decode steps; changes output order")
    parser.add_argument("--decode_kv_int8", action="store_true",
                        help="int8-quantize decode cross-attention K/V (halves "
                             "the decode stream; small accuracy risk). On a "
                             "GPU WCA_CROSS_ATTN=auto takes the int8 "
                             "cross-attention kernel")
    parser.add_argument("--decode_kv_int8_guarded", action="store_true",
                        help="int8 K/V decode with a transcript-parity guard: "
                             "each step's top1-top2 logit margin is tracked "
                             "and any utterance whose min margin falls below "
                             "the bound (WCA_KV_INT8_GUARD_MARGIN) is "
                             "re-decoded exactly, reusing its encoder states")
    parser.add_argument("--decode_frame_bucket_guarded", action="store_true",
                        help="frame-bucketed decode with a transcript-parity "
                             "guard (requires --decode_frame_bucket N): "
                             "utterances whose min margin falls below "
                             "WCA_BUCKET_GUARD_MARGIN re-decode over the full "
                             "30s window")
    parser.add_argument("--decode_sample_len", type=int, default=0,
                        help="cap sampled decode steps per utterance (0 = "
                             "published default, n_text_ctx // 2)")
    parser.add_argument("--use_gt_transcript", action="store_true",
                        help="align the ground-truth transcript instead of "
                             "the decoded one (decode still runs and is "
                             "timed)")
    parser.add_argument("--profile", action="store_true",
                        help="print per-stage wall-time summary at the end")
    parser.add_argument("--trace_dir", type=str, default=None,
                        help="write a torch.profiler trace (Chrome format) "
                             "here")
    parser.add_argument("--multihost", action="store_true",
                        help="shard the scp across processes (not ported "
                             "yet: raises)")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="host:port of process 0 (with --multihost)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)


def load_model_and_tokenizer(args, device=None
                             ) -> Tuple[wmodel.Whisper, WhisperTokenizer]:
    """Resolve weights + tokenizer from flags/env onto ``device``;
    ``--test_model`` gives a deterministic random tiny model for offline
    runs, its weights drawn on the CPU from a ``torch.Generator`` seeded 0,
    so they are the same on every device. ``--multihost`` and
    ``--encoder_int8`` raise here, for every CLI (``transcribe`` and
    ``serve`` build no pipeline at load), ``--data_parallel`` /
    ``--tensor_parallel`` above 1 in ``AlignmentPipeline``."""
    if getattr(args, "multihost", False):
        raise not_ported("--multihost", "parallel")
    if getattr(args, "encoder_int8", False):
        raise not_ported("--encoder_int8", "quantized")
    dev = resolve_device(device)
    if getattr(args, "test_model", False):
        tok = get_test_tokenizer()
        dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=1500,
                              n_text_ctx=448, state=32, head=2, layers=2,
                              n_mels=args.n_mels)
        gen = torch.Generator().manual_seed(0)
        model = wmodel.init_params(wmodel.Whisper(dims, device="cpu"), gen)
        return wmodel.cast_params(model, torch.float32, dev), tok

    ckpt = args.checkpoint or os.environ.get("WCA_CHECKPOINT")
    if not ckpt:
        raise SystemExit(
            "no weights available: pass --checkpoint / set WCA_CHECKPOINT "
            "(or use --test_model for an offline smoke run)")
    sd, dims = convert.load_checkpoint(ckpt)
    model = convert.model_from_state_dict(sd, dims, device=dev)
    multilingual = not args.model.endswith(".en")
    tok = get_tokenizer(multilingual, language="English",
                        tokenizer_dir=args.tokenizer_dir)
    return model, tok


def compute_dtype(args) -> torch.dtype:
    return torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32


def config_from_args(args) -> AlignConfig:
    keys = [f.name for f in AlignConfig.__dataclass_fields__.values()]
    kwargs = {k: getattr(args, k) for k in keys if hasattr(args, k)}
    return AlignConfig(**kwargs)


def results_basename(args, ts: float = None) -> str:
    """Timestamped output path stem under ``args.output_dir`` (no
    extension)."""
    filename = datetime.datetime.fromtimestamp(
        time.time() if ts is None else ts).strftime("%Y-%m-%d-%H:%M:%S")
    os.makedirs(args.output_dir, exist_ok=True)
    return os.path.join(args.output_dir, filename)


def dump_results(args, results: dict, stem: str = None) -> str:
    """Timestamped provenance JSON: config union metrics
    (reference infer_ali.py:139-146)."""
    merged = {**{k: v for k, v in vars(args).items()}, **results}
    out = (stem or results_basename(args)) + ".json"
    with open(out, "w") as f:
        json.dump(merged, f)
    return out
