"""Shared CLI plumbing: flags, model/tokenizer loading, result dumping.

Port of ``whisper_char_alignment_tpu/cli/common.py``: the same flags with
the same defaults, so a command line of the JAX CLIs runs here unchanged.
There is no compile cache (PyTorch runs eagerly; the CUDA kernels are built
once into ``build/torch_kernels/``). The CLIs run on the card; with
``WCA_PLATFORM=cpu`` (the JAX CLIs' own switch) they run on the CPU, through
every kernel's plain version.

Several devices (:func:`process_world`, :func:`mesh_from_args`): a port
process owns one device, so the JAX CLIs' in-process mesh of
``--data_parallel x --tensor_parallel`` devices is a world of as many
processes. ``--multihost`` joins the world its flags name, whose ranks make
``W / (data x model)`` replicas of that mesh, each aligning a round-robin
shard of the scp; without it, a mesh of more than one device starts its
ranks on this host. ``--data_parallel 0`` (the default) is one data rank.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

from ..config import AlignConfig, tiny_test_dims
from ..models import convert, whisper as wmodel
from ..parallel import distributed
from ..parallel.mesh import Mesh, make_mesh
from ..text.tokenizer import WhisperTokenizer, get_test_tokenizer, get_tokenizer
from ..utils.device import resolve_device


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
                        help="int8 encoder projections/MLP (per-channel "
                             "int8 weights, per-row int8 activations)")


def add_pipeline_flags(parser: argparse.ArgumentParser) -> None:
    """Batched-pipeline flags (infer_ali / probe_oracle only)."""
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--data_parallel", type=int, default=0,
                        help="devices (one process each) on the batch mesh "
                             "axis (0 = one)")
    parser.add_argument("--tensor_parallel", type=int, default=0,
                        help="devices (one process each) on the 'model' mesh "
                             "axis: shards the attention heads and MLP "
                             "(0/1 = off)")
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
                        help="print the stage profile (seconds by stage, "
                             "device seconds on a card) and the span "
                             "profile (kind, host and self seconds, "
                             "counters) at the end")
    parser.add_argument("--trace_dir", type=str, default=None,
                        help="write a torch.profiler trace (Chrome format) "
                             "here and print the card's idle seconds by "
                             "span")
    parser.add_argument("--multihost", action="store_true",
                        help="join a torch.distributed world and shard the "
                             "scp across its mesh replicas")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="host:port of process 0, or a file:// "
                             "rendezvous (with --multihost)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)


def load_model_and_tokenizer(args, device=None
                             ) -> Tuple[wmodel.Whisper, WhisperTokenizer]:
    """Resolve weights + tokenizer from flags/env onto ``device``;
    ``--test_model`` gives a deterministic random tiny model for offline
    runs, its weights drawn on the CPU from a ``torch.Generator`` seeded 0,
    so they are the same on every device. ``--encoder_int8`` quantizes the
    encoder here, at load, so every CLI honours it (JAX
    ``cli/common.py:182-187``; ``transcribe`` and ``serve`` build no
    pipeline)."""
    dev = resolve_device(device)
    if getattr(args, "test_model", False):
        tok = get_test_tokenizer()
        dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=1500,
                              n_text_ctx=448, state=32, head=2, layers=2,
                              n_mels=args.n_mels)
        gen = torch.Generator().manual_seed(0)
        model = wmodel.init_params(wmodel.Whisper(dims, device="cpu"), gen)
        return wmodel.cast_params(_maybe_quantize(model, args),
                                  torch.float32, dev), tok

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
    return _maybe_quantize(model, args), tok


def _maybe_quantize(model: wmodel.Whisper, args) -> wmodel.Whisper:
    if getattr(args, "encoder_int8", False):
        return wmodel.quantize_encoder_int8(model)
    return model


def _mesh_counts(args) -> Tuple[int, int]:
    return (max(1, getattr(args, "data_parallel", 0)),
            max(1, getattr(args, "tensor_parallel", 0)))


def _backend(device: torch.device) -> str:
    return "gloo" if device.type == "cpu" else "nccl"


@contextlib.contextmanager
def process_world(args, argv, module: str):
    """The world this CLI process runs in, around its work; yields the
    device. ``--multihost`` joins the world its flags name. Without it, a
    mesh of ``--data_parallel x --tensor_parallel`` above one device starts
    that many ranks on this host (the JAX CLI's local mesh): this process
    is rank 0 and the others run ``python -m module`` with this command's
    ``argv`` and ``--multihost`` flags, meeting at a file rendezvous in a
    fresh temporary directory; on the CPU they share its cores out
    (``OMP_NUM_THREADS``). It waits for them and raises when one fails;
    every process leaves the world at the end."""
    device = apply_platform_env()
    n = _mesh_counts(args)[0] * _mesh_counts(args)[1]
    procs, tmp, threads = [], None, torch.get_num_threads()
    try:
        if getattr(args, "multihost", False):
            distributed.initialize(args.coordinator_address,
                                   args.num_processes, args.process_id,
                                   backend=_backend(device))
        elif n > 1:
            if device.type == "cuda" and n > torch.cuda.device_count():
                raise ValueError(
                    f"a mesh of {n} devices needs {n} cards, this host has "
                    f"{torch.cuda.device_count()}")
            tmp = tempfile.mkdtemp(prefix="wca_world_")
            addr = Path(tmp, "rendezvous").as_uri()
            argv = sys.argv[1:] if argv is None else list(argv)
            env = dict(os.environ)
            if device.type == "cpu" and "OMP_NUM_THREADS" not in env:
                share = max(1, (os.cpu_count() or 1) // n)
                env["OMP_NUM_THREADS"] = str(share)
                torch.set_num_threads(min(threads, share))
            root = str(Path(__file__).resolve().parents[2])
            env["PYTHONPATH"] = os.pathsep.join(
                [root] + [p for p in [env.get("PYTHONPATH")] if p])
            procs = [subprocess.Popen(
                [sys.executable, "-m", module, *argv, "--multihost",
                 "--coordinator_address", addr, "--num_processes", str(n),
                 "--process_id", str(r)], env=env) for r in range(1, n)]
            # a rank that dies before the rendezvous fails the run in
            # minutes, not gloo's default half hour
            distributed.initialize(addr, n, 0, backend=_backend(device),
                                   timeout_s=600.0)
        yield device
        for r, p in enumerate(procs, start=1):
            if p.wait() != 0:
                raise RuntimeError(f"rank {r} of {module} exited with "
                                   f"{p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        distributed.shutdown()
        torch.set_num_threads(threads)
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def mesh_from_args(args, device: torch.device) -> Optional[Mesh]:
    """This rank's mesh of ``--data_parallel x --tensor_parallel`` ranks in
    the world :func:`process_world` joined (the world's other ranks are
    its replicas), or None in a world of one process."""
    if distributed.process_count() == 1:
        return None
    n_data, n_model = _mesh_counts(args)
    return make_mesh(n_data, n_model, device=device)


def replica_leader(mesh: Optional[Mesh]) -> bool:
    """Whether this rank writes its replica's outputs (its first rank)."""
    return mesh is None or (mesh.data_index == 0 and mesh.model_index == 0)


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
