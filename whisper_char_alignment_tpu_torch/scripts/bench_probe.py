"""Probe-oracle throughput bench (port of the repository's
``scripts/bench_probe.py``): the oracle-head sweep, which the reference
runs as 384 serial CPU DTWs an utterance.

    python -m whisper_char_alignment_tpu_torch.scripts.bench_probe
    WCA_PLATFORM=cpu WCA_PROBE_TINY=1 python -m whisper_char_alignment_tpu_torch.scripts.bench_probe

Drives the probe CLI's path (``cli/probe_oracle.infer_dataset``, its model
loader replaced by the built model): batched transcribe (mel + greedy
decode, pipelined to depth 2), one capture a batch, the per-head DTW of
every (utterance, head) pair in launches of at most 1024 rows, host
scoring. Whisper-medium shapes, random bf16 weights, synthetic utterances
of 18-22 words, ``--use_gt_transcript`` (the decode still runs and is
timed). The CLI's prints go to stderr. One warmup sweep captures the decode
graphs, then ``WCA_PROBE_PASSES`` timed sweeps, each ending in a
synchronize; the best is reported.

Prints ONE JSON line: ``metric`` ``probe_oracle_utts_per_sec_per_chip``,
``value``, ``unit``, ``hit_rate``, plus ``device``, ``launches`` (kernel
launches of the reported sweep) and ``graph_captures_timed``. Runs on
``cuda`` unless ``WCA_PLATFORM=cpu``; without a card it exits non-zero and
prints no line.

Knobs (env): WCA_PROBE_UTTS (24), WCA_PROBE_BATCH (8),
WCA_PROBE_DECODE_LEN (32), WCA_PROBE_PASSES (3), WCA_PROBE_TINY=1 (tiny
dims, CPU-friendly).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import tempfile
from typing import Optional

import torch

from ..bench import build_model, device_label, log, platform_device, timed
from ..cli import common, probe_oracle
from ..config import MODEL_DIMS, tiny_test_dims
from ..data.synthetic import make_timit_corpus
from ..text.tokenizer import get_test_tokenizer


@dataclasses.dataclass(frozen=True)
class Settings:
    tiny: bool = False
    n_utts: int = 24
    batch: int = 8
    decode_len: int = 32
    passes: int = 3

    @classmethod
    def from_env(cls) -> "Settings":
        env = os.environ.get
        tiny = env("WCA_PROBE_TINY") == "1"
        return cls(
            tiny=tiny,
            n_utts=int(env("WCA_PROBE_UTTS", "4" if tiny else "24")),
            batch=int(env("WCA_PROBE_BATCH", "2" if tiny else "8")),
            decode_len=int(env("WCA_PROBE_DECODE_LEN",
                               "8" if tiny else "32")),
            passes=max(1, int(env("WCA_PROBE_PASSES", "3"))))


@contextlib.contextmanager
def _probe_on(model, tokenizer, device: torch.device):
    """The probe CLI's loader returns ``model`` and its platform is
    ``device``'s while the block runs; both are restored after."""
    loader = common.load_model_and_tokenizer
    platform = os.environ.get("WCA_PLATFORM")
    common.load_model_and_tokenizer = lambda args, device=None: (model,
                                                                 tokenizer)
    os.environ["WCA_PLATFORM"] = "cpu" if device.type == "cpu" else "gpu"
    try:
        yield
    finally:
        common.load_model_and_tokenizer = loader
        if platform is None:
            os.environ.pop("WCA_PLATFORM", None)
        else:
            os.environ["WCA_PLATFORM"] = platform


def run(model, tokenizer, *, device=None,
        settings: Optional[Settings] = None) -> dict:
    """Probe with ``model`` (built in bf16 on ``device``) and return the one
    line's payload."""
    s = settings or Settings.from_env()
    device = torch.device(device or model.device)
    dims = model.dims
    with tempfile.TemporaryDirectory(prefix="wca_probe_corpus_") as root:
        # >= 18 words an utterance (the probe's eligibility filter)
        scp = make_timit_corpus(root, n_utts=s.n_utts,
                                seconds=(1.0, 2.0) if s.tiny else (3.0, 7.0),
                                words_per_utt=(18, 22), seed=0)
        argv = ["--dataset", "TIMIT", "--scp", scp,
                "--output_dir", os.path.join(root, "results"),
                "--aligned_unit_type", "char", "--strict", "--tolerance",
                "0.05", "--medfilt_width", "3",
                "--hit_within",
                str(min(10, dims.n_text_layer * dims.n_text_head)),
                "--batch_size", str(s.batch), "--use_gt_transcript",
                "--decode_sample_len", str(s.decode_len),
                "--compute_dtype", "bfloat16", "--profile"]
        args = probe_oracle.parse_args(argv)
        log(f"device {device_label(device)}; warmup sweep (captures the "
            "decode graphs)...")
        # the CLI prints its results to stdout, which carries only the one
        # JSON line
        with _probe_on(model, tokenizer, device), \
                contextlib.redirect_stdout(sys.stderr):
            with timed(device) as warm:
                probe_oracle.infer_dataset(args)
            log(f"warmup: {warm['wall_s']:.1f}s")
            best, captures = None, 0
            for _ in range(s.passes):
                with timed(device) as m:
                    results = probe_oracle.infer_dataset(args)
                captures += m["captures"]
                log(f"pass: {m['wall_s']:.2f}s")
                if best is None or m["wall_s"] < best["wall_s"]:
                    best = m
    throughput = s.n_utts / best["wall_s"]
    n_heads = dims.n_text_layer * dims.n_text_head
    log(f"{s.n_utts} utts x {n_heads} heads in {best['wall_s']:.2f}s -> "
        f"{throughput:.2f} utts/sec ({throughput * n_heads:.0f} "
        "head-DTWs/sec)")
    return {
        "metric": "probe_oracle_utts_per_sec_per_chip",
        "value": round(throughput, 3),
        "unit": "utts/sec",
        "hit_rate": results["hit_rate"],
        "n_utts": s.n_utts,
        "batch": s.batch,
        "passes": s.passes,
        "decode_len": s.decode_len,
        "best_pass_wall_s": round(best["wall_s"], 4),
        "device": device_label(device),
        "launches": best["launches"],
        "graph_captures_timed": captures,
    }


def main() -> None:
    s = Settings.from_env()
    device = platform_device()
    tok = get_test_tokenizer()
    dims = (tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=128,
                           n_text_ctx=160, state=32, head=4, layers=2)
            if s.tiny else MODEL_DIMS["medium"])
    log(f"device: {device_label(device)}")
    payload = run(build_model(dims, device), tok, device=device, settings=s)
    print(json.dumps(payload), flush=True)


if __name__ == "__main__":
    main()
