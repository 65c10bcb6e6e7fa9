"""Typed configuration for models and the alignment pipeline.

Copy of ``whisper_char_alignment_tpu/config.py`` for the PyTorch port, which
imports nothing of the JAX package; only imports changed.

One config dataclass mirrors every CLI flag of the reference (infer_ali.py:151-173,
probe_oracle.py:141-160, eval_ali.py:56-61), preserving both default sets: the argparse
defaults and the README-recommended recipe (reference README.md:22-33).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence, Tuple

from . import constants


@dataclasses.dataclass(frozen=True)
class ModelDims:
    """Whisper model dimensions (reference: whisper ModelDimensions, used at
    timing.py:48 via ``model.dims.n_text_layer``)."""

    n_mels: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_vocab: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int

    @property
    def n_audio_head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head

    @property
    def n_text_head_dim(self) -> int:
        return self.n_text_state // self.n_text_head


def _dims(state: int, head: int, audio_layer: int, text_layer: int,
          n_vocab: int, n_mels: int = 80) -> ModelDims:
    return ModelDims(
        n_mels=n_mels,
        n_audio_ctx=constants.MAX_FRAMES,
        n_audio_state=state,
        n_audio_head=head,
        n_audio_layer=audio_layer,
        n_vocab=n_vocab,
        n_text_ctx=constants.MAX_LENGTH,
        n_text_state=state,
        n_text_head=head,
        n_text_layer=text_layer,
    )


_MULTI_VOCAB = 51865  # multilingual tokenizer vocab (incl. specials + timestamps)
_EN_VOCAB = 51864  # English-only tokenizer vocab
_V3_VOCAB = 51866  # large-v3 adds the <|yue|> language token

# Public Whisper size table (state, heads, audio layers, text layers).
MODEL_DIMS = {
    "tiny.en": _dims(384, 6, 4, 4, _EN_VOCAB),
    "tiny": _dims(384, 6, 4, 4, _MULTI_VOCAB),
    "base.en": _dims(512, 8, 6, 6, _EN_VOCAB),
    "base": _dims(512, 8, 6, 6, _MULTI_VOCAB),
    "small.en": _dims(768, 12, 12, 12, _EN_VOCAB),
    "small": _dims(768, 12, 12, 12, _MULTI_VOCAB),
    "medium.en": _dims(1024, 16, 24, 24, _EN_VOCAB),
    "medium": _dims(1024, 16, 24, 24, _MULTI_VOCAB),
    "large-v1": _dims(1280, 20, 32, 32, _MULTI_VOCAB),
    "large-v2": _dims(1280, 20, 32, 32, _MULTI_VOCAB),
    "large-v3": _dims(1280, 20, 32, 32, _V3_VOCAB, n_mels=128),
    "large": _dims(1280, 20, 32, 32, _V3_VOCAB, n_mels=128),
    "large-v3-turbo": _dims(1280, 20, 32, 4, _V3_VOCAB, n_mels=128),
    "turbo": _dims(1280, 20, 32, 4, _V3_VOCAB, n_mels=128),
}


def tiny_test_dims(n_vocab: int = 256, n_audio_ctx: int = 32, n_text_ctx: int = 24,
                   state: int = 16, head: int = 2, layers: int = 2,
                   n_mels: int = 80) -> ModelDims:
    """A miniature config for unit tests (random weights, fast CPU forwards)."""
    return ModelDims(
        n_mels=n_mels, n_audio_ctx=n_audio_ctx, n_audio_state=state,
        n_audio_head=head, n_audio_layer=layers, n_vocab=n_vocab,
        n_text_ctx=n_text_ctx, n_text_state=state, n_text_head=head,
        n_text_layer=layers,
    )


# Per-model hand-picked alignment-head table used only by the baseline
# ``default_find_alignment`` path (reference: timing.py:156 reads
# ``model.alignment_heads``). The (layer, head) lists below are public data: they
# are the decoded form of the base85-gzip ``_ALIGNMENT_HEADS`` blobs shipped in
# the openai-whisper package, as mirrored verbatim in the ``alignment_heads``
# field of the HF ``openai/whisper-*`` ``generation_config.json`` files (and in
# whisper.cpp / CTranslate2). Override or extend via ``set_alignment_heads`` /
# ``load_alignment_heads_json``.
_PUBLISHED_ALIGNMENT_HEADS = {
    "tiny.en": [(1, 0), (2, 0), (2, 5), (3, 0), (3, 1), (3, 2), (3, 3), (3, 4)],
    "tiny": [(2, 2), (3, 0), (3, 2), (3, 3), (3, 4), (3, 5)],
    "base.en": [(3, 3), (4, 7), (5, 1), (5, 5), (5, 7)],
    "base": [(3, 1), (4, 2), (4, 3), (4, 7), (5, 1), (5, 2), (5, 4), (5, 6)],
    "small.en": [(6, 6), (7, 0), (7, 3), (7, 8), (8, 2), (8, 5), (8, 7), (9, 0),
                 (9, 4), (9, 8), (9, 10), (10, 0), (10, 1), (10, 2), (10, 3),
                 (11, 3), (11, 4)],
    "small": [(5, 3), (5, 9), (8, 0), (8, 4), (8, 7), (8, 8), (9, 0), (9, 7),
              (9, 9), (10, 5)],
    "medium.en": [(11, 4), (14, 1), (14, 12), (14, 14), (15, 4), (16, 0),
                  (16, 4), (16, 9), (17, 12), (17, 14), (18, 7), (18, 10),
                  (18, 15), (20, 0), (20, 3), (20, 9), (20, 14), (21, 12)],
    "medium": [(13, 15), (15, 4), (15, 15), (16, 1), (20, 0), (23, 4)],
    "large-v1": [(9, 19), (11, 2), (11, 4), (11, 17), (22, 7), (22, 11),
                 (22, 17), (23, 2), (23, 15)],
    "large-v2": [(10, 12), (13, 17), (16, 11), (16, 12), (16, 13), (16, 15),
                 (16, 16), (18, 4), (18, 11), (18, 19), (19, 11), (21, 2),
                 (21, 3), (22, 3), (22, 9), (22, 12), (23, 5), (23, 7),
                 (23, 13), (25, 5), (26, 1), (26, 12), (27, 15)],
    "large-v3": [(7, 0), (10, 17), (12, 18), (13, 12), (16, 1), (17, 14),
                 (19, 11), (21, 4), (24, 1), (25, 6)],
    "large-v3-turbo": [(2, 4), (2, 11), (3, 3), (3, 6), (3, 11), (3, 14)],
}
_PUBLISHED_ALIGNMENT_HEADS["large"] = _PUBLISHED_ALIGNMENT_HEADS["large-v3"]
_PUBLISHED_ALIGNMENT_HEADS["turbo"] = _PUBLISHED_ALIGNMENT_HEADS["large-v3-turbo"]

_ALIGNMENT_HEADS_REGISTRY: dict = dict(_PUBLISHED_ALIGNMENT_HEADS)


def set_alignment_heads(model_name: str, heads: Sequence[Tuple[int, int]]) -> None:
    _ALIGNMENT_HEADS_REGISTRY[model_name] = [tuple(h) for h in heads]


def load_alignment_heads_json(path: str) -> None:
    """Load ``{model_name: [[layer, head], ...]}`` from a JSON file."""
    with open(path) as f:
        table = json.load(f)
    for name, heads in table.items():
        set_alignment_heads(name, heads)


def get_alignment_heads(model_name: str, dims: ModelDims):
    """Return [(layer, head), ...] for the baseline timing path.

    Known models get the published table above (reference-equivalent). Unknown
    model names fall back to all heads of the last half of the decoder layers
    (the same head population the 'mean' aggregation uses, ref timing.py:86-89),
    which keeps the baseline path functional."""
    if model_name in _ALIGNMENT_HEADS_REGISTRY:
        return list(_ALIGNMENT_HEADS_REGISTRY[model_name])
    half = dims.n_text_layer // 2
    return [(l, h) for l in range(half, dims.n_text_layer)
            for h in range(dims.n_text_head)]


@dataclasses.dataclass
class AlignConfig:
    """Every flag of the reference CLIs, with the reference argparse defaults
    (infer_ali.py:154-171)."""

    model: str = "medium"
    dataset: str = "TIMIT"  # {"TIMIT", "LibriSpeech"}
    scp: str = "scp/test.wav.scp"
    output_dir: str = "results"
    n_mels: int = 80
    medfilt_width: int = 7
    aggr: str = "mean"  # {"mean", "topk"}
    topk: int = 15
    aligned_unit_type: str = "subword"  # {"subword", "char"}
    tolerance: float = 0.02
    w_colnorm: float = 1.0
    w_rownorm: float = 1.0
    w_coverage: float = 0.0
    plot: bool = False
    strict: bool = False
    save_prediction: bool = False
    default_whisper_timing: bool = False
    qk_scale: float = 1.0  # hard-wired in the reference (infer_ali.py:45)
    # probe_oracle extras (probe_oracle.py:151-152)
    hit_within: int = 10
    # TPU-pipeline extras (no reference analog): batching / sharding
    batch_size: int = 8
    checkpoint: Optional[str] = None  # path to .pt/.safetensors/.npz weights
    tokenizer_dir: Optional[str] = None  # dir with vocab/merges assets
    data_parallel: int = 1  # devices on the batch mesh axis
    # devices on the 'model' mesh axis (tensor parallelism: q/k/v + fc1 weight
    # columns and out/fc2 rows sharded; 0/1 = off). The lever for models whose
    # per-chip HBM budget gates cross-K/V reuse off (large-v3 — DESIGN.md);
    # parity-exact vs single-device (tests/test_multichip.py)
    tensor_parallel: int = 0
    # opt-in decode speedup: bucket cross-attention K/V to the batch's true
    # frame count rounded up to this multiple (0 = attend over the full padded
    # 30 s window, exactly like the reference)
    decode_frame_bucket: int = 0
    # opt-in decode speedup: int8-quantized cross-attention K/V (halves the
    # decode loop's HBM stream; small transcript-accuracy risk)
    decode_kv_int8: bool = False
    # guarded variant (VERDICT r03 #4): decode with int8 K/V while tracking
    # each sampled step's top1-top2 filtered-logit margin; utterances whose
    # minimum margin falls below the calibrated guard re-decode exactly
    # (encoder skipped via the saved states) — most of the int8 decode win
    # with transcript parity (oracle-tested in tests/test_kv_int8.py)
    decode_kv_int8_guarded: bool = False
    # guarded variant of decode_frame_bucket: bucketed decode with the same
    # margin guard — utterances whose minimum sampled-step top1-top2 logit
    # margin falls below the calibrated bound (WCA_BUCKET_GUARD_MARGIN)
    # re-decode over the full padded 30 s window, reusing their encoder
    # states. Requires decode_frame_bucket > 0 (the bucket multiple).
    decode_frame_bucket_guarded: bool = False
    # opt-in encoder speedup: per-channel int8 encoder projections/MLP on the
    # int8 MXU path (2x matmul throughput; NOT parity-true — perturbs the
    # encoder states at the ~1% quantization level)
    encoder_int8: bool = False
    # reuse the decode loop's per-layer cross K/V in the teacher-forced capture
    # pass (skips 2 x n_layers K/V projections over the 1500 encoder frames,
    # ~4.8 TFLOP at medium B=32). Same math in the same dtype, parity-preserving;
    # automatically disabled when decode_frame_bucket/decode_kv_int8 change the
    # stored K/V, or when a batch's skip-guards reorder the live rows.
    reuse_cross_kv: bool = True
    # opt-in: iterate the scp sorted by WAV size (a duration proxy) so batches
    # are length-homogeneous — the decode loop runs until a batch's LONGEST
    # transcript finishes, so mixed-length batches make short utterances pay
    # the longest one's steps. Changes output order, not per-utterance results.
    sort_by_duration: bool = False
    # software-pipeline depth of run_dataset: how many batches may have their
    # decode in flight before the oldest one's transcripts are synced. Depth 2
    # lets the decode-future sync overlap the NEXT batch's audio upload + mel
    # dispatch (the JAX package's round-2 bench lost ~2.1 s of a 3.9 s wall
    # to that sync at depth 1). Costs one extra in-flight (mel, xa) pair per
    # unit of depth; the cross-K/V reuse gate accounts for it.
    pipeline_depth: int = 2
    # cap on sampled decode steps per utterance (0 = the published default,
    # n_text_ctx // 2 = 224). Real checkpoints stop at eot long before the
    # cap; random-weight benches set a small cap so the decode stage measures
    # realistic step counts.
    decode_sample_len: int = 0
    # isolation mode (SURVEY.md §7 step 4): align the ground-truth transcript
    # instead of the decoded one, decoupling alignment quality from transcript
    # parity (also what bench.py uses so random-weight garbage transcripts
    # don't degenerate the alignment workload)
    use_gt_transcript: bool = False

    @classmethod
    def recommended(cls, **overrides) -> "AlignConfig":
        """README-recommended recipe (reference README.md:22-33): char units,
        topk=10 aggregation, medfilt 3, strict eval at 50 ms."""
        base = dict(aggr="topk", topk=10, aligned_unit_type="char",
                    medfilt_width=3, tolerance=0.05, strict=True)
        base.update(overrides)
        return cls(**base)
