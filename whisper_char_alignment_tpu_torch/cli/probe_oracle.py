"""Oracle-head probe CLI (port of ``whisper_char_alignment_tpu/cli/probe_oracle.py:1-396``; reference: probe_oracle.py).

For each utterance with >= 18 ground-truth words: rank every (layer, head)
map by saliency, align with each of the top-360 saliency heads individually
(``ORACLE_TOPK``, the reference's ``filter_attention(w, topk=360)`` cut,
probe_oracle.py:83), keep the candidate with the best strict F1 against the
ground truth, and measure how often that oracle head falls within the top
``--hit_within`` saliency-ranked heads.

On the card: one teacher-forced capture per batch (the QK post-process
kernel in each decoder layer) and then every (utterance, head)
column-normalized map as a row of the DTW wavefront and backtrace kernels,
in launches of at most 1024 rows, with the frame axis cut to the batch's
longest frame_len rounded up to 256. Scoring is host NumPy. As in the JAX
package, ``pipeline_depth`` batches keep their transcribe in flight while a
batch's capture and per-head DTW are queued, and one such batch stays queued
while the host scores the one before it.

With several devices (``common.process_world``; JAX
``cli/probe_oracle.py:116-142``) each replica probes its round-robin shard
of the scp, each data index its rows of a batch; the counters are
all-reduced and rank 0 writes the JSON. ``hit_rate`` divides by the whole
corpus.

The per-head scoring loop in the reference crashes as committed (it scores
``best_ends_hat`` instead of the current head's boundaries and reads an
unassigned variable, SURVEY.md §2a); this implements the intended
semantics, as the JAX package does: score each head's own boundaries, keep
the best F1.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys

import numpy as np
import torch

from ..align import timing
from ..align.metrics import (eval_n1, eval_n1_strict, eval_n1_strict_many,
                             get_seg_metrics)
from ..constants import (AUDIO_SAMPLES_PER_TOKEN, MAX_FRAMES, MAX_LENGTH,
                         TOKENS_PER_SECOND)
from ..data.dataset import DATASETS
from ..models.decoding import DecodeFuture
from ..parallel import distributed
from ..parallel.mesh import pad_to_multiple
from ..runner import AlignmentPipeline, pack_fixed_batch
from ..text import retokenize
from . import common

# the reference restricts the oracle search to the top-360 saliency heads
# (``filter_attention(w, topk=360)``, probe_oracle.py:83): for medium (384
# heads) the 24 lowest-saliency heads are not oracle candidates even if one
# of them would score the best F1; smaller models have fewer than 360 heads
ORACLE_TOPK = 360
# (utterance, head) rows per DTW launch
ROWS_PER_LAUNCH = 1024
# the frame axis is cut to the batch's longest frame_len rounded up to this
FRAME_BUCKET = 256


def _per_head_jump_frames_chunk(attn, token_len, frame_len, sot_len: int):
    """attn (l, B, H, T, F) -> (B, l*H, N+1) jump frames: one launch each of
    the DTW wavefront and backtrace kernels over all B*l*H maps."""
    l, b, h, t, f = attn.shape
    maps = attn.permute(1, 0, 2, 3, 4).reshape(b * l * h, t, f)
    maps = timing._safe_col_normalize(maps.float())
    tl = token_len.repeat_interleave(l * h)
    fl = frame_len.repeat_interleave(l * h)
    jf = timing.matrix_to_jump_frames(maps, tl, fl, sot_len)
    return jf.reshape(b, l * h, jf.shape[-1])


def _per_head_jump_frames(attn, token_len, frame_len, sot_len: int,
                          frame_slice: int = 0):
    """attn (L, B, H, T, F) -> jump frames per head (B, L*H, N+1) (JAX
    ``cli/probe_oracle.py:59-112``): every utterance x head map,
    column-normalized ('mean' aggregation of one head), through the DTW
    kernels, in groups of layers of at most ``ROWS_PER_LAUNCH`` (utterance,
    head) rows (``WCA_PROBE_LAYER_CHUNK`` layers when set).

    ``frame_slice`` drops the frame axis to that width before the
    column-normalize and the DTW: frames >= frame_len are zero in the
    capture output, the normalizer treats columns independently and the DTW
    never reads past frame_len, so the sliced result equals the full-width
    one (tests/test_torch_cli.py holds them equal)."""
    if frame_slice and frame_slice < attn.shape[-1]:
        attn = attn[..., :frame_slice]
    l, b, h = attn.shape[:3]
    chunk = int(os.environ.get("WCA_PROBE_LAYER_CHUNK", "0"))
    if chunk <= 0:
        chunk = max(1, ROWS_PER_LAUNCH // max(b * h, 1))
    token_len = token_len.to(attn.device)
    frame_len = frame_len.to(attn.device)
    return torch.cat([
        _per_head_jump_frames_chunk(attn[lo:lo + chunk], token_len,
                                    frame_len, sot_len)
        for lo in range(0, l, chunk)], dim=1)


def infer_dataset(args) -> dict:
    device = common.apply_platform_env()
    model, tok = common.load_model_and_tokenizer(args, device)
    cfg = common.config_from_args(args)
    # the probe's capture never consumes the decode loop's cross K/V
    cfg.reuse_cross_kv = False
    mesh = common.mesh_from_args(args, device)
    pipe = AlignmentPipeline(
        model, tok, cfg, device=device,
        compute_dtype=common.compute_dtype(args),
        mesh=mesh if mesh is not None and mesh.size > 1 else None)
    dims = pipe.dims
    dataset = DATASETS[args.dataset](args.scp, n_mels=args.n_mels)
    # the reference's hit_rate denominator is the whole corpus: taken
    # before the replica's shard
    global_len = len(dataset)
    if mesh is not None:
        dataset.entries = distributed.shard_entries(
            dataset.entries, mesh.replica, mesh.n_replicas)
    timers = pipe.timers

    state = dict(corrects=0, total_preds=0, total_gts=0, if_include_best=0)
    sot_len = len(tok.sot_sequence)

    def dispatch_batch(tp):
        """Wait for one batch's transcripts, then queue its capture, the
        saliency of every head and the per-head DTW, and start their
        outputs' copies to the host (reference semantics,
        probe_oracle.py:59-122, with the committed scoring bug fixed)."""
        utts = tp["utts"]  # this rank's rows of the batch
        if not utts:
            return None
        if cfg.use_gt_transcript:
            transcripts = [u.text for u in utts]
        else:
            with timers.stage("transcripts sync", units=len(utts),
                              kind="wait"):
                results = tp["future"].result()
            transcripts = [r.text for r in results[:len(utts)]]

        prepared = []
        for u, raw in zip(utts, transcripts):
            transcription = retokenize.remove_punctuation(raw)
            if len(transcription) == 0:
                transcription = " "
            text_tokens = retokenize.encode(transcription, tok,
                                            args.aligned_unit_type)
            tokens = [*tok.sot_sequence, tok.no_timestamps, *text_tokens,
                      tok.eot]
            max_frames = u.duration // AUDIO_SAMPLES_PER_TOKEN
            if (max_frames > MAX_FRAMES
                    or len(tokens) > min(MAX_LENGTH, dims.n_text_ctx)):
                print(u.fid)
                continue
            prepared.append((u, text_tokens, tokens, int(max_frames)))
        if not prepared:
            return None

        # fixed shapes: the batch padded to the pipeline's batch size, the
        # tokens to its 32-token bucket (runner.pack_fixed_batch)
        b_pad = max(pipe.rows, len(prepared))
        t_max = max(len(p[2]) for p in prepared)
        t_bucket = min(dims.n_text_ctx,
                       pad_to_multiple(t_max, pipe.token_bucket))
        tokens_arr, token_len, frame_len, xa_idx = pack_fixed_batch(
            [(p[0], p[2], p[3]) for p in prepared], utts, b_pad, t_bucket,
            tok.eot, dims.n_audio_ctx)
        dev = pipe.device
        xa_live = tp["xa"][pipe._upload(xa_idx.astype(np.int64))]
        tl = pipe._upload(token_len)
        fl = pipe._upload(frame_len)
        with timers.stage("capture", units=len(prepared)):
            attn, _ = timing.get_attentions(
                pipe.model, None, pipe._upload(tokens_arr), tl, fl,
                medfilt_width=args.medfilt_width, qk_scale=1.0,
                return_logits=False, xa=xa_live, device=dev.type)
        # saliency of all heads (reference probe_oracle.py:83) and the DTW of
        # every (utterance, head), frame-sliced to the batch's bucketed
        # longest frame_len
        f_slice = min(dims.n_audio_ctx, pad_to_multiple(
            int(frame_len[:len(prepared)].max()), FRAME_BUCKET))
        with timers.stage("head dtw", units=len(prepared)):
            scores_dev = timing.head_scores(attn, fl)
            jf_dev = _per_head_jump_frames(attn, tl, fl, sot_len,
                                           frame_slice=f_slice)
        del attn
        return prepared, DecodeFuture((scores_dev, jf_dev), lambda *a: a)

    def collect_batch(cp):
        """Wait for one queued batch's outputs and score it on the host."""
        if cp is None:
            return
        prepared, outputs = cp
        with timers.stage("collect sync", units=len(prepared),
                          kind="wait"):
            scores_all, jf_all = outputs.result()
        with timers.stage("host scoring", units=len(prepared),
                          kind="host"):
            _score_batch(prepared, scores_all, jf_all)

    def _score_batch(prepared, scores_all, jf_all):
        for bi, (u, text_tokens, tokens, max_frames) in enumerate(prepared):
            scores_blh = scores_all[bi]
            n_layers, n_heads = scores_blh.shape
            words, word_tokens, wb = timing.words_and_boundaries(
                text_tokens, tok, args.aligned_unit_type)
            if wb is None:
                continue
            words_flat = " ".join(words[:-1]).split()

            # ascending saliency with the (l, h) tie-break: np.lexsort is
            # the vectorized twin of the reference's sorted((score, (l, h)))
            flat = scores_blh.reshape(-1).astype(np.float64)
            l_idx = np.repeat(np.arange(n_layers), n_heads)
            h_idx = np.tile(np.arange(n_heads), n_layers)
            order = np.lexsort((h_idx, l_idx, flat))
            # oracle candidates: only the top-ORACLE_TOPK saliency heads
            cand = order[-ORACLE_TOPK:]
            # every candidate head's end boundaries, then one vectorized
            # strict-F1 sweep
            jf = jf_all[bi][:, :len(text_tokens) + 1]
            jt = jf.astype(np.float64) / TOKENS_PER_SECOND
            ends_hat_all = jt[:, wb[1:]][cand]  # (n_cand, n_words)
            tp_v, _, _ = eval_n1_strict_many(
                u.ends, ends_hat_all, u.text.split(), words_flat,
                args.tolerance)
            # identical float ops to get_seg_metrics(tp, tp, n_pred, n_gt)
            eps = 1e-7
            prec = tp_v / (ends_hat_all.shape[1] + eps)
            rec = tp_v / (len(u.ends) + eps)
            f1_v = 2 * (prec * rec) / (prec + rec + eps)
            # the reference's loop keeps f1 >= best over ascending rank, so
            # the winner is the last occurrence of the max
            bi_best = len(f1_v) - 1 - int(np.argmax(f1_v[::-1]))
            best_ends_hat = ends_hat_all[bi_best]
            best_saliency = flat[cand][bi_best]

            # the reference's strict '>' against the hit_within-th highest
            # saliency overall, clamped to the head count
            if best_saliency > flat[order][max(-args.hit_within, -flat.size)]:
                state["if_include_best"] += 1

            if not args.strict:
                correct_pred, _ = eval_n1(u.ends, best_ends_hat,
                                          args.tolerance)
                state["total_gts"] += len(u.ends)
                state["total_preds"] += len(best_ends_hat)
                state["corrects"] += correct_pred
            else:
                tp_, fp_, fn_ = eval_n1_strict(u.ends, best_ends_hat,
                                               u.text.split(), words_flat,
                                               args.tolerance)
                state["corrects"] += tp_
                state["total_gts"] += tp_ + fn_
                state["total_preds"] += tp_ + fp_

    try:
        from tqdm import tqdm
        indices = tqdm(range(len(dataset)))
    except ImportError:
        indices = range(len(dataset))

    # the software pipeline of JAX cli/probe_oracle.py:313-340: up to
    # pipeline_depth batches' transcribe in flight while a batch's capture
    # and scoring run, and one captured batch queued while the one before
    # it is scored on the host
    depth = max(1, cfg.pipeline_depth)
    buf = []
    pending = collections.deque()
    captured = collections.deque()
    for i in indices:
        utt = dataset[i]
        if len(utt.text.split()) < 18:
            continue
        buf.append(utt)
        if len(buf) == cfg.batch_size:
            pending.append(pipe._dispatch_transcribe(buf))
            buf = []
            if len(pending) > depth:
                captured.append(dispatch_batch(pending.popleft()))
            while len(captured) > 1:
                collect_batch(captured.popleft())
    if buf:
        pending.append(pipe._dispatch_transcribe(buf))
    while pending:
        captured.append(dispatch_batch(pending.popleft()))
        while len(captured) > 1:
            collect_batch(captured.popleft())
    while captured:
        collect_batch(captured.popleft())

    counts = {k: state[k] for k in ("corrects", "total_preds", "total_gts",
                                    "if_include_best")}
    if mesh is not None:
        # a data index scores its own rows; the model axis repeats them
        counts = distributed.allreduce_counters(
            counts, contribute=mesh.model_index == 0)
    precision, recall, f1, r_value, _ = get_seg_metrics(
        counts["corrects"], counts["corrects"], counts["total_preds"],
        counts["total_gts"])
    # hit_rate divides by the full dataset size, including the utterances
    # skipped above: the reference's exact behavior (probe_oracle.py:129
    # divides by the loader length)
    results = dict(precision=precision, recall=recall, f1=f1, r_value=r_value,
                   hit_rate=counts["if_include_best"] / max(global_len, 1))
    if getattr(args, "profile", False):
        for stage, s in timers.summary().items():
            print(f"stage {stage:>22s}: {s['total_s']:.3f}s total, "
                  f"{s.get('units_per_s', 0.0):.1f} utts/s", file=sys.stderr)
    print(results)
    if distributed.process_index() == 0:
        common.dump_results(args, results)
    return results


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Arguments for whisper-based forced alignments")
    common.add_reference_flags(parser)
    parser.add_argument("--hit_within", type=int, default=10,
                        help="compute how often the oracle head is included in "
                             "the selected heads using the proposed approach.")
    common.add_tpu_flags(parser)
    common.add_pipeline_flags(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    print(args)
    with common.process_world(args, argv, f"{__package__}.probe_oracle"):
        return infer_dataset(args)


if __name__ == "__main__":
    main()
