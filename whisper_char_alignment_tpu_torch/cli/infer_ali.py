"""Batch alignment CLI (port of ``whisper_char_alignment_tpu/cli/infer_ali.py:26-166``).

Flag-compatible with the reference's infer_ali.py (reference: infer_ali.py:
31-182): aligns a corpus with ``runner.AlignmentPipeline`` on the card (or,
with ``WCA_PLATFORM=cpu``, on the CPU), scores the boundaries, prints and
dumps the metrics JSON (the args merged with the metrics) and, with
``--save_prediction``, the predictions pkl beside it.

Example (README-recommended recipe):
    python -m whisper_char_alignment_tpu_torch.cli.infer_ali --dataset TIMIT \\
        --scp /path/to/scp --model medium --aggr topk --topk 10 \\
        --aligned_unit_type char --strict --output_dir results \\
        --tolerance 0.05 --medfilt_width 3

The predictions pkl is written with the standard library's ``pickle``, not
``joblib``: ``joblib.load`` reads a plain pickle, so the reference's and the
JAX package's ``eval_ali`` read it as they read their own.

With several devices (``common.process_world``; JAX ``cli/infer_ali.py:26-60,
106-130``): each replica aligns its round-robin shard of the scp, the
counters are all-reduced, one output stem is broadcast from rank 0, rank 0
writes the metrics JSON and, with ``--multihost``, each replica's first rank
its shard's ``-pN`` predictions pkl.

``--profile`` prints the pipeline's stage and span profiles
(``utils/profiling.StageTimers.report``: each span's kind, ``issue``,
``wait`` or ``host``, its host and self seconds and counters);
``--trace_dir`` writes a trace whose ``wca.<span>`` ranges name the spans
and prints the card's idle seconds by span (``utils/profiling.trace_busy``).
"""

from __future__ import annotations

import argparse
import pickle
import time
from collections import defaultdict

from ..align.metrics import eval_n1, eval_n1_strict, get_seg_metrics
from ..data.dataset import DATASETS
from ..parallel import distributed
from ..runner import AlignmentPipeline
from ..utils.profiling import device_trace
from . import common


def infer_dataset(args) -> dict:
    device = common.apply_platform_env()
    model, tok = common.load_model_and_tokenizer(args, device)
    cfg = common.config_from_args(args)
    mesh = common.mesh_from_args(args, device)
    pipe = AlignmentPipeline(
        model, tok, cfg, device=device,
        compute_dtype=common.compute_dtype(args),
        mesh=mesh if mesh is not None and mesh.size > 1 else None)

    ds_kwargs = {}
    if getattr(args, "alignment_file", None):
        # LibriSpeech Kaldi word alignments at an explicit path (the default
        # discovers ls_alignment_{split}.txt from the corpus layout)
        ds_kwargs["alignment_file"] = args.alignment_file
    dataset = DATASETS[args.dataset](args.scp, n_mels=args.n_mels, **ds_kwargs)
    if mesh is not None:
        dataset.entries = distributed.shard_entries(
            dataset.entries, mesh.replica, mesh.n_replicas)

    leader = common.replica_leader(mesh)
    corrects = 0
    total_preds = 0
    total_gts = 0
    all_predictions = defaultdict(int)
    n = 0
    # a with-block: an exception in an utterance still writes the trace
    with device_trace(getattr(args, "trace_dir", None)):
        for res in pipe.run_dataset(dataset):
            if res.skipped:
                print(res.fid)
                continue
            ends_hat = res.end_times
            if args.save_prediction:
                all_predictions[n] = dict(
                    starts=res.starts, ends=res.ends, texts=res.text.split(),
                    starts_hat=res.start_times, ends_hat=ends_hat,
                    predwords=res.words, fids=res.fid)
            if args.plot and res.matrix is not None and leader:
                from ..text.retokenize import encode as tok_encode
                from ..viz.plot import plot_attn

                text_tokens = tok_encode(res.transcription, tok,
                                         args.aligned_unit_type)
                plot_attn(res.matrix, text_tokens, tok, gt_alignment=res.ends,
                          pred_alignment=ends_hat, fid=res.fid,
                          aligned_unit_type=args.aligned_unit_type,
                          path=f"{args.output_dir}/imgs/{args.dataset}")
            # eval (reference infer_ali.py:121-132)
            if not args.strict:
                correct_pred, _ = eval_n1(res.ends, ends_hat, args.tolerance)
                total_gts += len(res.ends)
                total_preds += len(ends_hat)
                corrects += correct_pred
            else:
                words = " ".join(res.words[:-1]).split()
                tp, fp, fn = eval_n1_strict(res.ends, ends_hat,
                                            res.text.split(), words,
                                            args.tolerance)
                corrects += tp
                total_gts += tp + fn
                total_preds += tp + fp
            n += 1

    if getattr(args, "profile", False):
        pipe.timers.report()

    if mesh is not None:
        # every rank of a replica holds its results: its first rank counts
        summed = distributed.allreduce_counters(
            dict(corrects=corrects, total_preds=total_preds,
                 total_gts=total_gts), contribute=leader)
        corrects = summed["corrects"]
        total_preds = summed["total_preds"]
        total_gts = summed["total_gts"]

    precision, recall, f1, r_value, _ = get_seg_metrics(
        corrects, corrects, total_preds, total_gts)
    results = dict(precision=precision, recall=recall, f1=f1, r_value=r_value)
    print(results)
    # one stem for the metrics JSON and every replica's predictions
    stem = common.results_basename(
        args, ts=distributed.broadcast_scalar(time.time()))
    if distributed.process_index() == 0:
        common.dump_results(args, results, stem=stem)
    if args.save_prediction and leader:
        suffix = (f"-p{0 if mesh is None else mesh.replica}"
                  if args.multihost else "")
        with open(f"{stem}-predictions{suffix}.pkl", "wb") as f:
            pickle.dump(all_predictions, f)
    return results


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Arguments for whisper-based forced alignments")
    common.add_reference_flags(parser)
    parser.add_argument("--w_colnorm", type=float, default=1.0)
    parser.add_argument("--w_rownorm", type=float, default=1.0)
    parser.add_argument("--w_coverage", type=float, default=0.0)
    parser.add_argument("--save_prediction", action="store_true")
    parser.add_argument("--default_whisper_timing", action="store_true")
    parser.add_argument("--alignment_file", type=str, default=None,
                        help="explicit Kaldi word-alignment file for "
                             "--dataset LibriSpeech (default: discovered "
                             "from the corpus layout)")
    common.add_tpu_flags(parser)
    common.add_pipeline_flags(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    print(args)
    with common.process_world(args, argv, f"{__package__}.infer_ali"):
        return infer_dataset(args)


if __name__ == "__main__":
    main()
