"""Re-score saved predictions at a new tolerance, without re-running the model.

Copy of ``whisper_char_alignment_tpu/cli/eval_ali.py:1-111`` (pure Python and
NumPy), reading the pkl with the standard library's ``pickle``. Behavioral
contract with the reference CLI (reference: eval_ali.py): reads the
``*-predictions.pkl`` record schema (``fids``/``ends``/``texts``/``ends_hat``/
``predwords``), normalizes file ids by stripping the ``eval_`` prefix and
upper-casing, normalizes words with ``remove_punctuation``, scores strict
word-matched boundary TP/FP/FN per utterance, and prints P/R/F1/R-value at two
decimals. The implementation is records-based rather than the reference's pair
of parallel dicts.

A pkl in joblib's own format (numpy arrays written as joblib wrappers, or
compressed), as the JAX package's ``infer_ali`` writes, is read with
``joblib`` when it is installed; without it such a file raises, naming the
package. The port's own ``infer_ali`` writes plain pickles.
"""

from __future__ import annotations

import argparse
import dataclasses
import pickle
from typing import Dict, Iterable

from ..align.metrics import eval_n1_strict, get_seg_metrics
from ..text.retokenize import remove_punctuation


@dataclasses.dataclass
class UttRecord:
    """One utterance's ground truth + prediction, words already normalized."""

    fid: str
    gt_ends: list
    gt_words: list
    pred_ends: list
    pred_words: list


class _JoblibFormat(Exception):
    """The pickle stream names one of joblib's own classes."""


class _PlainUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == "joblib":
            raise _JoblibFormat(f"{module}.{name}")
        return super().find_class(module, name)


def load_predictions(pkl_path: str):
    """The predictions object of a pkl: a plain pickle, or, through
    ``joblib``, a file in joblib's own format."""
    try:
        with open(pkl_path, "rb") as f:
            return _PlainUnpickler(f).load()
    except (_JoblibFormat, pickle.UnpicklingError):
        pass
    try:
        import joblib
    except ImportError as e:
        raise RuntimeError(
            f"{pkl_path} is in joblib's own format: reading it needs the "
            "joblib package, which is not installed") from e
    return joblib.load(pkl_path)


def _normalize_fid(raw: str) -> str:
    """TIMIT fid normalization (reference eval_ali.py:16): the pkl may carry
    ``eval_``-prefixed lowercase ids while GT labels use upper-case."""
    return raw.replace("eval_", "").upper()


def read_prediction_records(pkl_path: str) -> Dict[str, UttRecord]:
    """Load a predictions pkl into normalized records, keyed by fid.

    Empty records (skipped utterances) are dropped; a repeated fid keeps the
    last occurrence, matching the reference's dict rebuild."""

    def clean(words):
        return [remove_punctuation(w) for w in words]

    data = load_predictions(pkl_path)
    # the pkl may be a list or a dict keyed 0..n-1 (both index as data[i])
    rows = ([data[i] for i in range(len(data))] if isinstance(data, dict)
            else list(data))

    records: Dict[str, UttRecord] = {}
    for rec in rows:
        if not rec:
            continue
        fid = _normalize_fid(rec["fids"])
        records[fid] = UttRecord(
            fid=fid,
            gt_ends=rec["ends"], gt_words=clean(rec["texts"]),
            pred_ends=rec["ends_hat"], pred_words=clean(rec["predwords"]),
        )
    return records


def score_records(records: Iterable[UttRecord], tolerance: float) -> dict:
    """Corpus-level strict scoring: per-utterance TP/FP/FN summed into the
    P/R/F1/R-value aggregate."""
    matched = n_pred = n_gt = 0
    for utt in records:
        tp, fp, fn = eval_n1_strict(utt.gt_ends, utt.pred_ends, utt.gt_words,
                                    utt.pred_words, tolerance=tolerance)
        matched += tp
        n_pred += tp + fp
        n_gt += tp + fn
    precision, recall, f1, r_value, _ = get_seg_metrics(
        matched, matched, n_pred, n_gt)
    return dict(precision=precision, recall=recall, f1=f1, r_value=r_value)


def _print_report(metrics: dict) -> None:
    rule = "-" * 17
    print(rule)
    for label, key in (("precision", "precision"), ("recall", "recall"),
                       ("f1", "f1"), ("r value", "r_value")):
        print(f"{label}: {metrics[key]:.2f}")
    print(rule)


def run_eval(args) -> dict:
    records = read_prediction_records(args.pred)
    metrics = score_records(records.values(), args.tolerance)
    _print_report(metrics)
    return metrics


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="eval alignment")
    parser.add_argument("--pred", type=str, required=True,
                        help="path to a *-predictions.pkl")
    parser.add_argument("--tolerance", type=float, default=0.05)
    return parser.parse_args(argv)


def main(argv=None):
    return run_eval(parse_args(argv))


if __name__ == "__main__":
    main()
