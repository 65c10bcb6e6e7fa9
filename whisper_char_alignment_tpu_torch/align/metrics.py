"""Boundary-matching evaluation metrics and head-scoring penalties.

Copy of ``whisper_char_alignment_tpu/align/metrics.py`` (NumPy only; the port
keeps its own copy rather than importing the JAX package). These run on the
host over tiny arrays (per-utterance boundary lists); the device twin of
``coverage_penalty`` used inside head scoring is ``align.timing``'s. The
matching algorithms and the R-value algebra are the evaluation contract and
stay numerically identical to the reference's metrics module (reference:
metrics.py).
"""

from __future__ import annotations

import string

import numpy as np


def dtw_timestamp(gt_ends, pred_ends):
    """Classic DTW distance between two boundary sequences
    (reference: metrics.py:5-20; unused by the CLIs but part of the public
    surface). Returns ``(distance, accumulated_cost_matrix)``."""
    pairwise = np.abs(np.subtract.outer(np.asarray(gt_ends, np.float64),
                                        np.asarray(pred_ends, np.float64)))
    n, m = pairwise.shape
    acc = np.full((n + 1, m + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(n):
        row_above, row = acc[i], acc[i + 1]
        for j in range(m):
            row[j + 1] = pairwise[i, j] + min(row_above[j + 1], row[j],
                                              row_above[j])
    return acc[n, m], acc


def eval_n1(y, yhat, tolerance=1):
    """Greedy two-pointer boundary matching (reference: metrics.py:22-43).

    Walks both sorted boundary lists once; a pair within ``tolerance`` matches
    and advances both pointers, otherwise the earlier boundary is dropped.
    Returns ``(n_match, n_match)`` — the duplicated return mirrors the
    reference signature (metrics.py:43); callers use only the first element.
    """
    if len(yhat) == 0:
        return 0, 0
    n_match = i = j = 0
    while i < len(y) and j < len(yhat):
        gap = y[i] - yhat[j]
        if abs(gap) <= tolerance:
            n_match += 1
            i += 1
            j += 1
        elif gap < 0:
            i += 1
        else:
            j += 1
    return n_match, n_match


def _normalize_words(ws):
    return [w.lower().strip(string.punctuation) for w in ws]


def eval_n1_strict(y, y_hat, words, words_hat, tolerance=1):
    """Word-identity-aware TP/FP/FN boundary matching
    (reference: metrics.py:45-72).

    Each prediction, in order, claims the first not-yet-claimed ground-truth
    boundary whose word matches (case/punctuation-insensitive) within
    ``tolerance`` seconds. Unclaimed predictions are false positives;
    unclaimed ground truths are false negatives.
    """
    gt_words = _normalize_words(words)
    pred_words = _normalize_words(words_hat)

    claimed = [False] * len(y)
    tp = 0
    for pred_word, pred_t in zip(pred_words, y_hat):
        for j, (gt_word, gt_t) in enumerate(zip(gt_words, y)):
            if claimed[j] or gt_word != pred_word:
                continue
            if abs(gt_t - pred_t) <= tolerance:
                claimed[j] = True
                tp += 1
                break

    fp = len(y_hat) - tp
    fn = len(y) - sum(claimed)
    return tp, fp, fn


def eval_n1_strict_many(y, y_hat_many, words, words_hat, tolerance=1):
    """Vectorized :func:`eval_n1_strict` over MANY prediction sets sharing one
    word list (the probe's per-head sweep: 384 candidate boundary sets per
    utterance, identical transcript). Returns (tp, fp, fn) int arrays of shape
    (n_sets,). Bit-equivalent to looping eval_n1_strict row by row (tested):
    the greedy claim scan runs over predictions in order, each claiming the
    FIRST unclaimed word-matching ground truth within tolerance — here as
    n_pred NumPy steps over (n_sets, n_gt) masks instead of
    n_sets * n_pred * n_gt Python iterations."""
    gt_words = _normalize_words(words)
    pred_words = _normalize_words(words_hat)
    yh = np.asarray(y_hat_many, np.float64)
    if yh.ndim == 1:
        yh = yh[None]
    n_sets = yh.shape[0]
    gt_t = np.asarray(y, np.float64)
    n_gt = len(gt_t)
    n_pred = min(len(pred_words), yh.shape[1])
    claimed = np.zeros((n_sets, n_gt), bool)
    tp = np.zeros((n_sets,), np.int64)
    # word-identity match is prediction-set-independent
    match = np.array([[gw == pw for gw in gt_words] for pw in pred_words],
                     bool) if n_gt else np.zeros((len(pred_words), 0), bool)
    for i in range(n_pred):
        if n_gt == 0:
            break
        ok = (~claimed & match[i][None, :]
              & (np.abs(gt_t[None, :] - yh[:, i:i + 1]) <= tolerance))
        any_ok = ok.any(axis=1)
        first = ok.argmax(axis=1)  # first eligible gt index per set
        claimed[np.arange(n_sets)[any_ok], first[any_ok]] = True
        tp += any_ok
    fp = yh.shape[1] - tp
    fn = n_gt - claimed.sum(axis=1)
    return tp, fp, fn


def get_seg_metrics(correct_predict, correct_retrieve, total_predict, total_gold):
    """Precision / recall / F1 / R-value (reference: metrics.py:74-86).

    The R-value (Räsänen et al. 2009) combines the distance of the
    (recall, over-segmentation) operating point from the ideal (1, 0) with its
    residual off the recall = over-segmentation + 1 diagonal; the expressions
    below keep the reference's exact operation order so accumulated rounding
    is identical.
    """
    EPS = 1e-7
    precision = correct_predict / (total_predict + EPS)
    recall = correct_retrieve / (total_gold + EPS)
    f1 = 2 * (precision * recall) / (precision + recall + EPS)

    over_seg = recall / (precision + EPS) - 1
    dist_to_ideal = np.sqrt((1 - recall) ** 2 + over_seg ** 2)
    diag_residual = (-over_seg + recall - 1) / (np.sqrt(2))
    r_value = 1 - (abs(dist_to_ideal) + abs(diag_residual)) / 2
    return precision, recall, f1, r_value, over_seg


def count_transitions(x):
    """Positions (and count) of value changes in a sequence
    (reference: metrics.py:88-97)."""
    positions = [i for i in range(1, len(x)) if x[i] != x[i - 1]]
    return len(positions), positions


def coverage_penalty(attn, threshold=0.5):
    """Penalize frames whose total attention mass exceeds ``threshold``
    (reference: metrics.py:99-111). ``attn``: (tokens, frames) array.

    Kept as sum-of-clamped-coverage minus the constant offset (NOT the
    algebraically-equal ``relu(coverage - threshold).sum()``) so the float
    rounding matches the device twin in ``align.timing`` bit-for-bit.
    """
    attn = np.asarray(attn)
    coverage = attn.sum(axis=0)
    clamped = np.maximum(coverage, threshold).sum(-1)
    return clamped - attn.shape[-1] * threshold


def entropy(prob, eps=1e-15):
    """Negated mean row entropy (reference: metrics.py:113-120)."""
    prob = np.asarray(prob, dtype=np.float64)
    prob = prob / prob.sum(axis=-1, keepdims=True)
    row_entropy = -(prob * np.log(prob + eps)).sum(axis=-1)
    return -row_entropy.mean()
