"""Alignment core: attention capture, head scoring/selection, aggregation, DTW.

Port of ``whisper_char_alignment_tpu/align/timing.py``. The teacher-forced
forward post-processes each layer's QK inside the layer loop (median filter
-> softmax, through the QK post-process kernel), head scoring and top-k
selection are batched reductions and a stable sort (keeping the reference's
ascending-sort tie-break), aggregation is a masked mean of column-normalized
maps, and the DTW runs through the wavefront and backtrace kernels. Only the
final word bookkeeping is host NumPy.

Fixed shapes: tokens are padded to a bucket, frames to the model window;
per-item ``token_len``/``frame_len`` masks make the padded computation equal
the reference's physical slicing.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import constants
from ..models import whisper as wmodel
from ..ops.dtw_cuda import dtw_jump_frames


def get_attentions(model, mel: Optional[torch.Tensor], tokens: torch.Tensor,
                   token_len: torch.Tensor, frame_len: torch.Tensor,
                   medfilt_width: int = 7, qk_scale: float = 1.0,
                   return_logits: bool = True,
                   xa: Optional[torch.Tensor] = None, cross_kv=None,
                   device=None):
    """Teacher-forced forward returning processed cross-attention maps.

    mel (B, n_mels, 2*n_audio_ctx); tokens (B, T) padded with eot; token_len
    (B,) true token counts; frame_len (B,) true encoder frames. Returns
    (attn (L, B, H, T, F) post-softmax/masked f32, logits (B, T, vocab) or
    None). Pass ``xa`` (and ``cross_kv``) to reuse the transcription pass's
    encoder states (and cross K/V); ``mel`` is then ignored."""
    if xa is None and cross_kv is None:
        xa = wmodel.encode_audio(model, mel, device=device)
    logits, attn = wmodel.decode_text(
        model, tokens, xa, return_qk=True, medfilt_width=medfilt_width,
        frame_len=frame_len, token_len=token_len, qk_scale=qk_scale,
        return_logits=return_logits, cross_kv=cross_kv, device=device)
    return attn, logits


# ---------------------------------------------------------------------------
# Head scoring + selection (reference: filter_attention, timing.py:13-43)
# ---------------------------------------------------------------------------

def _coverage_penalty(attn, frame_ok, threshold=0.5):
    """attn (..., T, F); frame_ok (..., F) bool: padded frames contribute
    nothing and the baseline subtracts only the true frame count."""
    coverage = attn.sum(dim=-2)  # (..., F)
    per_frame = torch.where(frame_ok, coverage.clamp(min=threshold),
                            torch.zeros((), device=attn.device))
    n_frames = frame_ok.sum(dim=-1).to(attn.dtype)
    return per_frame.sum(dim=-1) - n_frames * threshold


def head_scores(attn: torch.Tensor, frame_len: torch.Tensor, w_colnorm=1.0,
                w_rownorm=1.0, w_coverage=0.0) -> torch.Tensor:
    """Saliency score for every (layer, head): sum of column L2 norms + sum
    of row L2 norms - coverage penalty. attn (L, B, H, T, F) has padded rows
    and frames zeroed. Returns (B, L, H) f32."""
    a = attn.float()
    score = torch.zeros(a.shape[:3], device=a.device)
    if w_colnorm > 0:
        col = (a * a).sum(dim=-2).sqrt()  # (L, B, H, F)
        score = score + w_colnorm * col.sum(dim=-1)
    if w_rownorm > 0:
        row = (a * a).sum(dim=-1).sqrt()  # (L, B, H, T)
        score = score + w_rownorm * row.sum(dim=-1)
    if w_coverage > 0:
        f = attn.shape[-1]
        frame_ok = (torch.arange(f, device=a.device)[None, :]
                    < frame_len.to(a.device)[:, None])[None, :, None, :]
        score = score - w_coverage * _coverage_penalty(a, frame_ok)
    return score.permute(1, 0, 2)


def topk_heads(scores_blh: torch.Tensor, topk: int):
    """The top-k (layer, head) pairs per item with the reference's
    ``sorted(scores)[-topk:]`` semantics: ascending score, ties broken by
    (layer, head), returned in ascending order. A stable ascending sort over
    the flat l*H + h order gives exactly that. Returns (layer_idx (B, k),
    head_idx (B, k))."""
    b, l, h = scores_blh.shape
    order = torch.sort(scores_blh.reshape(b, l * h), dim=-1,
                       stable=True).indices[:, -topk:]
    return order // h, order % h


# ---------------------------------------------------------------------------
# Aggregation + DTW (reference: force_align, timing.py:69-114)
# ---------------------------------------------------------------------------

def _safe_col_normalize(m: torch.Tensor) -> torch.Tensor:
    """Divide by the per-frame column L2 norm over tokens; zero columns stay
    zero instead of NaN."""
    norm = (m * m).sum(dim=-2, keepdim=True).sqrt()
    return m / torch.where(norm == 0, torch.ones((), device=m.device), norm)


def aggregate_matrix(attn: torch.Tensor, aggregation: str, topk: int,
                     frame_len: torch.Tensor, w_colnorm=1.0, w_rownorm=1.0,
                     w_coverage=0.0):
    """Aggregate (L, B, H, T, F) maps into one (B, T, F) matrix.

    'mean': column-normalize every map of the last half of the layers and
    average over layers and heads. 'topk': score all heads, keep the k best,
    column-normalize, average. 'grad_norm': ``attn`` is an already-aggregated
    (B, T, F) matrix. Returns (matrix, (scores, l_sel, h_sel) or None)."""
    a = attn.float()
    if aggregation == "mean":
        n_layers = a.shape[0]
        return _safe_col_normalize(a[n_layers // 2:]).mean(dim=(0, 2)), None
    if aggregation == "grad_norm":
        return a, None
    if aggregation == "topk":
        if topk <= 0:
            raise ValueError(f"topk aggregation needs topk > 0, got {topk}")
        scores = head_scores(a, frame_len, w_colnorm, w_rownorm, w_coverage)
        l_sel, h_sel = topk_heads(scores, topk)  # (B, k) each
        items = torch.arange(a.shape[1], device=a.device)[:, None]
        sel = a[l_sel, items, h_sel]  # (B, k, T, F)
        return _safe_col_normalize(sel).mean(dim=1), (scores, l_sel, h_sel)
    raise ValueError(f"unknown aggregation: {aggregation}")


def matrix_to_jump_frames(matrix: torch.Tensor, token_len: torch.Tensor,
                          frame_len: torch.Tensor, sot_len: int) -> torch.Tensor:
    """Slice the text rows and run DTW -> first-visit frame per text row.

    matrix (B, T, F); rows used are [sot_len : token_len-1] (the reference's
    ``matrix[len(sot_sequence):-1]``). Costs are ``-matrix`` in f32. Returns
    (B, T - sot_len + 1) int32 jump frames (padded rows -1)."""
    dev = matrix.device
    costs = (-matrix[:, sot_len:, :].float()).contiguous()
    n_rows = (token_len.to(dev) - sot_len - 1).to(torch.int32)
    return dtw_jump_frames(costs, n_rows, frame_len.to(dev).to(torch.int32))


def force_align_batch(attn: torch.Tensor, token_len: torch.Tensor,
                      frame_len: torch.Tensor, sot_len: int,
                      aggregation: str = "mean", topk: int = -1,
                      w_colnorm=1.0, w_rownorm=1.0, w_coverage=0.0):
    """Aggregation + DTW over a batch. Returns (jump_frames (B, N+1), matrix
    (B, T, F), scores-or-None)."""
    matrix, scores = aggregate_matrix(attn, aggregation, topk, frame_len,
                                      w_colnorm, w_rownorm, w_coverage)
    jump_frames = matrix_to_jump_frames(matrix, token_len, frame_len, sot_len)
    return jump_frames, matrix, scores


# ---------------------------------------------------------------------------
# Host-side word bookkeeping + single-utterance convenience API
# ---------------------------------------------------------------------------

def words_and_boundaries(text_tokens, tokenizer, aligned_unit_type: str):
    """words, word_tokens, word_boundaries for force_align's output mapping
    (reference timing.py:105-108)."""
    from ..text.retokenize import split_tokens_on_spaces

    words, word_tokens = split_tokens_on_spaces(
        list(text_tokens) + [tokenizer.eot], tokenizer, aligned_unit_type)
    if len(word_tokens) <= 1:
        return words, word_tokens, None
    word_boundaries = np.pad(np.cumsum([len(t) for t in word_tokens[:-1]]),
                             (1, 0))
    return words, word_tokens, word_boundaries


def jump_frames_to_times(jump_frames: np.ndarray, word_boundaries: np.ndarray):
    """start/end times in seconds from per-row first-visit frames
    (reference timing.py:110-113)."""
    jump_times = (np.asarray(jump_frames, dtype=np.float64)
                  / constants.TOKENS_PER_SECOND)
    return jump_times[word_boundaries[:-1]], jump_times[word_boundaries[1:]]


def force_align(ws, text_tokens, tokenizer, aligned_unit_type="subword",
                aggregation="mean", topk=-1, w_colnorm=1.0, w_rownorm=1.0,
                w_coverage=0.0, frame_len: Optional[int] = None):
    """Single-utterance convenience mirroring the reference signature/return
    (timing.py:69-114): ``ws`` (layers, heads, tokens, frames) processed
    attention for ONE utterance (sot rows included). It runs where ``ws``
    lies. Returns (words, start_times, end_times, matrix, scores).

    ``aggregation='grad_norm'`` takes ``ws`` as an already-aggregated (T, F)
    matrix."""
    ws = torch.as_tensor(ws)
    dev = ws.device
    if aggregation == "grad_norm":
        if ws.ndim != 2:
            raise ValueError("grad_norm expects an aggregated (T, F) matrix")
        t, f = ws.shape
        attn = ws[None]
    else:
        _, _, t, f = ws.shape
        attn = ws[:, None]
    if frame_len is None:
        frame_len = f
    sot_len = len(tokenizer.sot_sequence)
    token_len = torch.tensor([t], dtype=torch.int32, device=dev)
    frame_len_t = torch.tensor([frame_len], dtype=torch.int32, device=dev)

    words, _, word_boundaries = words_and_boundaries(
        text_tokens, tokenizer, aligned_unit_type)
    if word_boundaries is None:
        return [[], [], [], [], None]

    jump_frames, matrix, scores = force_align_batch(
        attn, token_len, frame_len_t, sot_len, aggregation, topk, w_colnorm,
        w_rownorm, w_coverage)
    n_rows = t - sot_len - 1
    jf = jump_frames[0, :n_rows].cpu().numpy()
    start_times, end_times = jump_frames_to_times(jf, word_boundaries)
    matrix_np = matrix[0, sot_len:t - 1, :frame_len].cpu().numpy()
    scores_list = None
    if scores is not None:
        s, l_sel, h_sel = (x[0].cpu().numpy() for x in scores)
        scores_list = [
            (float(s[li, hi]), (int(li), int(hi)), f"sample_layer{li}_head{hi}")
            for li, hi in zip(l_sel, h_sel)]
    return words, start_times, end_times, matrix_np, scores_list


def filter_attention(attns, topk=20, w_colnorm=1, w_rownorm=1, w_coverage=0):
    """Reference-compatible head filter for one utterance (JAX
    ``align/timing.py:351-367``, reference timing.py:13-43): attns (layers,
    heads, tokens, frames) -> (selected maps list, scores list ascending)."""
    a = torch.as_tensor(attns)[:, None]  # (L, 1, H, T, F)
    f = a.shape[-1]
    frame_len = torch.tensor([f], dtype=torch.int32, device=a.device)
    scores = head_scores(a, frame_len, w_colnorm, w_rownorm,
                         w_coverage)[0].cpu().numpy()
    entries = []
    for l in range(scores.shape[0]):
        for h in range(scores.shape[1]):
            entries.append((float(scores[l, h]), (l, h),
                            f"sample_layer{l}_head{h}"))
    scores_sorted = sorted(entries)[-topk:]
    attns_np = a[:, 0].cpu().numpy()
    selected = [attns_np[l, h][None] for _, (l, h), _ in scores_sorted]
    return selected, scores_sorted


# ---------------------------------------------------------------------------
# Baseline path (reference: default_find_alignment, timing.py:116-186)
# ---------------------------------------------------------------------------

def _znorm_mean_heads(sel_attn: torch.Tensor,
                      token_len: torch.Tensor) -> torch.Tensor:
    """Z-normalize each selected head's map over the token axis (masked,
    biased std, no epsilon: reference timing.py:160-161), then average the
    heads. sel_attn (B, n_sel, T, F) f32 -> (B, T, F). The same divisions as
    JAX ``align/timing.py:374-388``, so a column whose valid rows are all
    equal gives 0/0 there as here."""
    t = sel_attn.shape[-2]
    token_len = token_len.to(sel_attn.device)
    token_ok = (torch.arange(t, device=sel_attn.device)[None, None, :, None]
                < token_len[:, None, None, None])  # (B, 1, T, 1)
    n = token_len.float()[:, None, None, None]
    zero = torch.zeros((), device=sel_attn.device)
    s = torch.where(token_ok, sel_attn, zero)
    mean = s.sum(dim=-2, keepdim=True) / n
    var = torch.where(token_ok, (sel_attn - mean) ** 2,
                      zero).sum(dim=-2, keepdim=True) / n
    z = (sel_attn - mean) / torch.sqrt(var + 0.0)
    z = torch.where(token_ok, z, zero)
    return z.mean(dim=1)


def default_find_alignment_batch(model, mel, tokens: torch.Tensor,
                                 token_len: torch.Tensor,
                                 frame_len: torch.Tensor, alignment_heads,
                                 eot: int, medfilt_width=7, qk_scale=1.0,
                                 sot_len=3, xa=None, cross_kv=None,
                                 device=None):
    """Whisper's built-in timing path, batched (JAX ``align/timing.py:
    391-423``, reference timing.py:116-186): the capture of
    :func:`get_attentions` (QK post-process kernel per layer), only the
    hand-picked alignment heads, z-normalized per token and averaged, then
    the DTW kernels; also the per-token text probabilities from the
    teacher-forced logits.

    Returns (jump_frames (B, N+1), text_token_probs (B, T - sot_len), matrix
    (B, T, F))."""
    attn, logits = get_attentions(model, mel, tokens, token_len, frame_len,
                                  medfilt_width=medfilt_width,
                                  qk_scale=qk_scale, return_logits=True,
                                  xa=xa, cross_kv=cross_kv, device=device)
    heads = torch.as_tensor(alignment_heads, dtype=torch.long,
                            device=attn.device).reshape(-1, 2)
    sel = attn[heads[:, 0], :, heads[:, 1]]  # (n_sel, B, T, F)
    matrix = _znorm_mean_heads(sel.permute(1, 0, 2, 3).float(), token_len)
    jump_frames = matrix_to_jump_frames(matrix, token_len, frame_len, sot_len)

    # per-token probabilities: softmax over the non-special vocab slice
    # [:eot] (reference timing.py:147-150); row sot_len + i predicts text
    # token i (the token at position sot_len + 1 + i)
    probs = torch.softmax(logits[..., :eot].float(), dim=-1)
    pred_rows = probs[:, sot_len:, :]
    next_tokens = tokens.to(probs.device)[:, sot_len + 1:].long()
    pad = pred_rows.shape[1] - next_tokens.shape[1]
    next_tokens = torch.nn.functional.pad(next_tokens, (0, pad))
    next_tokens = next_tokens.clamp(0, eot - 1)  # pad/eot rows are unused
    token_probs = torch.gather(pred_rows, -1, next_tokens[..., None])[..., 0]
    return jump_frames, token_probs, matrix
