"""What decides ``correct``: the timed path's outputs against the plain reference.

The harness hands over what the window's last pass produced for the held
batches (their mel and encoder states, the greedy decode's served tokens,
the selected heads and the word boundaries) and the raw inputs (the WAV
samples, the texts, the weights). The reference works everything out again
from the raw inputs, in float32, and each stage is judged by one number:

- ``mel_err``: the largest absolute gap of the program's log-mel;
- ``enc_err``: the largest relative (Frobenius) gap of an utterance's
  encoder states;
- ``decode_gap``: the widest gap by which a served token's logit lies below
  the reference's greedy pick under the published logit rules, the
  reference teacher-forced over the served tokens;
- ``head_regret``: the share of the reference's best k head scores that
  the program's k selected heads give up (their reference scores' sum
  below the best k's sum);
- ``dtw_regret``: how much dearer, as a share, the reference's best DTW path
  through the program's word boundaries is than its best path, on the
  reference's matrix aggregated over the program's heads.

Each later stage is teacher-forced by the program's own discrete choices
(tokens, heads), as a served model's tokens are, and judged by how far the
reference's own scores would have to move to make that choice: a near tie
reads near 0. The control (``side="control"``) puts the reference in the
program's place in float8 and is judged by the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .reference import whisper as ref

TOKENS_PER_SECOND = 50
NAMES = ("mel_err", "enc_err", "decode_gap", "head_regret", "dtw_regret")


@dataclasses.dataclass
class Case:
    """One judged utterance: its raw inputs and what the program made of
    it. ``starts``/``ends`` are the program's word times, ``heads`` its
    selected (layer, head) pairs, ``served`` its greedy tokens."""
    fid: str
    pcm: np.ndarray
    text: str
    served: List[int]
    heads: List[tuple]
    starts: np.ndarray
    ends: np.ndarray
    mel: Optional[torch.Tensor] = None  # the program's (n_mels, 3000)
    xa: Optional[torch.Tensor] = None  # the program's (1500, d)


def word_rows(text: str) -> np.ndarray:
    """The DTW rows at which each word starts, and the last row: char units
    with a space token before every word but the first."""
    rows, pos = [0], 0
    for k, word in enumerate(text.split()):
        pos += len(word) + (1 if k else 0)
        rows.append(pos)
    return np.asarray(rows)


def capture_tokens(text: str, spec: dict) -> List[int]:
    """The teacher-forced capture's tokens: the sot sequence, no-timestamps,
    one token a character (the toy vocabulary's byte tokens), eot."""
    return ([*spec["sot_sequence"], spec["no_timestamps"]]
            + list(text.encode()) + [spec["eot"]])


def _chunks(n: int, size: int):
    for i in range(0, n, size):
        yield slice(i, min(n, i + size))


def _decode_gaps(w, dims, xa, cases, spec, prec) -> float:
    """The widest gap over every served token (side program) or every
    token the control's logits pick (side control)."""
    sot = list(spec["sot_sequence"])
    worst = 0.0
    for sl in _chunks(len(cases), 16):
        group = cases[sl]
        seqs = []
        for c in group:
            seq = list(c.served)
            if len(seq) < spec["sample_len"]:
                seq.append(spec["eot"])  # the row ended: eot was served
            seqs.append(seq)
        t = max(len(s) for s in seqs)
        tokens = torch.full((len(group), len(sot) + t - 1), spec["eot"],
                            dtype=torch.long)
        for i, s in enumerate(seqs):
            row = sot + s[:-1]
            tokens[i, :len(row)] = torch.tensor(row)
        logits, _ = ref.decoder(w, tokens, xa[sl], dims, ref.Precision())
        base = len(sot) - 1
        ctl = None
        if prec.kind is not None:
            ctl, _ = ref.decoder(w, tokens, spec["control_xa"][sl], dims,
                                 prec)
        for i, s in enumerate(seqs):
            rows = slice(base, base + len(s))
            chosen = (torch.tensor(s) if ctl is None
                      else ref.picks(ctl[i, rows], s, spec))
            worst = max(worst, float(ref.gaps(logits[i, rows], s, chosen,
                                              spec).max()))
    return worst


def _capture(w, dims, xa_row, tokens, n_frames, width, prec):
    """(L, H, T, F) maps of one utterance, float32."""
    _, qks = ref.decoder(w, torch.tensor([tokens]), xa_row[None], dims, prec,
                         want_logits=False, want_qk=True)
    return torch.stack([ref.attention_maps(qk[0], len(tokens), n_frames,
                                           width) for qk in qks])


def _bounds_frames(starts, ends) -> np.ndarray:
    times = np.concatenate([np.asarray(starts, np.float64)[:1],
                            np.asarray(ends, np.float64)])
    return np.rint(times * TOKENS_PER_SECOND).astype(np.int64)


def _align(w, dims, xa, cases, spec, prec, cfg) -> tuple:
    """(head_regret, dtw_regret) over the cases."""
    width, k, sot_len = cfg["medfilt_width"], cfg["topk"], len(
        spec["sot_sequence"])
    head_regret = 0.0
    costs, bounds, shapes = [], [], []
    for i, c in enumerate(cases):
        tokens = capture_tokens(c.text, spec)
        n_frames = min(max(len(c.pcm) // 320, 1), xa.shape[1])
        maps = _capture(w, dims, xa[i], tokens, n_frames, width,
                        ref.Precision())
        scores = ref.head_scores(maps)  # (L, H)
        if prec.kind is None:
            heads = [tuple(h) for h in c.heads]
            frames = _bounds_frames(c.starts, c.ends)
        else:
            ctl = _capture(w, dims, spec["control_xa"][i], tokens, n_frames,
                           width, prec)
            heads = ref.top_heads(ref.head_scores(ctl), k)
            frames = None
        best = torch.sort(scores.view(-1), descending=True).values[:k]
        chosen = sum(float(scores[l, h]) for l, h in heads)
        head_regret = max(head_regret,
                          float((best.sum() - chosen) / best.sum()))
        rows = slice(sot_len, len(tokens) - 1)
        costs.append(-ref.aggregate(maps, heads)[rows])
        if frames is None:
            m = -ref.aggregate(ctl, heads)[rows]
            _, tr = ref.dtw(m[None], [m.shape[0]], [m.shape[1]], trace=True)
            first = ref.first_visits(tr[0].cpu().numpy(), *m.shape)
            frames = first[word_rows(c.text)]
        bounds.append(frames)
        shapes.append(costs[-1].shape)
    n = [s[0] for s in shapes]
    m = [s[1] for s in shapes]
    big = torch.full((len(costs), max(n), max(m)), float("inf"),
                     dtype=torch.float64, device=costs[0].device)
    enter = torch.ones(big.shape, dtype=torch.bool, device=big.device)
    for i, (c, case, fr) in enumerate(zip(costs, cases, bounds)):
        big[i, :n[i], :m[i]] = c
        for row, col in zip(word_rows(case.text), fr):
            if not 0 <= col < m[i] or row >= n[i]:
                big[i, row, :] = float("inf")  # no path: the regret is inf
                continue
            big[i, row, :col] = float("inf")
            enter[i, row, col + 1:] = False
    best = ref.dtw(_unconstrained(costs, n, m, big.device), n, m)
    held = ref.dtw(big, n, m, enter_ok=enter)
    regret = ((held - best) / best.abs()).max().item()
    return head_regret, float("inf") if np.isnan(regret) else regret


def _unconstrained(costs, n, m, device):
    big = torch.full((len(costs), max(n), max(m)), float("inf"),
                     dtype=torch.float64, device=device)
    for i, c in enumerate(costs):
        big[i, :n[i], :m[i]] = c
    return big


def judge(sd: Dict[str, torch.Tensor], dims: dict, cases: Sequence[Case],
          spec: dict, cfg: dict, device, side: str = "program"
          ) -> Dict[str, float]:
    """The five numbers for the program's outputs in ``cases`` (side
    ``program``) or for the float8 control in the program's place (side
    ``control``). ``spec``: the decode's token ids and rules; ``cfg``: the
    recipe (``medfilt_width``, ``topk``)."""
    if not cases:
        return {name: float("inf") for name in NAMES}
    prec = ref.Precision("fp8" if side == "control" else None)
    w = ref.Weights(sd, device)
    ref_mel = ref.log_mel([c.pcm for c in cases], dims["num_mel_bins"],
                          2 * dims["frames"] * ref.HOP)
    xa = torch.cat([ref.encoder(w, ref_mel[sl], dims, ref.Precision())
                    for sl in _chunks(len(cases), 8)])
    if side == "control":
        mel = prec(ref_mel)
        prog_xa = torch.cat([ref.encoder(w, mel[sl], dims, prec)
                             for sl in _chunks(len(cases), 8)])
        spec = dict(spec, control_xa=prog_xa)
    else:
        mel = torch.stack([c.mel.float().cpu() for c in cases])
        prog_xa = torch.stack([c.xa.to(device, torch.float32)
                               for c in cases])
    out = {"mel_err": float((mel.float() - ref_mel).abs().max())}
    diff = (prog_xa.to(device) - xa).flatten(1).norm(dim=1)
    out["enc_err"] = float((diff / xa.flatten(1).norm(dim=1)).max())
    out["decode_gap"] = _decode_gaps(w, dims, xa, list(cases), spec, prec)
    out["head_regret"], out["dtw_regret"] = _align(w, dims, xa, list(cases),
                                                   spec, prec, cfg)
    return out
