"""Plain Whisper: log-mel, encoder, decoder and the alignment recipe.

Float32 throughout (the caller turns TF32 off), written from the published
model (openai-whisper's ``model.py``, ``audio.py``, ``decoding.py`` and
``timing.py``) and the reference aligner's recipe (cross-attention logits,
median filter, softmax, top-k head selection by column and row norms,
column-normalised mean, DTW). It reads the leaves of a state dict by their
published names and imports nothing of the port.

``Precision`` rounds the operands of every product: ``Precision()`` is exact
float32; ``Precision("fp8")`` puts each operand through float8 e4m3 with one
scale a tensor, the control that a lower precision has to fail.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000
N_FFT = 400
HOP = 160
N_SAMPLES = 30 * SAMPLE_RATE
FP8_MAX = 448.0


class Precision:
    """Rounding of a product's operands: None (float32) or ``"fp8"``."""

    def __init__(self, kind: Optional[str] = None):
        if kind not in (None, "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.kind is None:
            return x
        amax = x.abs().amax().clamp(min=1e-30)
        scale = FP8_MAX / amax
        return (x * scale).to(torch.float8_e4m3fn).float() / scale


# -- log-mel -------------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep, f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), m * f_sp)


def mel_filters(n_mels: int) -> np.ndarray:
    """Slaney-scale, Slaney-normalised triangles (librosa's defaults, as the
    published ``mel_filters.npz`` holds them), float64 (n_mels, 201)."""
    freqs = np.linspace(0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SAMPLE_RATE / 2),
                                n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None],
                                   ramps[2:] / fdiff[1:, None]))
    return w * (2.0 / (hz[2:] - hz[:-2]))[:, None]


def log_mel(pcm: Sequence[np.ndarray], n_mels: int,
            n_samples: int = N_SAMPLES) -> torch.Tensor:
    """16-bit PCM clips -> (B, n_mels, n_samples // 160) float32: padded to
    ``n_samples`` (30 s), a
    centred STFT (periodic Hann, reflect padding, the last frame dropped),
    power, mel, log10 clamped at 1e-10, each clip cut at its max - 8, then
    (x + 4) / 4. Computed in float64."""
    audio = np.zeros((len(pcm), n_samples))
    for i, x in enumerate(pcm):
        n = min(len(x), n_samples)
        audio[i, :n] = np.asarray(x[:n], np.float64) / 32768.0
    padded = np.pad(audio, ((0, 0), (N_FFT // 2, N_FFT // 2)), mode="reflect")
    n_frames = n_samples // HOP
    idx = np.arange(n_frames)[:, None] * HOP + np.arange(N_FFT)[None, :]
    window = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(N_FFT) / N_FFT)
    filters = mel_filters(n_mels)
    out = np.empty((len(pcm), n_mels, n_frames))
    for i in range(len(pcm)):
        spec = np.fft.rfft(padded[i][idx] * window, axis=-1)
        mel = filters @ (np.abs(spec) ** 2).T
        log_spec = np.log10(np.maximum(mel, 1e-10))
        log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
        out[i] = (log_spec + 4.0) / 4.0
    return torch.from_numpy(out.astype(np.float32))


# -- the model -------------------------------------------------------------------

class Weights:
    """The state dict's leaves read as float32 on a device, on demand."""

    def __init__(self, sd: Dict[str, torch.Tensor], device):
        self.sd, self.device = sd, device

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.sd[name].to(self.device, torch.float32)

    def get(self, name: str) -> Optional[torch.Tensor]:
        return self[name] if name in self.sd else None


def _linear(w: Weights, name: str, x: torch.Tensor, prec: Precision):
    y = prec(x) @ prec(w[name + ".weight"]).T
    b = w.get(name + ".bias")
    return y if b is None else y + b


def _ln(w: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], w[name + ".weight"],
                        w[name + ".bias"], 1e-5)


def _heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.view(b, t, n_head, d // n_head).transpose(1, 2)


def _attention(w, name, x, src, n_head, prec, causal=False, want_qk=False):
    """Multi-head attention of x over src; returns (out, raw logits or
    None). Query and key are each scaled by head_dim ** -0.25."""
    hd = x.shape[-1] // n_head
    scale = hd ** -0.25
    q = _heads(_linear(w, name + ".query", x, prec), n_head) * scale
    k = _heads(_linear(w, name + ".key", src, prec), n_head) * scale
    v = _heads(_linear(w, name + ".value", src, prec), n_head)
    qk = prec(q) @ prec(k).transpose(-1, -2)
    if causal:
        t = qk.shape[-1]
        qk = qk + torch.full((t, t), float("-inf"),
                             device=qk.device).triu_(1)
    o = prec(torch.softmax(qk, dim=-1)) @ prec(v)
    o = o.transpose(1, 2).reshape(x.shape)
    return _linear(w, name + ".out", o, prec), (qk if want_qk else None)


def _mlp(w, name, x, prec):
    h = F.gelu(_linear(w, name + ".mlp.0", _ln(w, name + ".mlp_ln", x), prec))
    return _linear(w, name + ".mlp.2", h, prec)


def encoder(w: Weights, mel: torch.Tensor, dims: dict,
            prec: Precision) -> torch.Tensor:
    """mel (B, n_mels, 3000) -> encoder states (B, 1500, d) float32."""
    x = mel.to(w.device, torch.float32)
    x = F.gelu(F.conv1d(prec(x), prec(w["encoder.conv1.weight"]),
                        w["encoder.conv1.bias"], padding=1))
    x = F.gelu(F.conv1d(prec(x), prec(w["encoder.conv2.weight"]),
                        w["encoder.conv2.bias"], stride=2, padding=1))
    x = x.transpose(1, 2) + sinusoid_positions(x.shape[-1], x.shape[1],
                                               x.device)
    h = dims["encoder_attention_heads"]
    for i in range(dims["encoder_layers"]):
        name = f"encoder.blocks.{i}"
        a, _ = _self(w, name, x, h, prec)
        x = x + a
        x = x + _mlp(w, name, x, prec)
    return _ln(w, "encoder.ln_post", x)


def _self(w, name, x, n_head, prec, causal=False):
    y = _ln(w, name + ".attn_ln", x)
    return _attention(w, name + ".attn", y, y, n_head, prec, causal=causal)


def sinusoid_positions(length: int, channels: int, device) -> torch.Tensor:
    inc = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return torch.from_numpy(np.concatenate([np.sin(t), np.cos(t)], 1)
                            .astype(np.float32)).to(device)


def decoder(w: Weights, tokens: torch.Tensor, xa: torch.Tensor, dims: dict,
            prec: Precision, want_logits: bool = True,
            want_qk: bool = False):
    """Teacher-forced decoder over tokens (B, T) and encoder states xa (B,
    F, d). Returns (logits (B, T, vocab) float32 or None, [raw
    cross-attention logits (B, H, T, F) a layer] or None)."""
    dev = w.device
    tokens = tokens.to(dev)
    t = tokens.shape[1]
    x = (w["decoder.token_embedding.weight"][tokens]
         + w["decoder.positional_embedding"][:t])
    xa = xa.to(dev, torch.float32)
    h = dims["decoder_attention_heads"]
    qks = [] if want_qk else None
    for i in range(dims["decoder_layers"]):
        name = f"decoder.blocks.{i}"
        a, _ = _self(w, name, x, h, prec, causal=True)
        x = x + a
        c, qk = _attention(w, name + ".cross_attn",
                           _ln(w, name + ".cross_attn_ln", x), xa, h, prec,
                           want_qk=want_qk)
        x = x + c
        if want_qk:
            qks.append(qk)
        x = x + _mlp(w, name, x, prec)
    logits = None
    if want_logits:
        x = _ln(w, "decoder.ln", x)
        logits = prec(x) @ prec(w["decoder.token_embedding.weight"]).T
    return logits, qks


# -- the decode's logit rules -----------------------------------------------------

def rules(logits: torch.Tensor, seq: Sequence[int], spec: dict) -> tuple:
    """The published greedy logit rules at every step of one decode:
    ``logits`` (n, V), row k the step that follows ``seq[:k]``. Returns the
    logits masked by SuppressBlank (first step), SuppressTokens and
    ApplyTimestampRules up to its last rule, float64 (n, V); whether that
    last rule (timestamps' log-mass above every text token's) removes the
    text tokens (n,); and the timestamps' log-mass (n,)."""
    n, v = logits.shape
    dev = logits.device
    ts = spec["timestamp_begin"]
    x = logits.double().clone()
    x[:, list(spec["suppress"])] = -np.inf
    x[0, list(spec["blank"])] = -np.inf
    x[:, spec["no_timestamps"]] = -np.inf
    s = torch.tensor(list(seq[:n]), dtype=torch.long, device=dev)
    stamp = s >= ts
    last_was = torch.zeros(n, dtype=torch.bool, device=dev)
    last_was[1:] = stamp[:-1]
    penult_was = torch.ones(n, dtype=torch.bool, device=dev)
    penult_was[2:] = stamp[:-2]
    # the newest timestamp before each step (-1: none yet)
    at = torch.where(stamp, torch.arange(n, device=dev), -1).cummax(0).values
    before = torch.full((n,), -1, dtype=torch.long, device=dev)
    before[1:] = at[:-1]
    has = before >= 0
    newest = s[before.clamp(min=0)]
    lowest = torch.where(last_was & ~penult_was, newest, newest + 1)
    col = torch.arange(v, device=dev)[None]
    kill = ((last_was & penult_was)[:, None] & (col >= ts)
            | (last_was & ~penult_was)[:, None] & (col < spec["eot"])
            | has[:, None] & (col >= ts) & (col < lowest[:, None]))
    kill[0] |= (col[0] < ts) | (col[0] > ts + spec["max_initial_timestamp_index"])
    x = x.masked_fill(kill, -np.inf)
    ts_mass = torch.logsumexp(x[:, ts:], dim=1)
    return x, ts_mass > x[:, :ts].amax(1), ts_mass


def picks(logits: torch.Tensor, seq: Sequence[int], spec: dict
          ) -> torch.Tensor:
    """The greedy token at every step (:func:`rules`)."""
    x, text_off, _ = rules(logits, seq, spec)
    col = torch.arange(x.shape[1], device=x.device)[None]
    x = x.masked_fill(text_off[:, None] & (col < spec["timestamp_begin"]),
                      -np.inf)
    return x.argmax(1)


def gaps(logits: torch.Tensor, seq: Sequence[int], tokens: torch.Tensor,
         spec: dict) -> torch.Tensor:
    """By how much the reference's ``logits`` would have to move for each
    step's ``tokens`` to be its greedy pick after ``seq[:k]``: 0 where it
    is the pick, inf where a rule forbids it. A token on the other side of
    the timestamp-preference rule needs the rule's own margin too."""
    x, text_off, ts_mass = rules(logits, seq, spec)
    ts = spec["timestamp_begin"]
    xt = x.gather(1, tokens[:, None].to(x.device))[:, 0]
    max_text, max_ts = x[:, :ts].amax(1), x[:, ts:].amax(1)
    top = torch.maximum(max_text, max_ts)
    text = torch.where(text_off, torch.maximum(top - xt, ts_mass - max_text),
                       top - xt)
    # a timestamp is the pick either over every token or, with the rule
    # moved, over the timestamps
    stamp = torch.where(text_off, max_ts - xt, torch.minimum(
        top - xt, torch.maximum(max_text - ts_mass, max_ts - xt)))
    g = torch.where(tokens.to(x.device) < ts, text, stamp).clamp(min=0)
    return torch.where(torch.isfinite(xt), g, torch.full_like(g, np.inf))


# -- the alignment recipe ---------------------------------------------------------

def attention_maps(qk: torch.Tensor, n_tokens: int, n_frames: int,
                   medfilt_width: int) -> torch.Tensor:
    """Raw cross-attention logits (H, T, F) of one utterance -> its maps
    (H, n_tokens, n_frames): the median filter (reflected at the clip's last
    frame) on the logits of its frames, then a softmax over them."""
    x = qk[:, :n_tokens, :n_frames].float()
    pad = medfilt_width // 2
    if pad and n_frames > pad:
        xp = F.pad(x, (pad, pad), mode="reflect")
        x = xp.unfold(-1, medfilt_width, 1).median(dim=-1).values
    return torch.softmax(x, dim=-1)


def head_scores(maps: torch.Tensor) -> torch.Tensor:
    """(..., T, F) maps -> the sum of column L2 norms plus the sum of row L2
    norms, float64."""
    m = maps.double()
    return ((m * m).sum(-2).sqrt().sum(-1) + (m * m).sum(-1).sqrt().sum(-1))


def top_heads(scores: torch.Tensor, k: int) -> List[tuple]:
    """The k best (layer, head) of (L, H) scores, as ``sorted(...)[-k:]``
    gives them: ascending, ties in (layer, head) order."""
    n_head = scores.shape[1]
    order = sorted(range(scores.numel()),
                   key=lambda i: (float(scores.view(-1)[i]), i))[-k:]
    return [(i // n_head, i % n_head) for i in order]


def aggregate(maps: torch.Tensor, heads: Sequence[tuple]) -> torch.Tensor:
    """(L, H, T, F) maps -> the mean over ``heads`` of each map divided by
    its column L2 norms (a zero column stays zero), float64 (T, F)."""
    sel = torch.stack([maps[l, h] for l, h in heads]).double()
    norm = (sel * sel).sum(-2, keepdim=True).sqrt()
    return (sel / torch.where(norm == 0, torch.ones_like(norm), norm)).mean(0)


def _skew(x: torch.Tensor, n: int, m: int, fill) -> torch.Tensor:
    """(B, n, m) -> (B, n + 1, n + m + 1): row i + 1, column s holds cell
    (i, s - i - 2 + 1) = x[:, i, s - i - 2] of the wavefront."""
    b = x.shape[0]
    s = torch.arange(n + m + 1, device=x.device)
    i = torch.arange(1, n + 1, device=x.device)
    j = s[None, :] - i[:, None] - 1  # column of x in D's row i, diagonal s
    ok = (j >= 0) & (j < m)
    xp = torch.cat([x, torch.full((b, n, 1), fill, dtype=x.dtype,
                                  device=x.device)], dim=-1)
    g = torch.gather(xp, 2, torch.where(ok, j, m)[None].expand(b, -1, -1))
    top = torch.full((b, 1, n + m + 1), fill, dtype=x.dtype, device=x.device)
    return torch.cat([top, g], dim=1)


def dtw(costs: torch.Tensor, n: Sequence[int], m: Sequence[int],
        enter_ok: Optional[torch.Tensor] = None, trace: bool = False):
    """Whisper's DTW over (B, N, M) float64 costs (cells past an item's
    (n, m) are ignored), by anti-diagonals: each cell adds its cost to the
    diagonal predecessor if it is less than both others, else the upper
    one if it is less than both others, else the left one. ``enter_ok``
    (B, N, M) bool forbids entering a cell from the row above where False.
    Returns the cost of each item's path to its (n, m), and with ``trace``
    the (B, N + 1, N + M + 1) moves (0 diagonal, 1 up, 2 left) of the
    skewed layout."""
    b, nn, mm = costs.shape
    dev = costs.device
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=dev)
    xs = _skew(costs.double(), nn, mm, float("inf"))
    ok = (None if enter_ok is None
          else _skew(enter_ok.to(torch.float64), nn, mm, 1.0) > 0)
    d = torch.full((b, nn + 1, nn + mm + 1), float("inf"),
                   dtype=torch.float64, device=dev)
    d[:, 0, 0] = 0.0
    tr = (torch.full((b, nn + 1, nn + mm + 1), 2, dtype=torch.int8,
                     device=dev) if trace else None)
    for s in range(2, nn + mm + 1):
        c0, c1, c2 = d[:, :-1, s - 2], d[:, :-1, s - 1], d[:, 1:, s - 1]
        if ok is not None:
            c0 = torch.where(ok[:, 1:, s], c0, inf)
            c1 = torch.where(ok[:, 1:, s], c1, inf)
        pick0 = (c0 < c1) & (c0 < c2)
        pick1 = ~pick0 & (c1 < c0) & (c1 < c2)
        c = torch.where(pick0, c0, torch.where(pick1, c1, c2))
        d[:, 1:, s] = xs[:, 1:, s] + c
        if trace:
            tr[:, 1:, s] = torch.where(pick0, 0, torch.where(pick1, 1, 2)
                                       ).to(torch.int8)
    idx = torch.tensor([ni + mi for ni, mi in zip(n, m)], device=dev)
    rows = torch.tensor(list(n), device=dev)
    cost = d[torch.arange(b, device=dev), rows, idx]
    return (cost, tr) if trace else cost


def first_visits(trace: np.ndarray, n: int, m: int) -> np.ndarray:
    """The first column each row of one item's path visits, from its
    skewed trace (as :func:`dtw` returns it, on the host)."""
    i, j = n, m
    first = np.full(n, m, dtype=np.int64)
    while i > 0 and j > 0:
        first[i - 1] = j - 1
        t = trace[i, i + j]
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return first
