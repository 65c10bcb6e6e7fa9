"""The yardstick's arithmetic: operations and bytes of the window's work.

Each kernel family's least time is the larger of its bytes over the card's
memory bandwidth and its operations over the card's peak, with each input
byte read once and each output byte written once, counted for what the
inputs need: the live rows, the decode steps actually run, the keys a
causal mask leaves visible. The counts follow from the shapes the window
ran (``Batch``), never from a kernel, so a later kernel is held to the same
work. ``model_flops`` is ``utils/flops.py``'s count of the port, copied,
but over live utterances and the decode steps actually run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

# published dense peaks (NVIDIA's data sheet), matched in order against the
# lower-cased card name: (bf16 FLOP/s, HBM bytes/s)
PEAKS = (
    ("h100 nvl", 835e12, 3.9e12),
    ("h100 pcie", 756e12, 2.0e12),
    ("h100 sxm", 989e12, 3.35e12),
    ("h100 80gb hbm3", 989e12, 3.35e12),
)

BF16 = 2
F32 = 4
N_FFT = 400


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """{"flops": bf16 FLOP/s, "bytes": bytes/s} of a card, or None."""
    name = device_name.lower()
    for tag, flops, bw in PEAKS:
        if tag in name:
            return {"flops": flops, "bytes": bw}
    return None


@dataclasses.dataclass
class Batch:
    """The shapes one batch ran: live rows, the capture's live tokens per
    row and its padded bucket, the decode prompt (``sample_begin``) and the
    decode steps run."""
    rows: int
    token_lens: List[int]
    t_bucket: int
    sample_begin: int
    steps: int


@dataclasses.dataclass
class Work:
    flops: float = 0.0
    bytes: float = 0.0

    def add(self, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes

    def seconds(self, peak: Dict[str, float]) -> float:
        return max(self.flops / peak["flops"], self.bytes / peak["bytes"])


def linear(w: Work, m: int, k: int, n: int, bias: bool = True,
           out_bytes: int = BF16) -> None:
    """(m, k) x (k, n)^T + bias, bf16 operands."""
    w.add(2.0 * m * k * n,
          BF16 * (m * k + n * k + (n if bias else 0)) + out_bytes * m * n)


def attention(w: Work, heads: int, queries: int, keys: int, hd: int,
              pairs: Optional[float] = None, score_bytes: int = 0) -> None:
    """Attention of ``queries`` over ``keys`` for ``heads`` (batch x head)
    pairs of head size ``hd``: QK and PV over ``pairs`` visible (query,
    key) pairs a head (all of them by default); q, k, v read, the output
    written, and with ``score_bytes`` the raw scores written too."""
    pairs = queries * keys if pairs is None else pairs
    w.add(4.0 * heads * pairs * hd,
          BF16 * heads * hd * (2 * queries + 2 * keys)
          + score_bytes * heads * queries * keys)


def _decoder_linears(w: Work, m: int, d: int) -> None:
    """One decoder layer's float linears over m rows: self q/k/v/out (no
    bias on k), cross q/out, fc1, fc2."""
    for bias in (True, False, True, True, True, True):
        linear(w, m, d, d, bias)
    linear(w, m, d, 4 * d)
    linear(w, m, 4 * d, d)


def dec_attn(dims: dict, b: Batch) -> Work:
    """The decoder attention of one batch (``csrc/dec_attn.cu``): the
    prompt's prefill, each decode step's self- and cross-attention, and
    the capture's causal self-attention and cross-attention with its f32
    scores, over the batch's live rows."""
    w = Work()
    h, d, f = dims["decoder_attention_heads"], dims["d_model"], dims["frames"]
    hd, layers = d // h, dims["decoder_layers"]
    p0 = b.sample_begin - 1
    for _ in range(layers):
        attention(w, b.rows * h, p0, p0, hd, pairs=p0 * (p0 + 1) / 2)
        attention(w, b.rows * h, p0, f, hd)
        for t in range(b.steps):
            attention(w, b.rows * h, 1, b.sample_begin + t, hd)
            attention(w, b.rows * h, 1, f, hd)
        for n in b.token_lens:
            attention(w, h, n, n, hd, pairs=n * (n + 1) / 2)
            attention(w, h, n, f, hd, score_bytes=F32)
    return w


def rows_linear(dims: dict, b: Batch) -> Work:
    """The decoder's float linears of one batch (``csrc/rows_linear.cu``):
    the cross K/V over the frames, the prefill and each step's linears and
    lm head (float32 logits: the prefill's at one position), the capture's
    linears over its live tokens."""
    w = Work()
    d, f, v = dims["d_model"], dims["frames"], dims["vocab_size"]
    p0 = b.sample_begin - 1
    for _ in range(dims["decoder_layers"]):
        linear(w, b.rows * f, d, d, bias=False)
        linear(w, b.rows * f, d, d)
        _decoder_linears(w, b.rows * p0, d)
        for _ in range(b.steps):
            _decoder_linears(w, b.rows, d)
        _decoder_linears(w, sum(b.token_lens), d)
    for _ in range(b.steps + 1):
        linear(w, b.rows, d, v, bias=False, out_bytes=F32)
    return w


def encoder_attn(dims: dict, b: Batch) -> Work:
    """The encoder's self-attention of one batch (``csrc/encoder_attn.cu``):
    every layer, every head, all frames."""
    w = Work()
    h, d, f = dims["encoder_attention_heads"], dims["d_model"], dims["frames"]
    for _ in range(dims["encoder_layers"]):
        attention(w, b.rows * h, f, f, d // h)
    return w


FAMILIES = {"dec_attn": dec_attn, "rows_linear": rows_linear,
            "encoder_attn": encoder_attn}


def work(family: str, dims: dict, batches: List[Batch]) -> Work:
    total = Work()
    for b in batches:
        one = FAMILIES[family](dims, b)
        total.add(one.flops, one.bytes)
    return total


# -- model FLOPs (utils/flops.py's count) --------------------------------------

def _mm(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def mel_flops(dims: dict) -> int:
    n_frames = 2 * dims["frames"]
    rbins = N_FFT // 2 + 1
    return (_mm(n_frames, N_FFT, 2 * rbins)
            + _mm(n_frames, rbins, dims["num_mel_bins"]))


def encoder_flops(dims: dict) -> int:
    f, d = dims["frames"], dims["d_model"]
    conv = _mm(2 * f, dims["num_mel_bins"] * 3, d) + _mm(f, d * 3, d)
    layer = 4 * _mm(f, d, d) + 2 * _mm(f, f, d) + 2 * _mm(f, d, 4 * d)
    return conv + dims["encoder_layers"] * layer


def _decoder_layer_flops(dims: dict, t: int, self_ctx: int,
                         kv_frames: int) -> int:
    d = dims["d_model"]
    return (4 * _mm(t, d, d) + 2 * _mm(t, self_ctx, d) + 2 * _mm(t, d, d)
            + 2 * _mm(t, kv_frames, d) + 2 * _mm(t, d, 4 * d))


def decode_flops(dims: dict, prompt_len: int, steps: int) -> int:
    f, d, layers = dims["frames"], dims["d_model"], dims["decoder_layers"]
    total = layers * 2 * _mm(f, d, d)
    total += layers * _decoder_layer_flops(dims, prompt_len, prompt_len, f)
    total += _mm(1, d, dims["vocab_size"])
    for i in range(steps):
        total += layers * _decoder_layer_flops(dims, 1, prompt_len + i + 1, f)
        total += _mm(1, d, dims["vocab_size"])
    return total


def capture_flops(dims: dict, t_tokens: int) -> int:
    return dims["decoder_layers"] * _decoder_layer_flops(
        dims, t_tokens, t_tokens, dims["frames"])


def model_flops(dims: dict, batches: List[Batch], prompt_len: int) -> float:
    """Matmul FLOPs of the work the batches completed: per live utterance
    the mel DFT, the encoder, the decode (its prompt and the steps run) and
    the capture at the batch's token bucket (cross K/V reused)."""
    per_utt = mel_flops(dims) + encoder_flops(dims)
    total = 0.0
    for b in batches:
        total += b.rows * (per_utt + decode_flops(dims, prompt_len, b.steps)
                           + capture_flops(dims, b.t_bucket))
    return total
