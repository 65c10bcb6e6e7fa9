"""Analytic FLOPs-per-utterance model for the alignment pipeline, and the MFU
roll-up derived from it.

Copy of ``whisper_char_alignment_tpu/utils/flops.py`` for the PyTorch port,
which imports nothing of the JAX package. The counts are the JAX package's,
unchanged; :func:`device_peak_tflops` reads the card's name from
``torch.cuda.get_device_name`` and holds NVIDIA's dense bf16 data-sheet
peaks of the H100 parts (TPU kinds are not carried over).

Multiply the per-utterance FLOPs by the measured throughput and divide by the
card's bf16 peak. Counts are matmul/conv FLOPs (2 * M * K * N per dense
contraction) at the shapes the device ACTUALLY runs — i.e. the
padded/bucketed shapes, since padding is work the tensor cores perform —
with elementwise work (GELU, layernorm, softmax, the QK medfilt/softmax
postprocess, DTW) excluded: those stages are bandwidth-bound, contribute <2%
of arithmetic, and counting them would overstate MFU.

Reference for the pipeline structure being costed: the teacher-forced
capture pass (reference timing.py:45-67), the greedy decode
(infer_ali.py:60), and the encoder/decoder shapes of the openai-whisper
model (SURVEY.md §2b #11-12).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .. import constants
from ..config import ModelDims


def _mm(m: int, k: int, n: int) -> int:
    """FLOPs of an (m, k) x (k, n) matmul (multiply-add = 2 FLOPs)."""
    return 2 * m * k * n


def mel_flops(dims: ModelDims) -> int:
    """DFT-as-matmul log-mel frontend (audio/mel.py, use_fft=False): framed
    audio (n_frames, n_fft) x DFT (n_fft, 2 * rbins), then power x mel bank
    (rbins, n_mels). n_frames here is the STFT hop count over the 30 s
    window (= 2 * n_audio_ctx mel frames)."""
    n_frames = 2 * dims.n_audio_ctx
    rbins = constants.N_FFT // 2 + 1
    return (_mm(n_frames, constants.N_FFT, 2 * rbins)
            + _mm(n_frames, rbins, dims.n_mels))


def encoder_flops(dims: ModelDims) -> int:
    """Conv stem + n_audio_layer transformer blocks at the fixed F frames."""
    F = dims.n_audio_ctx
    d = dims.n_audio_state
    conv = (_mm(2 * F, dims.n_mels * 3, d)  # conv1: k=3, stride 1, T=2F
            + _mm(F, d * 3, d))             # conv2: k=3, stride 2 -> F
    per_layer = (4 * _mm(F, d, d)           # q/k/v/out projections
                 + 2 * _mm(F, F, d)         # QK^T + AV
                 + 2 * _mm(F, d, 4 * d))    # MLP fc1 + fc2
    return conv + dims.n_audio_layer * per_layer


def _decoder_layer_flops(dims: ModelDims, t: int, self_ctx: int,
                         kv_frames: int, cross_kv_proj: bool) -> int:
    """One decoder block over t query positions attending self_ctx cached
    self positions and kv_frames cross frames. ``cross_kv_proj`` counts the
    per-layer cross K/V projections (skipped when the capture pass reuses
    the decode loop's stacks — runner reuse_cross_kv)."""
    d = dims.n_text_state
    f = (4 * _mm(t, d, d)              # self q/k/v/out
         + 2 * _mm(t, self_ctx, d)     # self QK^T + AV over the cache
         + 2 * _mm(t, d, d)            # cross q + out
         + 2 * _mm(t, kv_frames, d)    # cross QK^T + AV
         + 2 * _mm(t, d, 4 * d))       # MLP
    if cross_kv_proj:
        f += 2 * _mm(kv_frames, d, d)  # cross k, v over the frames
    return f


def decode_flops(dims: ModelDims, *, prompt_len: int, steps: int,
                 kv_frames: Optional[int] = None,
                 prefill: bool = True) -> int:
    """Greedy decode: per-layer cross-K/V precompute over the (possibly
    bucketed) frames, a one-pass prompt prefill, then ``steps`` single-token
    autoregressive steps each projecting the full-vocab logit head.

    ``steps`` should be the number of loop iterations actually executed
    (sample_len when eot never fires, as in the random-weight bench)."""
    F = kv_frames or dims.n_audio_ctx
    d = dims.n_text_state
    L = dims.n_text_layer
    total = L * 2 * _mm(F, d, d)  # cross K/V stacks, all layers
    p = max(int(prompt_len), 0)
    if p > 0:
        if prefill:
            total += L * _decoder_layer_flops(dims, p, p, F, False)
            total += _mm(1, d, dims.n_vocab)  # logits at the last position
        else:
            for i in range(p):
                total += L * _decoder_layer_flops(dims, 1, i + 1, F, False)
                total += _mm(1, d, dims.n_vocab)
    for i in range(max(int(steps), 0)):
        total += L * _decoder_layer_flops(dims, 1, p + i + 1, F, False)
        total += _mm(1, d, dims.n_vocab)
    return total


def capture_flops(dims: ModelDims, *, t_tokens: int,
                  reuse_cross_kv: bool = True,
                  return_logits: bool = False,
                  encoder: bool = False) -> int:
    """Teacher-forced QK-capture pass at t_tokens (the PADDED token bucket the
    device runs). The production _align_step receives the decode pass's
    encoder states (and, when reuse is on, its cross K/V stacks), so the
    encoder (and optionally the cross projections) are not recomputed."""
    t = int(t_tokens)
    total = dims.n_text_layer * _decoder_layer_flops(
        dims, t, t, dims.n_audio_ctx, cross_kv_proj=not reuse_cross_kv)
    if return_logits:
        total += _mm(t, dims.n_text_state, dims.n_vocab)
    if encoder:
        total += encoder_flops(dims)
    return total


def pipeline_flops_per_utt(dims: ModelDims, *, t_tokens: int,
                           decode_prompt_len: int, decode_steps: int,
                           kv_frames: Optional[int] = None,
                           reuse_cross_kv: bool = True,
                           prefill: bool = True) -> dict:
    """Per-utterance matmul FLOPs of the production pipeline, by stage.

    The encoder runs ONCE per utterance (the capture pass reuses the decode
    pass's states — runner._dispatch_transcribe / _align_step)."""
    stages = {
        "mel": mel_flops(dims),
        "encoder": encoder_flops(dims),
        "decode": decode_flops(dims, prompt_len=decode_prompt_len,
                               steps=decode_steps, kv_frames=kv_frames,
                               prefill=prefill),
        "capture": capture_flops(dims, t_tokens=t_tokens,
                                 reuse_cross_kv=reuse_cross_kv),
    }
    stages["total"] = sum(stages.values())
    return stages


# dense bf16 peak per card, TFLOP/s (NVIDIA data sheets), matched in order
# against the lower-cased name torch.cuda.get_device_name gives
_PEAK_BF16_TFLOPS = (
    ("h100 nvl", 835.0),
    ("h100 pcie", 756.0),
    ("h100 sxm", 989.0),
    ("h100 80gb hbm3", 989.0),
)


def device_peak_tflops(device=None) -> Optional[float]:
    """bf16 peak of a card (``device``: an index or a CUDA device, card 0
    by default), from its name (override with WCA_PEAK_TFLOPS; None when
    the card is unknown or there is none — MFU is then not claimable)."""
    env = os.environ.get("WCA_PEAK_TFLOPS")
    if env:
        return float(env)
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = 0
    name = torch.cuda.get_device_name(device).lower()
    for tag, peak in _PEAK_BF16_TFLOPS:
        if tag in name:
            return peak
    return None


def mfu_summary(flops_per_utt: float, utts_per_sec: float,
                peak_tflops: Optional[float]) -> dict:
    """The roll-up: achieved TFLOP/s and % of peak."""
    tflops = flops_per_utt * utts_per_sec / 1e12
    return {
        "flops_per_utt_g": round(flops_per_utt / 1e9, 2),
        "tflops_per_sec": round(tflops, 2),
        "peak_bf16_tflops": peak_tflops,
        "mfu_pct": (round(100.0 * tflops / peak_tflops, 2)
                    if peak_tflops else None),
    }
