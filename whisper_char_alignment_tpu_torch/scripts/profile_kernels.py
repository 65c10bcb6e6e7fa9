"""A/B timings of the swappable kernels on the card (port of the
repository's ``scripts/profile_kernels.py``): the mel frontend (the plain
matmul DFT against the mel kernels) and the encoder self-attention (the
kernel, its K-transposed variant, the plain attention).

    python -m whisper_char_alignment_tpu_torch.scripts.profile_kernels [--batch 32] [--iters 5] [--which mel,enc]

Lines, the JAX script's:
  "mel XLA (DFT matmul)"  ``audio/mel.log_mel_spectrogram``, the plain
                          frontend (``WCA_MEL_IMPL=xla``)
  "mel Pallas fused"      ``ops/mel_cuda.log_mel``: the mel spectrum kernel
                          and its clip kernel (``csrc/mel.cu``)
  "enc attn kernel block_q=128", "enc attn kernel KT block_q=128"
                          ``ops/encoder_attn_cuda.encoder_self_attention``
                          and ``encoder_self_attention_kt`` at (B, 16, 1500,
                          64) bf16
  "enc attn XLA einsum"   their plain version
                          (``encoder_self_attention_plain``)

The JAX script sweeps the Pallas kernels' ``block_q`` (256, 512, 768; the
KT kernel 256, 512, 1536): a TPU tiling of the query rows into VMEM. The
Hopper kernels have one query block, 128 rows (8 warps of 16 in bf16), with
no knob, so the port times that one and names it in the line.

Each line's warm call runs it once (and builds the kernels); the reading is
the least of ``--iters`` timed calls. The lines (least and median) go to
stderr, then ONE JSON line: the readings (ms) under the lines' names,
``device``, ``launches`` and ``graph_captures_timed``. Runs on ``cuda``
unless ``WCA_PLATFORM=cpu``; without a card it exits non-zero and prints no
line.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import constants
from ..audio.mel import log_mel_spectrogram
from ..bench import device_label, log, platform_device
from ..ops import encoder_attn_cuda, mel_cuda
from ._profile import Readings

# the encoder self-attention's (heads, frames, head_dim) at Whisper-medium
ENC_SHAPE = (16, 1500, 64)
# the Hopper kernels' query rows per block (csrc/encoder_attn.cu)
BLOCK_Q = 128


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--which", default="mel,enc")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    b = args.batch
    which = set(args.which.split(","))
    device = platform_device()
    rng = np.random.default_rng(0)
    log(f"devices: {device_label(device)}  batch={b}")
    r = Readings("profile_kernels", device)

    def timed(name, fn):
        r.time(name, fn, args.iters, width=36, median=True)

    if "mel" in which:
        audio = torch.from_numpy(rng.normal(
            0, .1, (b, constants.N_SAMPLES)).astype(np.float32)).to(device)
        timed("mel XLA (DFT matmul)",
              lambda: log_mel_spectrogram(audio).sum())
        timed("mel Pallas fused", lambda: mel_cuda.log_mel(audio).sum())

    if "enc" in which:
        h, t, hd = ENC_SHAPE

        def draw():
            return torch.from_numpy(rng.normal(0, 1, (b, h, t, hd)).astype(
                np.float32)).to(device=device, dtype=torch.bfloat16)

        q, k, v = draw(), draw(), draw()
        timed(f"enc attn kernel block_q={BLOCK_Q}",
              lambda: encoder_attn_cuda.encoder_self_attention(
                  q, k, v, n_valid=t)[..., 0].sum())
        timed(f"enc attn kernel KT block_q={BLOCK_Q}",
              lambda: encoder_attn_cuda.encoder_self_attention_kt(
                  q, k, v, n_valid=t)[..., 0].sum())
        timed("enc attn XLA einsum",
              lambda: encoder_attn_cuda.encoder_self_attention_plain(
                  q, k, v, n_valid=t)[..., 0].sum())
    r.emit()


if __name__ == "__main__":
    main()
