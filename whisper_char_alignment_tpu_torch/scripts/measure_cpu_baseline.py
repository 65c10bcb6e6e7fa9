"""A torch-CPU, reference-equivalent baseline for ``bench``'s denominator
(port of the repository's ``scripts/measure_cpu_baseline.py``).

    python -m whisper_char_alignment_tpu_torch.scripts.measure_cpu_baseline

The reference repository needs the ``openai-whisper`` package, but its
execution model (one utterance at a time, eager PyTorch on the CPU,
hook-captured cross-attentions, NumPy DTW) can be reproduced with HF's
``WhisperForConditionalGeneration`` (the same architecture and math) at
Whisper-medium shapes with random weights (the run time does not depend on
the weights). It measures a CPU by definition, so it runs on the CPU
whatever ``WCA_PLATFORM`` says.

Per utterance (:func:`baseline_utterance`), mirroring ``bench``'s workload:
  1. 32 greedy decode steps with a KV cache (the transcription pass),
  2. one teacher-forced forward (96 tokens) with all cross-attentions,
  3. width-3 median filter + softmax + top-10 head selection,
  4. NumPy DTW (``ops/dtw.dtw_np``) over the aggregated (92, 300) matrix.

Prints utts/sec and an ``export WCA_BENCH_BASELINE=...`` line; ``bench``
reports ``vs_baseline`` only where that variable is set. Needs
``transformers``: without it the program exits 2 with a line naming the
package, before any work. Takes minutes: a medium forward on one CPU core is
slow, which is the point.

Knobs (env, the JAX script's): WCA_BASELINE_THREADS (1), WCA_BASELINE_UTTS
(1).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..bench import require_package
from ..ops.dtw import dtw_np  # NumPy DTW, like the reference's numba one


def medium_config():
    """HF's configuration of Whisper-medium's shapes."""
    import transformers

    cfg = transformers.WhisperConfig(
        vocab_size=51865, num_mel_bins=80, d_model=1024, encoder_layers=24,
        encoder_attention_heads=16, decoder_layers=24,
        decoder_attention_heads=16, encoder_ffn_dim=4096, decoder_ffn_dim=4096,
        max_source_positions=1500, max_target_positions=448,
        pad_token_id=50256, bos_token_id=50257, eos_token_id=50256,
        decoder_start_token_id=50257)
    cfg._attn_implementation = "eager"
    return cfg


@torch.no_grad()
def baseline_utterance(model, cfg, mel: torch.Tensor, rng, *,
                       decode_len: int = 32, t_tokens: int = 96,
                       frames: int = 300, topk: int = 10):
    """One utterance of the reference's execution model on ``model`` (an HF
    ``WhisperForConditionalGeneration``), ``mel`` (1, n_mels, 3000).
    Returns the DTW's (text_indices, time_indices)."""
    # 1. the encoder once, then cached decode steps (the transcription pass)
    enc = model.model.encoder(mel).last_hidden_state
    ids = torch.tensor([[cfg.decoder_start_token_id]])
    past = None
    for _ in range(decode_len):
        out = model(encoder_outputs=(enc,), decoder_input_ids=ids[:, -1:],
                    past_key_values=past, use_cache=True)
        past = out.past_key_values
        ids = torch.cat([ids, out.logits[:, -1:].argmax(-1)], dim=1)

    # 2. teacher-forced capture of all cross-attentions
    tokens = torch.from_numpy(
        rng.integers(0, 255, (1, t_tokens)).astype(np.int64))
    out = model(encoder_outputs=(enc,), decoder_input_ids=tokens,
                output_attentions=True)
    qk = torch.stack(out.cross_attentions)[:, 0]  # (L, H, T, 1500)

    # 3. frame slice + medfilt(3) + softmax + top-k selection
    w = qk[..., :frames]
    pad = 1
    l_, h_, t_, f_ = w.shape
    wp = torch.nn.functional.pad(w.reshape(l_ * h_, t_, f_), (pad, pad),
                                 mode="reflect")
    w = wp.unfold(-1, 3, 1).sort(dim=-1)[0][..., pad]
    w = w.reshape(l_, h_, t_, f_)
    w = w.softmax(dim=-1)
    scores = (w.norm(dim=-2).sum(-1) + w.norm(dim=-1).sum(-1)).flatten()
    top = torch.topk(scores, topk).indices
    sel = w.reshape(-1, t_tokens, frames)[top]
    matrix = (sel / sel.norm(dim=-2, keepdim=True)).mean(0)

    # 4. NumPy DTW over the text rows
    return dtw_np(-matrix[3:-1].numpy())


def main() -> None:
    require_package("transformers", "transformers", "measure_cpu_baseline",
                    "HF's Whisper model")
    import transformers

    torch.set_num_threads(int(os.environ.get("WCA_BASELINE_THREADS", "1")))
    cfg = medium_config()
    torch.manual_seed(0)
    model = transformers.WhisperForConditionalGeneration(cfg)
    model.eval()

    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.normal(0, 1, (1, 80, 3000)).astype(np.float32))
    n_utts = int(os.environ.get("WCA_BASELINE_UTTS", "1"))
    t0 = time.time()
    for _ in range(n_utts):
        baseline_utterance(model, cfg, mel, rng)
    wall = time.time() - t0

    tput = n_utts / wall
    print(f"torch-CPU reference-equivalent: {n_utts} utts in {wall:.1f}s "
          f"-> {tput:.4f} utts/sec")
    print(f"export WCA_BENCH_BASELINE={tput:.4f}")


if __name__ == "__main__":
    main()
