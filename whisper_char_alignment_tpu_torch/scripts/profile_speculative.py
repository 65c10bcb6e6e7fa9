"""The speculative decode's machine envelope on the card, B=1, Whisper-medium
target (port of the repository's ``scripts/profile_speculative.py``).

    python -m whisper_char_alignment_tpu_torch.scripts.profile_speculative
    WCA_PLATFORM=cpu WCA_SPEC_TINY=1 python -m whisper_char_alignment_tpu_torch.scripts.profile_speculative

Acceptance depends on the checkpoint and the data; what the card fixes is
the cost shape:

    t_exact      sequential greedy, ms per token
    t_round(k)   one speculative round: k draft steps + one (k+1)-wide
                 target verify window + the filters
    speedup(c) = t_exact * c / t_round, c = mean committed tokens a round

Cells:
  exact      ``decoding.decode``, B=1, DECODE_LEN steps (the greedy graph)
  spec k=K   ``decoding.decode_speculative`` with a random Whisper-tiny-
             shaped draft (seed 7) against the random medium target
             (seed 0): drafts almost never match, so a round commits about
             one token, the measured time is t_round, and t_round / (k+1)
             is the projected ms a token at full acceptance
  self k=K   the target as its own draft: near-full acceptance checks the
             projection with real acceptance, at a draft cost equal to the
             target's

Each cell's warm call captures its graph; the reading is the least of REPS
timed calls. The JAX script asserts that every speculative transcript
equals greedy's. The port's verify window sums its products in another
order than a step (``decode_speculative``: a near-tie may flip), so the
port reports each cell's ``transcript_equal`` instead of failing on it.

The cells' lines go to stderr, then ONE JSON line: the readings (ms) under
the JAX names (``exact``, ``spec k=K``, ``self k=K``), the JAX script's
summary (``ms_per_token_exact``, ``decode_len``, ``cells``), ``device``,
``launches`` and ``graph_captures_timed``. Runs on ``cuda`` unless
``WCA_PLATFORM=cpu``; without a card it exits non-zero and prints no line.

Knobs (env, the JAX script's): WCA_SPEC_DECODE_LEN (224), WCA_SPEC_KS
("2,4,8"), WCA_SPEC_REPS (3), WCA_SPEC_TINY=1 (tiny dims, CPU-friendly).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..bench import device_label, log, platform_device
from ..config import MODEL_DIMS, ModelDims, tiny_test_dims
from ..models import decoding, whisper as wmodel
from ..text.tokenizer import get_test_tokenizer
from ._profile import Readings

TINY = os.environ.get("WCA_SPEC_TINY") == "1"
DECODE_LEN = int(os.environ.get("WCA_SPEC_DECODE_LEN",
                                "8" if TINY else "224"))
KS = [int(x) for x in os.environ.get(
    "WCA_SPEC_KS", "2,4" if TINY else "2,4,8").split(",")]
REPS = int(os.environ.get("WCA_SPEC_REPS", "2" if TINY else "3"))


def tiny_draft_dims(dims: ModelDims) -> ModelDims:
    """A Whisper-tiny-shaped draft sharing the target's vocabulary and mel
    geometry."""
    if TINY:
        return ModelDims(
            n_mels=dims.n_mels, n_audio_ctx=dims.n_audio_ctx,
            n_audio_state=dims.n_audio_state // 2,
            n_audio_head=max(1, dims.n_audio_head // 2), n_audio_layer=1,
            n_vocab=dims.n_vocab, n_text_ctx=dims.n_text_ctx,
            n_text_state=dims.n_text_state // 2,
            n_text_head=max(1, dims.n_text_head // 2), n_text_layer=1)
    return ModelDims(n_mels=dims.n_mels, n_audio_ctx=dims.n_audio_ctx,
                     n_audio_state=384, n_audio_head=6, n_audio_layer=4,
                     n_vocab=dims.n_vocab, n_text_ctx=dims.n_text_ctx,
                     n_text_state=384, n_text_head=6, n_text_layer=4)


def _model(dims: ModelDims, seed: int, device) -> wmodel.Whisper:
    gen = torch.Generator(device=device).manual_seed(seed)
    return wmodel.init_params(
        wmodel.Whisper(dims, device=device, dtype=torch.bfloat16), gen)


def main() -> None:
    device = platform_device()
    log(f"devices: {device_label(device)}")
    tok = get_test_tokenizer()
    if TINY:
        dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=24,
                              n_text_ctx=24, state=16, head=2, layers=2)
    else:
        dims = dataclasses.replace(MODEL_DIMS["medium"], n_vocab=tok.n_vocab)
    ddims = tiny_draft_dims(dims)
    log(f"target layers={dims.n_text_layer} d={dims.n_text_state}; "
        f"draft layers={ddims.n_text_layer} d={ddims.n_text_state}; "
        f"decode_len={DECODE_LEN} ks={KS}")
    model = _model(dims, 0, device)
    draft = _model(ddims, 7, device)
    mel = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (dims.n_mels, 2 * dims.n_audio_ctx)).astype(np.float32)
    ).to(device)
    opts = decoding.DecodingOptions(language="en", sample_len=DECODE_LEN)
    r = Readings("profile_speculative", device)

    t_exact, res = r.time(
        "exact", lambda: decoding.decode(model, tok, mel, opts, device=device),
        iters=REPS)
    steps = res.n_steps - len(tok.sot_sequence) + 1
    ms_tok_exact = 1e3 * t_exact / max(steps, 1)
    log(f"exact: {t_exact * 1e3:.1f} ms for {steps} tokens -> "
        f"{ms_tok_exact:.2f} ms/token")

    cells = []
    for mode, dr in (("spec", draft), ("self", model)):
        for k in KS:
            t, (sres, info) = r.time(
                f"{mode} k={k}", lambda dr=dr, k=k: decoding.decode_speculative(
                    model, dr, tok, mel, opts, draft_k=k, return_info=True,
                    device=device),
                iters=REPS)
            n_r = info["n_rounds"]
            c_mean = steps / max(n_r, 1)
            equal = sres.tokens == res.tokens
            cell = {"mode": mode, "k": k, "s": t, "rounds": n_r,
                    "committed_per_round": c_mean, "transcript_equal": equal}
            if mode == "spec":
                t_round = 1e3 * t / max(n_r, 1)
                proj = t_round / (k + 1)  # ms/token at acceptance 1
                cell.update(t_round_ms=t_round, ms_per_token_proj_or_meas=proj)
                log(f"spec k={k}: {t * 1e3:.1f} ms, rounds={n_r} "
                    f"(committed/round {c_mean:.2f}), t_round={t_round:.2f} "
                    f"ms, projected ms/token at full acceptance {proj:.2f} "
                    f"({ms_tok_exact / proj:.2f}x exact); transcript equal "
                    f"to greedy: {equal}")
            else:
                ms_tok = 1e3 * t / max(steps, 1)
                cell.update(t_round_ms=None, ms_per_token_proj_or_meas=ms_tok)
                log(f"self k={k}: {t * 1e3:.1f} ms ({ms_tok:.2f} ms/token, "
                    f"{ms_tok_exact / ms_tok:.2f}x exact), rounds={n_r} "
                    f"(committed/round {c_mean:.2f}); transcript equal to "
                    f"greedy: {equal}")
            cells.append(cell)
    r.extra.update(ms_per_token_exact=ms_tok_exact, decode_len=DECODE_LEN,
                   cells=cells)
    r.emit()


if __name__ == "__main__":
    main()
