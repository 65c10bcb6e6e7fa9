"""Where the encoder's time goes (port of the repository's
``scripts/profile_encoder.py``): a sub-stage ablation at Whisper-medium
width, B=32: the convolutions alone, the blocks without attention or
without the MLP, and each attention implementation.

    python -m whisper_char_alignment_tpu_torch.scripts.profile_encoder
    B=8 MODEL=small python -m whisper_char_alignment_tpu_torch.scripts.profile_encoder

:func:`make_encoder` builds the encoder from the model's own helpers
(``models/whisper.py``); its attention is
  "fused"      the encoder self-attention kernel
               (``whisper._encoder_self_attention``, ``csrc/encoder_attn.cu``)
  "xla"        the plain attention (``whisper._qkv_attention``: f32 scores,
               softmax and P v in PyTorch)
  "proj_only"  the q/k/v/out projections without the (T, T) part
  "none"       no attention
and ``mlp="flat"`` runs each MLP linear as one (B*T, d) library product.
The two int8 lines run the same encoder on
``whisper.quantize_encoder_int8``'s copy (each linear the int8 kernels
around the library int8 product). The float linears and convolutions run
as ``ENC_LINEAR`` says: ``utterance`` (default, ``encode_audio``'s: one
library call per utterance, so a row does not depend on the batch),
``batch`` (one library call over the batch) or ``rows`` (the row-invariant
linear kernel, ``ops/rows_linear_cuda.py``, over the batch; convolutions
per utterance).

Each variant's warm call runs it once; the reading is the least of 5 timed
calls. The JAX lines go to stderr, then ONE JSON line: the readings (ms)
under the JAX names, ``device``, ``launches`` and ``graph_captures_timed``.
Runs on ``cuda`` unless ``WCA_PLATFORM=cpu``; without a card it exits
non-zero and prints no line.

Knobs (env): the JAX script's B (32) and MODEL (medium); ENC_LINEAR
(utterance).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..bench import build_model, device_label, log, platform_device
from ..config import MODEL_DIMS
from ..models import whisper as wmodel
from ..utils import device
from ._profile import Readings

B = int(os.environ.get("B", "32"))
dims = MODEL_DIMS[os.environ.get("MODEL", "medium")]
ENC_LINEAR = os.environ.get("ENC_LINEAR", "utterance")


def _linear_and_convs(mode: str):
    """(linear, per-utterance wrapper) of the encoder for ``ENC_LINEAR``."""
    if mode == "utterance":
        return wmodel._encoder_linear, device.per_utterance
    if mode == "batch":
        return (lambda lin, x: F.linear(x, lin.weight, lin.bias)
                if type(lin) is torch.nn.Linear else wmodel._linear(lin, x),
                lambda fn, x: fn(x))
    if mode == "rows":
        return wmodel._linear, device.per_utterance
    raise ValueError(f"ENC_LINEAR={mode!r}: use utterance, batch or rows")


def make_encoder(convs=True, attn="fused", mlp=True, n_layers=None,
                 dtype=torch.bfloat16, linear_mode="utterance"):
    """The encoder with sub-stages switched: returns ``run(model, mel)`` ->
    the encoder states (B, n_audio_ctx, d). The model's parameters are in
    ``dtype``; ``linear_mode`` is an ``ENC_LINEAR`` value."""
    linear, per_utterance = _linear_and_convs(linear_mode)

    @torch.no_grad()
    def run(model, mel):
        enc = model.encoder
        x = mel.to(dtype)
        if convs:
            x = F.gelu(per_utterance(enc.conv1, x))
            x = F.gelu(per_utterance(enc.conv2, x))
            x = x.transpose(1, 2)
        else:
            x = torch.zeros((mel.shape[0], dims.n_audio_ctx,
                             dims.n_audio_state), dtype=dtype,
                            device=mel.device)
        x = x + enc.positional_embedding.to(dtype)
        t = x.shape[1]
        nl = len(enc.blocks) if n_layers is None else n_layers
        for blk in list(enc.blocks)[:nl]:
            if attn != "none":
                h_in = wmodel._layer_norm(blk.attn_ln, x)
                if attn == "fused":
                    a = wmodel._encoder_self_attention(blk.attn, h_in,
                                                       n_valid=t,
                                                       linear=linear)
                elif attn == "xla":
                    a, _ = wmodel._qkv_attention(blk.attn, h_in, None)
                elif attn == "proj_only":
                    # q/k/v/out projections without the attention math:
                    # isolates the 4 d^2 products from the (T, T) part
                    q = linear(blk.attn.query, h_in)
                    k = linear(blk.attn.key, h_in)
                    v = linear(blk.attn.value, h_in)
                    a = linear(blk.attn.out, q + k + v)
                else:
                    raise ValueError(f"unknown attention {attn!r}")
                x = x + a
            if mlp == "flat":
                # one (B*T, d) product per linear instead of a (B, T, d) one
                h = wmodel._layer_norm(blk.mlp_ln, x)
                hf = h.reshape(-1, h.shape[-1])
                fc1, fc2 = blk.mlp[0], blk.mlp[2]
                hf = F.linear(F.gelu(F.linear(hf, fc1.weight, fc1.bias)),
                              fc2.weight, fc2.bias)
                x = x + hf.reshape(x.shape)
            elif mlp:
                x = x + wmodel._mlp(blk, x, linear)
        return wmodel._layer_norm(enc.ln_post, x)

    return run


def main() -> None:
    device = platform_device()
    log(f"devices: {device_label(device)} B={B} dims={dims.n_audio_state}x"
        f"{dims.n_audio_layer} ENC_LINEAR={ENC_LINEAR}")
    model = build_model(dims, device)
    mel = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (B, dims.n_mels, 2 * dims.n_audio_ctx)).astype(np.float32)
    ).to(device=device, dtype=torch.bfloat16)
    r = Readings("profile_encoder", device)
    mode = ENC_LINEAR
    variants = [
        ("full (fused attn)", make_encoder(linear_mode=mode)),
        ("full (xla attn)", make_encoder(attn="xla", linear_mode=mode)),
        ("convs only (0 layers)", make_encoder(n_layers=0, linear_mode=mode)),
        ("no convs", make_encoder(convs=False, linear_mode=mode)),
        ("attn proj only (no T^2)", make_encoder(attn="proj_only",
                                                 linear_mode=mode)),
        ("no attn (mlp only)", make_encoder(attn="none", linear_mode=mode)),
        ("no mlp", make_encoder(mlp=False, linear_mode=mode)),
        ("full, mlp flattened (B*T)", make_encoder(mlp="flat",
                                                   linear_mode=mode)),
        ("mlp only, flattened", make_encoder(attn="none", mlp="flat",
                                             linear_mode=mode)),
    ]
    for name, fn in variants:
        r.time(name, lambda f=fn: f(model, mel), iters=5, width=34)

    model_q = wmodel.quantize_encoder_int8(model)
    enc_full = make_encoder(linear_mode=ENC_LINEAR)
    enc_noattn_core = make_encoder(attn="proj_only", linear_mode=ENC_LINEAR)
    r.time("full int8 (fused attn)", lambda: enc_full(model_q, mel), iters=5,
           width=34)
    r.time("int8 proj only (no T^2)", lambda: enc_noattn_core(model_q, mel),
           iters=5, width=34)
    r.emit()


if __name__ == "__main__":
    main()
