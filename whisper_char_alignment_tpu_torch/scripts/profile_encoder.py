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
and ``mlp="flat"`` runs each MLP linear as one (B*T, d) product. The two
int8 lines run the same encoder on ``whisper.quantize_encoder_int8``'s copy
(each linear the int8 kernels around the library int8 product).

Each variant's warm call runs it once; the reading is the least of 5 timed
calls. The JAX lines go to stderr, then ONE JSON line: the readings (ms)
under the JAX names, ``device``, ``launches`` and ``graph_captures_timed``.
Runs on ``cuda`` unless ``WCA_PLATFORM=cpu``; without a card it exits
non-zero and prints no line.

Knobs (env, the JAX script's): B (32), MODEL (medium).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..bench import build_model, device_label, log, platform_device
from ..config import MODEL_DIMS
from ..models import whisper as wmodel
from ._profile import Readings

B = int(os.environ.get("B", "32"))
dims = MODEL_DIMS[os.environ.get("MODEL", "medium")]


def make_encoder(convs=True, attn="fused", mlp=True, n_layers=None,
                 dtype=torch.bfloat16):
    """The encoder with sub-stages switched: returns ``run(model, mel)`` ->
    the encoder states (B, n_audio_ctx, d). The model's parameters are in
    ``dtype``."""

    @torch.no_grad()
    def run(model, mel):
        enc = model.encoder
        x = mel.to(dtype)
        if convs:
            x = F.gelu(enc.conv1(x))
            x = F.gelu(enc.conv2(x))
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
                                                       n_valid=t)
                elif attn == "xla":
                    a, _ = wmodel._qkv_attention(blk.attn, h_in, None)
                elif attn == "proj_only":
                    # q/k/v/out projections without the attention math:
                    # isolates the 4 d^2 products from the (T, T) part
                    q = wmodel._linear(blk.attn.query, h_in)
                    k = wmodel._linear(blk.attn.key, h_in)
                    v = wmodel._linear(blk.attn.value, h_in)
                    a = wmodel._linear(blk.attn.out, q + k + v)
                else:
                    raise ValueError(f"unknown attention {attn!r}")
                x = x + a
            if mlp == "flat":
                # one (B*T, d) product per linear instead of a (B, T, d) one
                h = wmodel._layer_norm(blk.mlp_ln, x)
                hf = h.reshape(-1, h.shape[-1])
                hf = wmodel._linear(blk.mlp[2], F.gelu(
                    wmodel._linear(blk.mlp[0], hf)))
                x = x + hf.reshape(x.shape)
            elif mlp:
                x = x + wmodel._mlp(blk, x)
        return wmodel._layer_norm(enc.ln_post, x)

    return run


def main() -> None:
    device = platform_device()
    log(f"devices: {device_label(device)} B={B} dims={dims.n_audio_state}x"
        f"{dims.n_audio_layer}")
    model = build_model(dims, device)
    mel = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (B, dims.n_mels, 2 * dims.n_audio_ctx)).astype(np.float32)
    ).to(device=device, dtype=torch.bfloat16)
    r = Readings("profile_encoder", device)
    variants = [
        ("full (fused attn)", make_encoder()),
        ("full (xla attn)", make_encoder(attn="xla")),
        ("convs only (0 layers)", make_encoder(n_layers=0)),
        ("no convs", make_encoder(convs=False)),
        ("attn proj only (no T^2)", make_encoder(attn="proj_only")),
        ("no attn (mlp only)", make_encoder(attn="none")),
        ("no mlp", make_encoder(mlp=False)),
        ("full, mlp flattened (B*T)", make_encoder(mlp="flat")),
        ("mlp only, flattened", make_encoder(attn="none", mlp="flat")),
    ]
    for name, fn in variants:
        r.time(name, lambda f=fn: f(model, mel), iters=5, width=34)

    model_q = wmodel.quantize_encoder_int8(model)
    enc_full = make_encoder()
    enc_noattn_core = make_encoder(attn="proj_only")
    r.time("full int8 (fused attn)", lambda: enc_full(model_q, mel), iters=5,
           width=34)
    r.time("int8 proj only (no T^2)", lambda: enc_noattn_core(model_q, mel),
           iters=5, width=34)
    r.emit()


if __name__ == "__main__":
    main()
