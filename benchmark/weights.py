"""Whisper weights made from the seed, on the device, in the served dtype.

Every parameter of one model lies in one flat buffer. The leaves that share
a distribution lie next to each other, so each distribution is one
``normal_`` call on the device's generator: dense weights N(0, 1/d_in),
convolutions N(0, 0.05^2), the token embedding N(0, 0.02^2), the decoder's
positions N(0, 0.01^2), every bias N(0, 0.02^2) and every LayerNorm scale
N(1, 0.1^2). The encoder's positions are the published sinusoids. Biases and
LayerNorm terms are drawn, not zero, so the check covers them.

The leaves carry openai-whisper's names; :func:`state_dict` hands the same
tensors to the port and to the plain reference.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """The published fixed encoder positions (float32)."""
    inc = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return torch.from_numpy(np.concatenate([np.sin(t), np.cos(t)], 1)
                            .astype(np.float32))


def _block(prefix: str, d: int, cross: bool) -> List[Tuple[str, tuple, str]]:
    out = []
    for attn in ("attn", "cross_attn") if cross else ("attn",):
        for proj in ("query", "key", "value", "out"):
            out.append((f"{prefix}.{attn}.{proj}.weight", (d, d), "w_in"))
            if proj != "key":
                out.append((f"{prefix}.{attn}.{proj}.bias", (d,), "bias"))
        out.append((f"{prefix}.{attn}_ln.weight", (d,), "ln"))
        out.append((f"{prefix}.{attn}_ln.bias", (d,), "bias"))
    out += [(f"{prefix}.mlp.0.weight", (4 * d, d), "w_in"),
            (f"{prefix}.mlp.0.bias", (4 * d,), "bias"),
            (f"{prefix}.mlp.2.weight", (d, 4 * d), "w_wide"),
            (f"{prefix}.mlp.2.bias", (d,), "bias"),
            (f"{prefix}.mlp_ln.weight", (d,), "ln"),
            (f"{prefix}.mlp_ln.bias", (d,), "bias")]
    return out


def layout(dims: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, distribution) of every leaf of a Whisper model with
    ``dims`` (the configuration file's keys)."""
    d = dims["d_model"]
    out = [("encoder.conv1.weight", (d, dims["num_mel_bins"], 3), "conv"),
           ("encoder.conv1.bias", (d,), "bias"),
           ("encoder.conv2.weight", (d, d, 3), "conv"),
           ("encoder.conv2.bias", (d,), "bias")]
    for i in range(dims["encoder_layers"]):
        out += _block(f"encoder.blocks.{i}", d, False)
    out += [("encoder.ln_post.weight", (d,), "ln"),
            ("encoder.ln_post.bias", (d,), "bias"),
            ("decoder.token_embedding.weight", (dims["vocab_size"], d),
             "embed"),
            ("decoder.positional_embedding",
             (dims["max_target_positions"], d), "pos")]
    for i in range(dims["decoder_layers"]):
        out += _block(f"decoder.blocks.{i}", d, True)
    out += [("decoder.ln.weight", (d,), "ln"), ("decoder.ln.bias", (d,), "bias")]
    return out


def distributions(dims: dict) -> Dict[str, Tuple[float, float]]:
    """(mean, std) of each distribution."""
    d = dims["d_model"]
    return {"w_in": (0.0, d ** -0.5), "w_wide": (0.0, (4 * d) ** -0.5),
            "conv": (0.0, 0.05), "embed": (0.0, 0.02), "pos": (0.0, 0.01),
            "bias": (0.0, 0.02), "ln": (1.0, 0.1)}


def state_dict(dims: dict, seed: int, device, dtype=torch.bfloat16
               ) -> Dict[str, torch.Tensor]:
    """Every leaf, a view of one flat ``dtype`` buffer on ``device`` drawn
    from a generator on that device seeded with ``seed``; the encoder's
    positions are added in ``dtype``."""
    leaves = layout(dims)
    groups: Dict[str, List[Tuple[str, tuple]]] = {}
    for name, shape, dist in leaves:
        groups.setdefault(dist, []).append((name, shape))
    total = sum(int(np.prod(s)) for _, s, _ in leaves)
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    views, off = {}, 0
    for dist, members in groups.items():
        start = off
        for name, shape in members:
            n = int(np.prod(shape))
            views[name] = flat[off:off + n].view(shape)
            off += n
        mean, std = distributions(dims)[dist]
        flat[start:off].normal_(mean, std, generator=gen)
    sd = {name: views[name] for name, _, _ in leaves}
    sd["encoder.positional_embedding"] = sinusoids(
        dims["max_source_positions"], dims["d_model"]).to(device, dtype)
    return sd
