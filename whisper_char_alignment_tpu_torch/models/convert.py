"""Weights into the port's :class:`~.whisper.Whisper` module.

Counterpart of ``whisper_char_alignment_tpu/models/convert.py``. The port's
module tree uses OpenAI whisper's own parameter names, so:

- :func:`load_checkpoint` reads an OpenAI ``.pt`` file
  (``{"dims": ..., "model_state_dict": ...}``) with a plain ``torch.load``;
- :func:`params_from_jax` turns the JAX package's parameter pytree (numpy
  arrays; layers stacked on axis 0; dense weights stored (in, out); conv
  weights already (C_out, C_in, K)) into the port's ``state_dict``, which is
  how the tests carry the same weights across.

HF safetensors and ``.npz`` exports are read by a later slice.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..config import ModelDims
from ..utils.device import resolve_device
from ..utils.unported import not_ported
from .whisper import Whisper, sinusoids

_ATTN_NAMES = (("query", "q"), ("key", "k"), ("value", "v"), ("out", "out"))


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX parameter pytree (numpy or array-likes) -> the port's state_dict
    (float32 CPU tensors, OpenAI whisper names)."""
    sd: Dict[str, torch.Tensor] = {}

    def put(name, arr):
        sd[name] = torch.from_numpy(np.array(arr, dtype=np.float32,
                                             order="C", copy=True))

    def put_dense(prefix, d, i):
        put(f"{prefix}.weight", np.asarray(d["w"])[i].T)
        if "b" in d:
            put(f"{prefix}.bias", np.asarray(d["b"])[i])

    def put_ln(prefix, d, i=None):
        sel = (lambda a: np.asarray(a)) if i is None else (
            lambda a: np.asarray(a)[i])
        put(f"{prefix}.weight", sel(d["scale"]))
        put(f"{prefix}.bias", sel(d["bias"]))

    def put_block(prefix, blocks, i, cross):
        put_ln(f"{prefix}.attn_ln", blocks["attn_ln"], i)
        for ours, theirs in _ATTN_NAMES:
            put_dense(f"{prefix}.attn.{ours}", blocks["attn"][theirs], i)
        if cross:
            put_ln(f"{prefix}.cross_attn_ln", blocks["cross_attn_ln"], i)
            for ours, theirs in _ATTN_NAMES:
                put_dense(f"{prefix}.cross_attn.{ours}",
                          blocks["cross_attn"][theirs], i)
        put_ln(f"{prefix}.mlp_ln", blocks["mlp_ln"], i)
        put_dense(f"{prefix}.mlp.0", blocks["mlp"]["fc1"], i)
        put_dense(f"{prefix}.mlp.2", blocks["mlp"]["fc2"], i)

    enc, dec = tree["encoder"], tree["decoder"]
    for c in ("conv1", "conv2"):
        put(f"encoder.{c}.weight", enc[c]["w"])
        put(f"encoder.{c}.bias", enc[c]["b"])
    put("encoder.positional_embedding", enc["pos_emb"])
    n_enc = np.asarray(enc["blocks"]["attn_ln"]["scale"]).shape[0]
    for i in range(n_enc):
        put_block(f"encoder.blocks.{i}", enc["blocks"], i, cross=False)
    put_ln("encoder.ln_post", enc["ln_post"])
    put("decoder.token_embedding.weight", dec["tok_emb"])
    put("decoder.positional_embedding", dec["pos_emb"])
    n_dec = np.asarray(dec["blocks"]["attn_ln"]["scale"]).shape[0]
    for i in range(n_dec):
        put_block(f"decoder.blocks.{i}", dec["blocks"], i, cross=True)
    put_ln("decoder.ln", dec["ln"])
    return sd


def model_from_state_dict(sd: Dict[str, torch.Tensor], dims: ModelDims,
                          device=None, dtype=torch.float32) -> Whisper:
    """A :class:`Whisper` on ``device`` (cuda unless 'cpu' is asked for)
    holding ``sd``. A checkpoint without ``encoder.positional_embedding``
    gets the sinusoids."""
    dev = resolve_device(device)
    sd = dict(sd)
    if "encoder.positional_embedding" not in sd:
        sd["encoder.positional_embedding"] = torch.from_numpy(
            sinusoids(dims.n_audio_ctx, dims.n_audio_state))
    model = Whisper(dims, device=dev, dtype=dtype)
    model.load_state_dict({k: v.to(dtype) for k, v in sd.items()})
    return model


def load_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], ModelDims]:
    """Read an OpenAI whisper ``.pt`` checkpoint -> (state_dict, dims)."""
    ext = os.path.splitext(path)[1]
    if ext != ".pt":
        raise not_ported(f"reading {ext or 'a directory'} checkpoints "
                         f"({path})", "checkpoints")
    # weights_only: the format is dicts of tensors and ints, no code objects
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    d = ckpt["dims"]
    dims = ModelDims(**{k: d[k] for k in ModelDims.__dataclass_fields__})
    sd = {k: v.float() for k, v in ckpt["model_state_dict"].items()}
    return sd, dims
