"""Weights into the port's :class:`~.whisper.Whisper` module.

Counterpart of ``whisper_char_alignment_tpu/models/convert.py``. The port's
module tree uses OpenAI whisper's own parameter names, so:

- :func:`load_checkpoint` reads an OpenAI ``.pt`` file
  (``{"dims": ..., "model_state_dict": ...}``) with a plain ``torch.load``,
  the JAX package's own ``.npz`` export (its parameter pytree, flattened)
  and an HF ``WhisperForConditionalGeneration`` ``.safetensors`` file,
  both through numpy (JAX ``models/convert.py:321-335, 386-398, 425-440``);
- :func:`params_from_jax` turns the JAX package's parameter pytree (numpy
  arrays; layers stacked on axis 0; dense weights stored (in, out); conv
  weights already (C_out, C_in, K)) into the port's ``state_dict``, which is
  how the tests carry the same weights across.

Orbax checkpoint directories stay with the JAX package (ROADMAP.md,
"Departures kept on purpose").
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..config import MODEL_DIMS, ModelDims
from ..utils.device import resolve_device
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


# HF WhisperForConditionalGeneration names -> OpenAI whisper's (the port's)
_HF_RENAMES = (
    (r"encoder\.embed_positions\.weight$", "encoder.positional_embedding"),
    (r"decoder\.embed_positions\.weight$", "decoder.positional_embedding"),
    (r"decoder\.embed_tokens\.", "decoder.token_embedding."),
    (r"encoder\.layer_norm\.", "encoder.ln_post."),
    (r"decoder\.layer_norm\.", "decoder.ln."),
    (r"\.layers\.", ".blocks."),
    (r"\.self_attn_layer_norm\.", ".attn_ln."),
    (r"\.encoder_attn_layer_norm\.", ".cross_attn_ln."),
    (r"\.final_layer_norm\.", ".mlp_ln."),
    (r"\.self_attn\.", ".attn."),
    (r"\.encoder_attn\.", ".cross_attn."),
    (r"\.q_proj\.", ".query."),
    (r"\.k_proj\.", ".key."),
    (r"\.v_proj\.", ".value."),
    (r"\.out_proj\.", ".out."),
    (r"\.fc1\.", ".mlp.0."),
    (r"\.fc2\.", ".mlp.2."),
)


def dims_from_hf_shapes(sd: Dict[str, Any]) -> ModelDims:
    """ModelDims of an HF-layout state dict, from its tensor shapes (JAX
    ``models/convert.py:328-357``). Head counts are not derivable from shapes
    alone; they come from the published size table (unique per (d_model,
    n_layers)), else 64-dimensional heads."""
    pre = "model." if any(k.startswith("model.") for k in sd) else ""
    n_vocab, d_model = sd[f"{pre}decoder.embed_tokens.weight"].shape
    n_mels = sd[f"{pre}encoder.conv1.weight"].shape[1]
    li = 3 if pre else 2  # ["model",] "encoder", "layers", "<idx>", ...
    enc_layers = len({k.split(".")[li] for k in sd
                      if k.startswith(f"{pre}encoder.layers.")})
    dec_layers = len({k.split(".")[li] for k in sd
                      if k.startswith(f"{pre}decoder.layers.")})
    n_audio_ctx = sd[f"{pre}encoder.embed_positions.weight"].shape[0]
    n_text_ctx = sd[f"{pre}decoder.embed_positions.weight"].shape[0]
    for d in MODEL_DIMS.values():
        if (d.n_audio_state, d.n_audio_layer, d.n_text_layer) == (
                d_model, enc_layers, dec_layers):
            n_head = d.n_audio_head
            break
    else:
        n_head = max(1, d_model // 64)  # whisper uses 64-dim heads throughout
    return ModelDims(n_mels=n_mels, n_audio_ctx=n_audio_ctx,
                     n_audio_state=d_model, n_audio_head=n_head,
                     n_audio_layer=enc_layers, n_vocab=n_vocab,
                     n_text_ctx=n_text_ctx, n_text_state=d_model,
                     n_text_head=n_head, n_text_layer=dec_layers)


def state_dict_from_hf(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """HF ``WhisperForConditionalGeneration`` state dict (numpy arrays) ->
    the port's state_dict (float32 CPU tensors). The output
    projection (``proj_out``, tied to the token embedding) and a key bias
    (Whisper has none) are not carried, as in JAX ``from_hf_state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    for key, arr in sd.items():
        name = key[len("model."):] if key.startswith("model.") else key
        if not name.startswith(("encoder.", "decoder.")) or name.endswith(
                "k_proj.bias"):
            continue
        for pattern, repl in _HF_RENAMES:
            name = re.sub(pattern, repl, name)
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32,
                                              order="C", copy=True))
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The JAX ``.npz`` export's '/'-joined keys -> its nested pytree."""
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], ModelDims]:
    """Read a checkpoint -> (state_dict, dims): an OpenAI whisper ``.pt``,
    the JAX package's ``.npz`` export or an HF ``.safetensors`` file."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory: Orbax checkpoints are read by the JAX "
            "package only (ROADMAP.md, 'Departures kept on purpose'); export "
            "them to .npz or .safetensors")
    ext = os.path.splitext(path)[1]
    if ext == ".pt":
        # weights_only: the format is dicts of tensors and ints, no code
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        d = ckpt["dims"]
        dims = ModelDims(**{k: d[k] for k in ModelDims.__dataclass_fields__})
        sd = {k: v.float() for k, v in ckpt["model_state_dict"].items()}
        return sd, dims
    if ext == ".npz":
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        dims = ModelDims(*[int(x) for x in flat.pop("__dims__")])
        return params_from_jax(_unflatten(flat)), dims
    if ext == ".safetensors":
        from safetensors.numpy import load_file

        sd = load_file(path)
        return state_dict_from_hf(sd), dims_from_hf_shapes(sd)
    raise ValueError(f"unsupported checkpoint format: {path}")
