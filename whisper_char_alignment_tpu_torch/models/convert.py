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
  how the tests carry the same weights across. A tree quantized by JAX
  ``quantize_encoder_int8`` carries its int8 ``w8`` (L, in, out) and
  float32 ``s`` (L, 1, out) across as they are, and
  :func:`model_from_state_dict` builds the int8 encoder for them.

The writers are the JAX package's (JAX ``models/convert.py:117-185,
250-313, 386-390``), taking a :class:`Whisper`: :func:`save_openai_pt`
(the published ``.pt`` layout, the model's dtype or ``dtype``),
:func:`save_hf_safetensors` (HF names, float32) and :func:`save_npz` (the
JAX pytree of :func:`params_to_jax`, int8 encoders included). An int8
encoder has no ``.pt`` or HF layout, so those two refuse it.
:func:`from_hf_model` reads a live HF model (anything with ``.config`` and
``.state_dict()``); the port never imports ``transformers`` itself.

Orbax checkpoint directories stay with the JAX package (ROADMAP.md,
"Departures kept on purpose").
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import MODEL_DIMS, ModelDims
from ..utils.device import resolve_device
from .whisper import (Whisper, encoder_is_int8, quantize_encoder_int8,
                      sinusoids)

_ATTN_NAMES = (("query", "q"), ("key", "k"), ("value", "v"), ("out", "out"))


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX parameter pytree (numpy or array-likes) -> the port's state_dict
    (float32 CPU tensors, OpenAI whisper names; int8 ``w8`` codes stay
    int8)."""
    sd: Dict[str, torch.Tensor] = {}

    def put(name, arr):
        sd[name] = torch.from_numpy(np.array(arr, dtype=np.float32,
                                             order="C", copy=True))

    def put_dense(prefix, d, i):
        if "w8" in d:
            sd[f"{prefix}.w8"] = torch.from_numpy(np.ascontiguousarray(
                np.asarray(d["w8"])[i].T.astype(np.int8)))
            put(f"{prefix}.s", np.asarray(d["s"])[i, 0])
        else:
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


def params_to_jax(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`: the port's state_dict -> the
    JAX parameter pytree as numpy arrays (float leaves float32, layers
    stacked on axis 0, dense weights (in, out), conv weights (C_out, C_in,
    K)). An int8 encoder's ``w8`` goes back as (L, in, out) int8 and its
    ``s`` as (L, 1, out) float32, as JAX ``quantize_encoder_int8`` holds
    them."""
    def arr(name):
        return _numpy_copy(sd[name], torch.float32)

    def dense(prefix):
        if f"{prefix}.w8" in sd:
            d = {"w8": _numpy_copy(sd[f"{prefix}.w8"], torch.int8).T,
                 "s": arr(f"{prefix}.s")[None, :]}
        else:
            d = {"w": arr(f"{prefix}.weight").T}
        if f"{prefix}.bias" in sd:
            d["b"] = arr(f"{prefix}.bias")
        return d

    def ln(prefix):
        return {"scale": arr(f"{prefix}.weight"), "bias": arr(f"{prefix}.bias")}

    def block(prefix, cross):
        b = {"attn_ln": ln(f"{prefix}.attn_ln"),
             "attn": {theirs: dense(f"{prefix}.attn.{ours}")
                      for ours, theirs in _ATTN_NAMES},
             "mlp_ln": ln(f"{prefix}.mlp_ln"),
             "mlp": {"fc1": dense(f"{prefix}.mlp.0"),
                     "fc2": dense(f"{prefix}.mlp.2")}}
        if cross:
            b["cross_attn_ln"] = ln(f"{prefix}.cross_attn_ln")
            b["cross_attn"] = {theirs: dense(f"{prefix}.cross_attn.{ours}")
                               for ours, theirs in _ATTN_NAMES}
        return b

    def stack(side, cross):
        n = len({k.split(".")[2] for k in sd
                 if k.startswith(f"{side}.blocks.")})
        layers = [block(f"{side}.blocks.{i}", cross) for i in range(n)]

        def merge(nodes):
            if isinstance(nodes[0], dict):
                return {k: merge([n[k] for n in nodes]) for k in nodes[0]}
            return np.ascontiguousarray(np.stack(nodes))
        return merge(layers)

    return {
        "encoder": {
            "conv1": {"w": arr("encoder.conv1.weight"),
                      "b": arr("encoder.conv1.bias")},
            "conv2": {"w": arr("encoder.conv2.weight"),
                      "b": arr("encoder.conv2.bias")},
            "pos_emb": arr("encoder.positional_embedding"),
            "blocks": stack("encoder", False),
            "ln_post": ln("encoder.ln_post"),
        },
        "decoder": {
            "tok_emb": arr("decoder.token_embedding.weight"),
            "pos_emb": arr("decoder.positional_embedding"),
            "blocks": stack("decoder", True),
            "ln": ln("decoder.ln"),
        },
    }


def _numpy_copy(t: torch.Tensor, dtype: torch.dtype) -> np.ndarray:
    """A CPU copy of ``t`` in ``dtype`` as numpy, never a view of a live
    parameter."""
    return t.detach().to(device="cpu", dtype=dtype, copy=True).numpy()


def _whole_state_dict(model: Whisper, fmt: str) -> Dict[str, torch.Tensor]:
    """The model's state_dict, refusing what ``fmt`` cannot hold: a
    tensor-parallel rank's shard, and (``fmt`` not ``.npz``) an int8
    encoder, whose ``w8``/``s`` leaves have no published layout."""
    if getattr(model, "tp_group", None) is not None:
        raise ValueError("the model is a tensor-parallel rank's shard; write "
                         "the whole model")
    if fmt != ".npz" and encoder_is_int8(model):
        raise ValueError(f"{fmt} cannot hold an int8 encoder (w8/s leaves); "
                         "write it with save_npz (.npz)")
    return model.state_dict()


def to_openai_state_dict(model: Whisper, dtype: Optional[torch.dtype] = None
                         ) -> Dict[str, torch.Tensor]:
    """The model's OpenAI-whisper-layout state dict (the port's own names):
    CPU copies in the model's dtype or ``dtype``. Raises ``ValueError`` for
    an int8 encoder."""
    return {k: v.detach().to(device="cpu", dtype=dtype or v.dtype, copy=True)
            for k, v in _whole_state_dict(model, ".pt").items()}


def save_openai_pt(path: str, model: Whisper,
                   dtype: Optional[torch.dtype] = None) -> None:
    """Write the published OpenAI checkpoint format, a ``torch.save`` of
    ``{"dims": {...}, "model_state_dict": {tensors}}`` (the published files
    are float16: pass ``dtype=torch.float16``)."""
    dims = {f: getattr(model.dims, f) for f in ModelDims.__dataclass_fields__}
    torch.save({"dims": dims,
                "model_state_dict": to_openai_state_dict(model, dtype)}, path)


def _fit_mlp_width(side, sd, name: str, device, dtype) -> None:
    """Give ``side``'s blocks the checkpoint's MLP width where it is not
    Whisper's 4 x d_model (an HF config sets its own ``*_ffn_dim``)."""
    key = next((f"{name}.blocks.0.mlp.0.{leaf}" for leaf in ("weight", "w8")
                if f"{name}.blocks.0.mlp.0.{leaf}" in sd), None)
    if key is None or sd[key].shape[0] == side.blocks[0].mlp[0].out_features:
        return
    n_mlp, d = sd[key].shape
    for blk in side.blocks:
        blk.mlp[0] = nn.Linear(d, n_mlp, device=device, dtype=dtype)
        blk.mlp[2] = nn.Linear(n_mlp, d, device=device, dtype=dtype)


def model_from_state_dict(sd: Dict[str, torch.Tensor], dims: ModelDims,
                          device=None, dtype=torch.float32) -> Whisper:
    """A :class:`Whisper` on ``device`` (cuda unless 'cpu' is asked for)
    holding ``sd``. A checkpoint without ``encoder.positional_embedding``
    gets the sinusoids; one with int8 ``w8`` leaves gets the int8 encoder,
    its codes int8 and its scales float32."""
    dev = resolve_device(device)
    sd = dict(sd)
    if "encoder.positional_embedding" not in sd:
        sd["encoder.positional_embedding"] = torch.from_numpy(
            sinusoids(dims.n_audio_ctx, dims.n_audio_state))
    model = Whisper(dims, device=dev, dtype=dtype)
    for name in ("encoder", "decoder"):
        _fit_mlp_width(getattr(model, name), sd, name, dev, dtype)
    if any(k.endswith(".w8") for k in sd):
        model = quantize_encoder_int8(model)
    model.load_state_dict({
        k: (v.to(dtype) if v.is_floating_point() and not k.endswith(".s")
            else v) for k, v in sd.items()})
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


# OpenAI whisper's names (the port's) -> HF's, the inverse of _HF_RENAMES
_OPENAI_RENAMES = (
    (r"^encoder\.positional_embedding$", "encoder.embed_positions.weight"),
    (r"^decoder\.positional_embedding$", "decoder.embed_positions.weight"),
    (r"^decoder\.token_embedding\.", "decoder.embed_tokens."),
    (r"^encoder\.ln_post\.", "encoder.layer_norm."),
    (r"^decoder\.ln\.", "decoder.layer_norm."),
    (r"\.blocks\.", ".layers."),
    (r"\.attn_ln\.", ".self_attn_layer_norm."),
    (r"\.cross_attn_ln\.", ".encoder_attn_layer_norm."),
    (r"\.mlp_ln\.", ".final_layer_norm."),
    (r"\.attn\.", ".self_attn."),
    (r"\.cross_attn\.", ".encoder_attn."),
    (r"\.query\.", ".q_proj."),
    (r"\.key\.", ".k_proj."),
    (r"\.value\.", ".v_proj."),
    (r"\.out\.", ".out_proj."),
    (r"\.mlp\.0\.", ".fc1."),
    (r"\.mlp\.2\.", ".fc2."),
)


def dims_from_hf_config(cfg) -> ModelDims:
    """ModelDims of an HF ``WhisperConfig`` (JAX ``models/convert.py:188``)."""
    return ModelDims(
        n_mels=cfg.num_mel_bins,
        n_audio_ctx=cfg.max_source_positions,
        n_audio_state=cfg.d_model,
        n_audio_head=cfg.encoder_attention_heads,
        n_audio_layer=cfg.encoder_layers,
        n_vocab=cfg.vocab_size,
        n_text_ctx=cfg.max_target_positions,
        n_text_state=cfg.d_model,
        n_text_head=cfg.decoder_attention_heads,
        n_text_layer=cfg.decoder_layers,
    )


def to_hf_state_dict(model: Whisper) -> Dict[str, np.ndarray]:
    """The model in HF ``WhisperForConditionalGeneration``'s layout, float32
    numpy arrays with the ``model.`` prefix. No ``proj_out`` (tied to the
    token embedding, as in the published HF models) and no key bias
    (Whisper has none). Raises ``ValueError`` for an int8 encoder."""
    out = {}
    for name, v in _whole_state_dict(model, ".safetensors").items():
        for pattern, repl in _OPENAI_RENAMES:
            name = re.sub(pattern, repl, name)
        out[f"model.{name}"] = _numpy_copy(v, torch.float32)
    return out


def save_hf_safetensors(path: str, model: Whisper) -> None:
    """Write the HF safetensors layout that :func:`load_checkpoint` reads
    (dims inferred from the shapes on load)."""
    from safetensors.numpy import save_file

    save_file(to_hf_state_dict(model), path)


def from_hf_model(model) -> Tuple[Dict[str, torch.Tensor], ModelDims]:
    """(state_dict, dims) of a live HF ``WhisperForConditionalGeneration``,
    or anything with its ``.config`` and ``.state_dict()``."""
    sd = {k: _numpy_copy(v, torch.float32)
          for k, v in model.state_dict().items()}
    return state_dict_from_hf(sd), dims_from_hf_config(model.config)


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


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A nested pytree -> the JAX ``.npz`` export's '/'-joined keys."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
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


def save_npz(path: str, model: Whisper) -> None:
    """Write the JAX package's ``.npz`` export: :func:`params_to_jax`'s tree
    under '/'-joined keys plus ``__dims__`` (int64), which JAX
    ``load_npz`` and :func:`load_checkpoint` both read. Int8 encoders
    included."""
    flat = _flatten(params_to_jax(_whole_state_dict(model, ".npz")))
    flat["__dims__"] = np.array([getattr(model.dims, f) for f in
                                 ModelDims.__dataclass_fields__], np.int64)
    np.savez(path, **flat)


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
