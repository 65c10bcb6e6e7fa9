"""Whisper encoder/decoder as PyTorch modules (port of ``whisper_char_alignment_tpu/models/whisper.py``).

The module tree and parameter names are OpenAI whisper's own
(``encoder.blocks.N.attn.query.weight``, ...), so an OpenAI ``.pt``
checkpoint loads with ``load_state_dict`` as it is. Layers are an
``nn.ModuleList`` walked by a Python loop, where the JAX package stacks them
and scans.

The functions below keep the JAX package's names and public layouts:
attention stacks are (L, B, H, T, F), cross K/V (L, B, H, hd, F), the
self-attention cache (L, B, H, hd, ctx). They run where the model's
parameters lie; the compute dtype is the parameters' dtype (see
:func:`cast_params`).

Math parity notes (vs whisper.model and the JAX package):
- attention scales q and k each by ``head_dim ** -0.25``; scores, their
  softmax and P v are computed in float32 (the JAX package's
  ``preferred_element_type=float32``), probabilities cast to the compute
  dtype before P v;
- GELU is the exact erf form; LayerNorm eps 1e-5, computed in float32; the
  key projection has no bias; logits are tied to the token embedding.
- the encoder self-attention runs through the CUDA kernel of
  ``ops/encoder_attn_cuda.py``; each decoder layer's cross-attention logits
  through the QK post-process kernel of ``ops/qkpost_cuda.py`` when a median
  width is given, so the raw (L, B, H, T, F) logit stack is never held.
- the self-attention cache is updated in place (``index_copy_`` of one
  column per step, at a position held in a device tensor), where the JAX
  package returns a new cache; every step attends over the whole cache under
  a position mask, so its shapes are static and it can be captured in a CUDA
  graph (``models/decode_graph.py``).
- with int8 cross K/V (``precompute_cross_kv(..., quantize=True)``) a decode
  step's cross-attention runs as ``WCA_CROSS_ATTN`` says
  (:func:`cross_attn_mode`): the int8-product step (``mxu``), the kernel of
  ``ops/cross_attn_cuda.py`` (``pallas``), or dequantize-then-attend
  (``xla``); the prefill never takes the kernel.
- :func:`quantize_encoder_int8` swaps the encoder's attention projections
  and MLP for :class:`Int8Linear` layers: each activation row is quantized
  to int8, multiplied by the int8 weights into int32 and scaled back
  (``ops/int8_cuda.py``: two kernels around the library int8 product).
- under tensor parallelism (``parallel/mesh.shard_params``) each attention
  runs its rank's heads, and the row-split layers (:class:`SplitLinear`, a
  row-split :class:`Int8Linear`) all-reduce their partial products over the
  model group before adding the bias once.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelDims
from ..ops import int8_cuda
from ..ops.cross_attn_cuda import cross_attn_step_int8
from ..ops.encoder_attn_cuda import encoder_self_attention
from ..ops.qkpost_cuda import qk_postprocess
from ..utils.device import resolve_device

Cache = Dict[str, torch.Tensor]


def sinusoids(length: int, channels: int,
              max_timescale: float = 10000.0) -> np.ndarray:
    """Fixed sinusoidal position embedding (whisper.model.sinusoids)."""
    assert channels % 2 == 0
    log_timescale_increment = np.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)],
                          axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Modules (OpenAI whisper's names)
# ---------------------------------------------------------------------------

class MultiHeadAttention(nn.Module):
    def __init__(self, n_state: int, n_head: int, **factory):
        super().__init__()
        # heads this rank runs: all of them, or its share under tensor
        # parallelism; head_dim stays
        self.n_head = n_head
        self.head_dim = n_state // n_head
        self.query = nn.Linear(n_state, n_state, **factory)
        self.key = nn.Linear(n_state, n_state, bias=False, **factory)
        self.value = nn.Linear(n_state, n_state, **factory)
        self.out = nn.Linear(n_state, n_state, **factory)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, n_state: int, n_head: int, cross_attention: bool,
                 **factory):
        super().__init__()
        self.attn = MultiHeadAttention(n_state, n_head, **factory)
        self.attn_ln = nn.LayerNorm(n_state, **factory)
        self.cross_attn = (MultiHeadAttention(n_state, n_head, **factory)
                           if cross_attention else None)
        self.cross_attn_ln = (nn.LayerNorm(n_state, **factory)
                              if cross_attention else None)
        self.mlp = nn.Sequential(nn.Linear(n_state, 4 * n_state, **factory),
                                 nn.GELU(),
                                 nn.Linear(4 * n_state, n_state, **factory))
        self.mlp_ln = nn.LayerNorm(n_state, **factory)


class AudioEncoder(nn.Module):
    def __init__(self, dims: ModelDims, **factory):
        super().__init__()
        d = dims.n_audio_state
        self.conv1 = nn.Conv1d(dims.n_mels, d, kernel_size=3, padding=1,
                               **factory)
        self.conv2 = nn.Conv1d(d, d, kernel_size=3, stride=2, padding=1,
                               **factory)
        self.register_buffer("positional_embedding", torch.empty(
            dims.n_audio_ctx, d, **factory))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(d, dims.n_audio_head, False, **factory)
            for _ in range(dims.n_audio_layer))
        self.ln_post = nn.LayerNorm(d, **factory)


class TextDecoder(nn.Module):
    def __init__(self, dims: ModelDims, **factory):
        super().__init__()
        d = dims.n_text_state
        self.token_embedding = nn.Embedding(dims.n_vocab, d, **factory)
        self.positional_embedding = nn.Parameter(
            torch.empty(dims.n_text_ctx, d, **factory))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(d, dims.n_text_head, True, **factory)
            for _ in range(dims.n_text_layer))
        self.ln = nn.LayerNorm(d, **factory)


class Int8Linear(nn.Module):
    """An encoder linear with per-output-channel int8 weights (JAX
    ``quantize_encoder_int8``'s leaves): ``w8`` (out, in) int8 codes (JAX's
    (in, out) ``w8`` transposed: ``w8.t()`` is the column-major operand
    ``torch._int_mm`` takes), ``s`` (out,) float32 scales, and the float
    bias. ``group`` is the model group of a row-split layer under tensor
    parallelism (``parallel/mesh.py``), else None."""

    def __init__(self, w8: torch.Tensor, s: torch.Tensor,
                 bias: Optional[torch.Tensor]):
        super().__init__()
        self.out_features, self.in_features = w8.shape
        self.register_buffer("w8", w8)
        self.register_buffer("s", s)
        self.bias = (None if bias is None
                     else nn.Parameter(bias, requires_grad=False))
        self.group = None


class SplitLinear(nn.Linear):
    """A float linear split on its input rows over a tensor-parallel model
    group (``parallel/mesh.shard_params``): each rank's partial product is
    all-reduced, then the bias added once."""
    group = None


class Whisper(nn.Module):
    """Whisper's parameter tree. Built with uninitialised weights: fill them
    with :func:`init_params` or ``load_state_dict``. ``tp_group`` is the
    model group of a tensor-parallel rank's copy (``parallel/mesh.py``),
    else None."""

    def __init__(self, dims: ModelDims, device=None, dtype=None):
        super().__init__()
        factory = {"device": device, "dtype": dtype}
        self.dims = dims
        self.encoder = AudioEncoder(dims, **factory)
        self.decoder = TextDecoder(dims, **factory)
        self.tp_group = None

    @property
    def device(self) -> torch.device:
        return self.decoder.positional_embedding.device

    @property
    def dtype(self) -> torch.dtype:
        return self.decoder.positional_embedding.dtype


def init_params(model: Whisper, generator: torch.Generator) -> Whisper:
    """Random weights with the JAX package's distributions
    (whisper.py:53-124), drawn from ``generator`` on the model's device:
    dense weights N(0, 1) * d_in**-0.5 and zero biases, LayerNorms at (1, 0),
    convs N(0, 1) * 0.05, token embedding N * 0.02, decoder positions N *
    0.01, sinusoidal encoder positions. The numbers differ from the JAX
    package's for the same seed; tests carry JAX weights across instead."""

    def normal_(t: torch.Tensor, std: float):
        with torch.no_grad():
            t.copy_(torch.randn(t.shape, generator=generator,
                                device=t.device, dtype=torch.float32) * std)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                normal_(mod.weight, mod.in_features ** -0.5)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, nn.Conv1d):
                normal_(mod.weight, 0.05)
                mod.bias.zero_()
        enc, dec = model.encoder, model.decoder
        enc.positional_embedding.copy_(torch.from_numpy(sinusoids(
            *enc.positional_embedding.shape)))
        normal_(dec.token_embedding.weight, 0.02)
        normal_(dec.positional_embedding, 0.01)
    return model


def cast_params(model: Whisper, dtype: torch.dtype,
                device: Optional[torch.device] = None) -> Whisper:
    """The model in the compute dtype (and on ``device``): the same module
    when it already is, else a converted copy, so the caller's module is left
    as it was. The int8 leaves of :func:`quantize_encoder_int8` keep their
    types, as JAX ``cast_params`` keeps them: ``w8`` int8 and ``s`` float32
    (``Module.to(dtype)`` casts every floating buffer, so ``s`` is put
    back)."""
    device = model.device if device is None else torch.device(device)
    if model.dtype == dtype and model.device == device:
        return model
    out = copy.deepcopy(model).to(device=device, dtype=dtype)
    for mod, src in zip(out.modules(), model.modules()):
        if isinstance(mod, Int8Linear):
            mod.s = src.s.to(device=device, dtype=torch.float32)
    return out


def encoder_is_int8(model: Whisper) -> bool:
    return isinstance(model.encoder.blocks[0].attn.query, Int8Linear)


def _quantize_linear(lin: nn.Linear) -> Int8Linear:
    """Per-output-channel int8 codes of ``lin``'s weight, with the numpy
    arithmetic of JAX ``models/whisper.py:170-181``: ``s = amax / 127`` a
    float32 true division (not the reciprocal product of the activation
    quantizer), 1 where amax is 0; ``w8 = clip(round(w / s), -127,
    127)``."""
    w = lin.weight.detach().float()
    amax = w.abs().amax(dim=1, keepdim=True)
    s = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    w8 = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    bias = None if lin.bias is None else lin.bias.detach().clone()
    return Int8Linear(w8.contiguous(), s[:, 0].contiguous(), bias)


def quantize_encoder_int8(model: Whisper) -> Whisper:
    """Opt-in int8 encoder (JAX ``quantize_encoder_int8``): a copy whose
    encoder blocks' q/k/v/out projections and both MLP linears are
    :class:`Int8Linear`; the convs, layer norms and the whole decoder stay
    as they are. Idempotent: a quantized model is returned as it is. Not
    parity-true (quantization perturbs the encoder states); the float
    encoder stays the default."""
    if encoder_is_int8(model):
        return model
    out = copy.deepcopy(model)
    with torch.no_grad():
        for blk in out.encoder.blocks:
            for p in ("query", "key", "value", "out"):
                setattr(blk.attn, p, _quantize_linear(getattr(blk.attn, p)))
            for j in (0, 2):
                blk.mlp[j] = _quantize_linear(blk.mlp[j])
    return out


def _check_device(model: Whisper, device) -> torch.device:
    """Resolve an entry point's device and hold the model to it."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model is on {model.device}, the call asks for "
                         f"{dev}; move it with cast_params(model, dtype, "
                         "device)")
    return model.device


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------

def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), 1e-5).to(x.dtype)


def _linear(lin: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if isinstance(lin, Int8Linear):
        return _linear_int8(lin, x)
    if isinstance(lin, SplitLinear):
        return _split_linear(lin, x)
    return F.linear(x, lin.weight, lin.bias)


def _split_linear(lin: SplitLinear, x: torch.Tensor) -> torch.Tensor:
    """A row-split float linear: the rank's partial product in float32, its
    sum over the model group, then the compute dtype and the bias, once."""
    part = F.linear(x.float(), lin.weight.float())
    y = lin.group.all_reduce(part).to(x.dtype)
    return y if lin.bias is None else y + lin.bias


def _linear_int8(lin: Int8Linear, x: torch.Tensor) -> torch.Tensor:
    """JAX ``_linear_int8`` as XLA compiles it: each row of x quantized to
    int8 (``amax * f32(1/127)`` scales), the exact int32 product with
    ``w8``, then ``(float(y) * xs) * s`` in the compute dtype ``+ b``
    (``ops/int8_cuda.dequantize``: in float32 the last product and the bias
    add are one fused multiply-add, as XLA contracts them). A row-split
    layer takes its rows' max over the model group first, so its codes are
    the slices of the whole rows', and sums the int32 partial products
    (exact) before the epilogue: the result equals one rank's bit for
    bit."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    amax = None
    if lin.group is not None:
        amax = lin.group.all_reduce(
            x2.float().abs().amax(dim=-1, keepdim=True), op="max")
    x8, xs = int8_cuda.quantize_rows(x2, amax)
    y = int8_cuda.int_mm(x8, lin.w8)
    if lin.group is not None:
        y = lin.group.all_reduce(y)
    out = int8_cuda.dequantize(y, xs, lin.s, lin.bias, x.dtype)
    return out.reshape(*shape[:-1], out.shape[-1])


def _mlp(blk: ResidualAttentionBlock, x: torch.Tensor) -> torch.Tensor:
    h = _layer_norm(blk.mlp_ln, x)
    return _linear(blk.mlp[2], F.gelu(_linear(blk.mlp[0], h)))


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def _attend(q, k_t, v_t, dtype, mask=None):
    """q (B, H, T, hd) scaled; k_t, v_t (B, H, hd, S) with k scaled. Scores
    (B, H, T, S) in f32, f32 softmax, probabilities in ``dtype``, P v in f32
    then ``dtype``. Returns (out (B, H, T, hd), scores)."""
    qk = torch.matmul(q.float(), k_t.float())
    if mask is not None:
        qk = qk + mask
    w = torch.softmax(qk, dim=-1).to(dtype)
    out = torch.matmul(w.float(), v_t.float().transpose(-1, -2)).to(dtype)
    return out, qk


def _qkv_attention(attn: MultiHeadAttention, x, xa, mask=None):
    """Self- (xa None) or cross-attention over ``xa``; returns (out, qk f32)
    where qk is the pre-softmax logits including the mask."""
    n_head = attn.n_head
    scale = attn.head_dim ** -0.25
    q = _split_heads(_linear(attn.query, x), n_head) * scale
    src = x if xa is None else xa
    k = _split_heads(_linear(attn.key, src), n_head) * scale
    v = _split_heads(_linear(attn.value, src), n_head)
    o, qk = _attend(q, k.transpose(-1, -2), v.transpose(-1, -2), x.dtype, mask)
    return _linear(attn.out, _merge_heads(o)), qk


def _cross_attention_kv(attn: MultiHeadAttention, x, ck, cv,
                        mode: str = "xla", step: bool = False):
    """Cross-attention against precomputed (B, H, hd, F) K/V. Int8 K/V
    (``(codes, scales)`` pairs) run as ``mode`` says: ``mxu``
    (:func:`_cross_attn_step_int8_mxu`), ``kernel`` (the cross-attention
    kernel; decode steps only, ``step=True``) or ``xla`` (dequantize in the
    compute dtype, then attend). The returned logits are None on the int8
    paths other than ``xla``."""
    n_head = attn.n_head
    scale = attn.head_dim ** -0.25
    q = _split_heads(_linear(attn.query, x), n_head) * scale
    if isinstance(ck, tuple) and mode == "mxu":
        o, qk = _cross_attn_step_int8_mxu(q, ck, cv, scale, x.dtype), None
    elif isinstance(ck, tuple) and mode == "kernel" and step:
        o = cross_attn_step_int8(q, ck[0], ck[1], cv[0], cv[1],
                                 k_scale=scale).to(x.dtype)
        qk = None
    else:
        o, qk = _attend(q, _dequant(ck, x.dtype) * scale,
                        _dequant(cv, x.dtype), x.dtype)
    return _linear(attn.out, _merge_heads(o)), qk


def _encoder_self_attention(attn: MultiHeadAttention, x, n_valid: int):
    n_head = attn.n_head
    scale = attn.head_dim ** -0.25
    q = (_split_heads(_linear(attn.query, x), n_head) * scale).contiguous()
    k = (_split_heads(_linear(attn.key, x), n_head) * scale).contiguous()
    v = _split_heads(_linear(attn.value, x), n_head).contiguous()
    o = encoder_self_attention(q, k, v, n_valid=n_valid)
    return _linear(attn.out, _merge_heads(o.to(x.dtype)))


@torch.no_grad()
def encode_audio(model: Whisper, mel: torch.Tensor,
                 device=None) -> torch.Tensor:
    """AudioEncoder: mel (B, n_mels, 2 * n_audio_ctx) -> (B, n_audio_ctx, d).
    Each layer's self-attention goes through the encoder-attention kernel."""
    dev = _check_device(model, device)
    enc = model.encoder
    x = mel.to(device=dev, dtype=model.dtype)
    x = F.gelu(enc.conv1(x))
    x = F.gelu(enc.conv2(x))
    x = x.transpose(1, 2) + enc.positional_embedding
    t = x.shape[1]
    for blk in enc.blocks:
        x = x + _encoder_self_attention(blk.attn, _layer_norm(blk.attn_ln, x),
                                        n_valid=t)
        x = x + _mlp(blk, x)
    return _layer_norm(enc.ln_post, x)


def _causal_mask(t: int, device) -> torch.Tensor:
    return torch.full((t, t), float("-inf"), device=device).triu_(1)


def _logits(model: Whisper, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x.float(), model.decoder.token_embedding.weight.float())


@torch.no_grad()
def decode_text(model: Whisper, tokens: torch.Tensor, xa: Optional[torch.Tensor],
                return_qk: bool = True,
                medfilt_width: Optional[int] = None,
                frame_len: Optional[torch.Tensor] = None,
                token_len: Optional[torch.Tensor] = None,
                qk_scale: float = 1.0, return_logits: bool = True,
                cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                device=None):
    """TextDecoder teacher-forced over the full token sequence.

    tokens (B, T) int, xa (B, F, d) encoder output (may be None when
    ``cross_kv`` is given). Returns (logits (B, T, vocab) f32 or None, qk
    (L, B, H, T, F) f32 or None).

    With ``medfilt_width``, each layer's cross-attention logits go through
    the QK post-process kernel inside the layer loop (median filter -> scaled
    softmax -> pad-row zeroing), so the returned stack is the alignment-ready
    attention and the raw logit stack is never held. ``cross_kv``: the
    decode loop's (L, B, H, hd, F) K/V stacks, skipping the cross K/V
    projections."""
    dev = _check_device(model, device)
    dec = model.decoder
    dtype = model.dtype
    tokens = tokens.to(dev)
    t = tokens.shape[-1]
    x = (dec.token_embedding.weight[tokens] + dec.positional_embedding[:t])
    mask = _causal_mask(t, dev)
    if xa is not None:
        xa = xa.to(device=dev, dtype=dtype)
    if medfilt_width is not None:
        frame_len = frame_len.to(device=dev, dtype=torch.int32)
        token_len = token_len.to(device=dev, dtype=torch.int32)
    qks = []
    for layer, blk in enumerate(dec.blocks):
        a, _ = _qkv_attention(blk.attn, _layer_norm(blk.attn_ln, x), None, mask)
        x = x + a
        h = _layer_norm(blk.cross_attn_ln, x)
        if cross_kv is not None:
            c, qk = _cross_attention_kv(blk.cross_attn, h, cross_kv[0][layer],
                                        cross_kv[1][layer])
        else:
            c, qk = _qkv_attention(blk.cross_attn, h, xa)
        x = x + c
        if return_qk:
            if medfilt_width is not None:
                qk = qk_postprocess(qk.contiguous(), frame_len, token_len,
                                    medfilt_width, qk_scale)
            qks.append(qk)
        x = x + _mlp(blk, x)
    qk_stack = torch.stack(qks) if return_qk else None
    if not return_logits:
        return None, qk_stack
    return _logits(model, _layer_norm(dec.ln, x)), qk_stack


# ---------------------------------------------------------------------------
# Incremental decoding (KV cache)
# ---------------------------------------------------------------------------

def text_heads(model: Whisper) -> int:
    """Decoder heads this rank runs (all of them but under tensor
    parallelism): the head axis of its caches and cross K/V."""
    return model.decoder.blocks[0].attn.n_head


def init_kv_cache(dims: ModelDims, batch: int, max_len: int,
                  dtype: torch.dtype = torch.float32, device=None,
                  n_head: Optional[int] = None) -> Cache:
    """Self-attention K/V cache, (L, B, H, hd, ctx) each, zero-filled; H is
    ``n_head`` when given (a tensor-parallel rank's share,
    :func:`text_heads`), else all the decoder's heads."""
    shape = (dims.n_text_layer, batch, n_head or dims.n_text_head,
             dims.n_text_head_dim, max_len)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def quantize_cross_kv(x: torch.Tensor):
    """int8 codes and float32 scales of (..., hd, F) K or V: one scale per
    frame column over the head-dim axis (``int8_cuda.scale_of`` its amax);
    codes ``clip(round(x / scale), -127, 127)``, a true division, round
    half to even. Returns (codes int8 (..., hd, F), scales (..., 1, F))."""
    xf = x.float()
    scale = int8_cuda.scale_of(xf.abs().amax(dim=-2, keepdim=True))
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


@torch.no_grad()
def precompute_cross_kv(model: Whisper, xa: torch.Tensor,
                        quantize: bool = False):
    """Cross-attention K/V for every decoder layer, (L, B, H, hd, F) each.
    ``quantize=True`` stores each as ``(int8 codes, float32 scales (L, B, H,
    1, F))`` (:func:`quantize_cross_kv`): half the bytes the decode loop
    re-reads every step."""
    xa = xa.to(dtype=model.dtype)
    ks, vs = [], []
    for blk in model.decoder.blocks:
        n_head = blk.cross_attn.n_head
        ks.append(_split_heads(_linear(blk.cross_attn.key, xa),
                               n_head).transpose(-1, -2))
        vs.append(_split_heads(_linear(blk.cross_attn.value, xa),
                               n_head).transpose(-1, -2))
    ks, vs = torch.stack(ks), torch.stack(vs)
    if not quantize:
        return ks, vs
    return quantize_cross_kv(ks), quantize_cross_kv(vs)


def _dequant(c, dtype: torch.dtype) -> torch.Tensor:
    """Float K or V in ``dtype``: int8 codes times their scales, both cast
    to ``dtype`` first (the JAX package's rounding in bf16)."""
    if isinstance(c, tuple):
        return c[0].to(dtype) * c[1].to(dtype)
    return c.to(dtype)


def _int8_rowwise(x: torch.Tensor):
    """Quantize the trailing axis per row: (int8 codes, float32 scales)."""
    scale = int8_cuda.scale_of(x.abs().amax(dim=-1, keepdim=True))
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def _cross_attn_step_int8_mxu(qc, ck, cv, k_scale: float, dtype):
    """Cross-attention whose two products take the int8 K/V codes directly.

    qc (B, H, T, hd) already * hd**-0.25; ck/cv (int8 (B, H, hd, F), float32
    scales (B, H, 1, F)). q is quantized per row, so ``q8 . k8`` is an exact
    integer product; the per-frame V scale folds into the softmax
    probabilities before their own row quantization:
    ``out = (w8 . v8) * w_s``. The integer products are exact: q8 . k8 over
    hd=64 stays below 2**24 (float32), w8 . v8 over F=1500 may not, so it is
    taken in float64."""
    k8, k_s = ck
    v8, v_s = cv
    q8, q_s = _int8_rowwise(qc.float() * k_scale)
    qk = torch.matmul(q8.float(), k8.float()) * q_s * k_s
    w = torch.softmax(qk, dim=-1)
    w8, w_s = _int8_rowwise(w * v_s)
    o = torch.matmul(w8.double(), v8.double().transpose(-1, -2))
    return (o.float() * w_s).to(dtype)


def cross_attn_mode(device) -> str:
    """The int8 decode cross-attention (env ``WCA_CROSS_ATTN``), consulted
    only when the K/V are quantized: ``auto`` (default) gives the kernel
    (``kernel``) on a CUDA model and ``xla`` on a CPU model;
    ``mxu``/``int8mxu``; ``pallas``/``1``/``on``/``true`` select the kernel;
    ``xla``/``0``/``off``/``false`` dequantize. Anything else raises.

    The JAX package's ``auto`` takes the int8-product step on an
    accelerator. Here that step is some 35 small PyTorch calls per layer and
    step, and on an H100 the Whisper-medium int8 + 128-frame-bucket decode
    takes 0.70x its time through the kernel (``chip_smoke.py``)."""
    mode = os.environ.get("WCA_CROSS_ATTN", "auto")
    if mode == "auto":
        return "kernel" if torch.device(device).type == "cuda" else "xla"
    if mode in ("0", "off", "false", "xla"):
        return "xla"
    if mode in ("mxu", "int8mxu"):
        return "mxu"
    if mode in ("1", "on", "true", "pallas"):
        return "kernel"
    raise ValueError(f"WCA_CROSS_ATTN={mode!r} is not a known mode; use one "
                     "of auto / mxu / pallas / xla (off)")


def _layer_kv(c, layer: int):
    """One layer of a cross K or V stack, plain or ``(codes, scales)``."""
    if isinstance(c, tuple):
        return c[0][layer], c[1][layer]
    return c[layer]


def _cached_layers(model: Whisper, x, cache: Cache, cross_kv,
                   cols: torch.Tensor, mask: torch.Tensor,
                   cross_mode: str = "xla", step: bool = False):
    """Run the decoder blocks over x (B, P, d) at the positions ``cols`` (P,)
    int64, writing the P new self-attention K/V columns into ``cache`` in
    place (``index_copy_``). Every row attends over the whole ``max_len``
    cache with ``mask`` (P, max_len) float32, 0 where a column is visible and
    -inf elsewhere (JAX ``models/whisper.py:735-757``), so the shapes do not
    depend on the position and a step can be captured in a CUDA graph.
    ``cross_mode`` and ``step`` pick the int8 cross-attention
    (:func:`_cross_attention_kv`)."""
    dtype = model.dtype
    cross_ks, cross_vs = cross_kv
    for layer, blk in enumerate(model.decoder.blocks):
        attn = blk.attn
        n_head = attn.n_head
        scale = attn.head_dim ** -0.25
        h = _layer_norm(blk.attn_ln, x)
        q = _split_heads(_linear(attn.query, h), n_head) * scale
        k_new = _split_heads(_linear(attn.key, h), n_head)
        v_new = _split_heads(_linear(attn.value, h), n_head)
        k_layer, v_layer = cache["k"][layer], cache["v"][layer]
        for dst, new in ((k_layer, k_new), (v_layer, v_new)):
            dst.index_copy_(-1, cols, new.transpose(-1, -2).to(dst.dtype))
        a, _ = _attend(q, k_layer.to(dtype) * scale, v_layer.to(dtype), dtype,
                       mask)
        x = x + _linear(attn.out, _merge_heads(a))
        c, _ = _cross_attention_kv(blk.cross_attn,
                                   _layer_norm(blk.cross_attn_ln, x),
                                   _layer_kv(cross_ks, layer),
                                   _layer_kv(cross_vs, layer),
                                   mode=cross_mode, step=step)
        x = x + c
        x = x + _mlp(blk, x)
    return x


def _position_mask(rows: torch.Tensor, max_len: int) -> torch.Tensor:
    """(P, max_len) float32: 0 where cache column <= the row's position,
    -inf elsewhere."""
    cols = torch.arange(max_len, device=rows.device)
    return torch.where(cols[None, :] <= rows[:, None], 0.0,
                       float("-inf")).to(torch.float32)


def _as_position(pos, device) -> torch.Tensor:
    """A position as a (1,) int64 tensor on ``device``: a Python int is
    copied there; a tensor is taken as it is (no host read)."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1).to(device=device, dtype=torch.long)
    return torch.tensor([int(pos)], dtype=torch.long, device=device)


@torch.no_grad()
def decode_step(model: Whisper, tokens: torch.Tensor, pos, cache: Cache,
                cross_kv, cross_mode: Optional[str] = None,
                pos_emb: Optional[torch.Tensor] = None):
    """One autoregressive decoder step: tokens (B, 1) at position ``pos``, a
    Python int or a (1,) int64 tensor on the model's device; ``cache`` holds
    self-attention K/V for positions < pos and gains column ``pos`` in place.
    Returns (logits (B, vocab) f32, cache). Shapes do not depend on ``pos``
    (the whole cache is attended under a position mask), and a tensor
    position is never read on the host: the step is capturable in a CUDA
    graph (``models/decode_graph.py``).
    ``cross_mode=None`` resolves ``WCA_CROSS_ATTN`` (:func:`cross_attn_mode`);
    it matters only for int8 cross K/V. ``pos_emb`` replaces the learned
    position table (the speculative loop's, zero-padded past n_text_ctx)."""
    if cross_mode is None:
        cross_mode = cross_attn_mode(model.device)
    dec = model.decoder
    table = dec.positional_embedding if pos_emb is None else pos_emb
    pos = _as_position(pos, tokens.device)
    x = (dec.token_embedding.weight.index_select(0, tokens[:, 0])
         + table.index_select(0, pos))[:, None, :]
    mask = _position_mask(pos, cache["k"].shape[-1])
    x = _cached_layers(model, x, cache, cross_kv, pos, mask,
                       cross_mode=cross_mode, step=True)
    return _logits(model, _layer_norm(dec.ln, x[:, 0])), cache


@torch.no_grad()
def decode_prefill(model: Whisper, tokens: torch.Tensor, cache: Cache,
                   cross_kv, logits_at: Optional[int] = None,
                   cross_mode: Optional[str] = None):
    """Consume the decode prompt (B, P) in one teacher-forced pass, writing
    cache columns 0..P-1; row t attends to cache columns <= t under the same
    mask as :func:`decode_step` (JAX ``models/whisper.py:865-892``).
    Returns (logits (B, vocab) f32 at position ``logits_at``, or None to
    skip the lm head, cache). With int8 cross K/V
    the prefill takes the ``mxu`` step or dequantizes, never the kernel (it
    runs once per decode)."""
    if cross_mode is None:
        cross_mode = cross_attn_mode(model.device)
    dec = model.decoder
    p = tokens.shape[1]
    x = dec.token_embedding.weight[tokens] + dec.positional_embedding[:p]
    rows = torch.arange(p, device=x.device)
    x = _cached_layers(model, x, cache, cross_kv, rows,
                       _position_mask(rows, cache["k"].shape[-1]),
                       cross_mode=cross_mode)
    if logits_at is None:
        return None, cache
    return _logits(model, _layer_norm(dec.ln, x[:, logits_at])), cache


@torch.no_grad()
def decode_window(model: Whisper, tokens: torch.Tensor, start, cache: Cache,
                  cross_kv, cross_mode: Optional[str] = None,
                  pos_emb: Optional[torch.Tensor] = None):
    """Teacher-forced pass over a window of P tokens (B, P) at positions
    ``start .. start+P-1`` (JAX ``models/whisper.py:951-1062``), ``start`` a
    Python int or a (1,) int64 tensor on the model's device, never read on
    the host. Writes the P cache columns in place and returns (logits (B, P,
    vocab) f32, cache); row t attends to cache columns <= start+t under the
    mask of :func:`decode_step`, so each row computes what a step at its
    position computes. The speculative decode's verifier
    (``decoding.decode_speculative``). The positions must lie in the
    position table: ``pos_emb`` gives one padded past n_text_ctx (the JAX
    package clamps the window's start instead)."""
    if cross_mode is None:
        cross_mode = cross_attn_mode(model.device)
    dec = model.decoder
    table = dec.positional_embedding if pos_emb is None else pos_emb
    b, p = tokens.shape
    rows = (_as_position(start, tokens.device)
            + torch.arange(p, device=tokens.device))
    x = (dec.token_embedding.weight.index_select(0, tokens.reshape(-1))
         .reshape(b, p, -1) + table.index_select(0, rows))
    x = _cached_layers(model, x, cache, cross_kv, rows,
                       _position_mask(rows, cache["k"].shape[-1]),
                       cross_mode=cross_mode)
    return _logits(model, _layer_norm(dec.ln, x)), cache
