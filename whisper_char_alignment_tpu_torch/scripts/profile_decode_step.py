"""Localize the greedy decode step's cost (port of the repository's
``scripts/profile_decode_step.py``): STEPS-step loops with parts of the
decoder layer switched off (cross-attention, self-attention, MLP, logits),
at Whisper-medium width, B=32.

    python -m whisper_char_alignment_tpu_torch.scripts.profile_decode_step
    INT8_PALLAS=1 B=8 python -m whisper_char_alignment_tpu_torch.scripts.profile_decode_step

:func:`make_loop` builds a stripped copy of one decode step from the model's
own helpers (``models/whisper.py``: ``_layer_norm``, ``_linear``,
``_split_heads``, ``dec_attn``, ``_cross_attention_kv``, ``_mlp``,
``_logits``, and ``decoding.apply_logit_filters``); nothing of the main path
gains a switch. With every stage on it computes what ``whisper.decode_step``
computes: :func:`step_logits` equals that step's logits bit for bit. As in
the JAX script, the loop carries its cache unchanged: a step writes its
self-attention column into a copy of the layer's cache
(``torch.index_copy``), where ``decode_step`` writes in place.

On a card the step is captured once as a CUDA graph (the decode runner's
``_warm_up``/``_capture``, ``models/decode_graph.py``) on static buffers for
the token, the position and ``acc``, and a timed call replays it STEPS
times. The graph is captured in each variant's warm call, outside the timed
calls, and freed before the next variant's is captured. On the CPU the step
runs eagerly.

Variants, the JAX script's: eight in bf16 over float cross K/V, and over
int8 K/V (``precompute_cross_kv(..., quantize=True)``) the int8-product step
(``mxu``) and dequantize-then-attend (``xla-dequant``); with INT8_PALLAS=1
also the cross-attention kernel (``ops/cross_attn_cuda.cross_attn_step_int8``,
the port of ``cross_attn_pallas.cross_attn_step_int8``).

Besides the JAX lines (stderr) it prints each step's byte floor (the
decoder's weights, the cross K/V and the cache read once, at 3.35 TB/s),
the peak device memory of each variant, and the device-busy share and the
15 kernels with the most device time of one traced call of "full loop"
(``torch.profiler``, ``utils/profiling.trace_busy``). Then ONE JSON line on
stdout: every reading (least ms of 3 calls of STEPS steps) under its JAX
name, ``step_floor``, ``full_loop_trace``, ``peak_device_mem_gib``,
``device``, ``launches`` and ``graph_captures_timed``.

Runs on ``cuda`` unless ``WCA_PLATFORM=cpu``; without a card it exits
non-zero and prints no line. Knobs (env, the JAX script's): B (32), STEPS
(32), INT8_PALLAS (unset; 1 adds the kernel's two variants).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..bench import (build_model, device_label, log, peak_mem_gib,
                     platform_device, reset_peak_mem)
from ..config import MODEL_DIMS
from ..models import decode_graph, decoding, whisper as wmodel
from ..ops import _lib
from ..utils import profiling
from ._profile import HBM_BYTES_PER_S, Readings

B = int(os.environ.get("B", "32"))
STEPS = int(os.environ.get("STEPS", "32"))
dims = MODEL_DIMS["medium"]

# cross_impl -> the ``_cross_attention_kv`` mode that runs it
CROSS_MODES = {"bf16": "xla", "int8_xla": "xla", "int8_mxu": "mxu",
               "int8_pallas": "kernel"}


def _layers(model, x, cache, cross_kv, pos, *, cross=True, self_attn=True,
            mlp=True, dtype=torch.bfloat16, cross_impl="bf16"):
    """The decoder blocks over x (B, 1, d) at position ``pos`` ((1,) int64),
    with the stages switched as asked. ``cache`` is read, never written."""
    mask = wmodel._position_mask(pos, cache["k"].shape[-1])
    cross_ks, cross_vs = cross_kv
    for li, blk in enumerate(model.decoder.blocks):
        if self_attn:
            attn = blk.attn
            scale = attn.head_dim ** -0.25
            h = wmodel._layer_norm(blk.attn_ln, x)
            q = wmodel._split_heads(wmodel._linear(attn.query, h),
                                    attn.n_head) * scale
            k_new = wmodel._split_heads(wmodel._linear(attn.key, h),
                                        attn.n_head)
            v_new = wmodel._split_heads(wmodel._linear(attn.value, h),
                                        attn.n_head)
            k_all, v_all = (
                torch.index_copy(c[li], -1, pos,
                                 new.transpose(-1, -2).to(c.dtype))
                for c, new in ((cache["k"], k_new), (cache["v"], v_new)))
            a, _ = wmodel.dec_attn(q, k_all, v_all, dtype=dtype, mask=mask,
                                   k_scale=scale)
            x = x + wmodel._linear(attn.out, wmodel._merge_heads(a))
        if cross:
            c, _ = wmodel._cross_attention_kv(
                blk.cross_attn, wmodel._layer_norm(blk.cross_attn_ln, x),
                wmodel._layer_kv(cross_ks, li), wmodel._layer_kv(cross_vs, li),
                mode=CROSS_MODES[cross_impl], step=True, scores=False)
            x = x + c
        if mlp:
            x = x + wmodel._mlp(blk, x)
    return x


def _embed(model, tok, pos):
    dec = model.decoder
    return (dec.token_embedding.weight.index_select(0, tok)
            + dec.positional_embedding.index_select(0, pos))[:, None, :]


@torch.no_grad()
def step_logits(model, tok: torch.Tensor, pos: torch.Tensor, cache,
                cross_kv, cross_impl: str = "bf16") -> torch.Tensor:
    """The all-on stripped step's logits (B, vocab) f32 for tokens ``tok``
    (B,) at position ``pos`` ((1,) int64): ``whisper.decode_step``'s, bit
    for bit, with ``cross_mode`` the impl's mode (:data:`CROSS_MODES`)."""
    x = _layers(model, _embed(model, tok, pos), cache, cross_kv, pos,
                dtype=model.dtype, cross_impl=cross_impl)
    return wmodel._logits(model,
                          wmodel._layer_norm(model.decoder.ln, x[:, 0]))


def make_loop(cross=True, self_attn=True, mlp=True, logits=True,
              dtype=torch.bfloat16, cross_impl="bf16", filters=False):
    """A stripped copy of the decode loop with stages toggleable: returns
    ``run(model, cross_kv, cache) -> acc``, STEPS steps from position 0 and
    token 0, ``acc`` the sum of each step's mean logit (or, without logits,
    of its mean final state), as the JAX script's. The model's parameters
    are in ``dtype``.

    cross_impl: "bf16" (attend over float K/V), or over int8 K/V
    (``precompute_cross_kv(..., quantize=True)``) "int8_xla"
    (dequantize-then-attend), "int8_mxu" (the int8-product step),
    "int8_pallas" (the cross-attention kernel). ``run.release()`` frees the
    captured graph."""

    @torch.no_grad()
    def step(model, st, cross_kv, cache) -> None:
        i, tok = st["i"], st["tok"]
        x = _layers(model, _embed(model, tok, i).to(dtype), cache, cross_kv,
                    i, cross=cross, self_attn=self_attn, mlp=mlp, dtype=dtype,
                    cross_impl=cross_impl)
        if logits:
            lg = wmodel._logits(model,
                                wmodel._layer_norm(model.decoder.ln, x[:, 0]))
            if filters:
                # the production per-step rule masks, at realistic state
                n_vocab = model.dims.n_vocab
                lg = decoding.apply_logit_filters(
                    lg, i, st["tokens_buf"], st["has_ts"], st["last_ts"],
                    st["no_mask"], st["no_mask"], st["vocab_ids"],
                    sample_begin=0, ts_begin=n_vocab - 1501,
                    eot=n_vocab - 1600, no_timestamps=n_vocab - 1602,
                    max_initial_ts_index=50, use_timestamps=True)
            tok.copy_(lg.argmax(dim=-1))
            st["acc"].add_(lg.mean())
        else:
            x = wmodel._layer_norm(model.decoder.ln, x)
            tok.add_(1).remainder_(100)
            st["acc"].add_(x.mean().float())
        i.add_(1)

    held = {}

    def state(model, b: int) -> dict:
        dev = model.device
        st = {"i": torch.zeros(1, dtype=torch.long, device=dev),
              "tok": torch.zeros(b, dtype=torch.long, device=dev),
              "acc": torch.zeros((), dtype=torch.float32, device=dev)}
        if filters:
            v = model.dims.n_vocab
            st.update(
                tokens_buf=torch.zeros((b, STEPS + 4), dtype=torch.long,
                                       device=dev),
                has_ts=torch.zeros(b, dtype=torch.bool, device=dev),
                last_ts=torch.zeros(b, dtype=torch.long, device=dev),
                no_mask=torch.zeros(v, dtype=torch.float32, device=dev),
                vocab_ids=torch.arange(v, device=dev))
        return st

    def run(model, cross_kv, cache, readings: Optional[Readings] = None):
        b = cache["k"].shape[1]
        if model.device.type != "cuda":
            st = state(model, b)
            for _ in range(STEPS):
                step(model, st, cross_kv, cache)
            return st["acc"]
        key = tuple(t.data_ptr() for t in decode_graph._flat_kv(cross_kv)) \
            + (cache["k"].data_ptr(), id(model), STEPS)
        if held.get("key") != key:
            held.clear()
            st = state(model, b)
            fn = lambda: step(model, st, cross_kv, cache)  # noqa: E731
            decode_graph._warm_up(fn)
            before = _lib.launch_counts()
            graph = decode_graph._capture(fn)
            after = _lib.launch_counts()
            counts = {k: after[k] - before[k] for k in after}
            _lib.add_launches(counts, -1)  # the capture launched nothing
            held.update(key=key, st=st, graph=graph, counts=counts)
            if readings is not None:
                readings.own_captures += 1
        st = held["st"]
        for t in (st["i"], st["tok"], st["acc"]):
            t.zero_()
        for _ in range(STEPS):
            held["graph"].replay()
        _lib.add_launches(held["counts"], STEPS)
        return st["acc"].clone()

    run.release = held.clear
    return run


def step_floor(model, cross_kv, cache) -> tuple:
    """(bytes, ms): what one decode step must read at least, each once: the
    decoder's weights (the token embedding once, as the logits projection;
    one row of the positions), the cross K/V (int8 codes and scales, or
    float) and the self-attention cache, over the card's memory rate."""
    dec = model.decoder
    nbytes = sum(p.numel() * p.element_size()
                 for name, p in dec.named_parameters()
                 if name != "positional_embedding")
    nbytes += dec.positional_embedding[0].numel() * \
        dec.positional_embedding.element_size()
    nbytes += sum(t.numel() * t.element_size()
                  for t in decode_graph._flat_kv(cross_kv))
    nbytes += sum(t.numel() * t.element_size() for t in cache.values())
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def trace_call(fn, top: int = 15) -> dict:
    """One traced call of ``fn`` on the card (``torch.profiler``, CPU and
    CUDA activity, the card synchronised before the trace stops): its
    device-busy share (``utils/profiling.trace_busy``) and the ``top``
    kernels with the most device time, each with its launches and its
    share of the traced device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = profiling.trace_busy(prof)
    rows = []
    for evt in prof.key_averages():
        us = (getattr(evt, "self_device_time_total", None)
              or getattr(evt, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((us, evt.count, evt.key))
    total = sum(r[0] for r in rows)
    rows.sort(reverse=True)
    return {"busy_share": busy["share"],
            "window_ms": (None if busy["window_s"] is None
                          else busy["window_s"] * 1e3),
            "device_records": busy["records"],
            "device_ms": total / 1e3,
            "top_kernels": [{"name": key, "launches": n, "ms": us / 1e3,
                             "share": us / total}
                            for us, n, key in rows[:top]]}


def log_trace(name: str, tr: dict) -> None:
    log(f"{name}: one traced call: device busy {tr['busy_share']} of "
        f"{tr['window_ms']} ms ({tr['device_records']} device records, "
        f"{tr['device_ms']:.3f} ms of device time); top kernels:")
    for k in tr["top_kernels"]:
        log(f"  {k['ms']:9.3f} ms {k['share']:6.1%} x{k['launches']:<6d} "
            f"{k['name'][:100]}")


def main() -> None:
    int8_pallas = os.environ.get("INT8_PALLAS") == "1"
    device = platform_device()
    log(f"devices: {device_label(device)} B={B} steps={STEPS}")
    model = build_model(dims, device)
    rng = np.random.default_rng(0)
    xa = torch.from_numpy(rng.normal(
        0, 1, (B, dims.n_audio_ctx, dims.n_audio_state)).astype(np.float32)
    ).to(device=device, dtype=torch.bfloat16)
    cross_kv = wmodel.precompute_cross_kv(model, xa)
    cache = wmodel.init_kv_cache(dims, B, STEPS + 4, dtype=torch.bfloat16,
                                 device=device)
    r = Readings("profile_decode_step", device)
    r.extra.update(batch=B, steps=STEPS, step_floor={},
                   peak_device_mem_gib={}, full_loop_trace=None)

    def floor(label, kv):
        nbytes, ms = step_floor(model, kv, cache)
        r.extra["step_floor"][label] = {"bytes": nbytes, "ms": ms}
        log(f"byte floor ({label} cross K/V): {nbytes / 1e6:.1f} MB a step, "
            f"{ms:.4f} ms a step, {ms * STEPS:.3f} ms for {STEPS} steps at "
            f"{HBM_BYTES_PER_S / 1e12} TB/s")

    def measure(variants, kv):
        # each variant's graph is captured in its warm call and freed after
        # it, so that one graph's memory is held at a time
        for name, fn in variants:
            reset_peak_mem(device)
            r.time(name, lambda f=fn: f(model, kv, cache, r), iters=3,
                   suffix=lambda s: f"  ({s * 1e3 / STEPS:.4f} ms a step)")
            if name == "full loop":
                if device.type == "cuda":
                    tr = trace_call(lambda f=fn: f(model, kv, cache))
                    r.extra["full_loop_trace"] = tr
                    log_trace(name, tr)
                else:
                    log(f"{name}: busy share and kernels not measured (no "
                        "card)")
            r.extra["peak_device_mem_gib"][name] = peak_mem_gib(device)
            fn.release()

    floor("bf16", cross_kv)
    measure([
        ("full loop", make_loop()),
        ("full loop + logit filters", make_loop(filters=True)),
        ("no cross-attn", make_loop(cross=False)),
        ("no self-attn", make_loop(self_attn=False)),
        ("no mlp", make_loop(mlp=False)),
        ("no logits/argmax", make_loop(logits=False)),
        ("cross only", make_loop(self_attn=False, mlp=False, logits=False)),
        ("empty-ish (emb+ln only)", make_loop(cross=False, self_attn=False,
                                              mlp=False, logits=False)),
    ], cross_kv)
    del cross_kv

    cross_kv_q = wmodel.precompute_cross_kv(model, xa, quantize=True)
    floor("int8", cross_kv_q)
    int8_variants = [
        ("full loop int8 mxu", make_loop(cross_impl="int8_mxu")),
        ("full loop int8 xla-dequant", make_loop(cross_impl="int8_xla")),
        ("cross only int8 mxu", make_loop(self_attn=False, mlp=False,
                                          logits=False,
                                          cross_impl="int8_mxu")),
        ("cross only int8 xla-dequant", make_loop(self_attn=False, mlp=False,
                                                  logits=False,
                                                  cross_impl="int8_xla")),
    ]
    if int8_pallas:
        int8_variants += [
            ("full loop int8 pallas", make_loop(cross_impl="int8_pallas")),
            ("cross only int8 pallas", make_loop(self_attn=False, mlp=False,
                                                 logits=False,
                                                 cross_impl="int8_pallas")),
        ]
    measure(int8_variants, cross_kv_q)
    r.emit()


if __name__ == "__main__":
    main()
