"""Which op makes a row's bits depend on the rows beside it: one row
computed alone against the same row computed among others, op by op, at
Whisper-medium width in bf16 with random weights.

    python -m whisper_char_alignment_tpu_torch.scripts.diagnose_rows
    python -m whisper_char_alignment_tpu_torch.scripts.diagnose_rows --plain

Cases (:func:`cases`): the greedy ``decode_step`` of one item alone
against the same item in batches of 4, 8 and 16; ``decode_window`` over 5
tokens against 5 ``decode_step`` calls; ``decode_prefill`` of a 4-token
prompt against 4 steps; ``encode_audio`` and ``precompute_cross_kv`` of one
utterance alone against the same utterance among 4, 8 and 16;
``decode_text`` (the capture, with the width-3 QK post-process) of a t-token
transcript against the same transcript padded by a 32-token bucket. Both
sides of a case get the same inputs (the batch's cache, K/V and states
sliced for the item alone), so only the ops under test differ.

Every op the models module runs is recorded in call order (layer norms,
linears, attention, the lm head, the encoder attention and convolutions, the
QK post-process), and each op's rows are compared: rows, the largest
difference and bit-equal yes or no, and the first op that differs. After
the first, differences flow downstream, so ``suspects`` also holds each
suspect op on its own, with one input given alone and among others,
among them the decode loops' reductions over the vocabulary
(``decoding.vocab_softmax``, ``vocab_log_softmax``,
``vocab_logsumexp``).

``--plain`` runs the decoder attention and linears by their plain versions
on the card (``torch.matmul``, ``F.linear``: the port's numbers before
``csrc/dec_attn.cu`` and ``csrc/rows_linear.cu``) and the encoder in one
library call per op over the batch. Prints the tables on stderr and one JSON
line on stdout; ``--out FILE`` writes every op's row. Runs on the card
unless ``WCA_PLATFORM=cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from typing import Callable, Dict, List

import torch
from torch import nn

from ..bench import build_model, device_label, log, platform_device
from ..config import MODEL_DIMS
from ..models import decoding
from ..models import whisper as wm
from ..ops import dec_attn_cuda, rows_linear_cuda
from ..utils import device as udev

TOKEN_BUCKET = 32
BATCHES = (4, 8, 16)
WINDOW = 5
PROMPT = 4
CAPTURE_TOKENS = 20
WINDOW_BATCH = 4
AUDIO_BATCHES = (4, 8, 16)


@contextlib.contextmanager
def plain_ops():
    """The parent's arithmetic on the card: the two kernels' plain versions,
    the encoder's ops over the whole batch, and the decode loops'
    vocabulary reductions by the library on the rows where they lie."""
    saved = (wm.dec_attn, wm.rows_linear, udev.per_utterance,
             decoding.vocab_softmax, decoding.vocab_log_softmax,
             decoding.vocab_logsumexp)
    wm.dec_attn = dec_attn_cuda.dec_attn_plain
    wm.rows_linear = rows_linear_cuda.rows_linear_plain
    udev.per_utterance = lambda fn, x: fn(x)
    decoding.vocab_softmax = lambda x: torch.softmax(x, dim=-1)
    decoding.vocab_log_softmax = lambda x: torch.log_softmax(x, dim=-1)
    decoding.vocab_logsumexp = lambda x: torch.logsumexp(x, dim=-1)
    try:
        yield
    finally:
        (wm.dec_attn, wm.rows_linear, udev.per_utterance,
         decoding.vocab_softmax, decoding.vocab_log_softmax,
         decoding.vocab_logsumexp) = saved


@contextlib.contextmanager
def recording(model: nn.Module, log_: List[tuple], keep=lambda t: t):
    """Append (op label, ``keep(output)``) to ``log_`` for every op of the
    models module called while the block runs."""
    names = {id(m): n for n, m in model.named_modules()}
    state = {"module": "input"}
    saved = {k: getattr(wm, k) for k in (
        "_layer_norm", "_linear", "_encoder_linear", "dec_attn", "_logits",
        "encoder_self_attention", "qk_to_attention")}
    per_utt = udev.per_utterance

    def by_module(key):
        fn = saved[key]

        def wrapped(mod, x, *args, **kwargs):
            out = fn(mod, x, *args, **kwargs)
            label = names.get(id(mod), type(mod).__name__)
            state["module"] = label
            log_.append((label, keep(out.detach()).clone()))
            return out
        return wrapped

    def by_name(key, label):
        fn = saved[key]

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            first = out[0] if isinstance(out, tuple) else out
            log_.append((f"{label} after {state['module']}",
                         keep(first.detach()).clone()))
            if isinstance(out, tuple) and out[1] is not None:
                log_.append((f"{label} scores after {state['module']}",
                             keep(out[1].detach()).clone()))
            return out
        return wrapped

    def per_utterance(fn, x):
        out = per_utt(fn, x)
        if isinstance(fn, nn.Conv1d):
            state["module"] = names.get(id(fn), "conv")
            log_.append((state["module"], keep(out.detach()).clone()))
        return out

    wm._layer_norm = by_module("_layer_norm")
    wm._linear = by_module("_linear")
    wm._encoder_linear = by_module("_encoder_linear")
    wm._logits = by_name("_logits", "lm head")
    wm.dec_attn = by_name("dec_attn", "attention")
    wm.encoder_self_attention = by_name("encoder_self_attention",
                                        "encoder attention")
    wm.qk_to_attention = by_name("qk_to_attention", "QK post-process")
    udev.per_utterance = per_utterance
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(wm, k, v)
        udev.per_utterance = per_utt


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view({2: torch.int16, 4: torch.int32,
                                8: torch.int64}[t.element_size()])


def compare(label: str, alone: torch.Tensor, among: torch.Tensor) -> dict:
    """One op's rows: ``alone`` and ``among`` the same rows of both runs,
    cut to their common extent on every axis (a padded transcript's extra
    rows and keys are not the item's)."""
    cut = tuple(slice(0, min(a, b)) for a, b in zip(alone.shape, among.shape))
    a, b = alone[cut], among[cut]
    same = _bits(a) == _bits(b)
    diff = 0.0
    if not bool(same.all()):
        d = (a.float() - b.float()).abs()[~same]
        diff = float(torch.nan_to_num(d, nan=float("inf")).max())
    rows = a.reshape(-1, a.shape[-1]).shape[0] if a.ndim else 1
    return {"op": label, "rows": rows, "max_abs_diff": diff,
            "bit_equal": bool(same.all())}


def run_case(model, fn_alone: Callable, fn_among: Callable,
             pairs: Callable, row=None) -> List[dict]:
    """Record both sides and compare op by op: ``pairs(alone_log,
    among_log)`` yields (label, alone rows, among rows); with ``row`` the
    among side keeps only that batch item of each op."""
    alone, among = [], []
    with recording(model, alone):
        fn_alone()
    keep = (lambda t: t) if row is None else (lambda t: t[row:row + 1])
    with recording(model, among, keep):
        fn_among()
    return [compare(label, a, b) for label, a, b in pairs(alone, among)]


def _same_ops(alone, among):
    """Both sides op for op (a batch item alone against the same item
    among others, or the same batch at two lengths)."""
    if len(alone) != len(among):
        raise RuntimeError(f"{len(alone)} ops alone, {len(among)} among")
    for (label, a), (_, b) in zip(alone, among):
        yield label, a, b


def _position_pairs(n_steps: int):
    """Row t of a P-row pass (window, prompt) against step t: the pass's
    ops then each step's, in the same order. An op the pass ran on one row
    only (the prompt's last-row lm head) is held against its step only."""
    def pairs(passed, steps):
        per = len(steps) // n_steps
        if per * n_steps != len(steps) or per != len(passed):
            raise RuntimeError(f"{len(passed)} ops in the pass, "
                               f"{len(steps)} in {n_steps} steps")
        for t in range(n_steps):
            step = steps[t * per:(t + 1) * per]
            for (label, a), (_, b) in zip(passed, step):
                if a.shape == b.shape:
                    if t == n_steps - 1:  # the pass's op on its last row only
                        yield f"{label} (row {t})", a, b
                    continue
                if b.ndim == a.ndim - 1:
                    b = b.unsqueeze(-2)
                yield f"{label} (row {t})", a.select(-2, t), b.select(-2, 0)
    return pairs


def _cache(model, b: int, max_len: int):
    return wm.init_kv_cache(model.dims, b, max_len, dtype=model.dtype,
                            device=model.device)


def _slice_cache(cache, row: int):
    return {k: v[:, row:row + 1].clone() for k, v in cache.items()}


def _clone_cache(cache):
    return {k: v.clone() for k, v in cache.items()}


def _slice_kv(cross_kv, row: int):
    return tuple(c[:, row:row + 1].contiguous() for c in cross_kv)


def cases(model, gen: torch.Generator) -> Dict[str, List[dict]]:
    """Every case's op table (:data:`CASES` in order)."""
    dims, dev, dtype = model.dims, model.device, model.dtype
    d = dims.n_text_state
    nb = max(BATCHES)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def tokens(*shape):
        return torch.randint(0, dims.n_vocab, shape, generator=gen,
                             device=dev)

    out = {}
    xa = randn(nb, dims.n_audio_ctx, dims.n_audio_state)
    kv = wm.precompute_cross_kv(model, xa)
    cache = _cache(model, nb, 64)
    wm.decode_prefill(model, tokens(nb, 3), cache, kv)
    step_tok = tokens(nb, 1)
    for n in BATCHES:
        row = n - 1
        kv_n = tuple(c[:, :n].contiguous() for c in kv)
        cache_n = {k: v[:, :n].clone() for k, v in cache.items()}
        out[f"decode_step B=1 vs B={n}"] = run_case(
            model,
            lambda: wm.decode_step(model, step_tok[row:row + 1], 3,
                                   _slice_cache(cache_n, row),
                                   _slice_kv(kv_n, row)),
            lambda: wm.decode_step(model, step_tok[:n], 3,
                                   _clone_cache(cache_n), kv_n),
            _same_ops, row)

    b = WINDOW_BATCH
    kv_b = tuple(c[:, :b].contiguous() for c in kv)
    win = tokens(b, WINDOW)
    cache_b = {k: v[:, :b].clone() for k, v in cache.items()}

    def window_steps():
        c = _clone_cache(cache_b)
        for t in range(WINDOW):
            wm.decode_step(model, win[:, t:t + 1], 3 + t, c, kv_b)

    out[f"decode_window P={WINDOW} vs {WINDOW} steps"] = run_case(
        model, lambda: wm.decode_window(model, win, 3, _clone_cache(cache_b),
                                        kv_b),
        window_steps, _position_pairs(WINDOW))

    prompt = tokens(b, PROMPT)

    def prompt_steps():
        c = _cache(model, b, 64)
        for t in range(PROMPT):
            wm.decode_step(model, prompt[:, t:t + 1], t, c, kv_b)

    out[f"decode_prefill P={PROMPT} vs {PROMPT} steps"] = run_case(
        model, lambda: wm.decode_prefill(model, prompt, _cache(model, b, 64),
                                         kv_b, logits_at=PROMPT - 1),
        prompt_steps, _position_pairs(PROMPT))

    mel = torch.randn((nb, dims.n_mels, 2 * dims.n_audio_ctx), generator=gen,
                      device=dev)
    for n in AUDIO_BATCHES:
        row = n - 1
        out[f"encode_audio B=1 vs B={n}"] = run_case(
            model, lambda: wm.encode_audio(model, mel[row:row + 1],
                                           device=dev),
            lambda: wm.encode_audio(model, mel[:n], device=dev), _same_ops,
            row)
        out[f"precompute_cross_kv B=1 vs B={n}"] = run_case(
            model, lambda: wm.precompute_cross_kv(model, xa[row:row + 1]),
            lambda: wm.precompute_cross_kv(model, xa[:n]), _same_ops, row)

    t = CAPTURE_TOKENS
    text = tokens(b, t + TOKEN_BUCKET)
    frame_len = torch.full((b,), dims.n_audio_ctx, dtype=torch.int32)
    token_len = torch.full((b,), t, dtype=torch.int32)

    def capture(n_tok):
        return lambda: wm.decode_text(
            model, text[:, :n_tok], xa[:b], medfilt_width=3,
            frame_len=frame_len, token_len=token_len, device=dev)

    out[f"decode_text T={t} vs T={t + TOKEN_BUCKET}"] = run_case(
        model, capture(t), capture(t + TOKEN_BUCKET), _same_ops)
    return out


def suspects(model, gen: torch.Generator) -> List[dict]:
    """Each suspect op on its own: one input row alone against the same row
    among others (identical inputs on both sides)."""
    dims, dev, dtype = model.dims, model.device, model.dtype
    blk = model.decoder.blocks[0]
    eblk = model.encoder.blocks[0]
    hd, nh = dims.n_text_head_dim, dims.n_text_head

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    rows = []

    def held(label, alone, among):
        rows.append(compare(label, alone, among))

    x = randn(16, 1, dims.n_text_state)
    for name, lin in (("decoder query 1024x1024", blk.attn.query),
                      ("decoder mlp fc1 4096x1024", blk.mlp[0]),
                      ("decoder mlp fc2 1024x4096", blk.mlp[2])):
        xi = x if lin.in_features == dims.n_text_state else randn(
            16, 1, lin.in_features)
        for m in (5, 16):
            held(f"_linear {name}: M=1 vs M={m}", wm._linear(lin, xi[:1]),
                 wm._linear(lin, xi[:m])[:1])
    held("_logits: M=1 vs M=16", wm._logits(model, x[:1, 0]),
         wm._logits(model, x[:, 0])[:1])
    held("_layer_norm: M=1 vs M=16", wm._layer_norm(blk.attn_ln, x[:1]),
         wm._layer_norm(blk.attn_ln, x)[:1])
    scale = hd ** -0.25
    q = randn(16, nh, WINDOW, hd)
    k = randn(16, nh, hd, 64)
    v = randn(16, nh, hd, 64)
    mask = wm._position_mask(torch.arange(3, 3 + WINDOW, device=dev), 64)
    held("decoder self-attention: B=1 vs B=16",
         wm.dec_attn(q[:1, :, :1], k[:1], v[:1], dtype=dtype, mask=mask[:1],
                     k_scale=scale)[0],
         wm.dec_attn(q[:, :, :1], k, v, dtype=dtype, mask=mask[:1],
                     k_scale=scale)[0][:1])
    held(f"decoder self-attention: 1 query row vs {WINDOW}",
         wm.dec_attn(q[:1, :, 2:3], k[:1], v[:1], dtype=dtype,
                     mask=mask[2:3], k_scale=scale)[0],
         wm.dec_attn(q[:1], k[:1], v[:1], dtype=dtype, mask=mask,
                     k_scale=scale)[0][:, :, 2:3])
    kc = randn(16, nh, hd, dims.n_audio_ctx)
    vc = randn(16, nh, hd, dims.n_audio_ctx)
    held("decoder cross-attention (1500 frames): B=1 vs B=16",
         wm.dec_attn(q[:1, :, :1], kc[:1], vc[:1], dtype=dtype,
                     k_scale=scale)[0],
         wm.dec_attn(q[:, :, :1], kc, vc, dtype=dtype, k_scale=scale)[0][:1])
    nb = max(AUDIO_BATCHES)
    xa = randn(nb, dims.n_audio_ctx, dims.n_audio_state)
    held(f"cross K projection (precompute_cross_kv): B=1 vs B={nb}",
         wm._linear(blk.cross_attn.key, xa[:1]),
         wm._linear(blk.cross_attn.key, xa)[:1])
    held(f"encoder query projection: B=1 vs B={nb}",
         wm._encoder_linear(eblk.attn.query, xa[:1]),
         wm._encoder_linear(eblk.attn.query, xa)[:1])
    mel = torch.randn((nb, dims.n_mels, 2 * dims.n_audio_ctx),
                      generator=gen, device=dev).to(dtype)
    conv = model.encoder.conv1
    held(f"encoder conv1: B=1 vs B={nb}", udev.per_utterance(conv, mel[:1]),
         udev.per_utterance(conv, mel)[:1])
    # the decode loops' reductions over the vocabulary (logprobs, the
    # no-speech probability): the last row of 8 in a buffer of its own, as
    # a solo run holds it, against the same row among the batch's logits
    lg = torch.randn((8, dims.n_vocab), generator=gen, device=dev)
    for name, fn in (("logsumexp", decoding.vocab_logsumexp),
                     ("softmax", decoding.vocab_softmax),
                     ("log_softmax", decoding.vocab_log_softmax)):
        held(f"{name} over the vocabulary: row 8 of 8 alone vs in the batch",
             fn(lg[7:].clone()), fn(lg)[7:])
    return rows


def first_difference(table: List[dict]):
    return next((r for r in table if not r["bit_equal"]), None)


def diagnose(model, seed: int = 0) -> dict:
    """Both tables for ``model`` on its device."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    with torch.no_grad():
        return {"cases": cases(model, gen), "suspects": suspects(model, gen)}


def summary(result: dict) -> dict:
    """Per case: ops compared, ops bit-equal and the first op that differs;
    per suspect: bit-equal and the largest difference."""
    out = {}
    for name, table in result["cases"].items():
        first = first_difference(table)
        out[name] = {"ops": len(table),
                     "bit_equal": sum(r["bit_equal"] for r in table),
                     "first_difference": first}
    return {"cases": out, "suspects": result["suspects"]}


def log_tables(result: dict, card: str) -> None:
    log(f"row invariance on {card}")
    for name, s in summary(result)["cases"].items():
        first = s["first_difference"]
        where = ("every op bit-equal" if first is None else
                 f"first differs at {first['op']} ({first['rows']} rows, max "
                 f"abs diff {first['max_abs_diff']:.6g})")
        log(f"  {name}: {s['bit_equal']} of {s['ops']} ops bit-equal; {where}")
    for r in result["suspects"]:
        same = "bit-equal" if r["bit_equal"] else "DIFFERS"
        log(f"  suspect {r['op']}: {same} ({r['rows']} rows, max abs diff "
            f"{r['max_abs_diff']:.6g})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--plain", action="store_true",
                    help="the plain versions of the decoder's attention and "
                         "linears, the encoder in one call over the batch")
    ap.add_argument("--out", help="write every op's row to this JSON file")
    args = ap.parse_args(argv)
    device = platform_device()
    model = build_model(MODEL_DIMS["medium"], device)
    card = device_label(device)
    with plain_ops() if args.plain else contextlib.nullcontext():
        result = diagnose(model)
    log_tables(result, card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(result, device=card, plain=args.plain), f, indent=1)
    print(json.dumps(dict(summary(result), device=card, plain=args.plain)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
