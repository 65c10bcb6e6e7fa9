"""Greedy autoregressive transcription with Whisper's decoding rules.

Port of the greedy case of ``whisper_char_alignment_tpu/models/decoding.py``.
Each step applies the published logit filters over the batch:

1. SuppressBlank — " " and eot suppressed at the first sampled position;
2. SuppressTokens — non-speech symbols + [transcribe, translate, sot,
   sot_prev, sot_lm, no_speech] (the "-1" default suppress set);
3. ApplyTimestampRules — no_timestamps always suppressed; timestamps come in
   pairs; timestamps are monotonic; the first sampled token must be a
   timestamp (capped by max_initial_timestamp); and when the summed
   timestamp probability exceeds the best text token, text is suppressed.

The prompt is consumed in one teacher-forced prefill pass, then one
``decode_step`` per position until every row has emitted eot or the sample
budget runs out. The loop's state lives on the device and a step never reads
the host (:func:`loop_step_`; steps past the end change nothing), so on a
card the loop replays a captured CUDA graph of a chunk of steps and reads
one done flag a chunk (``models/decode_graph.py``, the counterpart of the
JAX package's jitted ``while_loop``); on the CPU the same step runs eagerly
(:func:`_decode_loop`). Beam search, temperature sampling,
language detection and prompt/prefix conditioning are refused with
``NotImplementedError`` (a later slice ports them).

The opt-in decode modes of the JAX package are here too: cross K/V over the
first ``kv_frames`` encoder frames only, int8 cross K/V, and their margin
guards, which re-decode exactly every utterance whose smallest top1-top2
logit gap falls below the guard.
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils.unported import not_ported
from . import whisper as wmodel

_NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class DecodingOptions:
    task: str = "transcribe"
    language: Optional[str] = None
    temperature: float = 0.0  # 0.0 = deterministic (greedy/beam); >0 samples
    sample_len: Optional[int] = None
    best_of: Optional[int] = None
    beam_size: Optional[int] = None
    patience: Optional[float] = None
    length_penalty: Optional[float] = None
    prompt: Optional[object] = None  # str | List[int]
    prefix: Optional[object] = None  # str | List[int]
    suppress_tokens: Optional[str] = "-1"
    suppress_blank: bool = True
    without_timestamps: bool = False
    max_initial_timestamp: Optional[float] = 1.0


@dataclasses.dataclass
class DecodingResult:
    language: str
    tokens: List[int]
    text: str
    avg_logprob: float
    no_speech_prob: float
    temperature: float
    compression_ratio: float
    # sequence positions the loop reached for the whole batch (prompt
    # positions count whether prefilled or stepped)
    n_steps: int = 0
    # smallest sampled-step top1-top2 filtered-logit gap of the utterance,
    # filled only when a guard tracked margins; NaN otherwise
    min_margin: float = float("nan")


# Default min-margin guards (logit units) of the guarded int8 and
# frame-bucket modes: an utterance re-decodes exactly unless every sampled
# step's top1-top2 filtered-logit gap exceeds the active guards' sum. A
# deployment that has measured its own bounds sets the environment values.
DEFAULT_KV_INT8_GUARD_MARGIN = 2.0
DEFAULT_BUCKET_GUARD_MARGIN = 2.0


def default_guard_margin() -> float:
    """The int8 guard: ``WCA_KV_INT8_GUARD_MARGIN``, default 2.0."""
    return float(os.environ.get("WCA_KV_INT8_GUARD_MARGIN",
                                DEFAULT_KV_INT8_GUARD_MARGIN))


def default_bucket_guard_margin() -> float:
    """The frame-bucket guard: ``WCA_BUCKET_GUARD_MARGIN``, default 2.0."""
    return float(os.environ.get("WCA_BUCKET_GUARD_MARGIN",
                                DEFAULT_BUCKET_GUARD_MARGIN))


def resolved_special_tokens(tokenizer, language: Optional[str],
                            task: Optional[str]):
    """(language_token, task_token) to patch into a sot sequence, or None
    where no patch applies. Accepts full language names ('English'); raises
    on unknown/unsupported languages."""
    from ..text.tokenizer import normalize_language

    lang_tok = task_tok = None
    if language is not None and tokenizer.is_multilingual:
        code = normalize_language(language)
        codes = tokenizer.all_language_codes
        if code not in codes:
            raise ValueError(
                f"language {language!r} is not supported by this tokenizer "
                f"({len(codes)} languages)")
        lang_tok = tokenizer.sot + 1 + codes.index(code)
    if task == "translate" and tokenizer.is_multilingual:
        task_tok = tokenizer.translate
    return lang_tok, task_tok


def _get_suppress_tokens(tokenizer, options: DecodingOptions) -> Tuple[int, ...]:
    """The published _get_suppress_tokens semantics: a comma string or an int
    iterable; a -1 anywhere expands to the non-speech symbols (and is
    dropped); the task/sot specials are always added."""
    opt = options.suppress_tokens
    if isinstance(opt, str):
        suppress = [int(t) for t in opt.split(",") if t.strip()]
    elif opt:
        suppress = [int(t) for t in opt]
    else:
        suppress = []
    if -1 in suppress:
        suppress = [t for t in suppress if t >= 0]
        suppress.extend(tokenizer.non_speech_tokens)
    suppress.extend([tokenizer.transcribe, tokenizer.translate, tokenizer.sot,
                     tokenizer.sot_prev, tokenizer.sot_lm])
    if tokenizer.no_speech is not None:
        suppress.append(tokenizer.no_speech)
    return tuple(sorted(set(suppress)))


def apply_logit_filters(logits: torch.Tensor, cur_len,
                        tokens: torch.Tensor, has_ts: torch.Tensor,
                        last_ts_tok: torch.Tensor, suppress_mask: torch.Tensor,
                        blank_mask: torch.Tensor, vocab_ids: torch.Tensor, *,
                        sample_begin: int, ts_begin: int, eot: int,
                        no_timestamps: int,
                        max_initial_ts_index: Optional[int],
                        use_timestamps: bool) -> torch.Tensor:
    """The published per-step logit filters (SuppressBlank, SuppressTokens,
    ApplyTimestampRules) over a (B, V) batch. ``cur_len`` is the position
    being predicted, a Python int or a (1,) int64 tensor on the logits'
    device; ``tokens`` (B, total) holds the consumed prefix. Every rule is a
    select on ``cur_len`` (JAX ``models/decoding.py:130-180``), never a host
    branch, so the filters run inside a captured decode step."""
    cur_len = wmodel._as_position(cur_len, logits.device)
    sampled = cur_len - sample_begin  # how many sampled tokens exist, (1,)
    first = sampled == 0
    logits = logits + (suppress_mask
                       + torch.where(first, blank_mask, 0.0))[None]
    if not use_timestamps:
        return logits
    last_tok = tokens.index_select(1, (cur_len - 1).clamp(min=0))[:, 0]
    penult_tok = tokens.index_select(1, (cur_len - 2).clamp(min=0))[:, 0]
    last_was = (last_tok >= ts_begin) & (sampled >= 1)
    penult_was = (penult_tok >= ts_begin) | (sampled < 2)
    is_ts_col = (vocab_ids >= ts_begin)[None]
    is_text_col = (vocab_ids < eot)[None]
    kill = (vocab_ids == no_timestamps)[None]
    kill = kill | ((last_was & penult_was)[:, None] & is_ts_col)
    kill = kill | ((last_was & ~penult_was)[:, None] & is_text_col)
    # monotonic timestamps: forbid [ts_begin, ts_last)
    ts_last = torch.where(last_was & ~penult_was, last_ts_tok, last_ts_tok + 1)
    kill = kill | (has_ts[:, None] & is_ts_col
                   & (vocab_ids[None] < ts_last[:, None]))
    # the first sampled token must be a timestamp, capped
    kill_first = ~is_ts_col
    if max_initial_ts_index is not None:
        kill_first = kill_first | (
            vocab_ids > ts_begin + max_initial_ts_index)[None]
    kill = kill | (first[:, None] & kill_first)
    logits = logits.masked_fill(kill, _NEG_INF)
    # prefer timestamps when their total probability dominates any text
    # token (raw-logit reductions: the shared log-softmax normalizer cancels)
    ts_lp = torch.logsumexp(logits[:, ts_begin:], dim=-1)
    max_text_lp = logits[:, :ts_begin].amax(dim=-1)
    kill_text_all = ((ts_lp > max_text_lp)[:, None]
                     & (vocab_ids < ts_begin)[None])
    return logits.masked_fill(kill_text_all, _NEG_INF)


def _decode_plan(dims, tokenizer, mel: torch.Tensor,
                 options: Optional[DecodingOptions]):
    """Host-side decode setup: the published initial token sequence,
    sample_len clamping, suppress/blank masks and option validation.

    Returns (options, single, mel (B, ...), sample_begin, sample_len,
    sot_index, prompt_arr, suppress_mask, blank_mask, max_initial_ts_index).
    """
    options = options or DecodingOptions()
    single = mel.ndim == 2
    if single:
        mel = mel[None]
    if (options.language is None and tokenizer.is_multilingual
            and len(tokenizer.sot_sequence) >= 2):
        raise not_ported("language detection (language=None)", "decoding")
    if options.prompt or options.prefix:
        raise not_ported("prompt/prefix conditioning", "decoding")
    if options.beam_size is not None or options.temperature > 0:
        raise not_ported("beam search and temperature sampling", "decoding")

    if options.without_timestamps:
        sot_seq = list(tokenizer.sot_sequence_including_notimestamps)
    else:
        sot_seq = list(tokenizer.sot_sequence)
    sample_len = options.sample_len or dims.n_text_ctx // 2
    initial = list(sot_seq)
    sample_begin = len(initial)
    sot_index = initial.index(tokenizer.sot)
    prompt_arr = np.asarray(initial, np.int64)
    lang_pos = sot_index + 1  # ..., sot, language, task[, notimestamps]
    lang_tok, task_tok = resolved_special_tokens(tokenizer, options.language,
                                                 options.task)
    if lang_tok is not None and len(sot_seq) >= 2:
        prompt_arr[lang_pos] = lang_tok
    if task_tok is not None and len(sot_seq) >= 3:
        prompt_arr[lang_pos + 1] = task_tok
    # the decoder's learned positions end at n_text_ctx
    sample_len = max(0, min(sample_len, dims.n_text_ctx - sample_begin))

    suppress = _get_suppress_tokens(tokenizer, options)
    suppress_mask = np.zeros((dims.n_vocab,), np.float32)
    suppress_mask[list(suppress)] = -np.inf
    blank_mask = np.zeros((dims.n_vocab,), np.float32)
    if options.suppress_blank:
        blank_ids = tokenizer.encode(" ") + [tokenizer.eot]
        blank_mask[blank_ids] = -np.inf

    max_initial_ts_index = None
    if options.max_initial_timestamp is not None and not options.without_timestamps:
        max_initial_ts_index = round(options.max_initial_timestamp / 0.02)

    # published option validation (whisper DecodingTask._verify_options)
    if options.patience is not None and options.beam_size is None:
        raise ValueError("patience requires beam_size to be given")
    if options.length_penalty is not None and not (
            0 <= options.length_penalty <= 1):
        raise ValueError(
            "length_penalty (alpha) should be a value between 0 and 1")
    if options.best_of is not None:
        raise ValueError(
            "best_of with greedy sampling (temperature=0) is not compatible")

    return (options, single, mel, sample_begin, sample_len, sot_index,
            prompt_arr, suppress_mask, blank_mask, max_initial_ts_index)


@dataclasses.dataclass(frozen=True)
class LoopSpec:
    """What every step of one greedy decode does: the Python values the step
    reads (never tensors), so a captured step is keyed by them."""
    sample_begin: int
    total: int  # sample_begin + the sample budget
    ts_begin: int
    eot: int
    no_timestamps: int
    no_speech: Optional[int]
    max_initial_ts_index: Optional[int]
    use_timestamps: bool
    sot_index: int
    cross_mode: str
    track_margin: bool


@dataclasses.dataclass
class LoopState:
    """The greedy loop's state, every tensor on the model's device (JAX
    ``models/decoding.py:196-347`` carries the same through its
    ``while_loop``). :func:`loop_step_` updates it in place."""
    tokens: torch.Tensor  # (B, total) int64: the prompt, then sampled tokens
    cache: wmodel.Cache  # self-attention K/V, (L, B, H, hd, total) each
    i: torch.Tensor  # (1,) int64: the position the next step predicts
    finished: torch.Tensor  # (B,) bool
    sum_lp: torch.Tensor  # (B,) float32
    has_ts: torch.Tensor  # (B,) bool
    last_ts_tok: torch.Tensor  # (B,) int64
    ns_prob: torch.Tensor  # (B,) float32
    min_margin: torch.Tensor  # (B,) float32
    done: torch.Tensor  # (1,) bool: every row finished or i reached total
    suppress_mask: torch.Tensor  # (V,) float32
    blank_mask: torch.Tensor  # (V,) float32
    vocab_ids: torch.Tensor  # (V,) int64

    def flat(self) -> List[torch.Tensor]:
        """Every tensor of the state, in a fixed order."""
        return [self.cache["k"], self.cache["v"]] + [
            getattr(self, f.name) for f in dataclasses.fields(self)
            if f.name != "cache"]

    def clone(self) -> "LoopState":
        return LoopState(**{
            f.name: ({k: v.clone() for k, v in self.cache.items()}
                     if f.name == "cache" else getattr(self, f.name).clone())
            for f in dataclasses.fields(self)})


def loop_setup(model, xa: torch.Tensor, prompt: np.ndarray,
               suppress_mask: torch.Tensor, blank_mask: torch.Tensor,
               spec: LoopSpec, kv_frames: Optional[int] = None,
               kv_int8: bool = False):
    """The cross K/V (sliced to ``kv_frames`` frames, int8 ``(codes,
    scales)`` under ``kv_int8``), the prompt's one-pass prefill and the
    loop's initial state. Returns (state, cross_kv)."""
    dev = xa.device
    b = xa.shape[0]
    xa_kv = xa
    if kv_frames is not None and kv_frames < xa.shape[1]:
        # attend only to the first kv_frames encoder positions: not equal to
        # the reference, which attends over the padded silence as well
        xa_kv = xa[:, :kv_frames]
    cross_kv = wmodel.precompute_cross_kv(model, xa_kv, quantize=kv_int8)
    cache = wmodel.init_kv_cache(model.dims, b, spec.total, dtype=model.dtype,
                                 device=dev)
    tokens = torch.full((b, spec.total), spec.eot, dtype=torch.long,
                        device=dev)
    tokens[:, :spec.sample_begin] = torch.from_numpy(prompt).to(dev)
    ns_prob = (torch.zeros(b, device=dev) if spec.no_speech is not None
               else torch.full((b,), float("nan"), device=dev))
    if spec.sample_begin >= 2:
        # positions 0..sample_begin-2 in one teacher-forced pass; the first
        # step consumes the last prompt token
        ns_at = (spec.sot_index if (spec.no_speech is not None
                                    and spec.sot_index < spec.sample_begin - 1)
                 else None)
        pf_logits, cache = wmodel.decode_prefill(
            model, tokens[:, :spec.sample_begin - 1], cache, cross_kv,
            logits_at=ns_at, cross_mode=spec.cross_mode)
        if ns_at is not None:
            ns_prob = torch.softmax(pf_logits, dim=-1)[:, spec.no_speech]
    state = LoopState(
        tokens=tokens, cache=cache,
        i=torch.full((1,), spec.sample_begin, dtype=torch.long, device=dev),
        finished=torch.zeros(b, dtype=torch.bool, device=dev),
        sum_lp=torch.zeros(b, device=dev),
        has_ts=torch.zeros(b, dtype=torch.bool, device=dev),
        last_ts_tok=torch.zeros(b, dtype=torch.long, device=dev),
        ns_prob=ns_prob,
        min_margin=torch.full((b,), float("inf"), device=dev),
        done=torch.full((1,), spec.sample_begin >= spec.total,
                        dtype=torch.bool, device=dev),
        suppress_mask=suppress_mask.to(dev), blank_mask=blank_mask.to(dev),
        vocab_ids=torch.arange(model.dims.n_vocab, device=dev))
    return state, cross_kv


def loop_step_(model, st: LoopState, cross_kv, spec: LoopSpec) -> None:
    """One step of the greedy loop, in place, without a host read: JAX's
    ``while_loop`` body (``models/decoding.py:245-310``) under its ``cond``.
    A step taken when every row has finished or ``i`` has reached ``total``
    changes no output (tokens, scores, margins, ``i``), so a caller may run
    steps past the end in chunks and read ``st.done`` once a chunk."""
    active = (st.i < spec.total) & ~st.finished.all()  # JAX's cond, (1,)
    pos_in = st.i - 1
    logits, _ = wmodel.decode_step(model, st.tokens.index_select(1, pos_in),
                                   pos_in, st.cache, cross_kv,
                                   cross_mode=spec.cross_mode)
    ns_prob = st.ns_prob
    if spec.no_speech is not None:
        # the no-speech probe right after sot, a select (JAX's lax.cond)
        ns_prob = torch.where(active & (st.i == spec.sot_index + 1),
                              torch.softmax(logits, dim=-1)[:, spec.no_speech],
                              ns_prob)
    filtered = apply_logit_filters(
        logits, st.i, st.tokens, st.has_ts, st.last_ts_tok, st.suppress_mask,
        st.blank_mask, st.vocab_ids, sample_begin=spec.sample_begin,
        ts_begin=spec.ts_begin, eot=spec.eot,
        no_timestamps=spec.no_timestamps,
        max_initial_ts_index=spec.max_initial_ts_index,
        use_timestamps=spec.use_timestamps)
    finished = st.finished
    next_sampled = filtered.argmax(dim=-1)
    top1 = filtered.amax(dim=-1)
    min_margin = st.min_margin
    if spec.track_margin:
        # the gap a logit perturbation must exceed to flip this step's
        # token: a second max with exactly the argmax index masked, so a
        # tie at the top gives 0
        second = filtered.masked_fill(
            st.vocab_ids[None, :] == next_sampled[:, None],
            _NEG_INF).amax(dim=-1)
        min_margin = torch.where(finished, min_margin,
                                 torch.minimum(min_margin, top1 - second))
    # greedy picks the max: its log-softmax value is max - logsumexp
    chosen_lp = top1 - torch.logsumexp(filtered, dim=-1)
    next_tok = torch.where(finished, spec.eot, next_sampled)
    sum_lp = torch.where(finished, st.sum_lp, st.sum_lp + chosen_lp)
    sampled_ts = ~finished & (next_tok >= spec.ts_begin)
    has_ts = st.has_ts | sampled_ts
    last_ts_tok = torch.where(sampled_ts, next_tok, st.last_ts_tok)
    new_finished = finished | (next_tok == spec.eot)
    # commit, where the step is active
    pos = st.i.clamp(max=spec.total - 1)
    st.tokens.index_copy_(1, pos, torch.where(
        active, next_tok, st.tokens.index_select(1, pos)[:, 0])[:, None])
    for old, new in ((st.finished, new_finished), (st.sum_lp, sum_lp),
                     (st.has_ts, has_ts), (st.last_ts_tok, last_ts_tok),
                     (st.ns_prob, ns_prob), (st.min_margin, min_margin)):
        old.copy_(torch.where(active, new, old))
    st.i.add_(active.long())


def run_chunk_(model, st: LoopState, cross_kv, spec: LoopSpec,
               steps: int) -> None:
    """``steps`` loop steps, then ``st.done``: the unit the eager loop runs
    between host reads and ``models/decode_graph.py`` captures."""
    for _ in range(steps):
        loop_step_(model, st, cross_kv, spec)
    st.done.copy_((st.i >= spec.total) | st.finished.all())


def loop_outputs(st: LoopState):
    """(tokens (B, total), sum_logprobs (B,), no_speech_probs (B,), n_steps
    (1,), min_margin (B,)): n_steps counts the sequence positions reached,
    prompt positions included (JAX's ``i - 1``)."""
    return st.tokens, st.sum_lp, st.ns_prob, st.i - 1, st.min_margin


@torch.no_grad()
def _decode_loop(model, xa: torch.Tensor, prompt: np.ndarray,
                 suppress_mask: torch.Tensor, blank_mask: torch.Tensor,
                 spec: LoopSpec, kv_frames: Optional[int] = None,
                 kv_int8: bool = False, chunk: int = 1):
    """The greedy loop run eagerly from encoder states xa (B, n_audio_ctx,
    d): ``chunk`` steps (:func:`run_chunk_`) between host reads of the done
    flag. The CPU path, and on a card the plain version that
    ``models/decode_graph.py`` is held against.

    Returns (tokens, sum_logprobs, no_speech_probs, n_steps, cross_kv,
    min_margin) (:func:`loop_outputs`); cross_kv are the K/V the loop used,
    (L, B, H, hd, F) each, reusable by the teacher-forced capture pass only
    without ``kv_frames`` or ``kv_int8``. With ``spec.track_margin`` each
    active sampled step's top1-top2 filtered-logit gap is tracked and
    min_margin is its smallest value per row (+inf otherwise)."""
    st, cross_kv = loop_setup(model, xa, prompt, suppress_mask, blank_mask,
                              spec, kv_frames, kv_int8)
    while not bool(st.done):
        run_chunk_(model, st, cross_kv, spec, chunk)
    tokens, sum_lp, ns_prob, n_steps, margin = loop_outputs(st)
    return tokens, sum_lp, ns_prob, n_steps, cross_kv, margin


def _loop_for(device: torch.device):
    """The greedy loop for a model on ``device``: a captured CUDA graph on a
    card (``models/decode_graph.py``; a failed capture raises), the eager
    loop on the CPU."""
    if device.type == "cuda":
        from . import decode_graph

        return decode_graph.graphed_loop
    return _decode_loop


class DecodeFuture:
    """Deferred decode results (JAX ``models/decoding.py:350-372``): the
    loop's outputs copied to pinned host memory without blocking, behind a
    CUDA event, so the caller can queue the next batch's device work before
    paying this batch's host sync. :meth:`result` waits for the copies and
    finalizes (``finalize(*numpy_arrays)``, once), running a guard's
    re-decode of flagged rows there. The runner and the probe defer their
    alignment outputs through it too. CPU tensors are taken as they are."""

    def __init__(self, arrays, finalize):
        self._host = []
        self._event = None
        for a in arrays:
            if a.device.type == "cuda":
                h = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                h.copy_(a, non_blocking=True)
                self._host.append(h)
                self._event = torch.cuda.Event()
            else:
                self._host.append(a)
        if self._event is not None:
            self._event.record()
        self._finalize = finalize
        self._results = None

    def result(self):
        if self._results is None:
            if self._event is not None:
                self._event.synchronize()
            self._results = self._finalize(*[h.numpy() for h in self._host])
            self._host = None
        return self._results


@torch.no_grad()
def decode(model, tokenizer, mel: torch.Tensor,
           options: Optional[DecodingOptions] = None,
           return_xa: bool = False, return_cross_kv: bool = False,
           xa: Optional[torch.Tensor] = None, device=None,
           kv_frames: Optional[int] = None, kv_int8: bool = False,
           kv_int8_guard: Optional[float] = None,
           kv_frames_guard: Optional[float] = None,
           async_results: bool = False):
    """Transcribe a batch of mels (B, n_mels, 2*n_audio_ctx), or one
    (n_mels, frames). Returns one DecodingResult per utterance (a single
    result for unbatched input). ``return_xa`` adds the encoder states
    (``(results, xa)``); ``return_cross_kv`` adds them and the loop's cross
    K/V stacks (``(results, xa, cross_kv)``) for reuse by the capture pass.
    ``xa`` supplies precomputed encoder states and skips the encoder. With
    ``async_results`` the results slot holds a :class:`DecodeFuture` (call
    ``.result()``) whose host copies are in flight.

    On a CUDA model the greedy loop replays a captured CUDA graph
    (``models/decode_graph.py``), reading the host once per chunk of steps;
    on the CPU it runs eagerly (:func:`_decode_loop`).

    Opt-in modes, none equal to the reference: ``kv_frames`` attends over
    the first kv_frames encoder frames only; ``kv_int8`` stores the cross
    K/V as int8 (its step runs as ``WCA_CROSS_ATTN`` says). The guards
    ``kv_int8_guard`` / ``kv_frames_guard`` (logit margins) track each
    sampled step's top1-top2 gap; rows whose smallest gap falls below the
    sum of the active guards are re-decoded, reusing xa, with the guarded
    modes off, and merged in (at ``.result()`` under ``async_results``, as
    the JAX package's ``finalize`` does). ``kv_int8_guard`` implies
    ``kv_int8``; ``kv_frames_guard`` needs ``kv_frames``."""
    dev = wmodel._check_device(model, device)
    dims = model.dims
    (options, single, mel, sample_begin, sample_len, sot_index, prompt_arr,
     suppress_mask, blank_mask, max_initial_ts_index) = _decode_plan(
         dims, tokenizer, mel, options)
    if kv_int8_guard is not None:
        kv_int8 = True  # the guard is a mode of the int8 path
    if kv_frames_guard is not None and kv_frames is None:
        raise ValueError(
            "kv_frames_guard guards the frame-bucketed decode: pass kv_frames "
            "(decode_frame_bucket > 0) alongside it")
    # the two perturbations compose additively in the worst case
    guard = ((kv_int8_guard or 0.0) + (kv_frames_guard or 0.0)
             if (kv_int8_guard is not None or kv_frames_guard is not None)
             else None)
    if xa is None:
        xa = wmodel.encode_audio(model, mel.to(dev), device=dev.type)
    suppress_t = torch.from_numpy(suppress_mask).to(dev)
    blank_t = torch.from_numpy(blank_mask).to(dev)
    loop_fn = _loop_for(dev)

    def loop(frames, int8, track):
        spec = LoopSpec(
            sample_begin=sample_begin, total=sample_begin + sample_len,
            ts_begin=tokenizer.timestamp_begin, eot=tokenizer.eot,
            no_timestamps=tokenizer.no_timestamps,
            no_speech=tokenizer.no_speech,
            max_initial_ts_index=max_initial_ts_index,
            use_timestamps=not options.without_timestamps,
            sot_index=sot_index,
            cross_mode=wmodel.cross_attn_mode(dev) if int8 else "xla",
            track_margin=track)
        return loop_fn(model, xa, prompt_arr, suppress_t, blank_t, spec,
                       kv_frames=frames, kv_int8=int8)

    tokens, sum_lp, ns_prob, n_steps, cross_kv, margin = loop(
        kv_frames, kv_int8, guard is not None)

    def finalize(tokens, sum_lp, ns_prob, n_steps, margin):
        if guard is not None:
            flagged = margin < guard
            if flagged.any():
                # only the guarded perturbations go: an unguarded mode
                # passed beside a guarded one was opted into without a
                # parity claim
                et, es, en, _, _, _ = loop(
                    None if kv_frames_guard is not None else kv_frames,
                    False if kv_int8_guard is not None else kv_int8, False)
                tokens = np.where(flagged[:, None], et.cpu().numpy(), tokens)
                sum_lp = np.where(flagged, es.cpu().numpy(), sum_lp)
                ns_prob = np.where(flagged, en.cpu().numpy(), ns_prob)
        return _results(tokenizer, options, single, sample_begin, tokens,
                        sum_lp, ns_prob, int(n_steps[0]),
                        margin if guard is not None else None)

    future = DecodeFuture((tokens, sum_lp, ns_prob, n_steps, margin),
                          finalize)
    out = future if async_results else future.result()
    if return_cross_kv:
        return out, xa, cross_kv
    return (out, xa) if return_xa else out


def _results(tokenizer, options: DecodingOptions, single: bool,
             sample_begin: int, tokens: np.ndarray, sum_lp: np.ndarray,
             ns_prob: np.ndarray, n_steps: int,
             margin: Optional[np.ndarray]):
    """One DecodingResult per row of the loop's host outputs (a single
    result for unbatched input)."""
    from ..text.tokenizer import normalize_language

    lang = normalize_language(options.language) or (tokenizer.language or "en")
    results = []
    for k in range(tokens.shape[0]):
        seq = tokens[k, sample_begin:].tolist()
        if tokenizer.eot in seq:
            seq = seq[:seq.index(tokenizer.eot)]
        text = tokenizer.decode(seq).strip()
        avg_lp = sum_lp[k] / (len(seq) + 1)
        ratio = len(text.encode()) / max(len(zlib.compress(text.encode())), 1)
        results.append(DecodingResult(
            language=lang, tokens=seq, text=text, avg_logprob=float(avg_lp),
            no_speech_prob=float(ns_prob[k]), temperature=options.temperature,
            compression_ratio=ratio, n_steps=n_steps,
            min_margin=(float(margin[k]) if margin is not None
                        else float("nan"))))
    return results[0] if single else results
