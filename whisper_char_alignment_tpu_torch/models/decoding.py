"""Autoregressive transcription with Whisper's decoding rules.

Port of ``whisper_char_alignment_tpu/models/decoding.py``. Each step applies
the published logit filters over the batch:

1. SuppressBlank — " " and eot suppressed at the first sampled position;
2. SuppressTokens — non-speech symbols + [transcribe, translate, sot,
   sot_prev, sot_lm, no_speech] (the "-1" default suppress set);
3. ApplyTimestampRules — no_timestamps always suppressed; timestamps come in
   pairs; timestamps are monotonic; the first sampled token must be a
   timestamp (capped by max_initial_timestamp); and when the summed
   timestamp probability exceeds the best text token, text is suppressed.

The prompt (the published initial tokens: an optional ``[sot_prev] +
prompt`` block, the sot sequence, an optional forced prefix) is consumed in
one teacher-forced prefill pass, then one ``decode_step`` per position until
every row has emitted eot or the sample budget runs out. ``language=None``
on a multilingual tokenizer detects each row's language first
(:func:`detect_language`, on the decode's own encoder states). The loop's
state lives on the device and a step never reads the host (:func:`loop_step_`;
steps past the end change nothing), so on a card the loop replays a
captured CUDA graph of a chunk of steps and reads one done flag a chunk
(``models/decode_graph.py``, the counterpart of the JAX package's jitted
``while_loop``); on the CPU the same step runs eagerly (:func:`run_eager`).
Beam search and temperature sampling (``models/beam.py``) and the
speculative decode (:func:`decode_speculative`) run the same way.

The opt-in decode modes of the JAX package are here too: cross K/V over the
first ``kv_frames`` encoder frames only, int8 cross K/V, and their margin
guards, which re-decode exactly every utterance whose smallest top1-top2
logit gap falls below the guard. Beam search and sampling drop them, with
the JAX package's warning.
"""

from __future__ import annotations

import dataclasses
import os
import zlib
import warnings
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

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


# The decode loops' reductions over the vocabulary, each row computed on a
# card as if it were alone. PyTorch's softmax kernels run a block a row,
# sized by the row's length, but peel a row's unaligned head first, and a
# (B, 51865) float32 row starts 4 bytes further each row: the rows go to a
# fresh buffer rounded up to 4 columns, padded with -inf (exp(-inf) adds
# exact zeros). The reduction kernel behind logsumexp splits a row by how
# many rows there are, so logsumexp is read off log_softmax instead. On
# the CPU each is the plain PyTorch call.

def _aligned(x: torch.Tensor) -> torch.Tensor:
    b, v = x.shape
    out = x.new_full((b, v + (-v % 4)), float("-inf"))
    out[:, :v] = x
    return out


def vocab_softmax(x: torch.Tensor) -> torch.Tensor:
    """softmax over the last axis of (B, V) rows."""
    if x.device.type != "cuda":
        return torch.softmax(x, dim=-1)
    return torch.softmax(_aligned(x), dim=-1)[:, :x.shape[1]]


def vocab_log_softmax(x: torch.Tensor) -> torch.Tensor:
    """log_softmax over the last axis of (B, V) rows."""
    if x.device.type != "cuda":
        return torch.log_softmax(x, dim=-1)
    return torch.log_softmax(_aligned(x), dim=-1)[:, :x.shape[1]]


def vocab_logsumexp(x: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last axis of (B, V) rows: on a card max(x) minus
    the max of log_softmax(x) (each x - max - log sum exp)."""
    if x.device.type != "cuda":
        return torch.logsumexp(x, dim=-1)
    return x.amax(dim=-1) - vocab_log_softmax(x).amax(dim=-1)


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
    ts_lp = vocab_logsumexp(logits[:, ts_begin:])
    max_text_lp = logits[:, :ts_begin].amax(dim=-1)
    kill_text_all = ((ts_lp > max_text_lp)[:, None]
                     & (vocab_ids < ts_begin)[None])
    return logits.masked_fill(kill_text_all, _NEG_INF)


def _decode_plan(dims, tokenizer, mel: torch.Tensor,
                 options: Optional[DecodingOptions],
                 detect: Optional[Callable[[], List[str]]] = None):
    """Host-side decode setup (JAX ``models/decoding.py:408-550``): language
    detection, the published initial token sequence (sot/prefix/prompt and
    their trimming quirks), per-row prompts, sample_len clamping,
    suppress/blank masks and the published option validation
    (``DecodingTask._verify_options``). ``detect()`` gives each row's
    language code; it is called only when ``language=None`` asks for it.

    Returns (options, single, mel (B, ...), sample_begin, sample_len,
    sot_index, prompt_arr ((P,) or (B, P) int64), suppress_mask, blank_mask,
    max_initial_ts_index, detected_langs (a code per row, or None))."""
    options = options or DecodingOptions()
    single = mel.ndim == 2
    if single:
        mel = mel[None]
    n = mel.shape[0]

    detected_langs = None
    if (options.language is None and tokenizer.is_multilingual
            and len(tokenizer.sot_sequence) >= 2):
        # published behaviour: detect first, then decode with each row's
        # detected token in its sot sequence
        detected_langs = list(detect())

    if options.without_timestamps:
        sot_seq = list(tokenizer.sot_sequence_including_notimestamps)
    else:
        sot_seq = list(tokenizer.sot_sequence)
    sample_len = options.sample_len or dims.n_text_ctx // 2
    # published _get_initial_tokens: forced prefix text after the sot
    # sequence, [sot_prev] + prompt tokens before it. Truthiness guards, as
    # published: an empty prompt or prefix is skipped entirely
    initial = list(sot_seq)
    if options.prefix:
        prefix_tokens = (tokenizer.encode(" " + options.prefix.strip())
                         if isinstance(options.prefix, str)
                         else list(options.prefix))
        # published quirk kept: with the default sample_len the slice is
        # [-0:], which trims nothing
        max_prefix_len = dims.n_text_ctx // 2 - sample_len
        initial = initial + prefix_tokens[-max_prefix_len:]
    prompt_rows = None  # per-row conditioning prompts
    if options.prompt:
        pr = options.prompt
        if isinstance(pr, str):
            prompt_tokens = tokenizer.encode(" " + pr.strip())
        elif (isinstance(pr, (list, tuple))
              and pr and isinstance(pr[0], (list, tuple, np.ndarray))):
            # a list of per-row token lists of one length: the fixed-shape
            # loop has one sample_begin for the batch
            prompt_rows = [list(map(int, r)) for r in pr]
            if not all(prompt_rows):
                raise ValueError("per-row prompts must be non-empty; pass "
                                 "prompt=None for promptless rows")
            lens = {len(r) for r in prompt_rows}
            if len(lens) != 1:
                raise ValueError(
                    f"per-row prompts must share one length, got "
                    f"{sorted(lens)} — bucket by prompt length upstream")
            if len(prompt_rows) != n:
                raise ValueError(
                    f"{len(prompt_rows)} per-row prompts for a batch of {n}")
            prompt_tokens = prompt_rows[0]
        else:
            prompt_tokens = list(pr)
        # published trim: the most recent n_text_ctx // 2 - 1 tokens
        kept = prompt_tokens[-(dims.n_text_ctx // 2 - 1):]
        prompt_keep = len(kept)
        initial = [tokenizer.sot_prev] + kept + initial
    sample_begin = len(initial)
    sot_index = initial.index(tokenizer.sot)
    prompt_arr = np.asarray(initial, np.int64)
    codes = tokenizer.all_language_codes
    lang_pos = sot_index + 1  # ..., sot, language, task[, notimestamps]
    lang_tok, task_tok = resolved_special_tokens(tokenizer, options.language,
                                                 options.task)
    if lang_tok is not None and len(sot_seq) >= 2:
        prompt_arr[lang_pos] = lang_tok
    if task_tok is not None and len(sot_seq) >= 3:
        prompt_arr[lang_pos + 1] = task_tok
    if detected_langs is not None:
        prompt_arr = np.tile(prompt_arr[None], (n, 1))
        for i, code in enumerate(detected_langs):
            prompt_arr[i, lang_pos] = tokenizer.sot + 1 + codes.index(code)
    if prompt_rows is not None:
        # each row's own tokens fill the [sot_prev] + prompt block; the sot
        # sequence after it is shared (or carries the detected language)
        if prompt_arr.ndim == 1:
            prompt_arr = np.tile(prompt_arr[None], (n, 1))
        for i, r in enumerate(prompt_rows):
            prompt_arr[i, 1:1 + prompt_keep] = r[-prompt_keep:]
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
    if options.beam_size is not None and options.best_of is not None:
        raise ValueError("beam_size and best_of can't be given together")
    if options.temperature == 0 and options.best_of is not None:
        raise ValueError(
            "best_of with greedy sampling (temperature=0) is not compatible")
    if options.patience is not None and options.beam_size is None:
        raise ValueError("patience requires beam_size to be given")
    if (options.beam_size is not None and options.patience is not None
            and round(options.beam_size * options.patience) < 1):
        raise ValueError(
            f"invalid beam size ({options.beam_size}) or patience "
            f"({options.patience}): less than one finished candidate")
    if options.length_penalty is not None and not (
            0 <= options.length_penalty <= 1):
        raise ValueError(
            "length_penalty (alpha) should be a value between 0 and 1")

    return (options, single, mel, sample_begin, sample_len, sot_index,
            prompt_arr, suppress_mask, blank_mask, max_initial_ts_index,
            detected_langs)


def prompt_rows(prompt: np.ndarray, b: int) -> torch.Tensor:
    """The (P,) or (B, P) prompt as (B, P) int64 on the CPU."""
    return torch.from_numpy(np.array(np.broadcast_to(
        prompt, (b, prompt.shape[-1]))))


class DeviceState:
    """Mixin of a decode loop's state dataclass, every field a tensor on the
    model's device or a dict of them (a self-attention cache): the static
    buffers a captured graph reads and writes."""

    def flat(self) -> List[torch.Tensor]:
        """Every tensor of the state, in a fixed order."""
        out = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out.extend([v[k] for k in sorted(v)] if isinstance(v, dict)
                       else [v])
        return out

    def clone(self):
        def copy(v):
            if isinstance(v, dict):
                return {k: t.clone() for k, t in v.items()}
            return v.clone()

        return type(self)(**{f.name: copy(getattr(self, f.name))
                             for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class LoopKind:
    """One decode loop as its runners see it (:func:`run_eager`, the CUDA
    graph of ``models/decode_graph.py``): ``step(st, kv, slot)`` runs one
    step in place without a host read, a step past the loop's end changing
    no output; ``finish(st)`` sets ``st.done``; ``outputs(st)`` gives the
    result tensors; ``refill(st, s, slot)``, where given, loads on the host
    side what step ``s`` of the decode reads from its ``slot`` of a chunk
    (the sampling loop's noise)."""
    step: Callable
    finish: Callable
    outputs: Callable
    refill: Optional[Callable] = None


# Steps one chunk runs: one replay of a captured graph
# (``models/decode_graph.py``, which says why 4), and the slots of the
# buffers a step reads from a refill (the sampling loop's noise).
CHUNK_STEPS = 4


def run_eager(model, key, kind: LoopKind, st, kv, max_steps: int,
              chunk: int = 1, keep=None):
    """A loop run eagerly: ``chunk`` steps between host reads of
    ``st.done``. The CPU path of every decode loop, and on a card the plain
    version its graph is held against. Takes the graph runner's arguments
    (``model``, ``key``, ``max_steps`` and ``keep`` go unread)."""
    s = 0
    while not bool(st.done):
        for _ in range(chunk):
            slot = s % CHUNK_STEPS
            if kind.refill is not None:
                kind.refill(st, s, slot)
            kind.step(st, kv, slot)
            s += 1
        kind.finish(st)
    return kind.outputs(st)


def runner_for(device: torch.device):
    """The runner of a loop on ``device``: the captured CUDA graph on a card
    (``decode_graph.replay``; a failed capture raises), :func:`run_eager` on
    the CPU."""
    if device.type == "cuda":
        from . import decode_graph

        return decode_graph.replay
    return run_eager


def loop_runner(model, device: torch.device):
    """The runner of ``model``'s loops: :func:`run_eager` for a
    tensor-parallel rank's copy (its steps run collectives, which a CUDA
    graph of a gloo group cannot hold; the choice is made up front), else
    :func:`runner_for` the device."""
    if getattr(model, "tp_group", None) is not None:
        return run_eager
    return runner_for(device)


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
class LoopState(DeviceState):
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


def loop_setup(model, xa: torch.Tensor, prompt: np.ndarray,
               suppress_mask: torch.Tensor, blank_mask: torch.Tensor,
               spec: LoopSpec, kv_frames: Optional[int] = None,
               kv_int8: bool = False):
    """The cross K/V (sliced to ``kv_frames`` frames, int8 ``(codes,
    scales)`` under ``kv_int8``), the prompt's one-pass prefill and the
    loop's initial state; ``prompt`` is (P,) or per row (B, P). Returns
    (state, cross_kv)."""
    dev = xa.device
    b = xa.shape[0]
    xa_kv = xa
    if kv_frames is not None and kv_frames < xa.shape[1]:
        # attend only to the first kv_frames encoder positions: not equal to
        # the reference, which attends over the padded silence as well
        xa_kv = xa[:, :kv_frames]
    cross_kv = wmodel.precompute_cross_kv(model, xa_kv, quantize=kv_int8)
    cache = wmodel.init_kv_cache(model.dims, b, spec.total, dtype=model.dtype,
                                 device=dev, n_head=wmodel.text_heads(model))
    tokens = torch.full((b, spec.total), spec.eot, dtype=torch.long,
                        device=dev)
    tokens[:, :spec.sample_begin] = prompt_rows(prompt, b).to(dev)
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
            ns_prob = vocab_softmax(pf_logits)[:, spec.no_speech]
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
                              vocab_softmax(logits)[:, spec.no_speech],
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
    chosen_lp = top1 - vocab_logsumexp(filtered)
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


def greedy_kind(model, spec: LoopSpec) -> LoopKind:
    """The greedy loop for the runners."""
    def finish(st: LoopState) -> None:
        st.done.copy_((st.i >= spec.total) | st.finished.all())

    return LoopKind(
        step=lambda st, kv, slot: loop_step_(model, st, kv, spec),
        finish=finish, outputs=loop_outputs)


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
    d): ``chunk`` steps between host reads of the done flag
    (:func:`run_eager`). The CPU path, and on a card the plain version that
    ``models/decode_graph.py`` is held against.

    Returns (tokens, sum_logprobs, no_speech_probs, n_steps, cross_kv,
    min_margin) (:func:`loop_outputs`); cross_kv are the K/V the loop used,
    (L, B, H, hd, F) each, reusable by the teacher-forced capture pass only
    without ``kv_frames`` or ``kv_int8``. With ``spec.track_margin`` each
    active sampled step's top1-top2 filtered-logit gap is tracked and
    min_margin is its smallest value per row (+inf otherwise)."""
    st, cross_kv = loop_setup(model, xa, prompt, suppress_mask, blank_mask,
                              spec, kv_frames, kv_int8)
    tokens, sum_lp, ns_prob, n_steps, margin = run_eager(
        model, None, greedy_kind(model, spec), st, cross_kv, 0, chunk)
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
           async_results: bool = False,
           generator: Optional[torch.Generator] = None):
    """Transcribe a batch of mels (B, n_mels, 2*n_audio_ctx), or one
    (n_mels, frames). Returns one DecodingResult per utterance (a single
    result for unbatched input). ``return_xa`` adds the encoder states
    (``(results, xa)``); ``return_cross_kv`` adds them and the loop's cross
    K/V stacks (``(results, xa, cross_kv)``) for reuse by the capture pass,
    None after beam search or sampling (their rows are repeated). ``xa``
    supplies precomputed encoder states and skips the encoder. With
    ``async_results`` the results slot holds a :class:`DecodeFuture` (call
    ``.result()``) whose host copies are in flight.

    Every option of :class:`DecodingOptions` runs: ``language=None`` detects
    each row's language (:func:`detect_language` on xa); ``prompt`` (a
    string, a token list, or equal-length token lists per row) and
    ``prefix``; ``beam_size`` with ``patience`` and ``length_penalty``, and
    ``temperature > 0`` with ``best_of`` (``models/beam.py``), whose
    Gumbel noise ``generator`` draws (a generator on the model's device
    seeded 0 when None, as the JAX package's ``rng`` defaults to
    ``PRNGKey(0)``; the numbers differ from JAX's).

    On a CUDA model every loop replays a captured CUDA graph
    (``models/decode_graph.py``), reading the host once per chunk of steps;
    on the CPU it runs eagerly (:func:`run_eager`).

    Opt-in modes of the greedy loop, none equal to the reference:
    ``kv_frames`` attends over the first kv_frames encoder frames only;
    ``kv_int8`` stores the cross K/V as int8 (its step runs as
    ``WCA_CROSS_ATTN`` says). The guards ``kv_int8_guard`` /
    ``kv_frames_guard`` (logit margins) track each sampled step's top1-top2
    gap; rows whose smallest gap falls below the sum of the active guards
    are re-decoded, reusing xa, with the guarded modes off, and merged in
    (at ``.result()`` under ``async_results``, as the JAX package's
    ``finalize`` does). ``kv_int8_guard`` implies ``kv_int8``;
    ``kv_frames_guard`` needs ``kv_frames``. Beam search and sampling drop
    all four with a warning, as the JAX package does."""
    dev = wmodel._check_device(model, device)
    dims = model.dims
    if xa is None:
        xa = wmodel.encode_audio(model, (mel[None] if mel.ndim == 2
                                         else mel).to(dev), device=dev.type)
    (options, single, mel, sample_begin, sample_len, sot_index, prompt_arr,
     suppress_mask, blank_mask, max_initial_ts_index, detected) = \
        _decode_plan(dims, tokenizer, mel, options,
                     detect=lambda: [c for c, _ in detect_language(
                         model, tokenizer, xa=xa, device=dev.type)])
    langs = detected or [_language(tokenizer, options)] * mel.shape[0]
    suppress_t = torch.from_numpy(suppress_mask).to(dev)
    blank_t = torch.from_numpy(blank_mask).to(dev)

    if options.beam_size is not None or options.temperature > 0:
        if (kv_frames is not None or kv_int8 or kv_int8_guard is not None
                or kv_frames_guard is not None):
            warnings.warn(
                "kv_frames / kv_int8 are greedy-decode-only speedups; "
                "falling back to the full-window un-quantized path for "
                "beam/sampling decoding", stacklevel=2)
        from . import beam

        future = beam.run(
            model, tokenizer, xa, options, prompt_arr, suppress_t, blank_t,
            sample_begin=sample_begin, sample_len=sample_len,
            sot_index=sot_index, max_initial_ts_index=max_initial_ts_index,
            langs=langs, single=single, generator=generator)
        out = future if async_results else future.result()
        if return_cross_kv:
            return out, xa, None
        return (out, xa) if return_xa else out

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
    # a tensor-parallel rank runs the eager loop (see loop_runner)
    loop_fn = (_decode_loop if getattr(model, "tp_group", None) is not None
               else _loop_for(dev))

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
        rows = [trim(tokens[k], sample_begin, tokenizer.eot)
                for k in range(tokens.shape[0])]
        return results(tokenizer, options, single, rows, list(sum_lp),
                       ns_prob, int(n_steps[0]), langs,
                       margin if guard is not None else None)

    future = DecodeFuture((tokens, sum_lp, ns_prob, n_steps, margin),
                          finalize)
    out = future if async_results else future.result()
    if return_cross_kv:
        return out, xa, cross_kv
    return (out, xa) if return_xa else out


def _language(tokenizer, options: DecodingOptions) -> str:
    """The language code a result reports when none was detected: the
    resolved option ("English" -> "en"), else the tokenizer's."""
    from ..text.tokenizer import normalize_language

    return normalize_language(options.language) or (tokenizer.language
                                                     or "en")


def trim(seq: np.ndarray, sample_begin: int, eot: int) -> List[int]:
    """The sampled tokens of one row: after the prompt, up to its first
    eot."""
    out = [int(t) for t in seq[sample_begin:]]
    return out[:out.index(eot)] if eot in out else out


def results(tokenizer, options: DecodingOptions, single: bool,
            seqs: List[List[int]], sum_lps, ns_prob, n_steps: int,
            langs: List[str], margin: Optional[np.ndarray] = None):
    """One DecodingResult per row's sampled tokens and summed log-prob (a
    single result for unbatched input): ``avg_logprob = sum_lp / (len +
    1)``, as published."""
    out = []
    for k, seq in enumerate(seqs):
        text = tokenizer.decode(seq).strip()
        ratio = len(text.encode()) / max(len(zlib.compress(text.encode())), 1)
        out.append(DecodingResult(
            language=langs[k], tokens=seq, text=text,
            avg_logprob=float(sum_lps[k] / (len(seq) + 1)),
            no_speech_prob=float(ns_prob[k]), temperature=options.temperature,
            compression_ratio=ratio, n_steps=n_steps,
            min_margin=(float(margin[k]) if margin is not None
                        else float("nan"))))
    return out[0] if single else out


@torch.no_grad()
def detect_language(model, tokenizer, mel: Optional[torch.Tensor] = None,
                    xa: Optional[torch.Tensor] = None, device=None):
    """Single-step language identification (JAX ``models/decoding.py:
    734-758``, the published ``detect_language``): feed sot, take the
    argmax and the softmax over the tokenizer's language tokens. Returns
    ``(code, {code: probability})`` per row (one pair for an unbatched
    mel). ``xa`` supplies the encoder states, which skips the encoder (the
    JAX package encodes the mel again; the result is the same)."""
    dev = wmodel._check_device(model, device)
    single = xa is None and mel.ndim == 2
    if xa is None:
        xa = wmodel.encode_audio(model, (mel[None] if single else mel).to(dev),
                                 device=dev.type)
    b = xa.shape[0]
    cross_kv = wmodel.precompute_cross_kv(model, xa)
    cache = wmodel.init_kv_cache(model.dims, b, 1, dtype=model.dtype,
                                 device=dev, n_head=wmodel.text_heads(model))
    sot = torch.full((b, 1), tokenizer.sot, dtype=torch.long, device=dev)
    logits, _ = wmodel.decode_step(model, sot, 0, cache, cross_kv)
    lang_logits = logits.index_select(1, torch.tensor(
        tokenizer.all_language_tokens, dtype=torch.long, device=dev))
    probs = vocab_softmax(lang_logits).cpu().numpy()
    idx = lang_logits.argmax(dim=-1).cpu().numpy()
    codes = tokenizer.all_language_codes
    out = [(codes[i], {c: float(probs[r, j]) for j, c in enumerate(codes)})
           for r, i in enumerate(idx)]
    return out[0] if single else out


# ---------------------------------------------------------------------------
# Speculative greedy decoding (a draft model proposes, one window verifies)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SpeculativeSpec:
    """What every round of one speculative decode does (Python values)."""
    sample_begin: int
    total: int
    k: int  # draft tokens a round
    ts_begin: int
    eot: int
    no_timestamps: int
    no_speech: Optional[int]
    max_initial_ts_index: Optional[int]
    use_timestamps: bool
    sot_index: int

    @property
    def buf(self) -> int:
        """Token and cache columns: a round's draft and window writes may
        run k + 1 past the budget."""
        return self.total + self.k + 1


@dataclasses.dataclass
class SpeculativeState(DeviceState):
    """The speculative loop's state (JAX ``models/decoding.py:945-948``),
    every tensor on the device; B = 1."""
    tokens: torch.Tensor  # (1, buf) int64: committed, then draft residue
    cache_t: wmodel.Cache  # the target's self-attention K/V
    cache_d: wmodel.Cache  # the draft's
    L: torch.Tensor  # (1,) int64: committed length
    finished: torch.Tensor  # (1,) bool
    sum_lp: torch.Tensor  # (1,) float32
    has_ts: torch.Tensor  # (1,) bool
    last_ts_tok: torch.Tensor  # (1,) int64
    ns_prob: torch.Tensor  # (1,) float32
    n_rounds: torch.Tensor  # (1,) int64
    done: torch.Tensor  # (1,) bool
    suppress_mask: torch.Tensor
    blank_mask: torch.Tensor
    vocab_ids: torch.Tensor
    pos_t: torch.Tensor  # (buf, d) the target's positions, zero past ctx
    pos_d: torch.Tensor  # the draft's


def _padded_positions(model, n: int) -> torch.Tensor:
    """The learned position table zero-padded to ``n`` rows (JAX's
    ``_pad_pos``): a window near the budget's end may reach positions past
    n_text_ctx, whose logits the commit clamp discards."""
    pe = model.decoder.positional_embedding.detach()
    if pe.shape[0] >= n:
        return pe.clone()
    return torch.cat([pe, pe.new_zeros(n - pe.shape[0], pe.shape[1])])


def speculative_setup(model, draft, xa: torch.Tensor, xa_d: torch.Tensor,
                      prompt: np.ndarray, suppress_mask: torch.Tensor,
                      blank_mask: torch.Tensor, spec: SpeculativeSpec):
    """Both models' cross K/V, both prompt prefills and the initial state.
    Returns (state, (target cross K/V, draft cross K/V))."""
    dev = xa.device
    buf = spec.buf
    cross_t = wmodel.precompute_cross_kv(model, xa)
    cross_d = wmodel.precompute_cross_kv(draft, xa_d)
    cache_t = wmodel.init_kv_cache(model.dims, 1, buf, dtype=model.dtype,
                                   device=dev, n_head=wmodel.text_heads(model))
    cache_d = wmodel.init_kv_cache(draft.dims, 1, buf, dtype=draft.dtype,
                                   device=dev, n_head=wmodel.text_heads(draft))
    tokens = torch.full((1, buf), spec.eot, dtype=torch.long, device=dev)
    tokens[:, :spec.sample_begin] = prompt_rows(prompt, 1).to(dev)
    ns_prob = (torch.zeros(1, device=dev) if spec.no_speech is not None
               else torch.full((1,), float("nan"), device=dev))
    if spec.sample_begin >= 2:
        ns_at = (spec.sot_index if (spec.no_speech is not None
                                    and spec.sot_index < spec.sample_begin - 1)
                 else None)
        pf_logits, cache_t = wmodel.decode_prefill(
            model, tokens[:, :spec.sample_begin - 1], cache_t, cross_t,
            logits_at=ns_at, cross_mode="xla")
        wmodel.decode_prefill(draft, tokens[:, :spec.sample_begin - 1],
                              cache_d, cross_d, cross_mode="xla")
        if ns_at is not None:
            ns_prob = vocab_softmax(pf_logits)[:, spec.no_speech]
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    state = SpeculativeState(
        tokens=tokens, cache_t=cache_t, cache_d=cache_d,
        L=torch.full((1,), spec.sample_begin, dtype=torch.long, device=dev),
        finished=torch.zeros(1, dtype=torch.bool, device=dev),
        sum_lp=torch.zeros(1, device=dev),
        has_ts=torch.zeros(1, dtype=torch.bool, device=dev),
        last_ts_tok=zero.clone(), ns_prob=ns_prob, n_rounds=zero.clone(),
        done=torch.full((1,), spec.sample_begin >= spec.total,
                        dtype=torch.bool, device=dev),
        suppress_mask=suppress_mask.to(dev), blank_mask=blank_mask.to(dev),
        vocab_ids=torch.arange(model.dims.n_vocab, device=dev),
        pos_t=_padded_positions(model, buf),
        pos_d=_padded_positions(draft, buf))
    return state, (cross_t, cross_d)


def speculative_round_(model, draft, st: SpeculativeState, kv,
                       spec: SpeculativeSpec) -> None:
    """One round in place, without a host read (JAX ``models/decoding.py:
    860-943``): the draft proposes ``k`` greedy tokens, the target scores
    the window [t_{L-1}, d_0 .. d_{k-1}] in one :func:`decode_window` pass,
    and the longest prefix of drafts equal to the target's own filtered
    argmax is committed with the target's token after it. A round past the
    loop's end (JAX's ``cond``) changes no output: it writes only token and
    cache columns at or past ``L``."""
    cross_t, cross_d = kv
    k, buf, total, eot = spec.k, spec.buf, spec.total, spec.eot
    dev = st.tokens.device
    active = (st.L < total) & ~st.finished.all()

    def filters(logits, pos, has_ts, last_ts):
        return apply_logit_filters(
            logits, pos, st.tokens, has_ts, last_ts, st.suppress_mask,
            st.blank_mask, st.vocab_ids, sample_begin=spec.sample_begin,
            ts_begin=spec.ts_begin, eot=eot,
            no_timestamps=spec.no_timestamps,
            max_initial_ts_index=spec.max_initial_ts_index,
            use_timestamps=spec.use_timestamps)

    # draft: k autoregressive steps under the same filters, written in place
    # after the committed tokens
    d_has, d_last = st.has_ts, st.last_ts_tok
    for j in range(k):
        pos = st.L - 1 + j
        lg, _ = wmodel.decode_step(draft, st.tokens.index_select(1, pos), pos,
                                   st.cache_d, cross_d, cross_mode="xla",
                                   pos_emb=st.pos_d)
        d_tok = filters(lg, pos + 1, d_has, d_last).argmax(dim=-1)
        is_ts = d_tok >= spec.ts_begin
        d_has = d_has | is_ts
        d_last = torch.where(is_ts, d_tok, d_last)
        st.tokens.index_copy_(1, pos + 1, d_tok[:, None])

    # verify: one target pass over the window
    start = st.L - 1
    window = st.tokens.index_select(
        1, start + torch.arange(k + 1, device=dev))
    logits_w, _ = wmodel.decode_window(model, window, start, st.cache_t,
                                       cross_t, cross_mode="xla",
                                       pos_emb=st.pos_t)
    ns_prob = st.ns_prob
    if spec.no_speech is not None:
        ns_prob = torch.where(
            active & (st.L == spec.sot_index + 1),
            vocab_softmax(logits_w[:, 0])[:, spec.no_speech],
            ns_prob)
    # the target's own greedy choice at each window position, teacher-forced
    # along the drafted prefix
    s_has, s_last = st.has_ts, st.last_ts_tok
    g, match, lp, hs, ls = [], [], [], [], []
    for jj in range(k + 1):
        pos = st.L + jj
        f = filters(logits_w[:, jj], pos, s_has, s_last)
        gj = f.argmax(dim=-1)
        d_tok = st.tokens.index_select(1, pos.clamp(max=buf - 1))[:, 0]
        is_ts = gj >= spec.ts_begin
        s_has = s_has | is_ts
        s_last = torch.where(is_ts, gj, s_last)
        g.append(gj)
        match.append(gj == d_tok)
        lp.append(f.amax(dim=-1) - vocab_logsumexp(f))
        hs.append(s_has)
        ls.append(s_last)
    g, match, lp = torch.cat(g), torch.cat(match), torch.cat(lp)
    hs, ls = torch.cat(hs), torch.cat(ls)
    # acceptance: the longest matching draft prefix, then the target's token
    # at the first mismatch (or the bonus token when all k match)
    idx = torch.arange(k + 1, device=dev)
    no_match = ~match | (idx == k)
    m = no_match.long().argmax()
    is_eot = (g == eot) & (idx <= m)
    any_eot = is_eot.any()
    e = torch.where(any_eot, is_eot.long().argmax(), m).reshape(1)
    room = total - st.L  # (1,)
    c = torch.minimum(e + 1, room)  # committed this round
    finished = st.finished | (any_eot & (e + 1 <= room))
    at = st.L + e
    st.tokens.index_copy_(1, at, torch.where(
        active, g.index_select(0, e), st.tokens.index_select(1, at)[:, 0]
    )[:, None])
    last = (c - 1).clamp(min=0)  # c >= 1 in an active round
    # the committed tokens' logprobs added one at a time, in the order and
    # the float sums of greedy's steps (a round's sum added at once would
    # round differently)
    sum_lp = st.sum_lp
    for jj in range(k + 1):
        sum_lp = torch.where(jj < c, sum_lp + lp[jj], sum_lp)
    for old, new in ((st.finished, finished), (st.sum_lp, sum_lp),
                     (st.has_ts, hs.index_select(0, last)),
                     (st.last_ts_tok, ls.index_select(0, last)),
                     (st.ns_prob, ns_prob)):
        old.copy_(torch.where(active, new, old))
    st.L.add_(torch.where(active, c, 0))
    st.n_rounds.add_(active.long())


def speculative_kind(model, draft, spec: SpeculativeSpec) -> LoopKind:
    """The speculative loop for the runners: a step is one round."""
    def finish(st: SpeculativeState) -> None:
        st.done.copy_((st.L >= spec.total) | st.finished.all())

    def outputs(st: SpeculativeState):
        # uncommitted draft and window residue past the final length -> eot
        cols = torch.arange(spec.buf, device=st.tokens.device)
        tokens = torch.where(cols[None] < st.L, st.tokens, spec.eot)
        return (tokens[:, :spec.total], st.sum_lp, st.ns_prob, st.L - 1,
                st.n_rounds)

    return LoopKind(
        step=lambda st, kv, slot: speculative_round_(model, draft, st, kv,
                                                     spec),
        finish=finish, outputs=outputs)


@torch.no_grad()
def _speculative_loop(model, draft, xa: torch.Tensor, xa_d: torch.Tensor,
                      prompt: np.ndarray, suppress_mask: torch.Tensor,
                      blank_mask: torch.Tensor, spec: SpeculativeSpec):
    """The speculative loop from both models' encoder states, run by
    :func:`loop_runner` (a captured graph of rounds on a card, :func:`run_eager`
    on the CPU). Returns (tokens (1, total), sum_lp (1,),
    ns_prob (1,), n_steps (1,), n_rounds (1,))."""
    st, kv = speculative_setup(model, draft, xa, xa_d, prompt, suppress_mask,
                               blank_mask, spec)
    run = loop_runner(model, xa.device)
    key = ("speculative", spec, id(draft), xa.shape[1], xa_d.shape[1],
           model.dtype, draft.dtype)
    # each round commits at least one token
    return run(model, key, speculative_kind(model, draft, spec), st, kv,
               spec.total - spec.sample_begin, keep=draft)


@torch.no_grad()
def decode_speculative(model, draft, tokenizer, mel: torch.Tensor,
                       options: Optional[DecodingOptions] = None,
                       draft_k: int = 4, return_info: bool = False,
                       device=None):
    """Greedy :func:`decode` accelerated by a draft model (JAX
    ``models/decoding.py:956-1042``): the draft (a smaller Whisper sharing
    the tokenizer) proposes ``draft_k`` tokens a round, the target verifies
    them in one :func:`whisper.decode_window` pass and commits the longest
    prefix that matches its own greedy choices, plus one token of its own.
    The result is greedy's, bit for bit: tokens, logprobs and no-speech
    probability (on a card the window's rows are computed as a step's by
    ``dec_attn`` and ``rows_linear``; the committed logprobs are added one
    at a time, as greedy adds them).

    One utterance (mel (n_mels, F) or (1, n_mels, F)), greedy options only.
    On a CUDA model the rounds replay a captured CUDA graph.
    ``return_info=True`` appends ``{"n_rounds", "n_steps"}``."""
    dims, draft_dims = model.dims, draft.dims
    if dims.n_vocab != draft_dims.n_vocab:
        raise ValueError(
            f"draft vocab {draft_dims.n_vocab} != target {dims.n_vocab}: the "
            "draft must share the target's tokenizer")
    if dims.n_mels != draft_dims.n_mels:
        raise ValueError(
            f"draft n_mels {draft_dims.n_mels} != target {dims.n_mels}: pick "
            "a draft with the target's mel frontend")
    if draft_k < 1:
        raise ValueError(f"draft_k must be >= 1, got {draft_k}")
    dev = wmodel._check_device(model, device)
    wmodel._check_device(draft, dev.type)
    mel3 = (mel[None] if mel.ndim == 2 else mel).to(dev)
    xa = wmodel.encode_audio(model, mel3, device=dev.type)
    (options, single, mel, sample_begin, sample_len, sot_index, prompt_arr,
     suppress_mask, blank_mask, max_initial_ts_index, detected) = \
        _decode_plan(dims, tokenizer, mel, options,
                     detect=lambda: [c for c, _ in detect_language(
                         model, tokenizer, xa=xa, device=dev.type)])
    if mel.shape[0] != 1:
        raise ValueError(
            f"decode_speculative is single-utterance (got batch "
            f"{mel.shape[0]}); batched alignment uses the exact loop")
    if options.beam_size is not None or options.best_of is not None \
            or options.temperature > 0:
        raise ValueError("decode_speculative is greedy-only: beam/best_of/"
                         "temperature>0 use decode()")
    spec = SpeculativeSpec(
        sample_begin=sample_begin, total=sample_begin + sample_len,
        k=int(draft_k), ts_begin=tokenizer.timestamp_begin,
        eot=tokenizer.eot, no_timestamps=tokenizer.no_timestamps,
        no_speech=tokenizer.no_speech,
        max_initial_ts_index=max_initial_ts_index,
        use_timestamps=not options.without_timestamps, sot_index=sot_index)
    xa_d = wmodel.encode_audio(draft, mel3, device=dev.type)
    tokens, sum_lp, ns_prob, n_steps, n_rounds = _speculative_loop(
        model, draft, xa, xa_d, prompt_arr,
        torch.from_numpy(suppress_mask).to(dev),
        torch.from_numpy(blank_mask).to(dev), spec)
    tokens, sum_lp, ns_prob = (t.cpu().numpy() for t in (tokens, sum_lp,
                                                         ns_prob))
    n_steps, n_rounds = int(n_steps[0]), int(n_rounds[0])
    langs = detected or [_language(tokenizer, options)]
    result = results(tokenizer, options, False,
                     [trim(tokens[0], sample_begin, tokenizer.eot)], sum_lp,
                     ns_prob, n_steps, langs)
    if single:
        result = result[0]
    if return_info:
        return result, {"n_rounds": n_rounds, "n_steps": n_steps}
    return result
