"""Long-form transcription: the ``whisper.transcribe`` equivalent.

Port of ``whisper_char_alignment_tpu/transcribe.py``, function by function
and with the same names. The published algorithm over this package's
decoder:

- one log-mel of the whole audio with 30 s of zero padding appended (the
  dynamic-range clip is global, as published), padded up to a window
  multiple: the plain frontend (``audio.mel.log_mel_spectrogram``, the JAX
  package's XLA frontend here too), on the model's device;
- a seek loop over 30 s windows: decode, then advance ``seek`` by the parsed
  timestamp tokens (consecutive-timestamp pairs split the window into
  segments; a single trailing timestamp or no timestamps consumes the
  window);
- temperature fallback: retry at increasing temperatures when the result's
  compression ratio or average logprob crosses the thresholds (beam options
  dropped at t > 0, best_of dropped at t == 0, as the published
  ``decode_with_fallback`` does); every rung runs on the sampling loop's
  one CUDA graph, whose temperature is a tensor of its state;
- no-speech skipping, and ``condition_on_previous_text``: prior output
  tokens ride into the next window as ``DecodingOptions.prompt`` (kept in
  ``prompt_bucket``-token steps, at most 192 tokens), reset after a
  fallback above temperature 0.5;
- word timestamps by teacher-forced cross-attention alignment of each
  window's tokens (the QK post-process and DTW kernels).

Returns the published schema: ``{"text", "segments": [{id, seek, start, end,
text, tokens, temperature, avg_logprob, compression_ratio, no_speech_prob}],
"language"}``.

Random numbers: the JAX package gives each window ``fold_in(rng, seek)``.
Here each window's decode gets a ``torch.Generator`` on the model's device
seeded with :func:`window_seed` ``(seed, seek)``, so a window's sampling
noise depends only on ``seed`` and its seek, whether it runs solo or from
:func:`transcribe_batched`. The numbers differ from JAX's threefry.

Entry points run on ``cuda`` unless ``device="cpu"`` is passed; the model
is used in its own dtype.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from . import constants
from .audio.mel import log_mel_spectrogram, pad_or_trim
from .models import decoding, whisper as wmodel

# published merge_punctuations defaults
_PREPEND_PUNCT = "\"'“¿([{-"
_APPEND_PUNCT = "\"'.。,，!！?？:：”)]}、"


def _merge_punctuations(words: List[dict], prepended: str, appended: str):
    """Published merge_punctuations: a leading-punctuation word is folded into
    the word after it, a trailing-punctuation word into the word before it
    (the punctuation word's own interval is dropped, as published)."""
    i, j = len(words) - 2, len(words) - 1
    while i >= 0:
        prev, follow = words[i], words[j]
        if prev["word"].startswith(" ") and prev["word"].strip() in prepended:
            follow["word"] = prev["word"] + follow["word"]
            follow["tokens"] = prev["tokens"] + follow["tokens"]
            prev["word"] = ""
            prev["tokens"] = []
        else:
            j = i
        i -= 1
    i, j = 0, 1
    while j < len(words):
        prev, follow = words[i], words[j]
        if not prev["word"].endswith(" ") and follow["word"] in appended:
            prev["word"] = prev["word"] + follow["word"]
            prev["tokens"] = prev["tokens"] + follow["tokens"]
            follow["word"] = ""
            follow["tokens"] = []
        else:
            i = j
        j += 1
    return [w for w in words if w["word"]]


def _resolved_sot_sequence(tokenizer, language: Optional[str],
                           task: str) -> List[int]:
    """The sot sequence with the resolved language/task tokens patched in,
    from the same helper ``decode`` patches its prompt with
    (``decoding.resolved_special_tokens``), so the capture pass and the
    decode pass cannot drift apart."""
    sot_seq = list(tokenizer.sot_sequence)
    lang_tok, task_tok = decoding.resolved_special_tokens(tokenizer, language,
                                                          task)
    if lang_tok is not None and len(sot_seq) >= 2:
        sot_seq[1] = lang_tok
    if task_tok is not None and len(sot_seq) >= 3:
        sot_seq[2] = task_tok
    return sot_seq


def _window_word_timings(model, tokenizer, mel_segment: torch.Tensor,
                         text_tokens, n_frames: int, alignment_heads,
                         word_aggr: str, sot_seq: List[int],
                         device=None) -> Optional[List[dict]]:
    """Word timings for one window's concatenated text tokens.

    ``word_aggr='default'`` is the published find_alignment recipe
    (hand-picked alignment heads, z-norm, median width 7), the path of the
    reference's ``--default_whisper_timing``; ``word_aggr='topk'`` the
    paper's unsupervised top-k saliency heads. Either way one capture (the
    QK post-process kernel per decoder layer) and one DTW (the wavefront and
    backtrace kernels). Returns [{word, tokens, start, end, probability}]
    with window-relative times, or None when unalignable."""
    from .align import timing
    from .parallel.mesh import pad_to_multiple

    dims = model.dims
    sot_len = len(sot_seq)
    tokens = [*sot_seq, tokenizer.no_timestamps, *text_tokens, tokenizer.eot]
    if len(tokens) > dims.n_text_ctx or not text_tokens:
        return None
    # eot-pad to a 32-multiple token bucket, masked by token_len
    t_bucket = min(dims.n_text_ctx, pad_to_multiple(len(tokens), 32))
    arr = np.full((1, t_bucket), tokenizer.eot, np.int32)
    arr[0, :len(tokens)] = tokens
    dev = mel_segment.device
    arr = torch.from_numpy(arr).to(dev)
    tl = torch.tensor([len(tokens)], dtype=torch.int32, device=dev)
    fl = torch.tensor([max(1, min(n_frames, dims.n_audio_ctx))],
                      dtype=torch.int32, device=dev)
    mel1 = mel_segment[None]
    token_probs = None
    if word_aggr == "topk":
        attn, _ = timing.get_attentions(model, mel1, arr, tl, fl,
                                        medfilt_width=7, qk_scale=1.0,
                                        return_logits=False, device=device)
        jf, _, _ = timing.force_align_batch(attn, tl, fl, sot_len, "topk", 10)
    else:
        jf, probs, _ = timing.default_find_alignment_batch(
            model, mel1, arr, tl, fl, alignment_heads, eot=tokenizer.eot,
            medfilt_width=7, qk_scale=1.0, sot_len=sot_len, device=device)
        token_probs = probs.cpu().numpy()[0][:len(text_tokens)]
    words, word_tokens = tokenizer.split_to_word_tokens(
        list(text_tokens) + [tokenizer.eot])
    if len(word_tokens) <= 1:
        return None
    wb = np.pad(np.cumsum([len(t) for t in word_tokens[:-1]]), (1, 0))
    jf1 = jf.cpu().numpy()[0][:len(text_tokens) + 1]
    starts, ends = timing.jump_frames_to_times(jf1, wb)
    out = []
    for k, (w, wt) in enumerate(zip(words[:-1], word_tokens[:-1])):
        prob = (float(np.mean(token_probs[wb[k]:wb[k + 1]]))
                if token_probs is not None else None)
        out.append({"word": w, "tokens": list(wt),
                    "start": float(starts[k]), "end": float(ends[k]),
                    "probability": prob})
    return _merge_punctuations(out, _PREPEND_PUNCT, _APPEND_PUNCT)


def _window_frames(dims) -> int:
    # test models may use a shorter audio context
    return 2 * dims.n_audio_ctx


def window_seed(seed: int, seek: int) -> int:
    """The seed of the generator of the window at ``seek`` (the JAX
    package's ``fold_in(rng, seek)``): ``seed`` in the high 32 bits, the
    seek in the low 32, so both read back from ``initial_seed()``."""
    return (seed % (1 << 32)) << 32 | seek


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def decode_with_fallback(model, tokenizer, mel_segment: torch.Tensor,
                         options: decoding.DecodingOptions,
                         temperatures: Sequence[float],
                         compression_ratio_threshold: Optional[float],
                         logprob_threshold: Optional[float],
                         no_speech_threshold: Optional[float],
                         device=None, seed: int = 0):
    """Published fallback ladder: the first temperature whose result passes
    the compression-ratio and logprob gates wins; a no-speech window never
    triggers a retry. Every rung's sampling noise comes from a generator
    seeded ``seed``.

    Library-facing helper (``whisper.transcribe.decode_with_fallback``). The
    seek loop inlines the same ladder in :func:`_seek_machine`, each decode
    yielded to its caller; a change to the gates goes in both places."""
    result = None
    for t in temperatures:
        if t > 0:
            opts = dataclasses.replace(options, temperature=t,
                                       beam_size=None, patience=None)
        else:
            opts = dataclasses.replace(options, temperature=t, best_of=None)
        result = decoding.decode(model, tokenizer, mel_segment, opts,
                                 device=device,
                                 generator=_generator(seed, model.device))
        needs_fallback = False
        if (compression_ratio_threshold is not None
                and result.compression_ratio > compression_ratio_threshold):
            needs_fallback = True  # too repetitive
        if (logprob_threshold is not None
                and result.avg_logprob < logprob_threshold):
            needs_fallback = True  # average log probability too low
        if (no_speech_threshold is not None
                and result.no_speech_prob > no_speech_threshold):
            needs_fallback = False  # silence: skip, don't retry
        if not needs_fallback:
            break
    return result


def _seek_machine(model, tokenizer, audio: Union[np.ndarray, torch.Tensor],
                  *,
                  temperature: Union[float, Sequence[float]] = (
                      0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
                  compression_ratio_threshold: Optional[float] = 2.4,
                  logprob_threshold: Optional[float] = -1.0,
                  no_speech_threshold: Optional[float] = 0.6,
                  condition_on_previous_text: bool = True,
                  initial_prompt: Optional[str] = None,
                  prompt_bucket: int = 32,
                  word_timestamps: bool = False,
                  word_aggr: str = "default",
                  model_name: Optional[str] = None,
                  seed: int = 0,
                  verbose: Optional[bool] = None,
                  device=None,
                  **decode_options):
    """The seek loop as a resumable generator: it yields device-work
    requests ({"kind": "decode"|"detect", "mel_segment", "options", "seed",
    "batchable"}) and receives their results through ``send``; the
    transcribe dict is the generator's return value.

    A caller holding N machines can so group their pending window decodes
    into one batched decode (:func:`transcribe_batched`), while
    :func:`transcribe` executes each request directly: both run the same
    seek-loop logic. ``batchable`` marks deterministic greedy requests
    (t == 0, no beam); fallback retries carry their window's seed and run
    solo. Word timings run here, on the window's mel."""
    if isinstance(temperature, (int, float)):
        temperatures = [float(temperature)]
    else:
        temperatures = [float(t) for t in temperature]
    # the published loop overwrites any caller-supplied prompt with the
    # rolling context every window; drop it rather than crash on the
    # duplicate keyword below
    decode_options.pop("prompt", None)

    dims = model.dims
    heads = None
    if word_timestamps:
        from .config import get_alignment_heads

        heads = get_alignment_heads(model_name or "", dims)
        if word_aggr == "default" and not all(
                0 <= l < dims.n_text_layer and 0 <= h < dims.n_text_head
                for l, h in heads):
            # the JAX package's gather clamps such indices without a word
            raise ValueError(
                f"the alignment heads of model {model_name!r} ({heads}) do "
                f"not fit a decoder of {dims.n_text_layer} layers x "
                f"{dims.n_text_head} heads: name the checkpoint's model size")
    audio = np.asarray(audio, np.float32).reshape(-1)
    window_frames = _window_frames(dims)
    window_samples = window_frames * constants.HOP_LENGTH
    # published padding: a full window of zeros after the content; round the
    # total up to a window multiple
    total = audio.size + window_samples
    total = ((total + window_samples - 1) // window_samples) * window_samples
    padded = np.zeros((total,), np.float32)
    padded[:audio.size] = audio
    mel = log_mel_spectrogram(torch.from_numpy(padded).to(model.device),
                              n_mels=dims.n_mels)
    content_frames = min(mel.shape[-1] - window_frames,
                         audio.size // constants.HOP_LENGTH)
    # resolve full names up front ("English" -> "en", ValueError on junk) so
    # the result dict, the per-window DecodingOptions and the word-timing
    # capture see the same code, the zero-content early return included
    from .text.tokenizer import normalize_language

    language = normalize_language(decode_options.pop("language", None))
    if content_frames <= 0:
        # published behavior: with no content frames the seek loop runs zero
        # windows: empty or sub-hop audio yields an empty result
        return {"text": "", "segments": [],
                "language": language or tokenizer.language or "en"}

    if language is None:
        if tokenizer.is_multilingual and len(tokenizer.sot_sequence) >= 2:
            seg0 = pad_or_trim(mel, window_frames, axis=-1)
            language = yield {"kind": "detect", "mel_segment": seg0}
        else:
            language = tokenizer.language or "en"

    input_stride = window_frames // dims.n_audio_ctx  # 2: mel frames / token
    time_precision = (input_stride * constants.HOP_LENGTH
                      / constants.SAMPLE_RATE)  # 0.02 s
    frames_per_second = constants.SAMPLE_RATE // constants.HOP_LENGTH

    all_tokens: List[int] = []
    all_segments: List[dict] = []
    prompt_reset_since = 0
    if initial_prompt is not None:
        initial_prompt_tokens = tokenizer.encode(" " + initial_prompt.strip())
        all_tokens.extend(initial_prompt_tokens)
    else:
        initial_prompt_tokens = []

    ts_begin = tokenizer.timestamp_begin
    seek = 0
    while seek < content_frames:
        time_offset = seek / frames_per_second
        segment_size = min(window_frames, content_frames - seek)
        segment_duration = segment_size / frames_per_second
        mel_segment = pad_or_trim(mel[..., seek:seek + window_frames],
                                  window_frames, axis=-1)

        # the rolling conditioning prompt, rounded DOWN to a prompt_bucket
        # multiple of its most recent tokens (cap 192 < the published 223
        # trim), as the JAX package keeps it: it sets what the decoder
        # sees. prompt_bucket=1 restores the published exact lengths.
        ctx = all_tokens[prompt_reset_since:]
        if prompt_bucket > 1 and len(ctx) >= prompt_bucket:
            keep = min((len(ctx) // prompt_bucket) * prompt_bucket,
                       (192 // prompt_bucket) * prompt_bucket)
        else:
            keep = len(ctx)  # sub-bucket contexts (and prompt_bucket=1) exact
        opts = decoding.DecodingOptions(
            language=language,
            prompt=ctx[len(ctx) - keep:] or None,
            **decode_options)
        # published fallback ladder (decode_with_fallback), each decode
        # yielded to the caller
        result = None
        for t in temperatures:
            if t > 0:
                opts_t = dataclasses.replace(opts, temperature=t,
                                             beam_size=None, patience=None)
            else:
                opts_t = dataclasses.replace(opts, temperature=t, best_of=None)
            result = yield {
                "kind": "decode", "mel_segment": mel_segment,
                "options": opts_t, "seed": window_seed(seed, seek),
                "batchable": (t == 0 and opts_t.beam_size is None)}
            needs_fallback = False
            if (compression_ratio_threshold is not None
                    and result.compression_ratio
                    > compression_ratio_threshold):
                needs_fallback = True  # too repetitive
            if (logprob_threshold is not None
                    and result.avg_logprob < logprob_threshold):
                needs_fallback = True  # average log probability too low
            if (no_speech_threshold is not None
                    and result.no_speech_prob > no_speech_threshold):
                needs_fallback = False  # silence: skip, don't retry
            if not needs_fallback:
                break
        tokens = list(result.tokens)

        if no_speech_threshold is not None:
            should_skip = result.no_speech_prob > no_speech_threshold
            if (logprob_threshold is not None
                    and result.avg_logprob > logprob_threshold):
                should_skip = False  # confident despite the no-speech signal
            if should_skip:
                seek += segment_size
                continue

        def new_segment(start, end, seg_tokens):
            return {
                "seek": seek,
                "start": start,
                "end": end,
                "text": tokenizer.decode(
                    [t for t in seg_tokens if t < tokenizer.eot]),
                "tokens": list(seg_tokens),
                "temperature": result.temperature,
                "avg_logprob": result.avg_logprob,
                "compression_ratio": result.compression_ratio,
                "no_speech_prob": result.no_speech_prob,
            }

        current_segments: List[dict] = []
        is_ts = [t >= ts_begin for t in tokens]
        single_timestamp_ending = is_ts[-2:] == [False, True]
        consecutive = [k + 1 for k in range(len(tokens) - 1)
                       if is_ts[k] and is_ts[k + 1]]
        if consecutive:
            # pairs of consecutive timestamps delimit segments
            slices = list(consecutive)
            if single_timestamp_ending:
                slices.append(len(tokens))
            last_slice = 0
            for cur in slices:
                seg_tokens = tokens[last_slice:cur]
                start_pos = seg_tokens[0] - ts_begin
                end_pos = seg_tokens[-1] - ts_begin
                current_segments.append(new_segment(
                    time_offset + start_pos * time_precision,
                    time_offset + end_pos * time_precision, seg_tokens))
                last_slice = cur
            if single_timestamp_ending:
                seek += segment_size  # no final pair: consume the window
            else:
                last_ts_pos = tokens[last_slice - 1] - ts_begin
                advance = last_ts_pos * input_stride
                # robustness deviation: a degenerate <|0.00|><|0.00|> pair
                # would advance 0 frames and loop forever (the published loop
                # shares this hazard); consume the window instead
                seek += advance if advance > 0 else segment_size
        else:
            duration = segment_duration
            ts_tokens = [t for t in tokens if t >= ts_begin]
            if ts_tokens and ts_tokens[-1] != ts_begin:
                duration = (ts_tokens[-1] - ts_begin) * time_precision
            current_segments.append(new_segment(
                time_offset, time_offset + duration, tokens))
            seek += segment_size

        if word_timestamps and current_segments:
            text_tokens = [t for seg in current_segments
                           for t in seg["tokens"] if t < tokenizer.eot]
            timings = _window_word_timings(
                model, tokenizer, mel_segment, text_tokens,
                segment_size // input_stride, heads, word_aggr,
                _resolved_sot_sequence(tokenizer, language,
                                       decode_options.get("task",
                                                          "transcribe")),
                device=device)
            if timings:
                for w in timings:
                    w["start"] += time_offset
                    w["end"] += time_offset
                idx = 0
                for seg in current_segments:
                    n_text = sum(1 for t in seg["tokens"]
                                 if t < tokenizer.eot)
                    seg_words, consumed = [], 0
                    while idx < len(timings) and consumed < n_text:
                        seg_words.append(timings[idx])
                        consumed += len(timings[idx]["tokens"])
                        idx += 1
                    seg["words"] = seg_words
                    if seg_words:  # tighten to the aligned word span
                        seg["start"] = seg_words[0]["start"]
                        seg["end"] = seg_words[-1]["end"]

        if verbose:
            for seg in current_segments:
                print(f"[{seg['start']:.2f} --> {seg['end']:.2f}] "
                      f"{seg['text']}")

        for seg in current_segments:
            seg["id"] = len(all_segments)
            all_segments.append(seg)
            all_tokens.extend(seg["tokens"])
        if not condition_on_previous_text or result.temperature > 0.5:
            # high-temperature fallback output is unreliable context
            prompt_reset_since = len(all_tokens)

    text = tokenizer.decode(
        [t for t in all_tokens[len(initial_prompt_tokens):]
         if t < tokenizer.eot])
    return {"text": text, "segments": all_segments, "language": language}


def _execute_request(model, tokenizer, req, device=None):
    """Run one machine request directly (the solo loop's executor, and the
    batched loop's path for requests that are not batchable)."""
    if req["kind"] == "detect":
        code, _ = decoding.detect_language(model, tokenizer,
                                           req["mel_segment"], device=device)
        return code
    return decoding.decode(model, tokenizer, req["mel_segment"],
                           req["options"], device=device,
                           generator=_generator(req["seed"], model.device))


def transcribe(model, tokenizer, audio: Union[np.ndarray, torch.Tensor],
               *, device=None, **kwargs) -> dict:
    """Transcribe 16 kHz mono ``audio`` of any length.

    ``kwargs`` are the seek-loop knobs plus DecodingOptions fields (language,
    beam_size, best_of, patience, length_penalty, prefix, suppress_tokens,
    sample_len, ...); a caller-supplied ``prompt`` is dropped (the loop owns
    it, as published). ``seed`` (default 0) seeds every window's sampling
    noise with its seek (:func:`window_seed`).

    ``word_timestamps=True`` attaches per-word ``{word, start, end,
    probability}`` lists to every segment by teacher-forced cross-attention
    alignment of each window's tokens: ``word_aggr='default'`` uses the
    published alignment-heads recipe (``model_name`` selects the head table),
    ``word_aggr='topk'`` the paper's unsupervised top-k saliency heads.
    Segment start/end are tightened to their words' span. As in the JAX
    package: no word-based seek refinement and no hallucination heuristics.
    """
    device = wmodel._check_device(model, device).type
    gen = _seek_machine(model, tokenizer, audio, device=device, **kwargs)
    resp = None
    while True:
        try:
            req = gen.send(resp)
        except StopIteration as e:
            return e.value
        resp = _execute_request(model, tokenizer, req, device)


def _pad_pow2(n: int, cap: int) -> int:
    """Next power of two >= n (capped): the batched decode's rows come in
    about log2(cap) distinct counts, so about as many greedy graphs."""
    b = 1
    while b < min(n, cap):
        b *= 2
    return min(b, cap)


def transcribe_batched(model, tokenizer, audios, *, max_batch: int = 8,
                       device=None, **kwargs) -> List[dict]:
    """Transcribe N audios with their seek-loop windows decoded in shared
    batched decodes.

    Each audio runs its own :func:`_seek_machine` (the same host logic as
    :func:`transcribe`); each round, every machine's pending window decode
    is grouped by (options minus prompt, prompt length, window shape) and
    run as one batched ``decoding.decode`` with per-row prompts. Window 1 of
    every request shares an empty prompt; later windows group when their
    prompt buckets coincide, and always under
    ``condition_on_previous_text=False``. Fallback retries (t > 0) and beam
    decodes run solo, with their window's seed. Language detection requests
    batch the same way.

    Batches are padded to a power of two (<= ``max_batch``) by repeating row
    0; the padded rows' results are discarded. Each request's result equals
    its solo :func:`transcribe`."""
    device = wmodel._check_device(model, device).type
    gens = [_seek_machine(model, tokenizer, a, device=device, **kwargs)
            for a in audios]
    results: List[Optional[dict]] = [None] * len(gens)
    pending = {}
    for i, g in enumerate(gens):
        try:
            pending[i] = g.send(None)
        except StopIteration as e:
            results[i] = e.value

    def run_group(idxs):
        reqs = [pending[i] for i in idxs]
        kind = reqs[0]["kind"]
        b_pad = _pad_pow2(len(idxs), max_batch)
        rows = [r["mel_segment"] for r in reqs]
        rows += [rows[0]] * (b_pad - len(rows))
        mels = torch.stack(rows)
        if kind == "detect":
            det = decoding.detect_language(model, tokenizer, mels,
                                           device=device)
            return {i: det[k][0] for k, i in enumerate(idxs)}
        base = dataclasses.replace(reqs[0]["options"], prompt=None)
        prompts = [r["options"].prompt or None for r in reqs]
        if prompts[0]:
            prows = [list(p) for p in prompts]
            prows += [prows[0]] * (b_pad - len(prompts))
            opts = dataclasses.replace(base, prompt=prows)
        else:
            opts = base
        out = decoding.decode(model, tokenizer, mels, opts, device=device)
        return {i: out[k] for k, i in enumerate(idxs)}

    while pending:
        groups: dict = {}
        solos = []
        for i, req in pending.items():
            opts = req.get("options")
            shape = tuple(req["mel_segment"].shape)
            if req["kind"] == "detect":
                groups.setdefault(("detect", shape), []).append(i)
            elif req.get("batchable"):
                plen = len(opts.prompt) if opts.prompt else 0
                key = ("decode",
                       repr(dataclasses.replace(opts, prompt=None)), plen,
                       shape)
                groups.setdefault(key, []).append(i)
            else:
                solos.append(i)
        resps = {}
        for key, idxs in groups.items():
            # chunk oversized groups to max_batch-row decodes
            for k0 in range(0, len(idxs), max_batch):
                resps.update(run_group(idxs[k0:k0 + max_batch]))
        for i in solos:
            resps[i] = _execute_request(model, tokenizer, pending[i], device)
        nxt = {}
        for i, resp in resps.items():
            try:
                nxt[i] = gens[i].send(resp)
            except StopIteration as e:
                results[i] = e.value
        pending = nxt
    return results
