"""Batched alignment runner (port of ``whisper_char_alignment_tpu/runner.py``).

One batch runs: int16/f32 wire -> log-mel on the GPU, the encoder, the greedy
KV-cached decode (a replayed CUDA graph on a card,
``models/decode_graph.py``), char re-tokenization on the host, one
teacher-forced capture (each decoder layer's cross-attention through the QK
post-process kernel) with head selection, aggregation and DTW (or, with
``default_whisper_timing``, Whisper's own alignment heads, z-normalized, and
per-word probabilities), then word times on the host.

As in the JAX package, a batch is dispatched in three stages
(``_dispatch_transcribe``, ``_dispatch_align``, ``_collect_align``), and
``run_dataset`` keeps a software pipeline: a background thread builds the
next batch's wire buffer, ``pipeline_depth`` batches keep their decode
results in flight (``decoding.DecodeFuture``) and one capture + align batch
stays queued while the host turns the previous one into word times. Uploads
go through pinned memory without blocking. Results and their order do not
depend on the depth. The main thread's pass is covered by top-level spans
of ``timers`` (``utils/profiling.StageTimers``: host and self seconds,
counters, and on a card device seconds between CUDA events, nothing
synchronised), each of a kind: ``issue`` (mel, encoder, decode dispatch,
capture pack, capture, align or capture+align, output copies), ``wait``
(transcripts sync, collect sync) or ``host`` (batch read, wire wait,
retokenize, word times, loop); ``wire prep`` runs on the wire-prep thread.
``stage_seconds`` is its seconds by stage.

With ``mesh=`` (``parallel/mesh.py``) the pipeline is one rank of a (data,
model) mesh: every rank reads every batch, pads it to a multiple of the data
size, runs its data index's rows (with its share of the heads under a model
axis) and gathers the results back in input order, so every rank runs every
collective, the last batch too. A model axis runs the decode loops eagerly
(``decoding.loop_runner``).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import constants
from .align import timing
from .audio.mel import wire_to_mel
from .config import AlignConfig, get_alignment_heads
from .data.dataset import Utterance, batch_iter
from .models import decoding, whisper as wmodel
from .parallel import mesh as mesh_lib
from .text import retokenize
from .utils.device import resolve_device
from .utils.profiling import StageTimers


@dataclasses.dataclass
class UttAlignment:
    fid: str
    words: List[str]
    start_times: np.ndarray
    end_times: np.ndarray
    transcription: str
    text: str  # normalized ground-truth text
    starts: List[float]
    ends: List[float]
    matrix: Optional[np.ndarray] = None
    scores: Optional[list] = None
    word_probabilities: Optional[List[float]] = None
    skipped: bool = False


def _cross_kv_bytes(dims, batch: int, compute_dtype: torch.dtype) -> int:
    """Device bytes of the decode loop's cross K/V stacks (K and V, all
    layers)."""
    itemsize = torch.empty((), dtype=compute_dtype).element_size()
    return (2 * dims.n_text_layer * batch * dims.n_text_state
            * dims.n_audio_ctx * itemsize)


def pack_fixed_batch(items, utts, b_pad: int, t_bucket: int, eot: int,
                     n_audio_ctx: int):
    """Fixed-shape packing of the live utterances for the capture pass.

    ``items``: ``(utt, tokens, max_frames)`` for the live (non-skip)
    utterances; ``utts`` the original batch order (encoder-state rows).
    Returns (tokens_arr, token_len, frame_len, xa_idx) NumPy arrays; rows >=
    len(items) are pad rows whose outputs are discarded."""
    tokens_arr = np.full((b_pad, t_bucket), eot, np.int32)
    token_len = np.ones((b_pad,), np.int32)
    frame_len = np.ones((b_pad,), np.int32)
    # match rows to encoder states by OBJECT IDENTITY, never by fid: fids are
    # not unique (a batch may carry one fid many times)
    utt_index = {id(u): j for j, u in enumerate(utts)}
    xa_idx = np.zeros((b_pad,), np.int32)
    for i, (u, toks, max_frames) in enumerate(items):
        tokens_arr[i, :len(toks)] = toks
        token_len[i] = len(toks)
        # clip to the model window (relevant only for sub-30 s test dims)
        frame_len[i] = min(max(int(max_frames), 1), n_audio_ctx)
        xa_idx[i] = utt_index[id(u)]
    return tokens_arr, token_len, frame_len, xa_idx


def _utt_wire_i16(u: Utterance):
    """Per-utterance int16 wire form, cached on the Utterance: the int16
    array when every sample is exactly representable as int16/32768 (16-bit
    PCM sources), else None (the batch then ships float32)."""
    cached = getattr(u, "_wire_i16", False)
    if cached is not False:
        return cached
    scaled = u.audio * 32768.0
    with np.errstate(invalid="ignore"):
        as_i16 = scaled.astype(np.int16)
    cached = as_i16 if np.array_equal(as_i16, scaled) else None
    try:
        u._wire_i16 = cached
    except AttributeError:
        pass  # slotted/frozen utterance stand-ins: just skip the cache
    return cached


class AlignmentPipeline:
    """End-to-end batched alignment with fixed-shape bucketing, on one GPU
    (``device=None``), on the CPU (``device="cpu"``), or as one rank of a
    ``mesh`` (on the mesh's device). ``cfg.data_parallel`` and
    ``cfg.tensor_parallel`` are read by the CLIs, which build the mesh (as
    in the JAX package)."""

    def __init__(self, model: wmodel.Whisper, tokenizer, cfg: AlignConfig,
                 device=None, compute_dtype=torch.float32,
                 token_bucket: int = 32, mesh: Optional[mesh_lib.Mesh] = None):
        if cfg.decode_frame_bucket_guarded and cfg.decode_frame_bucket <= 0:
            raise ValueError(
                "decode_frame_bucket_guarded guards the frame-bucketed "
                "decode: set decode_frame_bucket to the bucket multiple "
                "(e.g. 128) alongside it")
        self.mesh = mesh
        self.device = (mesh.device if mesh is not None
                       else resolve_device(device))
        self.compute_dtype = compute_dtype
        self.dims = model.dims
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.token_bucket = token_bucket
        if cfg.encoder_int8:
            # the int8 module tree routes the encoder's linears through the
            # int8 kernels (JAX runner.py:242-249)
            model = wmodel.quantize_encoder_int8(model)
        # the compute-dtype copy every stage uses (int8 leaves kept); the
        # caller's module stays; a model axis keeps this rank's slices
        self.model = wmodel.cast_params(model, self.compute_dtype, self.device)
        if mesh is not None:
            self.model = mesh_lib.shard_params(self.model, mesh)
        # rows of a full batch on this rank (its data index's share)
        self.rows = self._pad_batch(cfg.batch_size) // mesh_lib.data_size(mesh)
        self.sot_len = len(tokenizer.sot_sequence)
        self.alignment_heads = get_alignment_heads(cfg.model, self.dims)
        if cfg.default_whisper_timing and not all(
                0 <= l < self.dims.n_text_layer
                and 0 <= h < self.dims.n_text_head
                for l, h in self.alignment_heads):
            # the JAX package's gather clamps such indices without a word
            raise ValueError(
                f"the alignment heads of model {cfg.model!r} "
                f"({self.alignment_heads}) do not fit a decoder of "
                f"{self.dims.n_text_layer} layers x {self.dims.n_text_head} "
                "heads: name the checkpoint's model size")
        self.options = decoding.DecodingOptions(
            language=tokenizer.language or "en",
            sample_len=cfg.decode_sample_len or None)
        self.timers = StageTimers(self.device)
        # batches dispatched so far: the batch index of the spans
        self._batches_dispatched = 0
        # shape telemetry for the MFU roll-up (utils/flops.py): the padded
        # shapes each batch ran, (b_pad, n_live, kv_frames) per decode and
        # (t_bucket, b_pad, n_live, reused_kv) per capture (JAX runner.py)
        self.decode_shapes: List[tuple] = []
        self.capture_shapes: List[tuple] = []
        # test/isolation hook: a callable (utts -> list[str]) that supplies
        # transcripts instead of the decode output (the decode still runs)
        self.transcribe_override = None
        # per-utterance min top1-top2 logit margins of the aligned batches,
        # filled only when a guard tracked them (flag_rate)
        self.min_margins: List[float] = []

    def active_guard_margin(self) -> Optional[float]:
        """Sum of the active guards (an utterance re-decodes when its min
        margin is below it), or None when no guarded mode is set."""
        total, active = 0.0, False
        if self.cfg.decode_kv_int8_guarded:
            total += decoding.default_guard_margin()
            active = True
        if self.cfg.decode_frame_bucket_guarded:
            total += decoding.default_bucket_guard_margin()
            active = True
        return total if active else None

    def flag_rate(self) -> Optional[float]:
        """Fraction of margin-tracked utterances the guard re-decoded."""
        guard = self.active_guard_margin()
        if guard is None or not self.min_margins:
            return None
        return float(np.mean(np.asarray(self.min_margins) < guard))

    @property
    def stage_seconds(self) -> Dict[str, float]:
        """Seconds by stage name (``timers.totals``)."""
        return self.timers.totals

    def _pad_batch(self, n: int) -> int:
        """Rows of a batch of ``n``: a full batch, rounded up to a multiple
        of the mesh's data size (JAX ``runner.py:311-320``; a model axis
        shards weights, not the batch)."""
        return mesh_lib.pad_to_multiple(max(self.cfg.batch_size, n),
                                        mesh_lib.data_size(self.mesh))

    def _local(self, utts: Sequence[Utterance]):
        """This rank's utterances of a batch and its padded row count."""
        b_pad = self._pad_batch(len(utts))
        return (mesh_lib.shard_rows(utts, b_pad, self.mesh),
                b_pad // mesh_lib.data_size(self.mesh))

    # -- stages ---------------------------------------------------------------

    def _prep_wire(self, utts: Sequence[Utterance]) -> Optional[np.ndarray]:
        """This rank's wire buffer of a batch: (rows, wire_samples) int16
        when every utterance is exactly int16/32768-representable, else
        float32 (None when the rank has no utterance of it). Only the
        batch's true audio length is sent, bucketed to 5 s steps; the rest
        of the window is zero-padded on the device."""
        utts, b_pad = self._local(utts)
        if not utts:
            return None
        n_samples = 2 * self.dims.n_audio_ctx * constants.HOP_LENGTH
        sample_bucket = 5 * constants.SAMPLE_RATE
        max_live = max(min(u.audio.size, n_samples) for u in utts)
        wire_samples = min(n_samples,
                           mesh_lib.pad_to_multiple(max_live, sample_bucket))
        rows_i16 = [_utt_wire_i16(u) for u in utts]
        use_i16 = all(r is not None for r in rows_i16)
        wire = np.zeros((b_pad, wire_samples),
                        np.int16 if use_i16 else np.float32)
        for i, u in enumerate(utts):
            src = rows_i16[i] if use_i16 else u.audio
            n = min(src.size, wire_samples)
            wire[i, :n] = src[:n]  # pad_or_trim semantics: first n samples
        return wire

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the pipeline's device: on a card through pinned
        memory, copied without blocking the host."""
        t = torch.from_numpy(arr)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _dispatch_transcribe(self, utts: Sequence[Utterance],
                             wire: Optional[np.ndarray] = None) -> dict:
        """Stage 1: upload the wire, queue mel and encoder, decode. The
        transcripts arrive through the returned ``DecodeFuture``. ``wire`` is
        the batch's buffer from :meth:`_prep_wire` (``run_dataset`` builds it
        in the background); None builds it here. Under a mesh the returned
        ``utts`` are this rank's (none, past the batch's real rows)."""
        cfg = self.cfg
        kv_frames = None
        if cfg.decode_frame_bucket > 0:
            # one bucket for the whole batch, as on one device
            max_fl = max(max(u.duration // constants.AUDIO_SAMPLES_PER_TOKEN, 1)
                         for u in utts)
            kv_frames = min(self.dims.n_audio_ctx, mesh_lib.pad_to_multiple(
                int(max_fl), cfg.decode_frame_bucket))
        local = self._local(utts)[0]
        n = len(local)
        batch = self._batches_dispatched
        self._batches_dispatched += 1
        if not local:
            return dict(utts=local, future=None, mel=None, xa=None,
                        cross_kv=None, batch=batch)
        if wire is None:
            with self.timers.stage("wire prep", n, kind="host", batch=batch):
                wire = self._prep_wire(utts)
        utts = local
        n_samples = 2 * self.dims.n_audio_ctx * constants.HOP_LENGTH
        with self.timers.stage("mel", n, batch=batch):
            mel = wire_to_mel(self._upload(wire), self.dims.n_mels,
                              total_samples=n_samples,
                              compute_dtype=self.compute_dtype)
        b_pad = mel.shape[0]
        with self.timers.stage("encoder", n, batch=batch):
            xa = wmodel.encode_audio(self.model, mel,
                                     device=self.device.type)
        kv_int8 = cfg.decode_kv_int8 or cfg.decode_kv_int8_guarded
        # cross-K/V reuse: only when the decode loop's K/V are the capture
        # pass's own (full frames, not quantized), and when they fit the
        # budget (WCA_REUSE_KV_MAX_BYTES, default 8e9 bytes) divided among
        # the stacks run_dataset keeps alive: pipeline_depth batches with
        # their decode in flight and one in the capture (JAX runner.py:390),
        # and not under a mesh (JAX runner.py:398-405)
        n_live = max(1, cfg.pipeline_depth) + 1
        reuse_kv = (cfg.reuse_cross_kv and kv_frames is None and not kv_int8
                    and self.mesh is None
                    and _cross_kv_bytes(self.dims, b_pad, self.compute_dtype)
                    * n_live
                    <= int(float(os.environ.get("WCA_REUSE_KV_MAX_BYTES",
                                                8e9))))
        with self.timers.stage("decode dispatch", n, batch=batch):
            future, xa, cross_kv = decoding.decode(
                self.model, self.tokenizer, mel, self.options,
                return_cross_kv=True, xa=xa, device=self.device.type,
                kv_frames=kv_frames, kv_int8=kv_int8,
                kv_int8_guard=(decoding.default_guard_margin()
                               if cfg.decode_kv_int8_guarded else None),
                kv_frames_guard=(decoding.default_bucket_guard_margin()
                                 if cfg.decode_frame_bucket_guarded
                                 else None),
                async_results=True)
        self.decode_shapes.append((b_pad, len(utts), kv_frames))
        return dict(utts=utts, future=future, mel=mel, xa=xa,
                    cross_kv=cross_kv if reuse_kv else None, batch=batch)

    def transcribe_batch(self, utts: Sequence[Utterance]):
        """Synchronous wrapper: (transcripts, mel batch, encoder states);
        under a mesh the transcripts of the whole batch, the mel and states
        of this rank's rows."""
        p = self._dispatch_transcribe(utts)
        texts = ([] if p["future"] is None else
                 [r.text for r in p["future"].result()[:len(p["utts"])]])
        return mesh_lib.gather_rows(texts, self.mesh), p["mel"], p["xa"]

    def align_batch(self, utts: Sequence[Utterance],
                    return_matrix: bool = False) -> List[UttAlignment]:
        """One batch, end to end (the three stages back to back)."""
        return self._collect_align(self._dispatch_align(
            self._dispatch_transcribe(utts), return_matrix=return_matrix))

    def _dispatch_align(self, tp: dict, return_matrix: bool = False) -> dict:
        """Stage 2: wait for this batch's transcripts, re-tokenize on the
        host, queue the capture and the alignment, and start their outputs'
        copies to the host."""
        cfg = self.cfg
        tok = self.tokenizer
        utts = tp["utts"]
        xa = tp["xa"]
        batch = tp.get("batch")
        stage = functools.partial(self.timers.stage, batch=batch)
        margins = []
        if self.transcribe_override is not None:
            transcripts = self.transcribe_override(utts)
        elif not utts:
            transcripts = []
        else:
            with stage("transcripts sync", len(utts), kind="wait") as span:
                results = tp["future"].result()
                # sequence positions reached, less the prompt's before the
                # first sampled step
                span.count("decode steps needed",
                           int(results[0].n_steps) - (self.sot_len - 1))
            transcripts = [r.text for r in results[:len(utts)]]
            margins = [float(r.min_margin) for r in results[:len(utts)]
                       if np.isfinite(r.min_margin)]

        with stage("retokenize", len(utts), kind="host"):
            prepared = []
            for u, transcription in zip(utts, transcripts):
                text_norm = retokenize.remove_punctuation(u.text)
                tr_norm = (text_norm if cfg.use_gt_transcript
                           else retokenize.remove_punctuation(transcription))
                if len(tr_norm) == 0:  # reference guard
                    tr_norm = " "
                text_tokens = retokenize.encode(tr_norm, tok,
                                                cfg.aligned_unit_type)
                tokens = [*tok.sot_sequence, tok.no_timestamps, *text_tokens,
                          tok.eot]
                max_frames = u.duration // constants.AUDIO_SAMPLES_PER_TOKEN
                # reference guards (infer_ali.py:78-81); the token cap also
                # respects the model's own context
                skip = (max_frames > constants.MAX_FRAMES
                        or len(tokens) > min(constants.MAX_LENGTH,
                                             self.dims.n_text_ctx))
                prepared.append((u, tr_norm, text_norm, text_tokens, tokens,
                                 int(max_frames), skip))

        live = [p for p in prepared if not p[6]]
        outputs = None
        if live:
            with stage("capture pack", len(live)):
                b_pad = max(self.rows, len(live))
                t_max = max(len(p[4]) for p in live)
                t_bucket = min(self.dims.n_text_ctx, mesh_lib.pad_to_multiple(
                    t_max, self.token_bucket))
                tokens_arr, token_len, frame_len, xa_idx = pack_fixed_batch(
                    [(p[0], p[4], p[5]) for p in live], utts, b_pad, t_bucket,
                    tok.eot, self.dims.n_audio_ctx)
                # cross-K/V reuse needs the live rows in decode order
                cross_kv = tp.get("cross_kv")
                if cross_kv is not None and not (
                        xa.shape[0] == b_pad
                        and np.array_equal(xa_idx[:len(live)],
                                           np.arange(len(live)))):
                    cross_kv = None
                dev = self.device
                xa_live = (None if cross_kv is not None
                           else xa[self._upload(xa_idx.astype(np.int64))])
                self.capture_shapes.append((t_bucket, b_pad, len(live),
                                            cross_kv is not None))
                token_len_t = self._upload(token_len)
                frame_len_t = self._upload(frame_len)
                tokens_t = self._upload(tokens_arr)
            if cfg.default_whisper_timing:
                with stage("capture+align", len(live)):
                    jump_dev, probs_dev, matrix_dev = \
                        timing.default_find_alignment_batch(
                            self.model, None, tokens_t, token_len_t,
                            frame_len_t, self.alignment_heads, eot=tok.eot,
                            medfilt_width=cfg.medfilt_width,
                            qk_scale=cfg.qk_scale, sot_len=self.sot_len,
                            xa=xa_live, cross_kv=cross_kv, device=dev.type)
                sel = ()
            else:
                probs_dev = None
                with stage("capture", len(live)):
                    attn, _ = timing.get_attentions(
                        self.model, None, tokens_t, token_len_t, frame_len_t,
                        medfilt_width=cfg.medfilt_width,
                        qk_scale=cfg.qk_scale, return_logits=False,
                        xa=xa_live, cross_kv=cross_kv, device=dev.type)
                with stage("align", len(live)):
                    jump_dev, matrix_dev, scores = timing.force_align_batch(
                        attn, token_len_t, frame_len_t, self.sot_len,
                        cfg.aggr, cfg.topk, cfg.w_colnorm, cfg.w_rownorm,
                        cfg.w_coverage)
                    del attn
                sel = () if scores is None else (scores[1], scores[2])
            with stage("output copies", len(live)):
                named = dict(jump=jump_dev, probs=probs_dev,
                             matrix=matrix_dev if return_matrix else None)
                named.update(zip(("sel0", "sel1"), sel))
                named = {k: v for k, v in named.items() if v is not None}
                outputs = decoding.DecodeFuture(
                    list(named.values()),
                    lambda *arrays: dict(zip(named, arrays)))
        return dict(utts=utts, prepared=prepared, live=live, outputs=outputs,
                    margins=margins, batch=batch)

    def _collect_align(self, ap: dict) -> List[UttAlignment]:
        """Stage 3: wait for the alignment's outputs and turn them into word
        times on the host; under a mesh, gather every data index's in input
        order."""
        host = {}
        if ap["outputs"] is not None:
            with self.timers.stage("collect sync", len(ap["live"]),
                                   kind="wait", batch=ap.get("batch")):
                host = ap["outputs"].result()
        with self.timers.stage("word times", len(ap["prepared"]),
                               kind="host", batch=ap.get("batch")):
            return self._word_times(ap, host)

    def _word_times(self, ap: dict, host: dict) -> List[UttAlignment]:
        """Word times of a collected batch, on the host."""
        cfg = self.cfg
        tok = self.tokenizer
        prepared = ap["prepared"]
        jump_frames = host.get("jump")
        token_probs = host.get("probs")
        matrix_np = host.get("matrix")
        sel = (host["sel0"], host["sel1"]) if "sel0" in host else None

        out: List[UttAlignment] = []
        # device rows follow `live` (prepared minus skips, order kept): index
        # them positionally, never by fid
        live_i = -1
        for u, tr_norm, text_norm, text_tokens, tokens, max_frames, skip in \
                prepared:
            if skip:
                out.append(UttAlignment(
                    fid=u.fid, words=[], start_times=np.array([]),
                    end_times=np.array([]), transcription=tr_norm,
                    text=text_norm, starts=u.starts, ends=u.ends,
                    skipped=True))
                continue
            live_i += 1
            if cfg.default_whisper_timing:
                # the baseline path always groups with the tokenizer's own
                # word splitter (reference timing.py:167)
                words, word_tokens = tok.split_to_word_tokens(
                    list(text_tokens) + [tok.eot])
                wb = (None if len(word_tokens) <= 1 else np.pad(
                    np.cumsum([len(t) for t in word_tokens[:-1]]), (1, 0)))
            else:
                words, _, wb = timing.words_and_boundaries(
                    text_tokens, tok, cfg.aligned_unit_type)
            if wb is None:
                out.append(UttAlignment(
                    fid=u.fid, words=[], start_times=np.array([]),
                    end_times=np.array([]), transcription=tr_norm,
                    text=text_norm, starts=u.starts, ends=u.ends))
                continue
            jf = jump_frames[live_i][:len(text_tokens) + 1]
            starts, ends = timing.jump_frames_to_times(jf, wb)
            word_probs = None
            if token_probs is not None:
                tp_row = token_probs[live_i][:len(text_tokens)]
                word_probs = [float(np.mean(tp_row[i:j]))
                              for i, j in zip(wb[:-1], wb[1:])]
            m = None
            if matrix_np is not None:
                m = matrix_np[live_i][self.sot_len:len(tokens) - 1,
                                      :max_frames]
            out.append(UttAlignment(
                fid=u.fid, words=words, start_times=starts, end_times=ends,
                transcription=tr_norm, text=text_norm, starts=u.starts,
                ends=u.ends, matrix=m,
                scores=(None if sel is None
                        else (sel[0][live_i], sel[1][live_i])),
                word_probabilities=word_probs))
        self.min_margins.extend(mesh_lib.gather_rows(ap["margins"], self.mesh))
        return mesh_lib.gather_rows(out, self.mesh)

    def run_dataset(self, dataset, progress: bool = True):
        """Iterate a dataset in batches; yields UttAlignment per utterance,
        in dataset order (or duration order with ``cfg.sort_by_duration``).

        Software-pipelined as the JAX runner is (JAX ``runner.py:619-686``):
        a one-batch-lookahead thread builds the next batch's wire buffer;
        up to ``cfg.pipeline_depth`` batches keep their decode results in
        flight before the oldest one's transcripts are read; one capture +
        align batch stays queued on the device while the host collects the
        one before it."""
        timers = self.timers
        timers.claim()  # this thread issues the pass: it owns the stream
        loop = functools.partial(timers.stage, "loop", kind="host")
        with loop():
            order = None
            if self.cfg.sort_by_duration:
                from .data.dataset import duration_order

                order = duration_order(dataset)
            it = batch_iter(dataset, self.cfg.batch_size, order=order)
            if progress:
                try:
                    from tqdm import tqdm
                except ImportError:
                    pass
                else:
                    total = -(-len(dataset) // self.cfg.batch_size)
                    it = tqdm(it, total=total)
            it = iter(it)
            rm = self.cfg.plot
            depth = max(1, self.cfg.pipeline_depth)
            transcribed = collections.deque()  # decode results in flight
            aligned = collections.deque()  # capture + align in flight
            ex = ThreadPoolExecutor(max_workers=1,
                                    thread_name_prefix="wca-wireprep")
            # the batch index _dispatch_transcribe gives the next batch
            next_index = self._batches_dispatched

        def prep(batch, i):
            with timers.stage("wire prep", len(batch), kind="host", batch=i):
                return self._prep_wire(batch)

        def read():
            """The next batch and its wire buffer's future (its prep
            started), or None after the last."""
            nonlocal next_index
            with timers.stage("batch read", kind="host", batch=next_index):
                batch = next(it, None)
                if batch is None:
                    return None
                next_index += 1
                return batch, ex.submit(prep, batch, next_index - 1)

        def collected(ap):
            out = self._collect_align(ap)
            with loop():  # the caller holds the pass at each yield
                yield from out

        try:
            ahead = read()
            while ahead is not None:
                (batch, wire_fut), ahead = ahead, read()
                with timers.stage("wire wait", len(batch), kind="host"):
                    wire = wire_fut.result()
                transcribed.append(self._dispatch_transcribe(batch,
                                                             wire=wire))
                if len(transcribed) > depth:
                    aligned.append(self._dispatch_align(
                        transcribed.popleft(), return_matrix=rm))
                while len(aligned) > 1:
                    yield from collected(aligned.popleft())
            while transcribed:
                aligned.append(self._dispatch_align(transcribed.popleft(),
                                                    return_matrix=rm))
                while len(aligned) > 1:
                    yield from collected(aligned.popleft())
            while aligned:
                yield from collected(aligned.popleft())
        finally:
            with loop():
                ex.shutdown(wait=True, cancel_futures=True)
