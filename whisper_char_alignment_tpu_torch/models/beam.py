"""Beam-search and temperature-sampling decode loops (port of
``whisper_char_alignment_tpu/models/beam.py``).

The rest of the published ``whisper.decode`` option surface beyond the
greedy loop:

- **Beam search** (``beam_size``, deterministic): each step every beam
  proposes its top (beam+1) continuations; the candidates of an audio are
  merged in the published dict-insertion order and sorted by cumulative
  log-prob (stable), the best ``beam`` non-eot candidates become the next
  beams (the cache rows follow them), and eot candidates met before the beam
  is refilled are banked, up to ``round(beam * patience)``.
- **Sampling** (``temperature > 0``, optionally ``best_of`` rows per
  audio): a categorical draw from ``filtered / temperature`` as the argmax
  of the logits plus Gumbel noise (``jax.random.categorical``'s
  construction); the cumulative log-prob is taken from the un-scaled
  distribution (published ``GreedyDecoder.update``).
- Both end with the published maximum-likelihood ranker (``logprob /
  length`` or the ((5+L)/6)^alpha length penalty).

The published code de-duplicates beam candidates through a dict keyed by the
token sequence. Here duplicates exist only while all beams of an audio are
still identical (the first sampled step), so the dict is reproduced by
masking the candidates of beams > 0 at that step.

As the greedy loop (``models/decoding.py``), each loop's state lives on the
device and a step never reads the host: on a card the loop replays a
captured CUDA graph of a chunk of steps (``models/decode_graph.py``), on the
CPU it runs eagerly. The orders the JAX loop takes from XLA are made
explicit, since PyTorch promises none of them: ``lax.top_k`` keeps the lower
index on ties (a stable descending sort here); the candidate merge is a
stable argsort; the banked-candidate scatter that JAX drops when out of
range writes a spare slot here (an out-of-range index is a device-side
assert on a card). The sampling temperature is a tensor of the state, so
one captured graph serves every temperature, and the noise is drawn on the
host side of the graph, one (rows, V) draw per step from a
``torch.Generator`` (:func:`noise_source`, the seam through which a test
puts in JAX's own ``jax.random.gumbel`` noise).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from . import decoding
from . import whisper as wmodel

_NEG_INF = float("-inf")


def _length_penalty(length: int, alpha: Optional[float]) -> float:
    """Published MaximumLikelihoodRanker penalty: the plain length when alpha
    is None, else the GNMT ((5 + L) / 6) ** alpha; an empty candidate counts
    as length 1 (the published code would divide by zero)."""
    if alpha is None:
        return float(max(length, 1))
    return ((5.0 + max(length, 1)) / 6.0) ** alpha


def ml_rank(cand_tokens: List[List[int]], cand_lp: List[float],
            alpha: Optional[float]) -> int:
    """Index of the best candidate by length-normalized cumulative logprob."""
    scores = [lp / _length_penalty(len(t), alpha)
              for t, lp in zip(cand_tokens, cand_lp)]
    return int(np.argmax(scores))


def beam_candidates(tokens, sum_lp, fin_tok, fin_lp, fin_cnt, *,
                    beam_size: int, sample_begin: int, eot: int):
    """Published BeamSearchDecoder.finalize: the banked finished sequences,
    topped up (when fewer than beam_size finished) with the best unfinished
    beams by cumulative logprob. Returns per audio (cand_tokens: list of
    sampled-token lists, cand_lp: list of float)."""
    out = []
    for a in range(fin_cnt.shape[0]):
        n = int(fin_cnt[a])
        cands = [decoding.trim(fin_tok[a, j], sample_begin, eot) for j in range(n)]
        lps = [float(fin_lp[a, j]) for j in range(n)]
        if len(cands) < beam_size:
            # published: `np.argsort(sum_logprobs[i])[::-1]`, an ascending
            # sort reversed, so on equal sums the higher beam row wins
            rows = np.argsort(sum_lp[a * beam_size:(a + 1) * beam_size])[::-1]
            for j in rows:
                cands.append(decoding.trim(tokens[a * beam_size + int(j)],
                                   sample_begin, eot))
                lps.append(float(sum_lp[a * beam_size + int(j)]))
                if len(cands) >= beam_size:
                    break
        out.append((cands, lps))
    return out


def group_candidates(tokens, sum_lp, *, n_group: int, sample_begin: int,
                     eot: int):
    """Sampling finalize: each audio's n_group rows are its candidates."""
    out = []
    for a in range(tokens.shape[0] // n_group):
        rows = range(a * n_group, (a + 1) * n_group)
        out.append(([decoding.trim(tokens[r], sample_begin, eot) for r in rows],
                    [float(sum_lp[r]) for r in rows]))
    return out


# ---------------------------------------------------------------------------
# shared by both loops
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """What every step of a beam or sampling decode does: the Python values
    the step reads, so a captured step is keyed by them. ``group`` rows per
    audio (the beam, or best_of); ``max_candidates`` is the beam's
    ``round(beam * patience)`` (0 for sampling)."""
    sample_begin: int
    total: int
    ts_begin: int
    eot: int
    no_timestamps: int
    no_speech: Optional[int]
    max_initial_ts_index: Optional[int]
    use_timestamps: bool
    sot_index: int
    group: int
    max_candidates: int = 0


def _filters(st, logits, spec: GroupSpec) -> torch.Tensor:
    return decoding.apply_logit_filters(
        logits, st.i, st.tokens, st.has_ts, st.last_ts_tok, st.suppress_mask,
        st.blank_mask, st.vocab_ids, sample_begin=spec.sample_begin,
        ts_begin=spec.ts_begin, eot=spec.eot,
        no_timestamps=spec.no_timestamps,
        max_initial_ts_index=spec.max_initial_ts_index,
        use_timestamps=spec.use_timestamps)


def _group_setup(model, xa: torch.Tensor, prompt: np.ndarray,
                 spec: GroupSpec):
    """The cross K/V, the prompt's prefill over the un-repeated (B, P)
    prompt against the un-repeated cross K/V, and both repeated ``group``
    times per audio (the rows of an audio adjacent), as JAX does. Returns
    (tokens (rows, total), cache, ns_prob (rows,), cross_kv)."""
    dev = xa.device
    b, g = xa.shape[0], spec.group
    cross_kv = wmodel.precompute_cross_kv(model, xa)
    prompt_t = decoding.prompt_rows(prompt, b).to(dev)
    cache = wmodel.init_kv_cache(model.dims, b, spec.total, dtype=model.dtype,
                                 device=dev, n_head=wmodel.text_heads(model))
    ns_prob = (torch.zeros(b, device=dev) if spec.no_speech is not None
               else torch.full((b,), float("nan"), device=dev))
    if spec.sample_begin >= 2:
        ns_at = (spec.sot_index if (spec.no_speech is not None
                                    and spec.sot_index < spec.sample_begin - 1)
                 else None)
        pf_logits, cache = wmodel.decode_prefill(
            model, prompt_t[:, :spec.sample_begin - 1], cache, cross_kv,
            logits_at=ns_at, cross_mode="xla")
        if ns_at is not None:
            ns_prob = decoding.vocab_softmax(pf_logits)[:, spec.no_speech]
    cache = {k: v.repeat_interleave(g, dim=1) for k, v in cache.items()}
    cross_kv = tuple(c.repeat_interleave(g, dim=1) for c in cross_kv)
    tokens = torch.full((b * g, spec.total), spec.eot, dtype=torch.long,
                        device=dev)
    tokens[:, :spec.sample_begin] = prompt_t.repeat_interleave(g, dim=0)
    return tokens, cache, ns_prob.repeat_interleave(g), cross_kv


def _probe_no_speech(st, logits, active, spec: GroupSpec) -> torch.Tensor:
    """The no-speech probability right after sot, where the prefill did not
    take it (a select on the step's position)."""
    if spec.no_speech is None:
        return st.ns_prob
    return torch.where(active & (st.i == spec.sot_index + 1),
                       decoding.vocab_softmax(logits)[:, spec.no_speech],
                       st.ns_prob)


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BeamState(decoding.DeviceState):
    """The beam loop's state (JAX ``models/beam.py:224-234``), every tensor
    on the model's device; rows = B * beam, an audio's beams adjacent."""
    tokens: torch.Tensor  # (rows, total) int64
    cache: wmodel.Cache  # (L, rows, H, hd, total) each
    i: torch.Tensor  # (1,) int64: the position the next step predicts
    sum_lp: torch.Tensor  # (rows,) float32
    has_ts: torch.Tensor  # (rows,) bool
    last_ts_tok: torch.Tensor  # (rows,) int64
    fin_tok: torch.Tensor  # (B, MC + 1, total) int64; slot MC is spare
    fin_lp: torch.Tensor  # (B, MC + 1) float32
    fin_cnt: torch.Tensor  # (B,) int64
    ns_prob: torch.Tensor  # (rows,) float32
    done: torch.Tensor  # (1,) bool
    suppress_mask: torch.Tensor
    blank_mask: torch.Tensor
    vocab_ids: torch.Tensor


def beam_setup(model, xa: torch.Tensor, prompt: np.ndarray,
               suppress_mask: torch.Tensor, blank_mask: torch.Tensor,
               spec: GroupSpec):
    """The beam loop's initial state and its repeated cross K/V."""
    dev = xa.device
    b, mc = xa.shape[0], spec.max_candidates
    tokens, cache, ns_prob, cross_kv = _group_setup(model, xa, prompt, spec)
    rows = tokens.shape[0]
    st = BeamState(
        tokens=tokens, cache=cache,
        i=torch.full((1,), spec.sample_begin, dtype=torch.long, device=dev),
        sum_lp=torch.zeros(rows, device=dev),
        has_ts=torch.zeros(rows, dtype=torch.bool, device=dev),
        last_ts_tok=torch.zeros(rows, dtype=torch.long, device=dev),
        fin_tok=torch.full((b, mc + 1, spec.total), spec.eot,
                           dtype=torch.long, device=dev),
        fin_lp=torch.full((b, mc + 1), _NEG_INF, device=dev),
        fin_cnt=torch.zeros(b, dtype=torch.long, device=dev),
        ns_prob=ns_prob,
        done=torch.full((1,), spec.sample_begin >= spec.total,
                        dtype=torch.bool, device=dev),
        suppress_mask=suppress_mask.to(dev), blank_mask=blank_mask.to(dev),
        vocab_ids=torch.arange(model.dims.n_vocab, device=dev))
    return st, cross_kv


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k``'s values and indices: descending, the lower index first
    among equal values (``torch.topk`` promises no order on ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def beam_step_(model, st: BeamState, cross_kv, spec: GroupSpec) -> None:
    """One beam step in place, without a host read (JAX ``models/beam.py:
    143-222`` under its ``cond``: ``i < total`` and not every audio's bank
    full). A step past the end changes no output."""
    g, mc, total, eot = spec.group, spec.max_candidates, spec.total, spec.eot
    dev = st.tokens.device
    b = st.fin_cnt.shape[0]
    rows, c = b * g, g * (g + 1)
    active = (st.i < total) & ~(st.fin_cnt >= mc).all()
    pos_in = st.i - 1
    logits, _ = wmodel.decode_step(model, st.tokens.index_select(1, pos_in),
                                   pos_in, st.cache, cross_kv,
                                   cross_mode="xla")
    ns_prob = _probe_no_speech(st, logits, active, spec)
    logprobs = decoding.vocab_log_softmax(_filters(st, logits, spec).float())
    lp_k, tok_k = _top_k(logprobs, g + 1)  # (rows, g+1)
    cand_lp = (st.sum_lp[:, None] + lp_k).reshape(b, c)
    cand_tok = tok_k.reshape(b, c)
    row_in_audio = torch.arange(c, device=dev) // (g + 1)  # candidate -> beam
    # the dict's de-duplication: at the first sampled step every beam of an
    # audio is the same sequence, so only beam 0's candidates count
    first = st.i == spec.sample_begin
    cand_lp = cand_lp.masked_fill(first[:, None] & (row_in_audio > 0)[None],
                                  _NEG_INF)
    # published order: a stable sort by score over dict insertion order
    order = torch.argsort(-cand_lp, dim=-1, stable=True)  # (B, C)
    s_lp = cand_lp.gather(1, order)
    s_tok = cand_tok.gather(1, order)
    s_src = row_in_audio[order]  # the source beam of each candidate
    noneot = s_tok != eot
    ks = torch.arange(1, g + 1, device=dev).expand(b, g).contiguous()
    # the position of the k-th non-eot candidate, k = 1..g
    pos_k = torch.searchsorted(noneot.long().cumsum(dim=-1), ks)
    new_src = s_src.gather(1, pos_k)
    new_tok = s_tok.gather(1, pos_k)
    new_lp = s_lp.gather(1, pos_k)
    # eot candidates met before the beam was refilled are banked
    cut = pos_k[:, -1:]
    newly_fin = ~noneot & (torch.arange(c, device=dev)[None] < cut)
    fin_rank = newly_fin.long().cumsum(dim=-1)
    pos_f = torch.searchsorted(fin_rank, ks).clamp(max=c - 1)
    lanes = torch.arange(g, device=dev)[None]
    slot = st.fin_cnt[:, None] + lanes
    ins = (lanes < fin_rank[:, -1:]) & (slot < mc) & active
    audio_base = (torch.arange(b, device=dev) * g)[:, None]
    fin_src = (audio_base + s_src.gather(1, pos_f)).reshape(-1)
    col = st.i.clamp(max=total - 1)
    fin_seqs = st.tokens.index_select(0, fin_src).index_fill_(1, col, eot)
    # JAX drops the writes whose slot is out of range: here they go to the
    # spare slot mc, sliced away by the outputs
    slot = torch.where(ins, slot, mc)
    b_idx = torch.arange(b, device=dev)[:, None].expand(b, g)
    st.fin_tok.index_put_((b_idx, slot), fin_seqs.reshape(b, g, total))
    st.fin_lp.index_put_((b_idx, slot), s_lp.gather(1, pos_f))
    st.fin_cnt.add_(ins.sum(dim=-1))

    # advance the beams (the identity when the step is past the end)
    src = torch.where(active, (audio_base + new_src).reshape(-1),
                      torch.arange(rows, device=dev))
    nxt = new_tok.reshape(-1)
    tokens = st.tokens.index_select(0, src)
    tokens.index_copy_(1, col, torch.where(
        active, nxt, tokens.index_select(1, col)[:, 0])[:, None])
    st.tokens.copy_(tokens)
    for t in st.cache.values():
        t.copy_(t.index_select(1, src))
    sampled_ts = active & (nxt >= spec.ts_begin)
    st.has_ts.copy_(st.has_ts.index_select(0, src) | sampled_ts)
    st.last_ts_tok.copy_(torch.where(sampled_ts, nxt,
                                     st.last_ts_tok.index_select(0, src)))
    st.sum_lp.copy_(torch.where(active, new_lp.reshape(-1), st.sum_lp))
    st.ns_prob.copy_(ns_prob.index_select(0, src))
    st.i.add_(active.long())


def beam_kind(model, spec: GroupSpec) -> decoding.LoopKind:
    """The beam loop for the runners. Outputs (tokens (rows, total), sum_lp
    (rows,), fin_tok (B, MC, total), fin_lp (B, MC), fin_cnt (B,), ns_prob
    (rows,), n_steps (1,))."""
    mc = spec.max_candidates

    def finish(st: BeamState) -> None:
        st.done.copy_((st.i >= spec.total) | (st.fin_cnt >= mc).all())

    def outputs(st: BeamState):
        return (st.tokens, st.sum_lp, st.fin_tok[:, :mc], st.fin_lp[:, :mc],
                st.fin_cnt, st.ns_prob, st.i - 1)

    return decoding.LoopKind(
        step=lambda st, kv, slot: beam_step_(model, st, kv, spec),
        finish=finish, outputs=outputs)


@torch.no_grad()
def _beam_loop(model, xa: torch.Tensor, prompt: np.ndarray,
               suppress_mask: torch.Tensor, blank_mask: torch.Tensor,
               spec: GroupSpec):
    """The beam loop from encoder states xa (B, n_audio_ctx, d), run by
    ``decoding.loop_runner`` (a captured graph on a card). Returns
    the outputs of :func:`beam_kind`."""
    st, cross_kv = beam_setup(model, xa, prompt, suppress_mask, blank_mask,
                              spec)
    run = decoding.loop_runner(model, xa.device)
    key = ("beam", spec, xa.shape[0], xa.shape[1], model.dtype)
    return run(model, key, beam_kind(model, spec), st, cross_kv,
               spec.total - spec.sample_begin)


# ---------------------------------------------------------------------------
# temperature sampling
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SampleState(decoding.DeviceState):
    """The sampling loop's state (JAX ``models/beam.py:347-353``), every
    tensor on the model's device."""
    tokens: torch.Tensor  # (rows, total) int64
    cache: wmodel.Cache
    i: torch.Tensor  # (1,) int64
    finished: torch.Tensor  # (rows,) bool
    sum_lp: torch.Tensor  # (rows,) float32
    has_ts: torch.Tensor  # (rows,) bool
    last_ts_tok: torch.Tensor  # (rows,) int64
    ns_prob: torch.Tensor  # (rows,) float32
    temperature: torch.Tensor  # (1,) float32: a tensor, not a graph key
    noise: torch.Tensor  # (CHUNK_STEPS, rows, V) float32 Gumbel noise
    done: torch.Tensor  # (1,) bool
    suppress_mask: torch.Tensor
    blank_mask: torch.Tensor
    vocab_ids: torch.Tensor


def sample_setup(model, xa: torch.Tensor, prompt: np.ndarray,
                 suppress_mask: torch.Tensor, blank_mask: torch.Tensor,
                 spec: GroupSpec, temperature: float):
    """The sampling loop's initial state and its repeated cross K/V."""
    dev = xa.device
    tokens, cache, ns_prob, cross_kv = _group_setup(model, xa, prompt, spec)
    rows = tokens.shape[0]
    st = SampleState(
        tokens=tokens, cache=cache,
        i=torch.full((1,), spec.sample_begin, dtype=torch.long, device=dev),
        finished=torch.zeros(rows, dtype=torch.bool, device=dev),
        sum_lp=torch.zeros(rows, device=dev),
        has_ts=torch.zeros(rows, dtype=torch.bool, device=dev),
        last_ts_tok=torch.zeros(rows, dtype=torch.long, device=dev),
        ns_prob=ns_prob,
        temperature=torch.full((1,), float(temperature), device=dev),
        noise=torch.zeros(decoding.CHUNK_STEPS, rows, model.dims.n_vocab,
                          device=dev),
        done=torch.full((1,), spec.sample_begin >= spec.total,
                        dtype=torch.bool, device=dev),
        suppress_mask=suppress_mask.to(dev), blank_mask=blank_mask.to(dev),
        vocab_ids=torch.arange(model.dims.n_vocab, device=dev))
    return st, cross_kv


def sample_step_(model, st: SampleState, cross_kv, spec: GroupSpec,
                 slot: int) -> None:
    """One sampling step in place, without a host read (JAX
    ``models/beam.py:309-345``), drawing with the noise of ``slot``. A step
    past the end changes no output."""
    active = (st.i < spec.total) & ~st.finished.all()
    pos_in = st.i - 1
    logits, _ = wmodel.decode_step(model, st.tokens.index_select(1, pos_in),
                                   pos_in, st.cache, cross_kv,
                                   cross_mode="xla")
    ns_prob = _probe_no_speech(st, logits, active, spec)
    filtered = _filters(st, logits, spec).float()
    # jax.random.categorical: argmax(gumbel + logits / temperature)
    sampled = (st.noise[slot] + filtered / st.temperature).argmax(dim=-1)
    chosen = filtered.gather(1, sampled[:, None])[:, 0]
    chosen_lp = chosen - decoding.vocab_logsumexp(filtered)
    finished = st.finished
    next_tok = torch.where(finished, spec.eot, sampled)
    sum_lp = torch.where(finished, st.sum_lp, st.sum_lp + chosen_lp)
    sampled_ts = ~finished & (next_tok >= spec.ts_begin)
    has_ts = st.has_ts | sampled_ts
    last_ts_tok = torch.where(sampled_ts, next_tok, st.last_ts_tok)
    new_finished = finished | (next_tok == spec.eot)
    pos = st.i.clamp(max=spec.total - 1)
    st.tokens.index_copy_(1, pos, torch.where(
        active, next_tok, st.tokens.index_select(1, pos)[:, 0])[:, None])
    for old, new in ((st.finished, new_finished), (st.sum_lp, sum_lp),
                     (st.has_ts, has_ts), (st.last_ts_tok, last_ts_tok),
                     (st.ns_prob, ns_prob)):
        old.copy_(torch.where(active, new, old))
    st.i.add_(active.long())


def noise_source(generator: torch.Generator, rows: int, n_vocab: int
                 ) -> Callable[[int], torch.Tensor]:
    """The Gumbel noise of the step that predicts each position: one (rows,
    V) float32 draw from ``generator`` per call, on its device, as
    ``jax.random.gumbel`` makes it (``-log(-log(u))``, u uniform in [tiny,
    1)). Draws follow the order of the calls, so the eager loop and the
    graph, which ask for the positions in the same order, sample alike.
    Tests replace this function to put in JAX's own noise."""
    tiny = torch.finfo(torch.float32).tiny

    def noise(position: int) -> torch.Tensor:
        u = torch.rand((rows, n_vocab), generator=generator,
                       device=generator.device)
        return u.clamp_(min=tiny).log_().neg_().log_().neg_()

    return noise


def sample_kind(model, spec: GroupSpec,
                noise: Callable[[int], torch.Tensor]) -> decoding.LoopKind:
    """The sampling loop for the runners; ``refill`` loads step ``s``'s
    noise (position ``sample_begin + s``) into its slot before the step
    runs. Outputs (tokens (rows, total), sum_lp (rows,), ns_prob (rows,),
    n_steps (1,))."""
    def finish(st: SampleState) -> None:
        st.done.copy_((st.i >= spec.total) | st.finished.all())

    def refill(st: SampleState, s: int, slot: int) -> None:
        st.noise[slot].copy_(noise(spec.sample_begin + s))

    return decoding.LoopKind(
        step=lambda st, kv, slot: sample_step_(model, st, kv, spec, slot),
        finish=finish,
        outputs=lambda st: (st.tokens, st.sum_lp, st.ns_prob, st.i - 1),
        refill=refill)


@torch.no_grad()
def _sample_loop(model, xa: torch.Tensor, prompt: np.ndarray,
                 suppress_mask: torch.Tensor, blank_mask: torch.Tensor,
                 spec: GroupSpec, temperature: float,
                 noise: Callable[[int], torch.Tensor]):
    """The sampling loop from encoder states xa, run by
    ``decoding.loop_runner`` (a captured graph on a card).
    Returns the outputs of :func:`sample_kind`."""
    st, cross_kv = sample_setup(model, xa, prompt, suppress_mask, blank_mask,
                                spec, temperature)
    run = decoding.loop_runner(model, xa.device)
    key = ("sample", spec, xa.shape[0], xa.shape[1], model.dtype)
    return run(model, key, sample_kind(model, spec, noise), st, cross_kv,
               spec.total - spec.sample_begin)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def run(model, tokenizer, xa: torch.Tensor, options, prompt_arr: np.ndarray,
        suppress_mask: torch.Tensor, blank_mask: torch.Tensor, *,
        sample_begin: int, sample_len: int, sot_index: int,
        max_initial_ts_index: Optional[int], langs: List[str], single: bool,
        generator: Optional[torch.Generator] = None
        ) -> decoding.DecodeFuture:
    """Beam search or sampling for ``decoding.decode`` (JAX
    ``models/beam.py:410-496``): the loop on encoder states xa, then the
    published ranking at ``.result()`` of the returned future. Results:
    the best candidate per audio by :func:`ml_rank`, ``avg_logprob = lp /
    (len + 1)``, the no-speech probability of the audio's first row,
    ``n_steps = i - 1``."""
    beam = options.beam_size is not None
    g = options.beam_size if beam else (options.best_of or 1)
    spec = GroupSpec(
        sample_begin=sample_begin, total=sample_begin + sample_len,
        ts_begin=tokenizer.timestamp_begin, eot=tokenizer.eot,
        no_timestamps=tokenizer.no_timestamps, no_speech=tokenizer.no_speech,
        max_initial_ts_index=max_initial_ts_index,
        use_timestamps=not options.without_timestamps, sot_index=sot_index,
        group=g,
        max_candidates=(max(1, round(g * (
            options.patience if options.patience is not None else 1.0)))
            if beam else 0))
    eot = tokenizer.eot

    def build(groups, ns_prob, n_steps):
        seqs, lps = [], []
        for cands, cand_lps in groups:
            sel = ml_rank(cands, cand_lps, options.length_penalty)
            seqs.append(cands[sel])
            lps.append(cand_lps[sel])
        return decoding.results(tokenizer, options, single, seqs, lps,
                                ns_prob[::g], int(n_steps[0]), langs)

    if beam:
        outs = _beam_loop(model, xa, prompt_arr, suppress_mask, blank_mask,
                          spec)

        def finalize(tokens, sum_lp, fin_tok, fin_lp, fin_cnt, ns_prob,
                     n_steps):
            return build(beam_candidates(
                tokens, sum_lp, fin_tok, fin_lp, fin_cnt, beam_size=g,
                sample_begin=sample_begin, eot=eot), ns_prob, n_steps)
    else:
        if generator is None:
            generator = torch.Generator(device=xa.device).manual_seed(0)
        outs = _sample_loop(
            model, xa, prompt_arr, suppress_mask, blank_mask, spec,
            options.temperature,
            noise_source(generator, xa.shape[0] * g, model.dims.n_vocab))

        def finalize(tokens, sum_lp, ns_prob, n_steps):
            return build(group_candidates(
                tokens, sum_lp, n_group=g, sample_begin=sample_begin,
                eot=eot), ns_prob, n_steps)
    return decoding.DecodeFuture(outs, finalize)
