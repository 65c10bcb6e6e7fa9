"""One run of one cell: set-up, warm-up, the window of whole passes, the
check of the outputs, and the result line.

The program under test is the port's main path: an
``runner.AlignmentPipeline`` on the README recipe, driven by
``run_dataset`` over a corpus written by ``corpus.write`` and read by the
port's loaders. The pipeline is subclassed only to keep what it already
hands between its stages: each batch's served tokens and decode steps
(``DecodingResult``), the mel and encoder states of the held batches, and
the shapes each batch ran.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import corpus, costs, judge, trace as trace_mod, weights

JAX_NAMES = ("jax", "jaxlib", "flax", "whisper_char_alignment_tpu")


def log(msg) -> None:
    print(msg, file=sys.stderr, flush=True)


# -- the spec: BENCHMARK.json and the files it names ---------------------------

@dataclasses.dataclass
class Cell:
    root: str
    bench: dict
    workload: dict
    config: dict
    traffic: dict
    limits: dict

    @property
    def name(self) -> str:
        return self.workload["name"]


def load_cell(root: str, name: str) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json, with its configuration
    (the file the entry names), traffic (``traffic/<traffic>.json``) and
    limits (``limits/<workload>.json``) under the benchmark's folder."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    wl = cells[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    folder = os.path.join(root, bench["paths"][0])
    with open(os.path.join(root, cfgs[wl["config"]]["file"])) as f:
        config = json.load(f)
    with open(os.path.join(folder, "traffic", wl["traffic"] + ".json")) as f:
        traffic = json.load(f)
    with open(os.path.join(folder, "limits", name + ".json")) as f:
        limits = json.load(f)
    return Cell(root, bench, wl, config, traffic, limits)


def metric_readers(cell: Cell) -> Dict[str, tuple]:
    """(``read``, unit) of each per-layer metric this cell reports, from
    ``metrics/<name>.py``."""
    out = {}
    folder = os.path.join(cell.root, cell.bench["paths"][0], "metrics")
    for m in cell.bench["per_layer"]:
        if cell.name not in m.get("workloads", [cell.name]):
            continue
        path = os.path.join(folder, m["name"] + ".py")
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[m["name"]] = (mod.read, m["unit"])
    return out


DIM_KEYS = ("d_model", "encoder_layers", "decoder_layers",
            "encoder_attention_heads", "decoder_attention_heads",
            "num_mel_bins", "vocab_size", "max_source_positions",
            "max_target_positions")


def model_dims(config: dict) -> dict:
    """The configuration's sizes (its published keys), with ``frames``
    (encoder positions)."""
    dims = {k: config[k] for k in DIM_KEYS}
    return dict(dims, frames=dims["max_source_positions"])


# -- the program ----------------------------------------------------------------

def _port():
    from whisper_char_alignment_tpu_torch import config as pconfig, runner
    return pconfig, runner


def build_model(config: dict, sd: Dict[str, torch.Tensor]):
    """The port's Whisper module over the state dict's tensors (no copy)."""
    pconfig, _ = _port()
    from whisper_char_alignment_tpu_torch.models import whisper as wmodel

    d = model_dims(config)
    dims = pconfig.ModelDims(
        n_mels=d["num_mel_bins"], n_audio_ctx=d["max_source_positions"],
        n_audio_state=d["d_model"], n_audio_head=d["encoder_attention_heads"],
        n_audio_layer=d["encoder_layers"], n_vocab=d["vocab_size"],
        n_text_ctx=d["max_target_positions"], n_text_state=d["d_model"],
        n_text_head=d["decoder_attention_heads"],
        n_text_layer=d["decoder_layers"])
    dtype = next(iter(sd.values())).dtype
    model = wmodel.Whisper(dims, device="meta", dtype=dtype)
    model.load_state_dict(sd, assign=True)
    return model.requires_grad_(False)


def make_pipeline(cell: Cell, model, tok, device):
    """The port's pipeline on the cell's recipe, with the hooks that keep
    what its stages hand over."""
    pconfig, runner = _port()
    tr = cell.traffic
    cfg = pconfig.AlignConfig.recommended(
        model=cell.config["model"], batch_size=tr["batch_size"],
        decode_sample_len=tr["decode_sample_len"], **tr["recipe"])

    class Timed(runner.AlignmentPipeline):
        def start_pass(self, hold):
            """``hold``: {batch index: (mel, xa) buffers} that receive
            those batches' log-mel and encoder states, copied on the
            stream; the buffers live from set-up on, so which batches are
            held moves no memory peak."""
            self.hold, self.index = hold, 0
            self.held, self.served, self.batches = {}, {}, []

        def _dispatch_transcribe(self, utts, wire=None):
            tp = super()._dispatch_transcribe(utts, wire=wire)
            if self.index in self.hold:
                mel, xa = self.hold[self.index]
                n = len(tp["utts"])
                mel[:n].copy_(tp["mel"][:n])
                xa[:n].copy_(tp["xa"][:n])
                self.held[self.index] = ([u.fid for u in tp["utts"]], mel,
                                         xa)
            self.index += 1
            return tp

        def _dispatch_align(self, tp, return_matrix=False):
            ap = super()._dispatch_align(tp, return_matrix=return_matrix)
            if tp["future"] is not None:
                res = tp["future"].result()[:len(tp["utts"])]
                for u, r in zip(tp["utts"], res):
                    self.served[u.fid] = list(r.tokens)
                self.batches.append(dict(
                    rows=len(tp["utts"]), n_steps=int(res[0].n_steps),
                    longest=max(len(r.tokens) for r in res),
                    token_lens=[len(p[4]) for p in ap["live"]],
                    t_bucket=(self.capture_shapes[-1][0]
                              if ap["live"] else 0)))
            return ap

    pipe = Timed(model, tok, cfg, device=device,
                 compute_dtype=next(model.parameters()).dtype)
    pipe.start_pass({})
    return pipe


def decode_spec(tok, traffic: dict) -> dict:
    """The greedy decode's token ids and rules for the reference: the
    toy tokenizer's layout (an input both sides read, as a vocabulary file
    is) and the published defaults (suppress '-1' plus the task and sot
    tokens, blank suppression, a first timestamp at most 1.0 s)."""
    suppress = set(tok.non_speech_tokens)
    suppress.update([tok.transcribe, tok.translate, tok.sot, tok.sot_prev,
                     tok.sot_lm])
    if tok.no_speech is not None:
        suppress.add(tok.no_speech)
    return {"sot_sequence": list(tok.sot_sequence), "eot": tok.eot,
            "timestamp_begin": tok.timestamp_begin,
            "no_timestamps": tok.no_timestamps,
            "suppress": sorted(suppress),
            "blank": list(tok.encode(" ")) + [tok.eot],
            "max_initial_timestamp_index": 50,
            "sample_len": traffic["decode_sample_len"]}


def device_info(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def smi() -> str:
    """``nvidia-smi``'s reading of the card's name and power limit."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def allocated(device) -> int:
    return (torch.cuda.memory_allocated(device) if device.type == "cuda"
            else 0)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(one_pass, seconds: float, clock=time.perf_counter) -> tuple:
    """Whole passes (``one_pass(k)``, each ending in a synchronize) until
    ``seconds`` have elapsed, the last one let finish. Returns (passes,
    wall seconds of all of them)."""
    start = clock()
    passes = 0
    while True:
        one_pass(passes)
        passes += 1
        if clock() - start >= seconds:
            break
    return passes, clock() - start


class Context:
    """What a per-layer metric reads."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _batches(records: List[dict], sample_begin: int) -> List[costs.Batch]:
    return [costs.Batch(rows=r["rows"], token_lens=r["token_lens"],
                        t_bucket=r["t_bucket"], sample_begin=sample_begin,
                        steps=r["n_steps"] - (sample_begin - 1))
            for r in records]


def _failed(results, texts: Dict[str, str]) -> int:
    """Utterances of a pass without a sound answer: missing, skipped, or
    with word times of another count, not finite, or not in order."""
    seen, bad = set(), 0
    for a in results:
        seen.add(a.fid)
        n_words = len(texts[a.fid].split())
        s, e = np.asarray(a.start_times), np.asarray(a.end_times)
        if (a.skipped or len(s) != n_words or len(e) != n_words
                or not np.all(np.isfinite(s)) or not np.all(s <= e)
                or not np.all(np.diff(e) >= 0)):
            bad += 1
    return bad + len(set(texts) - seen)


def run(root: str, workload: str, seed: int, seconds: float, traced: bool,
        device=None, t0: Optional[float] = None, side: str = "program"
        ) -> dict:
    """One run; returns the result line (a dict). ``side="control"`` also
    judges the float8 control on the same inputs (its numbers under
    ``control``), which the benchmark's own runs never do."""
    t0 = time.time() if t0 is None else t0
    marks = [("start", time.time() - t0)]
    cell = load_cell(root, workload)
    device = torch.device("cuda" if device is None else device)
    _, runner = _port()
    from whisper_char_alignment_tpu_torch.data import dataset as pdata
    from whisper_char_alignment_tpu_torch.models import decode_graph
    from whisper_char_alignment_tpu_torch.text.tokenizer import (
        get_test_tokenizer)
    from whisper_char_alignment_tpu_torch.utils.device import resolve_device
    from whisper_char_alignment_tpu_torch.utils.profiling import StageTimers

    resolve_device(device)  # float32 is float32: no TF32 on the card
    cfgd, tr = cell.config, cell.traffic
    dims = model_dims(cfgd)
    sd = weights.state_dict(dims, seed, device, getattr(torch, cfgd["dtype"]))
    model = build_model(cfgd, sd)
    sync(device)
    marks.append(("weights", time.time() - t0))
    tok = get_test_tokenizer()
    data_dir = tempfile.mkdtemp(prefix="wca_corpus_")
    try:
        items = corpus.write(tr, data_dir, seed)
        texts = {it.fid: it.text for it in items}
        marks.append(("corpus", time.time() - t0))
        if tr["layout"] == "TIMIT":
            dataset = pdata.TIMIT(corpus.scp_path(data_dir))
        else:
            dataset = pdata.LibriSpeech(
                corpus.scp_path(data_dir),
                alignment_file=corpus.alignment_path(data_dir))
        pipe = make_pipeline(cell, model, tok, device)
        n_batches = -(-len(items) // tr["batch_size"])
        rng = np.random.default_rng(seed % 2**63)
        rows, dtype = tr["batch_size"], getattr(torch, cfgd["dtype"])
        before_hold = allocated(device)
        hold = {i: (torch.empty(rows, dims["num_mel_bins"],
                                2 * dims["frames"], dtype=dtype,
                                device=device),
                    torch.empty(rows, dims["frames"], dims["d_model"],
                                dtype=dtype, device=device))
                for i in {n_batches - 1,
                          int(rng.integers(0, max(n_batches - 1, 1)))}}
        # the held copies are the harness's, not the program's: their bytes
        # stay out of peak_mem_gib
        hold_bytes = allocated(device) - before_hold

        # warm-up: the same shard once, every graph and kernel built here
        list(pipe.run_dataset(dataset, progress=False))
        sync(device)
        setup_s = time.time() - t0
        log(f"card: {smi() if device.type == 'cuda' else 'cpu'}")
        log(f"setup: {setup_s:.3f} s (by then: " + ", ".join(
            f"{k} {v:.3f}" for k, v in marks) + ")")

        # the window: whole passes until the seconds are up
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        pipe.timers = StageTimers(device)
        captures0 = decode_graph.RECORD["captures"]
        window_batches, traced_batches, tr_out = [], [], {}
        state = {"failed": 0, "results": []}

        def one_pass(k: int) -> None:
            pipe.start_pass(hold)
            res = list(pipe.run_dataset(dataset, progress=False))
            sync(device)
            state["failed"] += _failed(res, texts)
            state["results"] = res
            window_batches.extend(pipe.batches)

        passes, wall = window(one_pass, seconds)
        failed, results = state["failed"], state["results"]
        held, served = pipe.held, pipe.served
        aligned = passes * len(items) - failed
        peak_bytes = (torch.cuda.max_memory_allocated(device)
                      if device.type == "cuda" else 0)
        stage_s = pipe.timers.totals
        if traced and device.type == "cuda":
            # one more pass under the profiler, after the window: the
            # tracer's cost stays out of the window's numbers
            pipe.start_pass({})
            with trace_mod.profiled(tr_out):
                res = list(pipe.run_dataset(dataset, progress=False))
            traced_batches = list(pipe.batches)
            failed += _failed(res, texts)
            passes_traced = 1
        else:
            passes_traced = 0
        captures = decode_graph.RECORD["captures"] - captures0
        attempted = (passes + passes_traced) * len(items)
        sample_begin = len(tok.sot_sequence)
        cap = tr["decode_sample_len"]
        short = sum(1 for b in window_batches
                    if b["n_steps"] - (sample_begin - 1) < cap
                    or b["longest"] < cap)
        log(f"window: {passes} passes, {attempted} utterances, "
            f"{wall:.3f} s, {captures} graph captures, decode steps a batch "
            f"{sorted({b['n_steps'] - sample_begin + 1 for b in window_batches})}"
            f" (cap {cap}), {short} batches short of it")

        # what the last pass produced for the held batches
        by_fid = {a.fid: a for a in results}
        item_of = {it.fid: it for it in items}
        cases = []
        for i in sorted(held):
            fids, mel, xa = held[i]
            for row, fid in enumerate(fids):
                a = by_fid.get(fid)
                if a is None or fid not in served:
                    continue  # counted under failed
                heads = (list(zip(np.asarray(a.scores[0]).tolist(),
                                  np.asarray(a.scores[1]).tolist()))
                         if a.scores is not None else [])
                cases.append(judge.Case(
                    fid=fid, pcm=corpus.read_wav(item_of[fid].path),
                    text=texts[fid], served=served[fid], heads=heads,
                    starts=a.start_times, ends=a.end_times, mel=mel[row],
                    xa=xa[row]))
        spec = decode_spec(tok, tr)
        ctx = Context(stage_s=stage_s, utts=aligned, wall_s=wall,
                      trace=tr_out.get("trace"),
                      traced_batches=_batches(traced_batches, sample_begin),
                      window_batches=_batches(window_batches, sample_begin),
                      dims=dims, prompt_len=sample_begin,
                      peak=(costs.peaks(torch.cuda.get_device_name(device))
                            if device.type == "cuda" else None))
        del pipe, model, results, by_fid
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)

    rcfg = {"medfilt_width": tr["recipe"]["medfilt_width"],
            "topk": tr["recipe"]["topk"]}
    t_ref = time.perf_counter()
    numbers = judge.judge(sd, dims, cases, spec, rcfg, device)
    log(f"reference: {time.perf_counter() - t_ref:.1f} s over "
        f"{len(cases)} utterances")
    control = None
    if side == "control":
        control = judge.judge(sd, dims, cases, spec, rcfg, device,
                              side="control")
    checks = {name: {"value": numbers[name], "limit": cell.limits[name]}
              for name in judge.NAMES}
    checks["captures_in_window"] = {"value": captures, "limit": 0}
    checks["decodes_short_of_cap"] = {"value": short, "limit": 0}
    checks["failed"] = {"value": failed, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    if traced:
        for name, (read, unit) in metric_readers(cell).items():
            value = read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
    else:
        metrics["utts_per_s"] = {"value": aligned / wall, "unit": "utts/s"}
        metrics["peak_mem_gib"] = {
            "value": (peak_bytes - hold_bytes) / 2**30, "unit": "GiB"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    dev = device_info(device)
    dev["memory_peak_bytes"] = peak_bytes
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if traced and ctx.trace is not None:
        out["device"]["busy_s"] = ctx.trace.busy_s
        out["device"]["window_s"] = ctx.trace.window_s
        out["breakdown"] = ctx.trace.breakdown()
    if control is not None:
        out["control"] = control
    out["checks"] = checks
    return out


def jax_loaded() -> List[str]:
    """Top-level names of JAX or the JAX package in ``sys.modules``,
    compared whole (the port's name only begins with the JAX package's)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(JAX_NAMES))
