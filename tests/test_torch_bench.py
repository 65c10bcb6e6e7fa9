"""The port's benchmark programs (``whisper_char_alignment_tpu_torch.bench``
and ``scripts/{bench_serve,bench_transcribe_longform,measure_latency,
bench_probe}``) on the CPU, against the JAX package's root ``bench.py``.

- the one-line contract: each program at tiny dims with ``WCA_PLATFORM=cpu``
  prints exactly one JSON line, with its JAX script's keys and ``device``,
  ``launches`` and ``graph_captures_timed`` (the keys ``chip_smoke.py``
  holds on the card), its logs on stderr;
- no fallback: without ``WCA_PLATFORM=cpu`` and without a card each exits
  non-zero and prints nothing on stdout;
- parity: ``run_passes`` on a tiny model whose JAX weights are carried
  across gives JAX ``AlignmentPipeline.run_dataset``'s words and
  boundaries; the MFU roll-up's FLOPs equal JAX ``utils/flops`` on the same
  shape telemetry; ``check_alignments`` accepts and rejects what JAX
  ``bench.check_alignments`` does; the knobs' defaults are the JAX
  script's;
- ``guard_margins`` restores the environment; the serve bench's p50/p95
  against ``numpy.percentile``.
"""

import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax

from whisper_char_alignment_tpu import runner as jrunner
from whisper_char_alignment_tpu.config import AlignConfig as JaxAlignConfig
from whisper_char_alignment_tpu.config import tiny_test_dims
from whisper_char_alignment_tpu.data.dataset import TIMIT as JaxTIMIT
from whisper_char_alignment_tpu.data.synthetic import make_timit_corpus
from whisper_char_alignment_tpu.models import decoding as jdec
from whisper_char_alignment_tpu.models import whisper as jw
from whisper_char_alignment_tpu.text.tokenizer import \
    get_test_tokenizer as jax_tokenizer
from whisper_char_alignment_tpu.utils import flops as jflops
from whisper_char_alignment_tpu_torch import bench
from whisper_char_alignment_tpu_torch.config import ModelDims
from whisper_char_alignment_tpu_torch.data.dataset import TIMIT
from whisper_char_alignment_tpu_torch.models import convert as tconvert
from whisper_char_alignment_tpu_torch.models import decoding as tdec
from whisper_char_alignment_tpu_torch.runner import AlignmentPipeline
from whisper_char_alignment_tpu_torch.scripts import bench_serve
from whisper_char_alignment_tpu_torch.text.tokenizer import get_test_tokenizer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# program -> the environment of its tiny CPU run
PROGRAMS = {
    "bench": {"WCA_BENCH_TINY": "1", "WCA_BENCH_UTTS": "8",
              "WCA_BENCH_PASSES": "1"},
    "bench_serve": {"WCA_SERVE_BENCH_TINY": "1", "WCA_SERVE_BENCH_REQS": "4"},
    "bench_transcribe_longform": {"WCA_XFER_TINY": "1",
                                  "SECONDS_AUDIO": "2", "ITERS": "1"},
    "measure_latency": {"LAT_TINY": "1", "LAT_ITERS": "2"},
    "bench_probe": {"WCA_PROBE_TINY": "1", "WCA_PROBE_PASSES": "1"},
}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    """``chip_smoke.py``, whose ``BENCH_KEYS`` are the programs' keys."""
    return _load("chip_smoke_keys", os.path.join(REPO, "chip_smoke.py"))


@pytest.fixture(scope="module")
def jax_bench():
    """The JAX package's root ``bench.py``, loaded as the JAX bench tests
    load it, with its knobs at their defaults."""
    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith("WCA_BENCH_")}
    try:
        return _load("jax_root_bench", os.path.join(REPO, "bench.py"))
    finally:
        os.environ.update(saved)


def _module(program):
    prefix = "" if program == "bench" else "scripts."
    return f"whisper_char_alignment_tpu_torch.{prefix}{program}"


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_program_prints_one_json_line(program, smoke):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("WCA_", "LAT_"))}
    env.update(PROGRAMS[program], WCA_PLATFORM="cpu", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", _module(program)], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [l for l in r.stdout.splitlines() if l.strip()]
    assert len(lines) == 1, r.stdout
    payload = json.loads(lines[0])
    assert smoke.BENCH_KEYS[program] | smoke.BENCH_COMMON_KEYS <= set(payload)
    assert payload["value"] > 0 and payload["device"] == "cpu"
    # nothing launches on the CPU; the counts are there, by kernel
    assert payload["launches"] and not any(payload["launches"].values())
    assert payload["graph_captures_timed"] == 0
    assert r.stderr.strip()  # the logs went to stderr


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_program_refuses_without_a_card(program, monkeypatch, capsys):
    """No ``WCA_PLATFORM=cpu`` and no card: a non-zero exit naming the
    missing card, before any model is built, and no line on stdout."""
    for k in list(os.environ):
        if k.startswith(("WCA_", "LAT_")):
            monkeypatch.delenv(k)
    for k, v in PROGRAMS[program].items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(_module(program))
    monkeypatch.setattr(mod, "build_model", lambda *a: pytest.fail(
        "a model was built without a device"))
    with pytest.raises(SystemExit) as e:
        mod.main()
    assert e.value.code not in (0, None)
    assert "no CUDA device" in str(e.value.code)
    assert capsys.readouterr().out == ""


def test_settings_defaults_are_the_jax_scripts(jax_bench, monkeypatch):
    for k in list(os.environ):
        if k.startswith("WCA_BENCH_"):
            monkeypatch.delenv(k)
    s = bench.Settings.from_env()
    assert (s.n_utts, s.batch, s.decode_len, s.bucket, s.bucket_guarded,
            s.sweep, s.sweep_passes, s.sweep_lens, s.sweep_bucket) == (
        jax_bench.N_UTTS, jax_bench.BATCH, jax_bench.DECODE_LEN,
        jax_bench.BUCKET, jax_bench.BUCKET_GUARDED, jax_bench.SWEEP,
        jax_bench.SWEEP_PASSES, jax_bench.SWEEP_LENS, jax_bench.SWEEP_BUCKET)
    assert s.passes == 3 and s.baseline is None  # vs_baseline: null
    cfg = bench.make_cfg("medium", s)
    jcfg = jax_bench.make_cfg("medium")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def test_run_passes_equals_the_jax_pipeline(tmp_path):
    """The bench's measured passes on the port give JAX ``run_dataset``'s
    words and boundaries (float32, tiny dims, JAX weights carried across,
    the bench's recipe at batch 2 with duration sorting)."""
    scp = make_timit_corpus(str(tmp_path), n_utts=5, seconds=(0.4, 1.2),
                            words_per_utt=(3, 5), seed=3)
    tok = jax_tokenizer()
    dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=96,
                          n_text_ctx=64, state=16, head=2, layers=2)
    params = jw.init_params(jax.random.PRNGKey(5), dims)
    model = tconvert.model_from_state_dict(
        tconvert.params_from_jax(jax.tree.map(np.asarray, params)),
        ModelDims(**dataclasses.asdict(dims)), device="cpu")
    s = bench.Settings(batch=2, decode_len=6)
    cfg = bench.make_cfg("tiny-test", s)
    cfg.topk = 2
    pipe = AlignmentPipeline(model, get_test_tokenizer(), cfg, device="cpu")
    pipe.options = tdec.DecodingOptions(language="en", sample_len=6)
    got = bench.run_passes(pipe, TIMIT(scp), 1.2, 2)
    assert got.n_aligned == 5 and got.graph_captures_timed == 0
    assert not any(got.launches.values())

    jpipe = jrunner.AlignmentPipeline(
        params, dims, tok, JaxAlignConfig(**dataclasses.asdict(cfg)))
    jpipe.options = jdec.DecodingOptions(language="en", sample_len=6)
    want = list(jpipe.run_dataset(JaxTIMIT(scp), progress=False))
    assert [r.fid for r in got.results] == [r.fid for r in want]
    for x, y in zip(got.results, want):
        assert x.words == y.words and len(x.words) >= 2
        np.testing.assert_array_equal(x.start_times, y.start_times)
        np.testing.assert_array_equal(x.end_times, y.end_times)
    assert bench.check_alignments(got.results, 1.2) == 5


TELEMETRY = types.SimpleNamespace(
    # (b_pad, n_live, kv_frames) per decode, (t_bucket, b_pad, n_live,
    # reused_kv) per capture, as the runners record them
    decode_shapes=[(16, 16, None), (16, 11, None), (16, 16, 384)],
    capture_shapes=[(64, 16, 16, True), (96, 16, 11, False),
                    (64, 16, 16, False)],
    options=types.SimpleNamespace(sample_len=None))


@pytest.mark.parametrize("size", ["medium", "tiny"])
def test_mfu_rollup_flops_equal_jax(size, jax_bench, monkeypatch):
    from whisper_char_alignment_tpu.config import MODEL_DIMS as JAX_DIMS
    from whisper_char_alignment_tpu_torch.config import MODEL_DIMS

    dims, jdims = MODEL_DIMS[size], JAX_DIMS[size]
    tok = get_test_tokenizer()
    total, n_utts = bench.stage_flops(TELEMETRY, dims, tok, 32)
    prompt = len(tok.sot_sequence)
    want = {"mel": 0, "encoder": 0, "decode": 0, "capture": 0}
    for b_pad, _, frames in TELEMETRY.decode_shapes:
        want["mel"] += jflops.mel_flops(jdims) * b_pad
        want["encoder"] += jflops.encoder_flops(jdims) * b_pad
        want["decode"] += jflops.decode_flops(
            jdims, prompt_len=prompt, steps=32, kv_frames=frames) * b_pad
    for t, b_pad, _, reused in TELEMETRY.capture_shapes:
        want["capture"] += jflops.capture_flops(
            jdims, t_tokens=t, reuse_cross_kv=reused) * b_pad
    assert n_utts == 43
    assert total == want and all(isinstance(v, int) for v in total.values())
    # the whole roll-up, as JAX bench.py computes it on the CPU (no peak)
    monkeypatch.setattr(jax_bench, "DECODE_LEN", 32)
    assert bench.mfu_rollup(TELEMETRY, dims, tok, 12.5, 32,
                            torch.device("cpu")) == jax_bench.mfu_rollup(
        TELEMETRY, jdims, jax_tokenizer(), 12.5, n_utts)


def _alignment(starts, ends, words=None, skipped=False, fid="u"):
    n = len(ends)
    return types.SimpleNamespace(
        fid=fid, skipped=skipped, start_times=np.asarray(starts, float),
        end_times=np.asarray(ends, float),
        words=words if words is not None else [f"w{i}" for i in range(n + 1)])


CHECK_CASES = {
    "good": [_alignment([0.0, 0.5, 1.0], [0.5, 1.0, 1.9])],
    "good with a skip": [_alignment([], [], skipped=True),
                         _alignment([0.1, 0.2], [0.2, 0.3])],
    "nothing live": [_alignment([], [], skipped=True)],
    "word count": [_alignment([0.0, 0.5], [0.5, 1.0], words=["a", "b"])],
    "start after end": [_alignment([0.0, 0.9], [0.9, 0.8])],
    "gap between words": [_alignment([0.0, 0.6], [0.5, 1.0])],
    "past the audio": [_alignment([0.0, 1.0], [1.0, 2.5])],
    "before zero": [_alignment([-0.1, 0.4], [0.4, 1.0])],
    "ends decrease": [_alignment([0.0, 1.2, 1.0], [1.2, 1.0, 1.5])],
}


@pytest.mark.parametrize("case", sorted(CHECK_CASES))
def test_check_alignments_agrees_with_jax(case, jax_bench):
    planted = CHECK_CASES[case]

    def outcome(fn):
        try:
            return fn(planted, 2.0)
        except AssertionError:
            return "rejected"

    got = outcome(bench.check_alignments)
    assert got == outcome(jax_bench.check_alignments)
    assert (got == "rejected") == (not case.startswith("good"))


def test_guard_margins_restores_the_environment(monkeypatch):
    monkeypatch.setenv("WCA_KV_INT8_GUARD_MARGIN", "1.5")
    monkeypatch.delenv("WCA_BUCKET_GUARD_MARGIN", raising=False)
    with bench.guard_margins("inf"):
        assert tdec.default_guard_margin() == float("inf")
        assert tdec.default_bucket_guard_margin() == float("inf")
    assert os.environ["WCA_KV_INT8_GUARD_MARGIN"] == "1.5"
    assert "WCA_BUCKET_GUARD_MARGIN" not in os.environ
    with pytest.raises(RuntimeError):
        with bench.guard_margins("0"):
            raise RuntimeError("a failed measurement")
    assert os.environ["WCA_KV_INT8_GUARD_MARGIN"] == "1.5"
    assert "WCA_BUCKET_GUARD_MARGIN" not in os.environ


@pytest.mark.parametrize("n", [1, 2, 7, 32])
def test_serve_latency_percentiles_match_numpy(n):
    lat = np.random.default_rng(n).gamma(2.0, 0.1, n)
    out = bench_serve.latency_summary(list(lat))
    assert out["samples"] == n
    assert out["p50_ms"] == round(float(np.percentile(lat * 1e3, 50)), 1)
    assert out["p95_ms"] == round(float(np.percentile(lat * 1e3, 95)), 1)


def test_port_modules_import_nothing_of_jax():
    """The programs' sources (the benchmark and profiling programs) name
    neither JAX nor the JAX package."""
    pkg = os.path.join(REPO, "whisper_char_alignment_tpu_torch")
    profiles = ("decode_step", "guarded_decode", "beam_decode", "prefill",
                "speculative", "encoder", "kernels", "probe_dtw", "pipeline",
                "e2e_overheads")
    for rel in ("bench.py", "scripts/__init__.py", "scripts/bench_serve.py",
                "scripts/bench_transcribe_longform.py",
                "scripts/measure_latency.py", "scripts/bench_probe.py",
                "scripts/_profile.py",
                *(f"scripts/profile_{p}.py" for p in profiles)):
        src = open(os.path.join(pkg, rel)).read()
        assert "import jax" not in src and "from jax" not in src, rel
        assert "whisper_char_alignment_tpu." not in src.replace(
            "whisper_char_alignment_tpu_torch.", ""), rel



def test_cast_params_keeps_a_model_on_the_current_card(monkeypatch):
    """``cuda`` without an index is the current card: a model whose tensors
    are on ``cuda:0`` in the wanted dtype is returned as it is, so
    ``api.align``'s pipeline shares its decode graphs and measure_latency's
    timed calls capture none (``tests/test_torch_cuda.py`` holds the same
    on a card)."""
    from whisper_char_alignment_tpu_torch.models import whisper as tw

    on_card = types.SimpleNamespace(dtype=torch.bfloat16,
                                    device=torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert tw.cast_params(on_card, torch.bfloat16, "cuda") is on_card
    assert tw.cast_params(on_card, torch.bfloat16, None) is on_card
