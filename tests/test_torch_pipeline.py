"""The port's slice as a whole against the JAX pipeline, on the CPU, plus the
port's package rules.

``api.test_model``-sized dims (state 32, 2 heads, 2 layers, n_audio_ctx
1500), JAX weights carried across, f32, the README recipe with the
ground-truth transcript, a 4-utterance synthetic corpus: the port's
``align_batch`` and ``run_dataset`` must give the same words and the same
boundaries as the JAX pipeline, for top-k and mean aggregation."""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from whisper_char_alignment_tpu import api as japi
from whisper_char_alignment_tpu import runner as jrunner
from whisper_char_alignment_tpu.config import AlignConfig as JaxAlignConfig
from whisper_char_alignment_tpu.data.dataset import TIMIT as JaxTIMIT
from whisper_char_alignment_tpu.data.synthetic import make_timit_corpus
from whisper_char_alignment_tpu_torch import api as tapi
from whisper_char_alignment_tpu_torch import runner as trunner
from whisper_char_alignment_tpu_torch.config import AlignConfig, ModelDims
from whisper_char_alignment_tpu_torch.data.dataset import TIMIT
from whisper_char_alignment_tpu_torch.models import convert as tconvert
from whisper_char_alignment_tpu_torch.ops import _lib
from whisper_char_alignment_tpu_torch.text.tokenizer import get_test_tokenizer
from whisper_char_alignment_tpu_torch.utils.device import resolve_device

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jm = japi.test_model(0)
    model = tconvert.model_from_state_dict(
        tconvert.params_from_jax(jax.tree.map(np.asarray, jm.params)),
        ModelDims(**dataclasses.asdict(jm.dims)), device="cpu")
    scp = make_timit_corpus(str(tmp_path_factory.mktemp("corpus")), n_utts=4,
                            seconds=(1.0, 2.0), words_per_utt=(3, 5), seed=0)
    return jm, model, scp


def _cfg(cls, aggr):
    return cls.recommended(model="test", batch_size=4, use_gt_transcript=True,
                           aggr=aggr, decode_sample_len=8)


def _same_alignments(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.fid == b.fid
        assert a.words == b.words and len(a.words) >= 2
        assert a.transcription == b.transcription
        np.testing.assert_array_equal(a.start_times, b.start_times)
        np.testing.assert_array_equal(a.end_times, b.end_times)


@pytest.mark.parametrize("aggr", ["topk", "mean"])
def test_slice_matches_jax_pipeline(setup, aggr):
    jm, model, scp = setup
    jp = jrunner.AlignmentPipeline(jm.params, jm.dims, jm.tokenizer,
                                   _cfg(JaxAlignConfig, aggr))
    tp = trunner.AlignmentPipeline(model, get_test_tokenizer(),
                                   _cfg(AlignConfig, aggr), device="cpu")
    before = _lib.launch_counts()
    _same_alignments(list(tp.run_dataset(TIMIT(scp))),
                     list(jp.run_dataset(JaxTIMIT(scp), progress=False)))
    batch = [TIMIT(scp)[i] for i in range(4)]
    ours = tp.align_batch(batch, return_matrix=True)
    theirs = jp.align_batch([JaxTIMIT(scp)[i] for i in range(4)],
                            return_matrix=True)
    _same_alignments(ours, theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.matrix, b.matrix, rtol=1e-5, atol=1e-6)
    assert _lib.launch_counts() == before  # the CPU path launches nothing
    assert set(tp.stage_seconds) >= {"mel", "encoder", "decode dispatch",
                                     "transcripts sync", "capture",
                                     "align"}
    # transcripts of the decode pass agree too
    assert tp.transcribe_batch(batch)[0] == jp.transcribe_batch(
        [JaxTIMIT(scp)[i] for i in range(4)])[0]


def test_api_align_matches_jax(setup):
    jm, model, scp = setup
    u = TIMIT(scp)[1]
    want = japi.align(jm, u.audio, gt_text=u.text, use_gt_transcript=True,
                      decode_sample_len=8)
    got = tapi.align(tapi.Model(model=model, tokenizer=get_test_tokenizer(),
                                name="test"),
                     u.audio, gt_text=u.text, use_gt_transcript=True,
                     decode_sample_len=8, device="cpu")
    _same_alignments([got], [want])


def test_test_model_is_seeded_and_refuses_a_missing_gpu(monkeypatch):
    a = tapi.test_model(0, device="cpu")
    b = tapi.test_model(0, device="cpu")
    assert a.dims.n_audio_ctx == 1500 and a.dims.n_text_state == 32
    assert torch.equal(a.model.decoder.token_embedding.weight,
                       b.model.decoder.token_embedding.weight)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.test_model(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.align(a, np.zeros(16000, np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("override", [
    dict(encoder_int8=True), dict(encoder_int8=True, decode_kv_int8=True),
    dict(data_parallel=2), dict(tensor_parallel=2), "mesh"])
def test_unported_pipeline_options_raise(setup, override):
    _, model, _ = setup
    kw = {}
    cfg = AlignConfig.recommended(model="test")
    if override == "mesh":
        kw["mesh"] = object()
    else:
        cfg = dataclasses.replace(cfg, **override)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trunner.AlignmentPipeline(model, get_test_tokenizer(), cfg,
                                  device="cpu", **kw)


def test_pack_fixed_batch_matches_jax():
    class U:
        pass

    utts = [U(), U(), U()]
    items = [(utts[2], [5, 6, 7], 900), (utts[0], [1, 2], 3000)]
    want = jrunner.pack_fixed_batch(items, utts, 4, 8, 99, 1500)
    got = trunner.pack_fixed_batch(items, utts, 4, 8, 99, 1500)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_wire_is_int16_for_pcm_sources(setup):
    _, _, scp = setup
    utts = [TIMIT(scp)[i] for i in range(2)]
    assert all(trunner._utt_wire_i16(u) is not None for u in utts)
    jutts = [JaxTIMIT(scp)[i] for i in range(2)]
    for a, b in zip(utts, jutts):
        np.testing.assert_array_equal(trunner._utt_wire_i16(a),
                                      jrunner._utt_wire_i16(b))
    odd = dataclasses.replace(utts[0], audio=utts[0].audio + 1e-7)
    assert trunner._utt_wire_i16(odd) is None


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = ["api", "runner", "transcribe", "align.metrics", "align.timing",
            "audio.mel", "audio.resample", "audio.wav", "cli.common",
            "cli.eval_ali", "cli.infer_ali", "cli.probe_oracle",
            "cli.serve", "cli.transcribe", "config", "constants",
            "data.dataset", "data.synthetic", "models.beam", "models.convert",
            "models.decode_graph", "models.decoding", "models.whisper",
            "ops.cross_attn_cuda", "ops.dtw", "ops.dtw_cuda",
            "ops.encoder_attn_cuda", "ops.medfilt", "ops.mel_cuda",
            "ops.qkpost_cuda", "ops._lib", "text.bpe", "text.numwords",
            "text.retokenize", "text.tokenizer", "utils.device",
            "utils.profiling", "utils.unported", "utils.writers", "viz.plot"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module('whisper_char_alignment_tpu_torch.' + m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'whisper_char_alignment_tpu'\n"
        "       or m.startswith('whisper_char_alignment_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout
    pkg = os.path.join(REPO, "whisper_char_alignment_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(root, f)).read()
                assert "import jax" not in src and "from jax" not in src, f
                assert "whisper_char_alignment_tpu." not in src.replace(
                    "whisper_char_alignment_tpu_torch", ""), f
    smoke = open(os.path.join(REPO, "chip_smoke.py")).read()
    assert "import jax" not in smoke and "from jax" not in smoke


def test_chip_smoke_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((REPO, os.path.join(REPO, "chip_smoke.py")),
                        (str(tmp_path), str(tmp_path / "chip_smoke.py"))):
        if cwd != REPO:
            shutil.copy(os.path.join(REPO, "chip_smoke.py"), script)
        out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("kernel,records,want_ms", [
    ("dtw_trace_kernel", {"dtw_trace_kernel<1, 32, 8>": (20, 100.0)}, 0.1),
    # a trace that lost 5 of 20 records still reads the kernel's own time
    ("dtw_trace_kernel", {"dtw_trace_kernel<1, 32, 8>": (15, 100.0)}, 0.1),
    # all device work of a call of two launches of one kernel and one of
    # another, 2 records lost; the runtime's host records carry no time
    ("", {"gemm": (38, 50.0), "softmax": (20, 10.0),
          "cudaLaunchKernel": (60, 0.0)}, 0.11),
    ("dtw_trace_kernel", {"cudaLaunchKernel": (20, 0.0)}, None),
])
def test_chip_smoke_device_ms_takes_the_mean_per_recorded_launch(
        monkeypatch, kernel, records, want_ms):
    """``chip_smoke.device_ms`` reads a profiler trace of 20 calls: each
    activity's mean per recorded launch times its launches per call, so a
    trace that dropped records does not read low."""
    import importlib.util
    import types

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    events = [types.SimpleNamespace(key=k, count=c,
                                    self_device_time_total=c * us)
              for k, (c, us) in records.items()]

    class FakeProfile:
        def __init__(self, **kw):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return events

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    calls = []
    got = smoke.device_ms(lambda: calls.append(1), kernel, iters=20,
                          warmup=3)
    assert len(calls) == 23
    if want_ms is None:
        assert got is None
    else:
        assert got == pytest.approx(want_ms)


# records per trace: (name, start us relative to the trace, duration us,
# count); a trace's kernel is "mel_clip_kernel", its bound 0.05 ms
_OWN = ("mel_clip_kernel(float*)", 10.0, 100.0)


@pytest.mark.parametrize("traces,want", [
    ([[_OWN + (20,)]], (0.1, "trace", 1)),
    # 7 of 20 records lost
    ([[_OWN + (13,)]], (0.1, "trace", 1)),
    # records of launches made before the trace (an L2-warm call's) and the
    # runtime's host records are not counted
    ([[_OWN + (20,), ("mel_clip_kernel(float*)", -400.0, 40.0, 20),
       ("cudaLaunchKernel", 10.0, 3.0, 20)]], (0.1, "trace", 1)),
    # a stray short record does not move the median
    ([[_OWN + (18,), ("mel_clip_kernel(float*)", 10.0, 40.0, 2)]],
     (0.1, "trace", 1)),
    # too few records, then too many: traced again, then a whole trace
    ([[_OWN + (9,)], [_OWN + (21,)], [_OWN + (20,)]], (0.1, "trace", 3)),
    # three traces with too few records: CUDA events of the whole call
    ([[_OWN + (3,)]] * 3, (0.7, "events", 3)),
    # a median below the bound is traced again
    ([[("mel_clip_kernel(float*)", 10.0, 40.0, 20)], [_OWN + (20,)]],
     (0.1, "trace", 2)),
    # and fails the run when no trace reads at or above it
    ([[("mel_clip_kernel(float*)", 10.0, 40.0, 20)]] * 2 + [[_OWN + (3,)]],
     (None, None, 3)),
])
def test_chip_smoke_kernel_ms_takes_the_median_of_the_traces_own_launches(
        monkeypatch, traces, want):
    """``chip_smoke.kernel_ms`` times a kernel that each call launches once
    by the median of its launches' own records in a trace of 20 calls, so a
    trace that lost records, or handed back records of launches made before
    it, reads neither low nor high; a trace that holds too few or too many
    records is taken again."""
    import importlib.util
    import types

    from torch.autograd import DeviceType

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    taken = []

    class FakeProfile:
        def __init__(self, **kw):
            self.records = traces[len(taken)]
            taken.append(1)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return [types.SimpleNamespace(
                name=name, time_range=types.SimpleNamespace(
                    start=start, end=start + us),
                device_type=(DeviceType.CPU if name.startswith("cuda")
                             else DeviceType.CUDA))
                for name, start, us, n in self.records for _ in range(n)]

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(smoke, "cuda_ms", lambda fn: 0.7)
    want_ms, want_method, want_traces = want
    if want_ms is None:
        with pytest.raises(AssertionError, match="below its bound"):
            smoke.kernel_ms(lambda: None, "mel_clip_kernel", 0.05)
    else:
        ms, method = smoke.kernel_ms(lambda: None, "mel_clip_kernel", 0.05)
        assert (ms, method) == (pytest.approx(want_ms), want_method)
    assert len(taken) == want_traces


@pytest.mark.parametrize("traces,want", [
    ([0.1], (0.1, "trace", 1)),
    # an empty trace, then a usable one
    ([None, 0.1], (0.1, "trace", 2)),
    # two traces below the bound (they missed some of the call's kernels)
    ([0.02, 0.03, 0.1], (0.1, "trace", 3)),
    # no usable trace in three: CUDA events of the whole call
    ([None, 0.02, None], (0.7, "events", 3)),
])
def test_chip_smoke_library_ms_retakes_unusable_traces(monkeypatch, traces,
                                                        want):
    """``chip_smoke.library_ms`` times a library yardstick (SDPA, the
    ``torch.stft`` frontend) by its traced device time, as ``kernel_ms``
    times a kernel: a trace that holds no device time or reads below the
    bound is taken again, up to three times, before CUDA events of the
    whole call stand in; the method says which gave the figure."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    taken = []

    def fake_device_ms(fn):
        taken.append(1)
        return traces[len(taken) - 1]

    monkeypatch.setattr(smoke, "device_ms", fake_device_ms)
    monkeypatch.setattr(smoke, "cuda_ms", lambda fn: 0.7)
    want_ms, want_method, want_traces = want
    ms, method = smoke.library_ms(lambda: None, 0.05)
    assert (ms, method) == (pytest.approx(want_ms), want_method)
    assert len(taken) == want_traces
