"""The port's spans (``utils/profiling.StageTimers``), on the CPU, with
stub CUDA events and a fake clock where a device or a time is read:

- a span's parent is the innermost span open on its thread, and its self
  time is its host time less what its children cover; kinds are checked;
- counters: the deltas of ``ops/_lib.LAUNCHES`` and
  ``models/decode_graph.RECORD`` fall to the innermost open span, counts a
  span adds itself too, and nothing outside every span;
- a span on a second thread keeps host seconds only: no CUDA events, and
  no share of the launches the stream's thread makes meanwhile;
- ``totals`` keeps its keys and values for existing callers (device
  seconds of the top-level spans) and carries the snapshot in ``spans``;
  no span records an event while a CUDA graph is being captured;
- while a profiler runs, each span opens a ``wca.<name>`` range;
- ``run_dataset`` on a tiny model covers the main thread's pass with its
  spans, with the decode graph stubbed so its replays run: every span is
  there, and the decode steps needed never exceed the steps run;
- the four benchmark metrics that read the snapshot, and None on a plain
  mapping as the parent's ``totals`` gives;
- ``trace_busy`` charges an idle gap to the innermost ``wca.`` range of
  the main thread and keeps mirrored ranges out of busy time;
- on a card (marked ``gpu``): a ``host`` span's event pair reads the card's
  idle time.
"""

import importlib.util
import os
import threading
import time
import types

import pytest
import torch

from whisper_char_alignment_tpu_torch import runner
from whisper_char_alignment_tpu_torch.config import (AlignConfig,
                                                     tiny_test_dims)
from whisper_char_alignment_tpu_torch.data.dataset import TIMIT
from whisper_char_alignment_tpu_torch.data.synthetic import make_timit_corpus
from whisper_char_alignment_tpu_torch.models import decode_graph
from whisper_char_alignment_tpu_torch.models import decoding as tdec
from whisper_char_alignment_tpu_torch.models import whisper as tw
from whisper_char_alignment_tpu_torch.ops import _lib
from whisper_char_alignment_tpu_torch.text.tokenizer import get_test_tokenizer
from whisper_char_alignment_tpu_torch.utils import profiling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ("host_issue_ms_per_utt.corpus", "host_wait_ms_per_utt.corpus",
           "host_work_ms_per_utt.corpus", "host_idle_ms_per_utt.corpus")


class _Clock:
    """A host clock the test moves by hand."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t


class _StubEvent:
    """A CUDA event on a fake device clock (``_StubEvent.clock``)."""
    clock = 0.0
    made = 0

    def __init__(self, enable_timing=False):
        self.t = None
        _StubEvent.made += 1

    def record(self):
        self.t = _StubEvent.clock

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(profiling, "time", c)
    return c


@pytest.fixture
def stub_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _StubEvent)
    _StubEvent.clock, _StubEvent.made = 0.0, 0
    return profiling.StageTimers(torch.device("cuda"))


@pytest.fixture
def counters(monkeypatch):
    """The process's counters stay as they were: the test counts in
    copies."""
    monkeypatch.setattr(_lib, "LAUNCHES", dict(_lib.LAUNCHES))
    monkeypatch.setattr(decode_graph, "RECORD", dict(decode_graph.RECORD))


def test_span_parent_and_self_time_under_nesting(clock):
    timers = profiling.StageTimers(torch.device("cpu"))
    with timers.stage("outer", units=3, kind="issue") as outer:
        clock.t += 1.0
        with profiling.span("child", kind="wait"):
            clock.t += 2.0
            with profiling.span("grandchild", kind="host"):
                clock.t += 0.5
        clock.t += 0.25
        with timers.stage("child", kind="wait"):
            clock.t += 1.0
        assert profiling._open_frames()[-1] is outer
    assert not profiling._open_frames()
    spans = timers.totals.spans
    assert spans["outer"].host_s == pytest.approx(4.75)
    assert spans["outer"].self_s == pytest.approx(1.25)
    assert spans["child"].calls == 2
    assert spans["child"].host_s == pytest.approx(3.5)
    assert spans["child"].self_s == pytest.approx(3.0)
    assert spans["grandchild"].self_s == pytest.approx(0.5)
    assert [spans[n].kind for n in ("outer", "child", "grandchild")] == [
        "issue", "wait", "host"]
    # one thread: every self second is the stream thread's
    assert sum(s.main_s for s in spans.values()) == pytest.approx(4.75)
    assert spans["outer"].units == 3
    with profiling.span("alone"):  # no span open: nothing kept
        pass
    assert "alone" not in timers.totals.spans
    with pytest.raises(ValueError):
        with timers.stage("x", kind="compute"):
            pass


def test_counters_fall_to_the_innermost_span(counters):
    timers = profiling.StageTimers(torch.device("cpu"))
    _lib.count("dtw_trace")  # outside every span: nobody's
    with timers.stage("decode dispatch"):
        _lib.count("dec_attn")
        with profiling.span("decode replay"):
            _lib.add_launches({"dec_attn": 2, "rows_linear": 5})
            decode_graph.RECORD["replays"] += 1
            decode_graph.RECORD["steps"] += decode_graph.CHUNK_STEPS
        with profiling.span("decode flag wait", kind="wait"):
            profiling.count("host syncs")
        _lib.count("dec_attn")
    _lib.count("dtw_trace")
    with timers.stage("decode dispatch"):
        profiling.count("host syncs", 2)
    spans = timers.totals.spans
    assert spans["decode dispatch"].counters == {"launches dec_attn": 2,
                                                 "host syncs": 2}
    assert spans["decode replay"].counters == {
        "launches dec_attn": 2, "launches rows_linear": 5,
        "decode replays": 1, "decode steps run": decode_graph.CHUNK_STEPS}
    assert spans["decode flag wait"].counters == {"host syncs": 1}


def test_a_span_on_a_second_thread_keeps_host_seconds_only(stub_card,
                                                           counters):
    timers = stub_card
    opened, release, done = (threading.Event(), threading.Event(),
                             threading.Event())

    def prep():
        with timers.stage("wire prep", kind="host"):
            opened.set()
            release.wait(10)
        done.set()

    worker = threading.Thread(target=prep)
    with timers.stage("mel"):
        worker.start()
        assert opened.wait(10)
        _lib.count("mel")  # the stream's thread launches meanwhile
        _StubEvent.clock += 0.5
        release.set()
        worker.join(10)
    assert done.is_set() and not worker.is_alive()
    totals = timers.totals
    assert totals == {"mel": 0.5}  # the thread's span has no event pair
    spans = totals.spans
    assert spans["wire prep"].device_s is None
    assert spans["wire prep"].main_s == 0.0
    assert spans["wire prep"].host_s > 0
    assert spans["wire prep"].counters == {}
    assert spans["mel"].counters == {"launches mel": 1}
    assert _StubEvent.made == 2


def test_totals_keep_their_keys_and_values_for_existing_callers(stub_card):
    timers = stub_card
    with timers.stage("decode dispatch", units=8):
        _StubEvent.clock += 0.75
        with profiling.span("decode replay"):  # a child: no event pair
            _StubEvent.clock += 0.25
    with timers.stage("collect sync", units=8, kind="wait"):
        pass
    totals = timers.totals
    assert isinstance(totals, dict)
    assert totals == {"decode dispatch": 1.0, "collect sync": 0.0}
    assert {n: s.calls for n, s in totals.spans.items()} == {
        "decode dispatch": 1, "decode replay": 1, "collect sync": 1}
    assert set(totals.spans) == {"decode dispatch", "decode replay",
                                 "collect sync"}
    assert totals.spans["decode replay"].device_s is None
    assert set(timers.summary()) == {"decode dispatch", "collect sync"}
    assert timers.summary()["decode dispatch"]["units_per_s"] == 8.0
    # the snapshot is a copy: later spans do not change it
    with timers.stage("collect sync", kind="wait"):
        pass
    assert totals.spans["collect sync"].calls == 1
    assert timers.span_summary()["collect sync"]["calls"] == 2


def test_no_event_pair_while_a_graph_is_captured(stub_card, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with stub_card.stage("captured"):
        pass
    assert _StubEvent.made == 0
    assert stub_card.totals == {}
    assert stub_card.totals.spans["captured"].calls == 1


def test_spans_open_profiler_ranges_only_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile

    timers = profiling.StageTimers(torch.device("cpu"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timers.stage("capture", batch=3):
            with profiling.span("decode replay"):
                torch.ones(4).sum()
    names = [e.name for e in prof.events()]
    assert "wca.capture" in names and "wca.decode replay" in names
    with timers.stage("capture"):
        pass
    assert timers.totals.spans["capture"].calls == 2


# ---------------------------------------------------------------------------
# the pass on a tiny model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tok = get_test_tokenizer()
    dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=96, n_text_ctx=64,
                          state=16, head=2, layers=2)
    model = tw.init_params(tw.Whisper(dims), torch.Generator().manual_seed(0))
    scp = make_timit_corpus(str(tmp_path_factory.mktemp("corpus")), n_utts=7,
                            seconds=(0.4, 1.2), words_per_utt=(3, 5), seed=6)
    return tok, model, scp


class _StubFlag:
    """A done flag read at once (no card, no event)."""

    def __init__(self, done):
        self.value = bool(done)

    def read(self):
        return self.value


NEW_SPANS = {"batch read", "wire prep", "wire wait", "capture pack",
             "output copies", "word times", "loop", "decode prefill",
             "decode replay", "decode flag wait"}


def test_run_dataset_covers_the_pass_with_its_spans(tiny, monkeypatch,
                                                    counters):
    """The greedy decode replays its stubbed graph (the chunk run as a
    callable, the flag read at once), so the pass runs every span of the
    card's path."""
    tok, model, scp = tiny
    monkeypatch.setattr(tdec, "_loop_for", lambda dev: decode_graph._graphed)
    monkeypatch.setattr(decode_graph, "_warm_up", lambda fn: fn())
    monkeypatch.setattr(decode_graph, "_capture",
                        lambda fn: types.SimpleNamespace(replay=fn))
    monkeypatch.setattr(decode_graph, "_Flag", _StubFlag)
    pipe = runner.AlignmentPipeline(
        model, tok, AlignConfig.recommended(
            topk=2, batch_size=2, use_gt_transcript=True,
            decode_sample_len=6, pipeline_depth=2), device="cpu")
    t0 = time.perf_counter()
    got = list(pipe.run_dataset(TIMIT(scp), progress=False))
    wall = time.perf_counter() - t0
    assert len(got) == 7
    spans = pipe.timers.totals.spans
    assert NEW_SPANS | {"mel", "encoder", "decode dispatch",
                        "transcripts sync", "retokenize", "capture",
                        "align", "collect sync"} <= set(spans)
    assert spans["wire prep"].main_s == 0.0  # its own thread
    assert spans["loop"].kind == spans["word times"].kind == "host"
    assert spans["capture pack"].kind == "issue"
    assert spans["decode flag wait"].kind == "wait"
    # the main thread's spans cover its pass
    assert sum(s.main_s for s in spans.values()) >= 0.95 * wall
    needed = spans["transcripts sync"].counters["decode steps needed"]
    replay = spans["decode replay"].counters
    assert replay["decode replays"] == spans["decode replay"].calls
    assert 0 < needed <= replay["decode steps run"] == (
        replay["decode replays"] * decode_graph.CHUNK_STEPS)
    assert spans["decode flag wait"].counters["host syncs"] == (
        spans["decode flag wait"].calls)
    assert spans["encoder"].counters["encoder calls"] > 0
    # the batch index: one per dispatched batch, in the pass's order
    assert pipe._batches_dispatched == 4


# ---------------------------------------------------------------------------
# the benchmark's readers of the snapshot
# ---------------------------------------------------------------------------

def _metric(name):
    path = os.path.join(REPO, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "spans_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _snapshot():
    S = profiling.SpanStats
    spans = {
        "mel": S("issue", calls=2, host_s=0.25, self_s=0.25, main_s=0.25,
                 device_s=0.5),
        "decode dispatch": S("issue", calls=2, host_s=1.0, self_s=0.5,
                             main_s=0.5, device_s=3.0),
        "decode replay": S("issue", calls=8, host_s=0.25, self_s=0.25,
                           main_s=0.25),
        "decode flag wait": S("wait", calls=6, host_s=0.25, self_s=0.25,
                              main_s=0.25),
        "collect sync": S("wait", calls=2, host_s=0.5, self_s=0.5,
                          main_s=0.5, device_s=0.5),
        "retokenize": S("host", calls=2, host_s=0.75, self_s=0.75,
                        main_s=0.75, device_s=0.125),
        "loop": S("host", calls=3, host_s=0.25, self_s=0.25, main_s=0.25,
                  device_s=0.125),
        "wire prep": S("host", calls=2, host_s=4.0, self_s=4.0)}
    seconds = {n: s.device_s for n, s in spans.items()
               if s.device_s is not None}
    return profiling.SpanTotals(seconds, spans)


@pytest.mark.parametrize("name,want", [
    (METRICS[0], 1000 * 1.0 / 10), (METRICS[1], 1000 * 0.75 / 10),
    (METRICS[2], 1000 * 1.0 / 10), (METRICS[3], 1000 * 0.25 / 10)])
def test_span_metrics_read_the_snapshot(name, want):
    read = _metric(name)
    assert read(types.SimpleNamespace(stage_s=_snapshot(), utts=10)) == (
        pytest.approx(want))
    # the parent's totals: a plain mapping, nothing to read
    assert read(types.SimpleNamespace(stage_s={"encoder": 1.0},
                                      utts=10)) is None
    assert read(types.SimpleNamespace(stage_s=_snapshot(), utts=0)) is None


def test_idle_metric_is_none_off_a_card():
    snap = _snapshot()
    for s in snap.spans.values():
        s.device_s = None
    assert _metric(METRICS[3])(types.SimpleNamespace(
        stage_s=snap, utts=10)) is None


# ---------------------------------------------------------------------------
# the trace reader
# ---------------------------------------------------------------------------

def _event(name, start, end, device=False, thread=1, activity=None):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(
        name=name, thread=thread,
        time_range=types.SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        activity_type=activity or ("kernel" if device else "cpu_op"),
        is_user_annotation=name.startswith("wca."))


def test_trace_busy_charges_idle_to_the_innermost_span():
    events = [
        # the main thread: decode dispatch holds a flag wait; then loop
        _event("wca.decode dispatch", 0, 600),
        _event("wca.decode flag wait", 300, 500),
        _event("wca.loop", 600, 1000),
        # the wire-prep thread's range covers less: it is not the main one
        _event("wca.wire prep", 100, 900, thread=2),
        _event("aten::copy_", 650, 700),
        # device records: kernels 0-200 and 350-450, 900-950
        _event("kernel_a", 0, 200, device=True),
        _event("kernel_b", 350, 450, device=True),
        _event("kernel_c", 900, 950, device=True),
        # the decode dispatch range mirrored on the device: not busy
        _event("wca.decode dispatch", 0, 600, device=True,
               activity="gpu_user_annotation"),
    ]
    got = profiling.trace_busy(types.SimpleNamespace(events=lambda: events))
    assert got["records"] == 3
    assert got["busy_s"] == pytest.approx(350e-6)
    assert got["share"] == pytest.approx(0.35)
    idle = got["idle_by_span"]
    # gaps 200-350 (decode dispatch to 300, then the flag wait), 450-900
    # (flag wait to 500, dispatch to 600, loop), 950-1000 (loop)
    assert idle == pytest.approx({"decode dispatch": 200e-6,
                                  "decode flag wait": 100e-6,
                                  "loop": 350e-6})
    assert sum(idle.values()) == pytest.approx(got["window_s"]
                                               - got["busy_s"])


def test_trace_busy_charges_idle_outside_every_span_to_other():
    events = [_event("wca.mel", 100, 200), _event("kernel", 0, 50, True),
              _event("aten::add", 250, 400)]
    got = profiling.trace_busy(types.SimpleNamespace(events=lambda: events))
    assert got["idle_by_span"] == pytest.approx({"mel": 100e-6,
                                                 "other": 250e-6})


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_host_span_device_seconds_read_the_cards_idle_time():
    """A ``host`` span launches nothing: its event pair reads the idle time
    of the stream. Empty, all of a 20 ms sleep; behind a longer kernel,
    next to nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the events time the device")
    torch.cuda.synchronize()
    # the spin kernel's cycles a millisecond, on this card's clock
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    per_ms = 10_000_000 / start.elapsed_time(end)
    timers = profiling.StageTimers(torch.device("cuda"))
    with timers.stage("empty", kind="host"):
        time.sleep(0.02)
    torch.cuda._sleep(int(60 * per_ms))
    with timers.stage("behind a kernel", kind="host"):
        time.sleep(0.02)
    totals = timers.totals
    assert totals["empty"] == pytest.approx(0.02, abs=0.002)
    assert totals["behind a kernel"] < 0.002
