"""The port's software pipeline on the CPU, against the JAX package.

- ``run_dataset`` at ``pipeline_depth`` 1, 2, 3 and 10 (more than the
  batches there are) gives identical words and boundaries in identical
  order, equal to the JAX pipeline at depth 2 (JAX
  tests/test_pipeline_e2e.py:166-195);
- ``probe_oracle`` at depths 1 and 3 gives the JAX probe's results;
- the cross-K/V reuse budget (``WCA_REUSE_KV_MAX_BYTES``) is divided among
  ``pipeline_depth + 1`` live stacks, as in JAX runner.py:390-405;
- ``align_batch`` and ``transcribe_batch`` stay synchronous.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from tests.test_probe_and_plot import make_long_corpus
from tests.test_torch_cli import carried_model, results_json
from whisper_char_alignment_tpu import runner as jrunner
from whisper_char_alignment_tpu.config import AlignConfig as JaxAlignConfig
from whisper_char_alignment_tpu.config import tiny_test_dims
from whisper_char_alignment_tpu.data.dataset import TIMIT as JaxTIMIT
from whisper_char_alignment_tpu.data.synthetic import make_timit_corpus
from whisper_char_alignment_tpu.models import whisper as jw
from whisper_char_alignment_tpu.text.tokenizer import \
    get_test_tokenizer as jax_tokenizer
from whisper_char_alignment_tpu_torch import runner as trunner
from whisper_char_alignment_tpu_torch.cli import common, probe_oracle
from whisper_char_alignment_tpu_torch.config import AlignConfig, ModelDims
from whisper_char_alignment_tpu_torch.data.dataset import TIMIT
from whisper_char_alignment_tpu_torch.models import convert as tconvert
from whisper_char_alignment_tpu_torch.models import decoding as tdec
from whisper_char_alignment_tpu_torch.text.tokenizer import get_test_tokenizer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX tests/test_pipeline_e2e.py's depth fixture: 7 utterances in
    batches of 2 (4 batches), tiny dims, JAX weights carried across."""
    scp = make_timit_corpus(str(tmp_path_factory.mktemp("corpus")), n_utts=7,
                            seconds=(0.4, 1.2), words_per_utt=(3, 5), seed=6)
    tok = jax_tokenizer()
    dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=96, n_text_ctx=64,
                          state=16, head=2, layers=2)
    params = jw.init_params(jax.random.PRNGKey(7), dims)
    model = tconvert.model_from_state_dict(
        tconvert.params_from_jax(jax.tree.map(np.asarray, params)),
        ModelDims(**dataclasses.asdict(dims)), device="cpu")
    return scp, dims, params, model


def _kw(depth):
    return dict(topk=2, batch_size=2, use_gt_transcript=True,
                decode_sample_len=6, pipeline_depth=depth)


def _port_pipe(setup, depth, **over):
    _, _, _, model = setup
    return trunner.AlignmentPipeline(
        model, get_test_tokenizer(),
        AlignConfig.recommended(**_kw(depth), **over), device="cpu")


def _same(a, b):
    assert [r.fid for r in a] == [r.fid for r in b]
    for x, y in zip(a, b):
        assert x.words == y.words and x.transcription == y.transcription
        np.testing.assert_array_equal(x.start_times, y.start_times)
        np.testing.assert_array_equal(x.end_times, y.end_times)


@pytest.fixture(scope="module")
def jax_depth2(setup):
    scp, dims, params, _ = setup
    pipe = jrunner.AlignmentPipeline(params, dims, jax_tokenizer(),
                                     JaxAlignConfig.recommended(**_kw(2)))
    return list(pipe.run_dataset(JaxTIMIT(scp), progress=False))


@pytest.mark.parametrize("depth", [1, 2, 3, 10])
def test_run_dataset_at_any_depth_equals_jax(setup, jax_depth2, depth):
    scp = setup[0]
    ds = TIMIT(scp)
    got = list(_port_pipe(setup, depth).run_dataset(ds, progress=False))
    assert [r.fid for r in got] == [ds[i].fid for i in range(len(ds))]
    assert all(len(r.words) >= 2 for r in got)
    _same(got, jax_depth2)
    base = list(_port_pipe(setup, 1).run_dataset(ds, progress=False))
    _same(got, base)


def test_run_dataset_keeps_depth_batches_in_flight(setup, monkeypatch):
    """At depth 2 the third batch's decode is dispatched before the first
    batch's transcripts are read; at depth 1 before the second's."""
    scp = setup[0]
    for depth, first_sync in ((1, 2), (2, 3)):
        pipe = _port_pipe(setup, depth)
        events = []
        dispatch, align = pipe._dispatch_transcribe, pipe._dispatch_align
        monkeypatch.setattr(pipe, "_dispatch_transcribe", lambda b, wire=None:
                            events.append("t") or dispatch(b, wire=wire))
        monkeypatch.setattr(pipe, "_dispatch_align", lambda tp, **kw:
                            events.append("a") or align(tp, **kw))
        assert len(list(pipe.run_dataset(TIMIT(scp), progress=False))) == 7
        assert events.index("a") == first_sync, (depth, events)
        assert events.count("t") == events.count("a") == 4
        assert {"wire wait", "transcripts sync", "collect sync"} <= set(
            pipe.stage_seconds)


def test_reuse_budget_is_divided_among_live_stacks(setup, monkeypatch):
    scp, dims, _, _ = setup
    batch = [TIMIT(scp)[i] for i in range(2)]
    stack = trunner._cross_kv_bytes(dims, 2, torch.float32)
    for depth in (1, 2, 3):
        monkeypatch.setenv("WCA_REUSE_KV_MAX_BYTES", str(stack * (depth + 1)))
        assert _port_pipe(setup, depth)._dispatch_transcribe(
            batch)["cross_kv"] is not None
        monkeypatch.setenv("WCA_REUSE_KV_MAX_BYTES",
                           str(stack * (depth + 1) - 1))
        assert _port_pipe(setup, depth)._dispatch_transcribe(
            batch)["cross_kv"] is None


def test_synchronous_wrappers(setup):
    scp = setup[0]
    pipe = _port_pipe(setup, 2)
    batch = [TIMIT(scp)[i] for i in range(2)]
    tp = pipe._dispatch_transcribe(batch)
    assert isinstance(tp["future"], tdec.DecodeFuture)
    texts, mel, xa = pipe.transcribe_batch(batch)
    assert texts == [r.text for r in tp["future"].result()[:2]]
    assert mel.shape[0] == xa.shape[0] == 2
    one = pipe.align_batch(batch)
    _same(one, list(pipe.run_dataset(TIMIT(scp), progress=False))[:2])


@pytest.fixture(scope="module")
def jax_probe(tmp_path_factory):
    """Five long utterances in batches of 2 (three batches) and the JAX
    probe's results JSON on them. The JAX CLI runs in its own process: a
    second JAX probe run in a process that has run the port can abort it
    without a message."""
    root = tmp_path_factory.mktemp("probe")
    scp = make_long_corpus(str(root), n_utts=5)
    argv = ["--dataset", "TIMIT", "--scp", scp, "--aligned_unit_type",
            "char", "--strict", "--tolerance", "0.05", "--medfilt_width", "3",
            "--hit_within", "2", "--test_model", "--batch_size", "2",
            "--use_gt_transcript", "--decode_sample_len", "4"]
    subprocess.run([sys.executable, "-m",
                    "whisper_char_alignment_tpu.cli.probe_oracle", *argv,
                    "--output_dir", str(root / "jax")], check=True,
                   cwd=REPO, capture_output=True, timeout=600)
    return argv, results_json(str(root / "jax"))


@pytest.mark.parametrize("depth", [1, 3])
def test_probe_at_any_depth_equals_jax(jax_probe, tmp_path, monkeypatch,
                                       depth):
    """Three batches: the lookahead holds batches in flight at depth 3 and
    none at depth 1; the results are the JAX probe's either way."""
    argv, want = jax_probe
    tok = get_test_tokenizer()
    dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=1500,
                          n_text_ctx=448, state=32, head=2, layers=2)
    _, model = carried_model(dims)
    monkeypatch.setenv("WCA_PLATFORM", "cpu")
    monkeypatch.setattr(common, "load_model_and_tokenizer",
                        lambda args, device=None: (model, tok))
    config_from_args = common.config_from_args
    monkeypatch.setattr(common, "config_from_args", lambda args: dataclasses.
                        replace(config_from_args(args), pipeline_depth=depth))
    dispatched = []
    dispatch = trunner.AlignmentPipeline._dispatch_transcribe
    monkeypatch.setattr(trunner.AlignmentPipeline, "_dispatch_transcribe",
                        lambda self, utts, wire=None: dispatched.append(
                            len(utts)) or dispatch(self, utts, wire=wire))
    got = probe_oracle.main(argv + ["--output_dir", str(tmp_path / "port")])
    assert dispatched == [2, 2, 1]
    assert results_json(str(tmp_path / "port")) == want
    assert got == {k: want[k] for k in got}
