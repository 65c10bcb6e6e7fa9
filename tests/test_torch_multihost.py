"""``--multihost`` sweeps of the port's CLIs on the CPU, as JAX
tests/test_multihost.py holds the JAX CLIs: a world of gloo processes,
meeting at a ``file://`` rendezvous in the test's own ``tmp_path``, must
reproduce the single-process metrics exactly.

Each mesh replica aligns its round-robin shard of the scp; the counters are
all-reduced; rank 0 writes the metrics JSON, each replica's first rank its
``-pN`` predictions pkl. Per-utterance results do not depend on the batch or
its sharding, so the sums equal a single process's.

- two processes, one replica each (``infer_ali --save_prediction``): the
  metrics, and the two shards' pkls cover the corpus;
- ``probe_oracle`` over two processes, with the whole corpus as the
  ``hit_rate`` denominator;
- two replicas of a (2 data x 2 model) mesh, eight processes: marked
  ``slow`` like its JAX counterpart (eight interpreters and their eager
  tensor-parallel decodes take about a minute on a loaded host)."""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest

from tests.test_probe_and_plot import make_long_corpus
from whisper_char_alignment_tpu.data.synthetic import make_timit_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _infer_argv(scp, out_dir, extra=()):
    return [sys.executable, "-m", "whisper_char_alignment_tpu_torch.cli."
            "infer_ali", "--dataset", "TIMIT", "--scp", scp, "--output_dir",
            out_dir, "--aggr", "topk", "--topk", "3", "--aligned_unit_type",
            "char", "--strict", "--tolerance", "0.05", "--medfilt_width", "3",
            "--batch_size", "2", "--test_model", *extra]


def _probe_argv(scp, out_dir, extra=()):
    return [sys.executable, "-m", "whisper_char_alignment_tpu_torch.cli."
            "probe_oracle", "--dataset", "TIMIT", "--scp", scp, "--output_dir",
            out_dir, "--aligned_unit_type", "char", "--strict", "--tolerance",
            "0.05", "--medfilt_width", "3", "--hit_within", "2",
            "--test_model", *extra]


def _env():
    return dict(os.environ, WCA_PLATFORM="cpu", OMP_NUM_THREADS="1",
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))


def _metrics(out_dir, keys=("precision", "recall", "f1", "r_value")):
    jsons = [f for f in os.listdir(out_dir) if f.endswith(".json")]
    assert len(jsons) == 1, jsons
    with open(os.path.join(out_dir, jsons[0])) as f:
        blob = json.load(f)
    return {k: blob[k] for k in keys}


def _single(argv_fn, scp, tmp_path):
    out = str(tmp_path / "single")
    r = subprocess.run(argv_fn(scp, out), env=_env(), cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return out


def _world(argv_fn, scp, tmp_path, n, extra=()):
    out = str(tmp_path / "multi")
    init = Path(tmp_path, "rendezvous").as_uri()
    procs = [subprocess.Popen(
        argv_fn(scp, out, ["--multihost", "--coordinator_address", init,
                           "--num_processes", str(n), "--process_id",
                           str(pid), *extra]),
        env=_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(n)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return out


@pytest.fixture
def corpus(tmp_path):
    return make_timit_corpus(str(tmp_path / "corpus"), n_utts=6,
                             seconds=(0.8, 1.4), words_per_utt=(3, 5), seed=0)


def test_two_process_sweep_matches_single_process(corpus, tmp_path):
    single = _single(_infer_argv, corpus, tmp_path)
    multi = _world(_infer_argv, corpus, tmp_path, 2, ["--save_prediction"])
    assert _metrics(multi) == _metrics(single)
    shards = sorted(f for f in os.listdir(multi) if f.endswith(".pkl"))
    assert [s[-7:] for s in shards] == ["-p0.pkl", "-p1.pkl"], shards
    fids = []
    for f in shards:
        with open(os.path.join(multi, f), "rb") as fh:
            fids += [r["fids"] for r in pickle.load(fh).values()]
    assert len(fids) == len(set(fids)) == 6


def test_two_process_probe_oracle_matches_single_process(tmp_path):
    scp = make_long_corpus(str(tmp_path / "corpus"), n_utts=4)
    keys = ("precision", "recall", "f1", "r_value", "hit_rate")
    single = _single(_probe_argv, scp, tmp_path)
    multi = _world(_probe_argv, scp, tmp_path, 2)
    assert _metrics(multi, keys) == _metrics(single, keys)


@pytest.mark.slow
def test_two_replicas_of_a_data_tensor_mesh_match_single_process(corpus,
                                                                 tmp_path):
    single = _single(_infer_argv, corpus, tmp_path)
    multi = _world(_infer_argv, corpus, tmp_path, 8,
                   ["--data_parallel", "2", "--tensor_parallel", "2"])
    assert _metrics(multi) == _metrics(single)
