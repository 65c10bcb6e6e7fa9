"""The port's asset-day runbook (``scripts/asset_gates.py``) on the CPU.

- ``_parse_metrics``: the cases of the JAX suite's parser test
  (``tests/test_bench_smoke.py``), and the port's real CLI output
  (``cli.infer_ali``'s results dict, ``cli.eval_ali``'s two-decimal block);
- the refusal without ``WCA_CHECKPOINT`` / ``WCA_TOKENIZER_DIR``: a clear
  message, no traceback;
- ``--rehearse --only 2,2b,5`` with ``WCA_PLATFORM=cpu``: exit 0, a metrics
  dict for each gate, every child command a module of the port, the other
  gates skipped loudly; the whole rehearsal with gate 1 (the HF twin) is
  ``slow``, as the JAX suite's is.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

from whisper_char_alignment_tpu_torch.cli import eval_ali, infer_ali
from whisper_char_alignment_tpu_torch.scripts import asset_gates

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "whisper_char_alignment_tpu_torch"


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("WCA_CHECKPOINT", "WCA_TOKENIZER_DIR")}
    env.update(OMP_NUM_THREADS="1", **extra)
    return env


def _runbook(args, env, timeout=600):
    return subprocess.run([sys.executable, "-m", f"{PACKAGE}.scripts."
                           "asset_gates", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_metrics_parser_takes_the_dict_line():
    out = ("Namespace(model='medium')\nsome log line\n"
           "{'precision': 0.91, 'recall': 0.88, 'f1': 0.895, "
           "'r_value': np.float64(0.9012), 'hit_rate': 1.0}\n")
    assert asset_gates._parse_metrics(out) == {
        "precision": 0.91, "recall": 0.88, "f1": 0.895, "r_value": 0.9012,
        "hit_rate": 1.0}
    assert asset_gates._parse_metrics("no metrics here\n") is None
    # a trailing chatter line that mentions hit_rate (with parseable pairs)
    # must not shadow the real dict line above it
    noisy = out + "note: 'hit_rate': 0.0 computed over the full corpus\n"
    assert asset_gates._parse_metrics(noisy)["hit_rate"] == 1.0


def test_metrics_parser_reads_the_port_clis(tmp_path, monkeypatch):
    """``infer_ali``'s printed results dict and ``eval_ali``'s report, as
    the CLIs print them."""
    monkeypatch.setenv("WCA_PLATFORM", "cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results = infer_ali.main(
            ["--scp", os.path.join(REPO, "sample", "test.scp"),
             "--test_model", "--model", "test", "--output_dir",
             str(tmp_path), "--save_prediction"])
    got = asset_gates._parse_metrics(out.getvalue())
    assert got == pytest.approx({k: float(v) for k, v in results.items()})
    (pkl,) = [f for f in os.listdir(tmp_path) if f.endswith(".pkl")]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        metrics = eval_ali.main(["--pred", str(tmp_path / pkl),
                                 "--tolerance", "0.1"])
    got = asset_gates._parse_metrics(out.getvalue())
    assert set(got) == {"precision", "recall", "f1", "r_value"}
    assert got == pytest.approx({k: round(float(v), 2)
                                 for k, v in metrics.items()})


@pytest.mark.parametrize("missing", ["WCA_CHECKPOINT", "WCA_TOKENIZER_DIR"])
def test_runbook_refuses_without_assets(missing, tmp_path):
    env = _env()
    if missing == "WCA_TOKENIZER_DIR":
        env["WCA_CHECKPOINT"] = str(tmp_path / "medium.pt")
    r = _runbook([], env, timeout=120)
    assert r.returncode != 0
    assert f"{missing} is not set" in r.stderr
    assert "Traceback" not in r.stderr and r.stdout == ""


def _held_rehearsal(tmp_path, only, gates, timeout=600):
    artifact = tmp_path / "scoreboard.json"
    args = ["--rehearse", "--rehearse_dir", str(tmp_path / "work"),
            "--rehearse_utts", "4", "--artifact", str(artifact)]
    r = _runbook(args + (["--only", only] if only else []),
                 _env(WCA_PLATFORM="cpu"), timeout=timeout)
    assert r.returncode == 0, (r.stdout[-4000:], r.stderr[-4000:])
    board = json.loads(artifact.read_text())
    assert board["rehearse"] is True and board["failures"] == 0
    for gate in gates:
        assert board[gate]["rc"] == 0, (gate, board)
    commands = [l[2:] for l in r.stdout.splitlines() if l.startswith("$ ")]
    assert commands and all(f" -m {PACKAGE}." in c for c in commands), \
        commands
    return board


def test_rehearsal_subset(tmp_path):
    gates = ("2 TIMIT F1@50ms (recommended recipe)",
             "2b eval_ali re-score of gate 2's pkl at 0.1s",
             "5 probe_oracle sweep")
    board = _held_rehearsal(tmp_path, "2,2b,5", gates)
    for gate in gates:
        assert board[gate].get("metrics"), (gate, board)
    assert "hit_rate" in board["5 probe_oracle sweep"]["metrics"]
    # the un-run gates were skipped loudly, not dropped
    for n in ("1 ", "3 ", "4 ", "6 ", "7 "):
        assert any(s.startswith(n) for s in board["skipped"]), board


@pytest.mark.slow
def test_whole_rehearsal_with_the_twin(tmp_path):
    """Every gate of the rehearsal, gate 1 the HF twin's parity run."""
    pytest.importorskip("transformers")
    gates = ("1 golden-style parity rehearsal (HF twin, real-format assets)",
             "2 TIMIT F1@50ms (recommended recipe)",
             "2b eval_ali re-score of gate 2's pkl at 0.1s",
             "3 TIMIT subword/mean recipe", "4 LibriSpeech vs Kaldi alignments",
             "5 probe_oracle sweep", "6 default whisper timing baseline")
    board = _held_rehearsal(tmp_path, None, gates, timeout=1500)
    for gate in gates[1:]:
        assert board[gate].get("metrics"), (gate, board)
    assert [s for s in board["skipped"]] == [
        "7 reference parity (rehearsal: gate 1's HF twin carries the 20 ms "
        "bound offline)"]
