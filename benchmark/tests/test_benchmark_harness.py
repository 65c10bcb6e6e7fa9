"""The harness on the CPU at a tiny size: one cell added from new files
alone, run end to end; the result line; the fixed work; the window's rate;
the imports; and the faults that ``correct`` has to catch."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import corpus, harness, judge

from conftest import REPO, TINY_TRAFFIC, make_root

SEED = 2**31 + 12345  # more than 32 signed bits hold
WORKLOAD = "tiny.timit_b4"


def _run(root, seed=SEED, seconds=0.0, traced=False, side="program"):
    return harness.run(root, WORKLOAD, seed, seconds, traced, device="cpu",
                       side=side)


def test_a_cell_from_new_files_runs_one_pass(tiny_root):
    out = _run(tiny_root)
    assert out["correct"], out["checks"]
    assert out["attempted"] == TINY_TRAFFIC["utterances"]
    assert out["failed"] == 0
    assert set(out["metrics"]) == {"utts_per_s", "peak_mem_gib", "setup_s"}
    assert all(m["value"] > 0 for k, m in out["metrics"].items()
               if k != "peak_mem_gib")


def test_result_line_keys_and_checks_last(tiny_root):
    out = _run(tiny_root)
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert set(judge.NAMES) <= set(out["checks"])
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(out["device"])
    json.dumps(out)  # one JSON line


def test_traced_run_reports_the_per_layer_metrics_it_can_read(tiny_root):
    out = _run(tiny_root, traced=True)
    # on the CPU no trace of the card: only the program's spans and counts
    assert "utts_per_s" not in out["metrics"]
    assert "encoder_ms_per_utt.corpus" in out["metrics"]
    assert "dec_attn_roofline.corpus" not in out["metrics"]
    assert out["correct"]


def test_run_without_a_card_exits_nonzero_and_prints_nothing(tmp_path):
    root = make_root(tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", WORKLOAD,
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root,
        env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout == ""


def test_two_seeds_give_the_same_sorted_shapes(tmp_path):
    traffic = json.load(open(os.path.join(REPO, "benchmark", "traffic",
                                          "timit_b32.json")))
    traffic = dict(traffic, utterances=40)
    sets = []
    for seed in (3, SEED):
        items = corpus.write(traffic, str(tmp_path / str(seed)), seed)
        sets.append(([(it.n_samples, len(it.text)) for it in items],
                     [it.text for it in items]))
    (a, ta), (b, tb) = sets
    assert sorted(a) == sorted(b) == sorted(corpus.shapes(traffic))
    assert a != b and ta != tb  # the seed permutes and draws the letters


def test_sorted_batches_have_the_same_shapes_across_seeds(tmp_path):
    from whisper_char_alignment_tpu_torch.data import dataset as pdata

    traffic = json.load(open(os.path.join(REPO, "benchmark", "traffic",
                                          "libri_b16.json")))
    traffic = dict(traffic, utterances=48)
    batches = []
    for seed in (5, SEED):
        root = str(tmp_path / str(seed))
        corpus.write(traffic, root, seed)
        ds = pdata.LibriSpeech(corpus.scp_path(root),
                               alignment_file=corpus.alignment_path(root))
        seen = [[(u.duration, len(u.text)) for u in b] for b in
                pdata.batch_iter(ds, traffic["batch_size"], prefetch=0,
                                 order=pdata.duration_order(ds))]
        batches.append(seen)
    assert batches[0] == batches[1]
    assert len(batches[0]) == 3


def test_the_rate_counts_every_pass_over_all_their_time():
    ticks = iter(range(100))
    ran = []
    passes, wall = harness.window(ran.append, 2.5,
                                  clock=lambda: float(next(ticks)))
    # passes end at 1, 2, 3: the third crosses 2.5 and finishes
    assert ran == [0, 1, 2] and passes == 3
    assert wall == 4.0  # the last clock read, from the window's start


def test_whole_passes_in_the_window(tiny_root):
    out = _run(tiny_root, seconds=0.5)
    n = TINY_TRAFFIC["utterances"]
    assert out["attempted"] % n == 0 and out["attempted"] >= n
    assert out["correct"]


def test_jax_is_named_by_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "whisper_char_alignment_tpu_torch_x",
                        object())
    assert "whisper_char_alignment_tpu" not in harness.jax_loaded()
    monkeypatch.setitem(sys.modules, "whisper_char_alignment_tpu.fake",
                        object())
    assert "whisper_char_alignment_tpu" in harness.jax_loaded()


def test_a_run_loads_no_jax(tmp_path):
    root = make_root(tmp_path)
    code = ("import sys; from benchmark import harness; "
            f"harness.run({root!r}, {WORKLOAD!r}, 7, 0.0, False, "
            "device='cpu'); print(harness.jax_loaded())")
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("name", ["reference/whisper.py", "judge.py",
                                  "costs.py", "corpus.py", "weights.py",
                                  "trace.py"])
def test_the_yardstick_imports_nothing_of_the_port_or_jax(name):
    tops = set(_imports(os.path.join(REPO, "benchmark", name)))
    assert not tops & {"whisper_char_alignment_tpu_torch",
                       "whisper_char_alignment_tpu", "jax", "jaxlib",
                       "flax"}


def test_importing_the_reference_loads_nothing_of_the_port():
    code = ("import sys; import benchmark.judge, benchmark.costs; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'whisper_char_alignment_tpu_torch', "
            "'whisper_char_alignment_tpu', 'jax'}))")
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.stdout.strip() == "[]", p.stderr[-2000:]


# -- faults the check has to catch ----------------------------------------------

def _plant(monkeypatch, fault):
    from whisper_char_alignment_tpu_torch import runner
    from whisper_char_alignment_tpu_torch.audio import mel
    from whisper_char_alignment_tpu_torch.align import timing
    from whisper_char_alignment_tpu_torch.models import decoding, whisper

    if fault == "decode step leaves its state unchanged":
        def step(model, st, cross_kv, spec):
            st.i.add_(1)  # the loop moves on; tokens and scores do not
        monkeypatch.setattr(decoding, "loop_step_", step)
    elif fault == "encoder layer returns its input":
        monkeypatch.setattr(whisper, "_encoder_self_attention",
                            lambda attn, x, n_valid, linear=None:
                            torch.zeros_like(x))
    elif fault == "half of each batch left out":
        orig = runner.AlignmentPipeline._collect_align

        def half(self, ap):
            out = orig(self, ap)
            return out[:len(out) // 2]
        monkeypatch.setattr(runner.AlignmentPipeline, "_collect_align", half)
    elif fault == "a served token altered":
        orig_trim = decoding.trim

        def trim(seq, sample_begin, eot):
            out = orig_trim(seq, sample_begin, eot)
            return [out[0] + 1] + out[1:] if out else out
        monkeypatch.setattr(decoding, "trim", trim)
    elif fault == "a word boundary altered":
        orig_times = timing.jump_frames_to_times

        def times(jf, wb):
            jf = np.array(jf, copy=True)
            jf[wb[1]] = jf[wb[-1]]  # the first word ends at the last
            return orig_times(jf, wb)
        monkeypatch.setattr(runner.timing, "jump_frames_to_times", times)
    elif fault == "the log-mel altered":
        orig_mel = mel.wire_to_mel
        monkeypatch.setattr(runner, "wire_to_mel",
                            lambda *a, **k: orig_mel(*a, **k) + 0.01)
    else:
        raise AssertionError(fault)


@pytest.mark.parametrize("fault", [
    "decode step leaves its state unchanged",
    "encoder layer returns its input",
    "half of each batch left out",
    "a served token altered",
    "a word boundary altered",
    "the log-mel altered"])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault):
    assert _run(tiny_root)["correct"]
    _plant(monkeypatch, fault)
    out = _run(tiny_root)
    assert not out["correct"], (fault, out["checks"])
