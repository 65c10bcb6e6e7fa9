"""The port's kernel verification, reference-parity and CPU-baseline
programs (``scripts/verify_kernels_on_device.py``,
``parity_vs_reference.py``, ``measure_cpu_baseline.py``) on the CPU, and
the refusals every asset-day program owes.

- ``verify_kernels_on_device``: each of its six checks at tiny dims (the
  kernels' plain versions run on the CPU), a failing check's FAIL line and
  exit, and ``run``'s JSON payload;
- ``parity_vs_reference.compare`` on equal input, a word mismatch, an
  over-tolerance boundary and zero words (exit 2); ``run_ours`` on a
  two-utterance scp against the JAX script's ``run_ours`` on the same
  port-written assets;
- ``measure_cpu_baseline.baseline_utterance`` on a tiny ``WhisperConfig``;
- without ``WCA_PLATFORM=cpu`` and without a card every device program
  exits non-zero with nothing on stdout; a missing optional package
  (``transformers``, ``openai-whisper``) stops a program with exit 2 and a
  line naming it, before any work.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from whisper_char_alignment_tpu_torch.config import tiny_test_dims
from whisper_char_alignment_tpu_torch.data.synthetic import make_timit_corpus
from whisper_char_alignment_tpu_torch.ops import encoder_attn_cuda
from whisper_char_alignment_tpu_torch.scripts import (
    asset_gates, calibrate_kv_guard, measure_cpu_baseline,
    parity_vs_reference, rehearse_asset_day, verify_kernels_on_device)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "whisper_char_alignment_tpu_torch"
CPU = torch.device("cpu")

# tiny dims for the checks that build a model (2 and 6): 64-wide heads, as
# the kernels take
DIMS = tiny_test_dims(n_vocab=300, n_audio_ctx=64, n_text_ctx=48, state=64,
                      head=1, layers=2)


# ---------------------------------------------------------------------------
# verify_kernels_on_device
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bf16_model():
    return verify_kernels_on_device.bf16_model(DIMS, CPU)


@pytest.mark.parametrize("name", [n for n, _ in
                                  verify_kernels_on_device.CHECKS])
def test_verify_check_passes_on_the_plain_versions(name, bf16_model, capsys):
    fn = dict(verify_kernels_on_device.CHECKS)[name]
    fn(bf16_model, CPU, np.random.default_rng(0))
    lines = capsys.readouterr().out.splitlines()
    assert lines and all(l.startswith("PASS  ") for l in lines), lines


def test_verify_run_prints_every_check_then_its_payload(capsys):
    payload = verify_kernels_on_device.run(DIMS, CPU)
    out = capsys.readouterr().out.splitlines()
    # qkpost at two widths, the kernel and the mxu step on two softmaxes
    assert sum(l.startswith("PASS  ") for l in out) == 10
    assert out[-1] == "ALL KERNELS PASS ON DEVICE"
    assert payload["checks"] == 6 and payload["device"] == "cpu"
    assert set(payload["launches"]) >= {"encoder_attn", "qkpost",
                                        "dtw_trace", "dtw_backtrace", "mel",
                                        "mel_clip", "cross_attn_int8"}
    assert not any(payload["launches"].values())  # plain versions only
    json.dumps(payload)


def test_verify_failure_prints_fail_and_exits(capsys):
    with pytest.raises(SystemExit, match="on-device parity failure: x"):
        verify_kernels_on_device.check("x", False, "detail")
    assert capsys.readouterr().out.startswith("FAIL  x  detail")


# ---------------------------------------------------------------------------
# parity_vs_reference
# ---------------------------------------------------------------------------

REF = {"a": [("she", 0.0, 0.3), ("had", 0.3, 0.52)],
       "b": [("your", 0.1, 0.4)]}


@pytest.mark.parametrize("ours,rc,says", [
    (REF, 0, "within 20 ms: 3 (100.00%)"),
    ({**REF, "b": [("yours", 0.1, 0.4)]}, 1, "word mismatches: 1"),
    ({**REF, "a": [("she", 0.0, 0.3), ("had", 0.3, 0.55)]}, 1,
     "a: had off by 30 ms"),
    ({**REF, "a": [("She", 0.01, 0.3), ("HAD", 0.3, 0.51)]}, 0,
     "worst boundary delta: 10 ms"),
    ({"a": REF["a"]}, 1, "b: word count differs (0 vs 1)"),
])
def test_compare(ours, rc, says, capsys):
    assert parity_vs_reference.compare(ours, REF, 0.02) == rc
    assert says in capsys.readouterr().out


def test_compare_refuses_zero_words(capsys):
    assert parity_vs_reference.compare({}, {"a": []}, 0.02) == 2
    assert "no words were compared" in capsys.readouterr().err


def test_run_ours_matches_the_jax_scripts(tmp_path):
    """The port's ``run_ours`` and the JAX script's on the same
    port-written checkpoint and a two-utterance scp."""
    dims = rehearse_asset_day.rehearsal_dims(medium=False)
    assets = rehearse_asset_day.make_assets(
        str(tmp_path), dims, seed=rehearse_asset_day.SEED, formats=("pt",))
    scp = make_timit_corpus(str(tmp_path / "corpus"), n_utts=2,
                            seconds=(1.0, 2.0))
    args = argparse.Namespace(model="medium", checkpoint=assets["pt"],
                              tokenizer_dir=assets["tokenizer_dir"], scp=scp,
                              aligned_unit_type="char", topk=10,
                              medfilt_width=3)
    ours = parity_vs_reference.run_ours(args, "cpu")
    spec = importlib.util.spec_from_file_location(
        "jax_parity", os.path.join(REPO, "scripts", "parity_vs_reference.py"))
    jax_parity = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_parity)
    theirs = jax_parity.run_ours(args)
    assert sorted(ours) == ["dr1-utt0", "dr1-utt1"]
    assert ours == theirs


# ---------------------------------------------------------------------------
# measure_cpu_baseline
# ---------------------------------------------------------------------------

def test_baseline_utterance_on_a_tiny_config():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.WhisperConfig(
        vocab_size=300, num_mel_bins=80, d_model=64, encoder_layers=2,
        encoder_attention_heads=8, decoder_layers=2,
        decoder_attention_heads=8, encoder_ffn_dim=128, decoder_ffn_dim=128,
        max_source_positions=1500, max_target_positions=448, pad_token_id=0,
        bos_token_id=1, eos_token_id=0, decoder_start_token_id=1)
    cfg._attn_implementation = "eager"
    torch.manual_seed(0)
    model = transformers.WhisperForConditionalGeneration(cfg).eval()
    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.normal(0, 1, (1, 80, 3000)).astype(np.float32))
    ti, tj = measure_cpu_baseline.baseline_utterance(model, cfg, mel, rng,
                                                     decode_len=4)
    # the DTW path over the 92 text rows and 300 frames, start to end
    assert (ti[0], tj[0], ti[-1], tj[-1]) == (0, 0, 91, 299)
    assert np.all(np.diff(ti) >= 0) and np.all(np.diff(tj) >= 0)


# ---------------------------------------------------------------------------
# imports; the offline models on the card
# ---------------------------------------------------------------------------

PROGRAMS = ("asset_gates", "calibrate_kv_guard", "measure_cpu_baseline",
            "parity_vs_reference", "rehearse_asset_day",
            "verify_kernels_on_device")


def test_programs_import_neither_jax_nor_the_optional_packages():
    """Importing the six programs imports no JAX, nothing of the JAX
    package, and none of the optional packages (only the functions that
    build the twin, the baseline or the reference import those)."""
    code = (
        "import importlib, sys\n"
        f"for m in {PROGRAMS!r}:\n"
        f"    importlib.import_module('{PACKAGE}.scripts.' + m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax',\n"
        "       'whisper_char_alignment_tpu', 'transformers', 'safetensors',\n"
        "       'whisper')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr

@pytest.mark.parametrize("program", ["calibrate_kv_guard", "asset_gates",
                                     "rehearse_asset_day"])
def test_offline_models_fit_the_encoder_kernel(program):
    """The tiny models the programs build for their offline runs
    (``--test_model``, ``--rehearse``) run on the card too: their heads are
    a width the encoder kernel takes (the JAX scripts' are 8 wide)."""
    dims = {"calibrate_kv_guard": calibrate_kv_guard.tiny_dims(300),
            "asset_gates": asset_gates.rehearsal_dims(),
            "rehearse_asset_day": rehearse_asset_day.rehearsal_dims(False)
            }[program]
    for state, heads in ((dims.n_audio_state, dims.n_audio_head),
                         (dims.n_text_state, dims.n_text_head)):
        assert state // heads in encoder_attn_cuda._HEAD_DIMS


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

# program -> the argv that would run it on the card
DEVICE_PROGRAMS = {
    "calibrate_kv_guard": (calibrate_kv_guard.main, ["--test_model"]),
    "verify_kernels_on_device": (verify_kernels_on_device.main, None),
    "rehearse_asset_day": (rehearse_asset_day.main, []),
    "parity_vs_reference": (parity_vs_reference.main,
                            ["--scp", "x.scp", "--reference_repo", "ref"]),
    "asset_gates": (asset_gates.main, ["--rehearse"]),
}


@pytest.mark.parametrize("program", sorted(DEVICE_PROGRAMS))
def test_device_program_refuses_without_a_card(program, monkeypatch, capsys):
    for k in ("WCA_PLATFORM", "WCA_CHECKPOINT", "WCA_TOKENIZER_DIR"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(rehearse_asset_day, "make_assets", lambda *a, **k:
                        pytest.fail("assets were written without a device"))
    main, argv = DEVICE_PROGRAMS[program]
    with pytest.raises(SystemExit) as e:
        main() if argv is None else main(argv)
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("program", ["calibrate_kv_guard",
                                     "verify_kernels_on_device"])
def test_device_program_refuses_in_a_process(program):
    """``python -m`` without ``WCA_PLATFORM=cpu`` in a card-less process."""
    env = {k: v for k, v in os.environ.items() if k != "WCA_PLATFORM"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    argv = ["--test_model"] if program == "calibrate_kv_guard" else []
    r = subprocess.run([sys.executable, "-m", f"{PACKAGE}.scripts.{program}",
                        *argv], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
    assert "no CUDA device" in r.stderr


@pytest.mark.parametrize("program,module,package", [
    ("rehearse_asset_day", "transformers", "transformers"),
    ("rehearse_asset_day", "safetensors", "safetensors"),
    ("measure_cpu_baseline", "transformers", "transformers"),
    ("parity_vs_reference", "whisper", "openai-whisper"),
])
def test_missing_package_exits_2_naming_it(program, module, package,
                                           monkeypatch, capsys):
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None
                        if name == module else find_spec(name, *a))
    monkeypatch.setenv("WCA_PLATFORM", "cpu")
    mod = sys.modules[f"{PACKAGE}.scripts.{program}"]
    argv = DEVICE_PROGRAMS.get(program, (None, None))[1]
    with pytest.raises(SystemExit) as e:
        mod.main() if argv is None else mod.main(argv)
    assert e.value.code == 2
    out = capsys.readouterr()
    assert out.out == "" and f"'{package}' package" in out.err
    assert len(out.err.strip().splitlines()) == 1


def test_parity_without_openai_whisper_in_a_process():
    """This image has no openai-whisper: the program says so, exit 2."""
    if importlib.util.find_spec("whisper") is not None:
        pytest.skip("openai-whisper is installed here")
    r = subprocess.run([sys.executable, "-m",
                        f"{PACKAGE}.scripts.parity_vs_reference", "--scp",
                        "x.scp", "--reference_repo", "ref"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 2 and r.stdout == ""
    assert "'openai-whisper' package" in r.stderr
