"""``probe_oracle`` in the port, on the CPU (``WCA_PLATFORM=cpu``).

It finds a planted oracle head (tests/test_planted_accuracy.py:118-225, the
capture replaced by the banded stand-in in torch): hit_rate 1.0 and F1 1;
it keeps the reference's top-360 cut; and its results JSON equals the JAX
CLI's on a small random fixture with the JAX ``--test_model`` weights
carried across."""

import os

import pytest
import torch

from tests.test_planted_accuracy import _make_planted_corpus
from tests.test_probe_and_plot import make_long_corpus
from tests.test_torch_cli import banded_attentions, carried_model, results_json
from whisper_char_alignment_tpu.cli import probe_oracle as jprobe
from whisper_char_alignment_tpu.config import tiny_test_dims
from whisper_char_alignment_tpu.text.tokenizer import \
    get_test_tokenizer as jax_test_tokenizer
from whisper_char_alignment_tpu_torch.align import timing as ttiming
from whisper_char_alignment_tpu_torch.cli import common, probe_oracle
from whisper_char_alignment_tpu_torch.text.tokenizer import get_test_tokenizer

torch.set_num_threads(1)

BASE = ("she had your dark suit in greasy wash water all year and then "
        "some more words to pass the filter")  # 19 words


def _planted(tmp_path, monkeypatch, texts, fake):
    tok = get_test_tokenizer()
    scp, _ = _make_planted_corpus(str(tmp_path), texts, jax_test_tokenizer(),
                                  len(tok.sot_sequence))
    dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=256,
                          n_text_ctx=160, state=16, head=2, layers=2)
    _, model = carried_model(dims)
    monkeypatch.setenv("WCA_PLATFORM", "cpu")
    monkeypatch.setattr(common, "load_model_and_tokenizer",
                        lambda args, device=None: (model, tok))
    monkeypatch.setattr(ttiming, "get_attentions", fake)
    return ["--dataset", "TIMIT", "--scp", scp,
            "--output_dir", str(tmp_path / "results"),
            "--aligned_unit_type", "char", "--strict", "--tolerance", "0.05",
            "--medfilt_width", "3", "--hit_within", "2", "--batch_size", "3",
            "--use_gt_transcript", "--decode_sample_len", "2", "--test_model"]


def test_probe_finds_the_planted_oracle_head(tmp_path, monkeypatch):
    """One banded head (layer 1, head 1) among all-zero heads: it is the
    oracle (F1 1) and the top saliency, so hit_rate is 1.0 at hit_within 2
    (the reference's strict '>' misses at 1)."""
    sot_len = len(get_test_tokenizer().sot_sequence)
    argv = _planted(tmp_path, monkeypatch,
                    [BASE, BASE + " now", BASE + " again"],
                    banded_attentions(sot_len, star=(1, 1)))
    results = probe_oracle.main(argv)
    assert results["f1"] > 0.9999, results
    assert results["hit_rate"] == 1.0, results
    assert os.listdir(tmp_path / "results")


def test_probe_keeps_the_top_360_cut(tmp_path, monkeypatch):
    """The perfect banded head has the lowest saliency (the others are
    all-ones maps): with the cut at all 4 heads the probe finds it, with the
    cut at 3 it is excluded and F1 collapses."""
    sot_len = len(get_test_tokenizer().sot_sequence)
    argv = _planted(tmp_path, monkeypatch, [BASE],
                    banded_attentions(sot_len, star=(0, 0),
                                      ones_elsewhere=True))
    argv[argv.index("--batch_size") + 1] = "1"
    assert probe_oracle.ORACLE_TOPK == 360
    monkeypatch.setattr(probe_oracle, "ORACLE_TOPK", 4)
    all_heads = probe_oracle.main(argv)
    assert all_heads["f1"] > 0.9999 and all_heads["hit_rate"] == 0.0
    monkeypatch.setattr(probe_oracle, "ORACLE_TOPK", 3)
    assert probe_oracle.main(argv)["f1"] < 0.6


def test_probe_results_match_jax(tmp_path, monkeypatch):
    scp = make_long_corpus(str(tmp_path))
    argv = ["--dataset", "TIMIT", "--scp", scp, "--aligned_unit_type", "char",
            "--strict", "--tolerance", "0.05", "--medfilt_width", "3",
            "--hit_within", "2", "--test_model", "--batch_size", "2",
            "--use_gt_transcript", "--decode_sample_len", "4"]
    want = jprobe.main(argv + ["--output_dir", str(tmp_path / "jax")])
    tok = get_test_tokenizer()
    dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=1500,
                          n_text_ctx=448, state=32, head=2, layers=2)
    _, model = carried_model(dims)
    monkeypatch.setenv("WCA_PLATFORM", "cpu")
    monkeypatch.setattr(common, "load_model_and_tokenizer",
                        lambda args, device=None: (model, tok))
    got = probe_oracle.main(argv + ["--output_dir", str(tmp_path / "port")])
    assert set(got) == {"precision", "recall", "f1", "r_value", "hit_rate"}
    assert got == want
    assert results_json(str(tmp_path / "port")) == \
        results_json(str(tmp_path / "jax"))
