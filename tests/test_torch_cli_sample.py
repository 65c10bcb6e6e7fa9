"""``infer_ali`` and ``eval_ali`` on the repository's ``sample/`` fixture:
the port against the JAX CLIs, on the CPU (``WCA_PLATFORM=cpu``).

The JAX CLI's ``--test_model`` weights are carried into the port. The
port's predictions pkl holds the JAX CLI's words and boundaries, for the
README recipe at median width 17 and for ``--default_whisper_timing``;
``eval_ali`` re-scores it as JAX ``eval_ali`` does, JAX's
``read_prediction_records`` reads it, and the port's ``eval_ali`` reads the
JAX CLI's joblib-format pkl through joblib, or names the package without
it."""

import glob
import os
import pickle
import sys

import joblib
import numpy as np
import pytest
import torch

from whisper_char_alignment_tpu.cli import eval_ali as jeval
from whisper_char_alignment_tpu.cli import infer_ali as jinfer
from whisper_char_alignment_tpu.config import tiny_test_dims
from whisper_char_alignment_tpu_torch.cli import common, eval_ali, infer_ali
from whisper_char_alignment_tpu_torch.text.tokenizer import get_test_tokenizer

from tests.test_torch_cli import carried_model

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUNS = {
    "recipe": ["--aggr", "topk", "--topk", "2", "--aligned_unit_type",
               "char", "--strict", "--medfilt_width", "17"],
    "default_timing": ["--model", "test", "--default_whisper_timing",
                       "--medfilt_width", "3"],
}


@pytest.fixture(scope="module", params=sorted(RUNS))
def runs(request, tmp_path_factory):
    """Both CLIs on sample/test.scp; (JAX pkl, port pkl, JAX metrics, port
    metrics)."""
    tmp = tmp_path_factory.mktemp(request.param)
    mp = pytest.MonkeyPatch()
    try:
        mp.chdir(REPO)  # the scp names sample/test.wav
        argv = ["--scp", "sample/test.scp", "--test_model", "--save_prediction",
                "--use_gt_transcript", "--decode_sample_len", "8",
                "--tolerance", "0.3"] + RUNS[request.param]
        want = jinfer.main(argv + ["--output_dir", str(tmp / "jax")])
        tok = get_test_tokenizer()
        dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=1500,
                              n_text_ctx=448, state=32, head=2, layers=2)
        _, model = carried_model(dims)
        mp.setenv("WCA_PLATFORM", "cpu")
        mp.setattr(common, "load_model_and_tokenizer",
                   lambda args, device=None: (model, tok))
        got = infer_ali.main(argv + ["--output_dir", str(tmp / "port")])
    finally:
        mp.undo()
    (jpkl,) = glob.glob(str(tmp / "jax" / "*-predictions.pkl"))
    (tpkl,) = glob.glob(str(tmp / "port" / "*-predictions.pkl"))
    return jpkl, tpkl, want, got


def test_infer_ali_on_sample_matches_jax(runs):
    jpkl, tpkl, want, got = runs
    assert got == want
    theirs = joblib.load(jpkl)
    with open(tpkl, "rb") as f:
        ours = pickle.load(f)
    assert sorted(ours) == sorted(theirs) == [0]
    a, b = ours[0], theirs[0]
    assert a["fids"] == b["fids"] == "dr0-sample-test"
    assert a["predwords"] == b["predwords"] and len(a["predwords"]) >= 2
    assert a["texts"] == b["texts"]
    np.testing.assert_array_equal(a["starts_hat"], b["starts_hat"])
    np.testing.assert_array_equal(a["ends_hat"], b["ends_hat"])
    np.testing.assert_array_equal(a["starts"], b["starts"])
    np.testing.assert_array_equal(a["ends"], b["ends"])


@pytest.mark.parametrize("tolerance", ["0.05", "0.3"])
def test_eval_ali_rescores_as_jax_does(runs, tolerance, capsys):
    jpkl, tpkl, _, _ = runs
    want = jeval.main(["--pred", jpkl, "--tolerance", tolerance])
    report = capsys.readouterr().out
    assert eval_ali.main(["--pred", tpkl, "--tolerance", tolerance]) == want
    assert capsys.readouterr().out == report
    # the JAX package reads the port's plain pickle, the port reads the JAX
    # CLI's joblib file
    theirs = jeval.read_prediction_records(tpkl)
    ours = eval_ali.read_prediction_records(tpkl)
    assert sorted(theirs) == sorted(ours) == ["DR0-SAMPLE-TEST"]
    for a, b in zip(ours.values(), theirs.values()):
        for field in ("fid", "gt_ends", "gt_words", "pred_ends",
                      "pred_words"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))
    assert eval_ali.main(["--pred", jpkl, "--tolerance", tolerance]) == want


def test_eval_ali_names_joblib_when_it_is_missing(runs, monkeypatch):
    jpkl, tpkl, _, _ = runs
    monkeypatch.setitem(sys.modules, "joblib", None)
    assert eval_ali.load_predictions(tpkl)  # a plain pickle needs no joblib
    with pytest.raises(RuntimeError, match="joblib package"):
        eval_ali.load_predictions(jpkl)
