"""The port's command-line surface against the JAX package's, on the CPU
(``WCA_PLATFORM=cpu``).

- ``infer_ali`` on the planted-accuracy fixture (tests/test_planted_accuracy
  .py): the capture replaced by the banded stand-in, written in torch; F1 >
  0.9999 and the results JSON equal to the JAX CLI's; ``--plot`` writes one
  figure an utterance.
- the probe's per-head DTW sweep: layer chunks and the frame slice equal the
  single full-width launch, and JAX's sweep.
- the flags the port once refused (``--encoder_int8``, ``--multihost``,
  ``--data_parallel``/``--tensor_parallel`` 2) against the JAX CLIs with the
  same flags; the platform switch, the stage timers and the trace."""

import glob
import json
import os
import pickle

import joblib
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_planted_accuracy import (W, _fake_get_attentions,
                                         _make_planted_corpus)
from whisper_char_alignment_tpu.align import timing as jtiming
from whisper_char_alignment_tpu.cli import common as jcommon
from whisper_char_alignment_tpu.cli import infer_ali as jinfer
from whisper_char_alignment_tpu.cli import probe_oracle as jprobe
from whisper_char_alignment_tpu.config import tiny_test_dims
from whisper_char_alignment_tpu.models import convert as jconvert
from whisper_char_alignment_tpu.models import whisper as jwhisper
from whisper_char_alignment_tpu.text.tokenizer import \
    get_test_tokenizer as jax_test_tokenizer
from whisper_char_alignment_tpu_torch.align import timing as ttiming
from whisper_char_alignment_tpu_torch.cli import common, infer_ali, probe_oracle
from whisper_char_alignment_tpu_torch.config import ModelDims
from whisper_char_alignment_tpu_torch.models import convert as tconvert
from whisper_char_alignment_tpu_torch.text.tokenizer import get_test_tokenizer
from whisper_char_alignment_tpu_torch.utils import profiling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def banded_attentions(sot_len: int, star=None, ones_elsewhere=False):
    """The planted capture in torch: text token i hot on frames [i*W,
    (i+1)*W) of every head, or of head ``star`` alone (the others zero, or
    all-ones maps with ``ones_elsewhere``)."""

    def fake(model, mel, tokens, token_len, frame_len, **kw):
        dims = model.dims
        b, t = tokens.shape
        f = dims.n_audio_ctx
        row = torch.arange(t)[None, :, None] - sot_len
        col = torch.arange(f)[None, None, :]
        band = (col >= row * W) & (col < (row + 1) * W)
        token_ok = ((torch.arange(t)[None, :, None]
                     < (token_len.cpu()[:, None, None] - 1)) & (row >= 0))
        frame_ok = col < frame_len.cpu()[:, None, None]
        banded = (band & token_ok & frame_ok).float()  # (B, T, F)
        shape = (dims.n_text_layer, b, dims.n_text_head, t, f)
        if star is None:
            return banded[None, :, None].expand(shape).clone(), None
        base = ((token_ok & frame_ok).float() if ones_elsewhere
                else torch.zeros((b, t, f)))
        attn = base[None, :, None].expand(shape).clone()
        attn[star[0], :, star[1]] = banded
        return attn, None

    return fake


def carried_model(dims, seed=0):
    """JAX random weights at ``dims`` and the same weights in the port."""
    params = jwhisper.init_params(jax.random.PRNGKey(seed), dims)
    model = tconvert.model_from_state_dict(
        tconvert.params_from_jax(jax.tree.map(np.asarray, params)),
        ModelDims(**{k: getattr(dims, k)
                     for k in ModelDims.__dataclass_fields__}),
        device="cpu")
    return params, model


def results_json(out_dir):
    (path,) = glob.glob(os.path.join(out_dir, "*.json"))
    with open(path) as f:
        out = json.load(f)
    out.pop("output_dir")
    return out


PLANTED_TEXTS = ["she had your dark suit", "greasy wash water all year",
                 "artificial intelligence is for real"]


@pytest.mark.parametrize("aggr,topk", [("mean", -1), ("topk", 2)])
def test_infer_ali_planted_attention_matches_jax(tmp_path, monkeypatch, aggr,
                                                 topk):
    tok = get_test_tokenizer()
    sot_len = len(tok.sot_sequence)
    scp, _ = _make_planted_corpus(str(tmp_path), PLANTED_TEXTS,
                                  jax_test_tokenizer(), sot_len)
    # dims of this test alone: the JAX CLI's jitted align step traces the
    # planted capture afresh
    dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=103,
                          n_text_ctx=96, state=16, head=2, layers=2)
    params, model = carried_model(dims)
    argv = ["--dataset", "TIMIT", "--scp", scp, "--aggr", aggr, "--topk",
            str(topk), "--aligned_unit_type", "char", "--strict",
            "--tolerance", "0.05", "--medfilt_width", "3", "--batch_size",
            "3", "--use_gt_transcript", "--decode_sample_len", "2",
            "--test_model"]
    monkeypatch.setattr(jcommon, "load_model_and_tokenizer",
                        lambda args: (params, dims, jax_test_tokenizer()))
    monkeypatch.setattr(jtiming, "get_attentions",
                        _fake_get_attentions(sot_len))
    want = jinfer.main(argv + ["--output_dir", str(tmp_path / "jax")])

    monkeypatch.setenv("WCA_PLATFORM", "cpu")
    monkeypatch.setattr(common, "load_model_and_tokenizer",
                        lambda args, device=None: (model, tok))
    monkeypatch.setattr(ttiming, "get_attentions", banded_attentions(sot_len))
    extra = ["--plot"] if aggr == "topk" else []
    got = infer_ali.main(argv + extra + ["--output_dir",
                                         str(tmp_path / "port")])
    assert got["f1"] > 0.9999 and got["precision"] > 0.9999, got
    assert got == want
    theirs = results_json(str(tmp_path / "jax"))
    ours = results_json(str(tmp_path / "port"))
    if extra:
        assert ours.pop("plot") and not theirs.pop("plot")
        figs = os.listdir(tmp_path / "port" / "imgs" / "TIMIT")
        assert sorted(figs) == [f"dr1-p{i}.png" for i in range(3)]
    assert ours == theirs


@pytest.mark.parametrize("chunk,frame_slice", [("0", 0), ("2", 0), ("0", 24),
                                               ("2", 24)])
def test_per_head_dtw_sweep_matches_jax(monkeypatch, chunk, frame_slice):
    """Layer chunks (3 layers, chunk 2: a remainder group) and the frame
    slice are launch shapes only: with frames >= frame_len zero, as the
    capture gives them, every (utterance, head) row equals the single
    full-width launch and JAX's sweep."""
    rng = np.random.default_rng(3)
    l, b, h, t, f = 3, 3, 2, 10, 48
    attn = rng.random((l, b, h, t, f)).astype(np.float32)
    fl = np.array([17, 9, 23], np.int32)
    attn *= np.arange(f)[None, None, None, None, :] < fl[None, :, None, None,
                                                         None]
    tl = np.array([t, t - 2, t - 1], np.int32)
    monkeypatch.delenv("WCA_PROBE_LAYER_CHUNK", raising=False)
    want = np.asarray(jprobe._per_head_jump_frames(
        jnp.asarray(attn), jnp.asarray(tl), jnp.asarray(fl), 3))
    monkeypatch.setenv("WCA_PROBE_LAYER_CHUNK", chunk)
    got = probe_oracle._per_head_jump_frames(
        torch.from_numpy(attn), torch.from_numpy(tl), torch.from_numpy(fl), 3,
        frame_slice=frame_slice).numpy()
    assert got.shape == (b, l * h, t - 3 + 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flag,item", [
    (["--encoder_int8"], "item 7"), (["--multihost"], "item 9"),
    (["--data_parallel", "2"], "item 9"), (["--tensor_parallel", "2"],
                                           "item 9")])
def test_refused_flags_name_their_item(tmp_path, monkeypatch, flag, item):
    """The flags of ROADMAP items 7 (int8 encoder) and 9 (multi-GPU), once
    refused, run: ``infer_ali`` and ``probe_oracle`` with each give the JAX
    CLIs' metrics with the same flag, and ``infer_ali`` their words and
    boundaries, on the port's ``--test_model`` weights carried into JAX. A
    mesh of 2 here is a second process that draws those weights itself;
    ``--multihost`` alone is a world of one. The int8 boundaries may move by
    one frame (tests/test_torch_encoder_int8.py says why)."""
    monkeypatch.chdir(REPO)
    monkeypatch.setenv("WCA_PLATFORM", "cpu")
    args = infer_ali.parse_args(["--output_dir", "x", "--test_model"])
    model, tok = common.load_model_and_tokenizer(args, "cpu")
    dims = jcommon.load_model_and_tokenizer(args)[1]
    params = jconvert.from_openai_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, dims)
    monkeypatch.setattr(jcommon, "load_model_and_tokenizer", lambda a: (
        jcommon._maybe_quantize(params, a), dims, jax_test_tokenizer()))
    argv = ["--scp", "sample/test.scp", "--test_model", "--use_gt_transcript",
            "--decode_sample_len", "8", "--aligned_unit_type", "char",
            "--aggr", "topk", "--topk", "2", "--medfilt_width", "3"] + flag
    for name, cli, jcli in (("infer", infer_ali, jinfer),
                            ("probe", probe_oracle, jprobe)):
        extra = ["--save_prediction"] if name == "infer" else []
        want = jcli.main(argv + extra + ["--output_dir",
                                         str(tmp_path / "jax" / name)])
        got = cli.main(argv + extra + ["--output_dir",
                                       str(tmp_path / "port" / name)])
        assert got == want, (name, got, want)
    (jpkl,) = glob.glob(str(tmp_path / "jax" / "infer" / "*-predictions*"))
    (tpkl,) = glob.glob(str(tmp_path / "port" / "infer" / "*-predictions*"))
    assert os.path.basename(tpkl)[-7:] == os.path.basename(jpkl)[-7:]
    theirs = joblib.load(jpkl)
    with open(tpkl, "rb") as f:
        ours = pickle.load(f)
    assert sorted(ours) == sorted(theirs) == [0]
    assert ours[0]["predwords"] == theirs[0]["predwords"]
    assert len(ours[0]["predwords"]) >= 2
    frame = 1 / 50 if flag == ["--encoder_int8"] else 0
    for key in ("starts_hat", "ends_hat"):
        np.testing.assert_allclose(ours[0][key], theirs[0][key], rtol=0,
                                   atol=frame + 1e-9)


def test_platform_switch(monkeypatch):
    monkeypatch.setenv("WCA_PLATFORM", "cpu")
    assert common.apply_platform_env().type == "cpu"
    monkeypatch.setenv("WCA_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="WCA_PLATFORM"):
        common.apply_platform_env()
    monkeypatch.delenv("WCA_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.apply_platform_env()


def test_test_model_weights_do_not_depend_on_the_device(monkeypatch):
    """``--test_model`` draws its weights on the CPU, so the card and the CPU
    run the same tiny model; and it has the JAX CLI's dims."""
    args = infer_ali.parse_args(["--output_dir", "x", "--test_model"])
    model, tok = common.load_model_and_tokenizer(args, "cpu")
    again, _ = common.load_model_and_tokenizer(args, "cpu")
    assert model.dims == ModelDims(**{
        k: getattr(jcommon.load_model_and_tokenizer(args)[1], k)
        for k in ModelDims.__dataclass_fields__})
    for (k, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k


def test_stage_timers_and_trace(tmp_path):
    timers = profiling.StageTimers(torch.device("cpu"))
    for _ in range(2):
        with timers.stage("work", units=4):
            pass
    work = timers.totals.spans["work"]
    assert work.calls == 2 and work.units == 8
    assert set(timers.summary()["work"]) == {"total_s", "calls",
                                             "ms_per_call", "units_per_s"}
    timers.reset()
    assert not timers.totals and not timers.totals.spans
    with profiling.device_trace(None):
        pass
    with pytest.raises(KeyError):
        with profiling.device_trace(str(tmp_path / "trace")):
            torch.ones(4).sum()
            raise KeyError("the trace is written all the same")
    (trace,) = glob.glob(str(tmp_path / "trace" / "*.json"))
    assert "traceEvents" in json.load(open(trace))
