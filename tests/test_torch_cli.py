"""The port's command-line surface against the JAX package's, on the CPU
(``WCA_PLATFORM=cpu``).

- ``infer_ali`` on the planted-accuracy fixture (tests/test_planted_accuracy
  .py): the capture replaced by the banded stand-in, written in torch; F1 >
  0.9999 and the results JSON equal to the JAX CLI's; ``--plot`` writes one
  figure an utterance.
- the probe's per-head DTW sweep: layer chunks and the frame slice equal the
  single full-width launch, and JAX's sweep.
- refused flags, the platform switch, the stage timers and the trace."""

import glob
import json
import os

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
    monkeypatch.setenv("WCA_PLATFORM", "cpu")
    argv = ["--scp", "sample/test.scp", "--output_dir", str(tmp_path),
            "--test_model"] + flag
    for cli in (infer_ali, probe_oracle):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
            cli.main(argv)
    assert not os.listdir(tmp_path)


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
    assert timers.counts["work"] == 2 and timers.units["work"] == 8
    assert set(timers.summary()["work"]) == {"total_s", "calls",
                                             "ms_per_call", "units_per_s"}
    timers.reset()
    assert not timers.totals and not timers.counts
    with profiling.device_trace(None):
        pass
    with pytest.raises(KeyError):
        with profiling.device_trace(str(tmp_path / "trace")):
            torch.ones(4).sum()
            raise KeyError("the trace is written all the same")
    (trace,) = glob.glob(str(tmp_path / "trace" / "*.json"))
    assert "traceEvents" in json.load(open(trace))
