"""The port's guard calibration (``scripts/calibrate_kv_guard.py``) against
the JAX script's logic, on the CPU.

- parity: ``measure`` / ``calibrate`` on the JAX script's ``--test_model``
  weights carried across (``convert.params_from_jax``) and the same
  synthetic corpus give the JAX script's loop (``decoding.decode`` exact and
  perturbed, per batch, the trailing batch padded) the same flipped
  utterances and per-utterance margins within 1e-3 (the tolerance
  ``tests/test_torch_decode_graph.py`` holds graphed and eager margins to),
  in each mode, with ``WCA_CROSS_ATTN=xla`` on both sides; the summary
  fields follow the JAX script's formulas. The script's ``--test_model``
  corpus flips nothing (its bucket is the whole window), so a corpus of
  short utterances under a 12-frame bucket adds flips;
- the trailing-batch pad: 6 utterances at batch 4 count 6;
- ``--rehearse`` goes through ``rehearse_asset_day.make_assets`` and the
  CLI loader (``cli/common.load_model_and_tokenizer``);
- the JSON line's keys: the JAX script's plus ``cross_attn``, ``device``
  and ``launches``.
"""

import dataclasses
import io
import json
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_char_alignment_tpu import constants as jconstants
from whisper_char_alignment_tpu.audio.mel import \
    log_mel_spectrogram as jax_log_mel
from whisper_char_alignment_tpu.audio.mel import pad_or_trim as jax_pad
from whisper_char_alignment_tpu.config import tiny_test_dims
from whisper_char_alignment_tpu.data.dataset import TIMIT as JaxTIMIT
from whisper_char_alignment_tpu.data.dataset import batch_iter as jax_batches
from whisper_char_alignment_tpu.data.synthetic import make_timit_corpus
from whisper_char_alignment_tpu.models import decoding as jdec
from whisper_char_alignment_tpu.models import whisper as jw
from whisper_char_alignment_tpu.parallel import mesh as jmesh
from whisper_char_alignment_tpu.text.tokenizer import \
    get_test_tokenizer as jax_tokenizer
from whisper_char_alignment_tpu_torch.config import ModelDims
from whisper_char_alignment_tpu_torch.data.dataset import TIMIT
from whisper_char_alignment_tpu_torch.models import convert as tconvert
from whisper_char_alignment_tpu_torch.scripts import calibrate_kv_guard as cal
from whisper_char_alignment_tpu_torch.text.tokenizer import get_test_tokenizer

torch.set_num_threads(1)

# the JAX script's keys, and the three the port adds
JAX_KEYS = {"metric", "mode", "source", "recommended_guard_margin", "basis",
            "n_utts", "flip_rate_unguarded", "predicted_flag_rate",
            "predicted_flag_rate_at_default", "margin_percentiles",
            "deployable_hint"}
PORT_KEYS = {"cross_attn", "device", "launches"}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX script's ``--test_model`` (tiny dims, PRNGKey(0), f32) on
    both sides and its synthetic corpus (8 utterances of 2-5 s)."""
    tok = jax_tokenizer()
    dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=96, n_text_ctx=64,
                          state=16, head=2, layers=2)
    params = jw.init_params(jax.random.PRNGKey(0), dims)
    model = tconvert.model_from_state_dict(
        tconvert.params_from_jax(jax.tree.map(np.asarray, params)),
        ModelDims(**dataclasses.asdict(dims)), device="cpu")
    scp = make_timit_corpus(str(tmp_path_factory.mktemp("calib")), n_utts=8,
                            seconds=(2.0, 5.0))
    # utterances of 0.2-1.0 s under a 12-frame bucket: the second batch's
    # bucket truncates enough to flip its transcripts, the first's does not
    # (the --test_model corpus flips none: its bucket is the whole window)
    short = make_timit_corpus(str(tmp_path_factory.mktemp("short")),
                              n_utts=8, seconds=(0.2, 1.0))
    return dict(params=params, dims=dims, model=model,
                scps={"test_model": (scp, 128), "short": (short, 12)})


def jax_script_margins(params, dims, scp, mode, batch_size, decode_len,
                       frame_bucket=128):
    """The loop of the JAX script's ``main`` (scripts/calibrate_kv_guard.py
    :126-175), f32: per utterance, the perturbed pass's min margin and
    whether it flipped."""
    tok = jax_tokenizer()
    n_samples = 2 * dims.n_audio_ctx * jconstants.HOP_LENGTH
    opts = jdec.DecodingOptions(without_timestamps=True,
                                sample_len=decode_len)
    margins, flipped = [], []
    for batch in jax_batches(JaxTIMIT(scp), batch_size):
        n_live = len(batch)
        if n_live < batch_size:
            batch = list(batch) + [batch[-1]] * (batch_size - n_live)
        audio = np.stack([np.asarray(jax_pad(u.audio, n_samples))
                          for u in batch])
        mel = jax_log_mel(jnp.asarray(audio), n_mels=dims.n_mels)
        exact = jdec.decode(params, dims, tok, mel, opts,
                            compute_dtype=jnp.float32)
        kv_frames = None
        if mode in ("bucket", "both"):
            max_fl = max(max(u.duration // jconstants.AUDIO_SAMPLES_PER_TOKEN,
                             1) for u in batch)
            kv_frames = min(dims.n_audio_ctx,
                            jmesh.pad_to_multiple(int(max_fl), frame_bucket))
        quant = jdec.decode(
            params, dims, tok, mel, opts, compute_dtype=jnp.float32,
            kv_int8=mode in ("int8", "both"), kv_frames=kv_frames,
            kv_int8_guard=0.0 if mode in ("int8", "both") else None,
            kv_frames_guard=0.0 if mode in ("bucket", "both") else None)
        for e, q in zip(exact[:n_live], quant[:n_live]):
            margins.append(float(q.min_margin))
            flipped.append(e.tokens != q.tokens)
    return margins, flipped


def jax_script_summary(margins, flipped, mode, safety=2.0):
    """The JAX script's recommendation (:177-206) of its loop's output."""
    margins = np.asarray(margins, np.float64)
    flips = [m for m, f in zip(margins, flipped) if f]
    default = {"int8": 2.0, "bucket": 2.0, "both": 4.0}[mode]
    bound = safety * max(flips) if flips else default
    return {"recommended_guard_margin": round(float(bound), 4),
            "n_utts": len(margins),
            "flip_rate_unguarded": round(len(flips) / max(len(margins), 1),
                                         4),
            "predicted_flag_rate": round(float((margins < bound).mean()), 4),
            "predicted_flag_rate_at_default": round(
                float((margins < default).mean()), 4)}


@pytest.mark.parametrize("mode,corpus", [
    ("int8", "test_model"), ("bucket", "test_model"), ("both", "test_model"),
    ("bucket", "short"), ("both", "short")])
def test_calibration_matches_the_jax_script(setup, mode, corpus,
                                            monkeypatch):
    monkeypatch.setenv("WCA_CROSS_ATTN", "xla")
    scp, bucket = setup["scps"][corpus]
    jm, jf = jax_script_margins(setup["params"], setup["dims"], scp, mode,
                                batch_size=4, decode_len=8,
                                frame_bucket=bucket)
    dataset = TIMIT(scp)
    got = cal.measure(setup["model"], get_test_tokenizer(), dataset,
                      mode=mode, batch_size=4, decode_len=8,
                      frame_bucket=bucket)
    if corpus == "short":
        assert 0 < sum(jf) < 8, "the short corpus should flip some"
    assert len(got.margins) == len(jm) == 8
    # a near-tie (a margin under the tolerance) may decode either way on
    # the two packages: such an utterance is named and left out; the check
    # holds on every other one
    ties = [i for i in range(8) if min(jm[i], got.margins[i]) < 1e-3
            and got.flipped[i] != jf[i]]
    keep = [i for i in range(8) if i not in ties]
    assert len(keep) >= 6, f"near-ties split utterances {ties}"
    assert [got.flipped[i] for i in keep] == [jf[i] for i in keep], \
        f"flips differ (near-ties left out: {ties})"
    np.testing.assert_allclose([got.margins[i] for i in keep],
                               [jm[i] for i in keep], atol=1e-3)
    if not ties:
        line = cal.calibrate(setup["model"], get_test_tokenizer(), dataset,
                             mode=mode, batch_size=4, decode_len=8,
                             frame_bucket=bucket)
        want = jax_script_summary(jm, jf, mode)
        assert line["basis"].startswith("safety" if any(jf) else "no flips")
        assert line["n_utts"] == want["n_utts"]
        assert line["flip_rate_unguarded"] == want["flip_rate_unguarded"]
        assert line["recommended_guard_margin"] == pytest.approx(
            want["recommended_guard_margin"], abs=2e-3)
        assert line["cross_attn"] == ("xla" if mode != "bucket" else "float")


def test_trailing_batch_is_padded_and_counted_once(tmp_path, monkeypatch):
    """6 utterances at batch 4: the second batch is padded with the last
    utterance, and the pad rows are not counted."""
    scp = make_timit_corpus(str(tmp_path), n_utts=6, seconds=(2.0, 5.0))
    model, tok = cal.toy_model(torch.device("cpu"))
    sizes = []
    decode = cal.decoding.decode

    def spy(model_, tok_, mel, *a, **kw):
        sizes.append(mel.shape[0])
        return decode(model_, tok_, mel, *a, **kw)

    monkeypatch.setattr(cal.decoding, "decode", spy)
    line = cal.calibrate(model, tok, TIMIT(scp), mode="int8", batch_size=4,
                         decode_len=4)
    assert line["n_utts"] == 6
    assert sizes == [4, 4, 4, 4]  # two batches, exact + int8 each, padded


def _main(argv, monkeypatch):
    monkeypatch.setenv("WCA_PLATFORM", "cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cal.main(argv) == 0
    lines = [l for l in out.getvalue().splitlines() if l.strip()]
    assert len(lines) == 1
    return json.loads(lines[0])


def test_rehearse_goes_through_the_asset_path(monkeypatch, capsys):
    made, loaded = [], []
    from whisper_char_alignment_tpu_torch.scripts import rehearse_asset_day
    make, load = (rehearse_asset_day.make_assets,
                  cal.common.load_model_and_tokenizer)

    def spy_make(*a, **kw):
        made.append(make(*a, **kw))
        return made[-1]

    def spy_load(args, device=None):
        loaded.append(args)
        return load(args, device)

    monkeypatch.setattr(rehearse_asset_day, "make_assets", spy_make)
    monkeypatch.setattr(cal.common, "load_model_and_tokenizer", spy_load)
    line = _main(["--rehearse", "--mode", "both", "--n_utts", "4",
                  "--batch_size", "4", "--decode_len", "4"], monkeypatch)
    assert JAX_KEYS | PORT_KEYS <= set(line)
    assert line["metric"] == "kv_both_guard_calibration"
    assert line["source"] == "rehearsal-assets" and line["n_utts"] == 4
    assert line["device"] == "cpu" and not any(line["launches"].values())
    assert line["recommended_guard_margin"] > 0
    pct = [line["margin_percentiles"][k] for k in ("1", "5", "25", "50")]
    assert all(np.isfinite(v) and v >= 0 for v in pct) and pct == sorted(pct)
    # the real formats were written and read back by the CLI loader
    (assets,) = made
    assert set(assets) == {"pt", "tokenizer_dir"}
    (args,) = loaded
    assert args.checkpoint == assets["pt"]
    assert args.tokenizer_dir == assets["tokenizer_dir"]
    assert "rehearsal assets (real formats)" in capsys.readouterr().err


def test_test_model_line_has_every_key(monkeypatch):
    line = _main(["--test_model", "--n_utts", "4", "--batch_size", "4",
                  "--decode_len", "4", "--mode", "bucket"], monkeypatch)
    assert JAX_KEYS | PORT_KEYS <= set(line)
    assert line["source"] == "test_model" and line["cross_attn"] == "float"
    assert 0.0 <= line["predicted_flag_rate"] <= 1.0


def test_real_path_needs_weights(monkeypatch):
    """Without ``WCA_CHECKPOINT`` the real path stops with the CLI loader's
    message, before any decode."""
    monkeypatch.setenv("WCA_PLATFORM", "cpu")
    monkeypatch.delenv("WCA_CHECKPOINT", raising=False)
    with pytest.raises(SystemExit, match="no weights available"):
        cal.main(["--n_utts", "2"])
