"""The port's result writers and ``cli.transcribe`` against the JAX
package's, on the CPU (``WCA_PLATFORM=cpu``).

- every writer (txt, srt, vtt, tsv, json) and ``get_writer("all")`` gives
  files byte-equal to the JAX writers' for one result dict (hour-long
  times, ``-->`` and tabs in the text, non-ASCII text, word lists);
- ``cli.transcribe`` with ``--output_format all``, word timestamps and the
  fallback ladder (JAX's noise put in, tests/test_torch_transcribe.py) on a
  tiny model carried across from JAX: the txt, srt, vtt and tsv files are
  byte-equal to the JAX CLI's; the json files are equal as parsed, their
  float fields (avg_logprob, no_speech_prob, word probabilities) within
  2e-4, the model tolerance of the JAX suite;
- ``task="translate"`` puts the translate token into the decode's prompt.
"""

import io
import json

import numpy as np
import pytest
import torch

from test_torch_transcribe import _setup, jax_window_noise
from whisper_char_alignment_tpu.cli import common as jcommon
from whisper_char_alignment_tpu.cli import transcribe as jcli
from whisper_char_alignment_tpu.text.tokenizer import \
    get_test_tokenizer as jax_tokenizer
from whisper_char_alignment_tpu.utils import writers as jwriters
from whisper_char_alignment_tpu_torch.audio.wav import save as wav_save
from whisper_char_alignment_tpu_torch.cli import common
from whisper_char_alignment_tpu_torch.cli import transcribe as tcli
from whisper_char_alignment_tpu_torch.models import beam as tbeam
from whisper_char_alignment_tpu_torch.models import decoding
from whisper_char_alignment_tpu_torch.utils import writers

torch.set_num_threads(1)

RESULT = {
    "text": " hello world again, naïve --> tab\there",
    "language": "en",
    "segments": [
        {"id": 0, "seek": 0, "start": 0.0, "end": 1.5,
         "text": " hello world", "tokens": [1, 2], "temperature": 0.0,
         "avg_logprob": -0.5, "compression_ratio": 1.0,
         "no_speech_prob": 0.01,
         "words": [{"word": " hello", "tokens": [1], "start": 0.0,
                    "end": 0.7, "probability": 0.25},
                   {"word": " world", "tokens": [2], "start": 0.7,
                    "end": 1.5, "probability": None}]},
        {"id": 1, "seek": 150, "start": 3661.007, "end": 3662.5,
         "text": " again, naïve --> tab\there", "tokens": [3],
         "temperature": 0.2, "avg_logprob": -0.4,
         "compression_ratio": 1.0, "no_speech_prob": 0.02},
        {"id": 2, "seek": 300, "start": 7322.0004, "end": 7322.0006,
         "text": "", "tokens": [], "temperature": 1.0,
         "avg_logprob": -1.25, "compression_ratio": 0.5,
         "no_speech_prob": 0.5},
    ],
}


@pytest.mark.parametrize("seconds", [0.0, 0.0004, 1.5, 59.9996, 3661.007,
                                     36000.5])
def test_format_timestamp(seconds):
    for hours in (False, True):
        for marker in (".", ","):
            assert writers.format_timestamp(seconds, hours, marker) == \
                jwriters.format_timestamp(seconds, hours, marker)
    assert writers.format_timestamp(1.5, always_include_hours=True,
                                    decimal_marker=",") == "00:00:01,500"


@pytest.mark.parametrize("fmt", ["txt", "srt", "vtt", "tsv", "json"])
def test_writers_byte_equal(tmp_path, fmt):
    port = tmp_path / f"port.{fmt}"
    ref = tmp_path / f"jax.{fmt}"
    getattr(writers, f"write_{fmt}")(RESULT, str(port))
    getattr(jwriters, f"write_{fmt}")(RESULT, str(ref))
    assert port.read_bytes() == ref.read_bytes()
    buf, jbuf = io.StringIO(), io.StringIO()
    getattr(writers, f"write_{fmt}")(RESULT, buf)
    getattr(jwriters, f"write_{fmt}")(RESULT, jbuf)
    assert buf.getvalue() == jbuf.getvalue() == port.read_text("utf-8")


def test_get_writer_all(tmp_path):
    writers.get_writer("all", str(tmp_path / "port"))(RESULT,
                                                      "/somewhere/clip.wav")
    jwriters.get_writer("all", str(tmp_path / "jax"))(RESULT,
                                                      "/somewhere/clip.wav")
    for ext in ("txt", "srt", "vtt", "tsv", "json"):
        assert (tmp_path / "port" / f"clip.{ext}").read_bytes() == \
            (tmp_path / "jax" / f"clip.{ext}").read_bytes(), ext
    with pytest.raises(ValueError):
        writers.get_writer("mp4", str(tmp_path))


def _assert_json_like(got, want):
    if isinstance(want, float):
        assert got == pytest.approx(want, abs=2e-4)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_json_like(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_json_like(g, w)
    else:
        assert got == want


@pytest.mark.parametrize("aggr", ["default", "topk"])
def test_transcribe_cli_matches_jax_cli(tmp_path, monkeypatch, aggr):
    tok, dims, params, model = _setup()
    monkeypatch.setenv("WCA_PLATFORM", "cpu")
    monkeypatch.setattr(common, "load_model_and_tokenizer",
                        lambda args, device=None: (model, tok))
    monkeypatch.setattr(jcommon, "load_model_and_tokenizer",
                        lambda args: (params, dims, jax_tokenizer()))
    monkeypatch.setattr(tbeam, "noise_source", jax_window_noise())
    window = 2 * dims.n_audio_ctx * 160
    audio = (np.random.default_rng(0).normal(0, 0.05, int(2.3 * window))
             .astype(np.float32))
    paths = []
    for k, a in enumerate((audio, audio[:window // 2])):
        paths.append(str(tmp_path / f"clip{k}.wav"))
        wav_save(paths[-1], a, 16000)
    argv = paths + ["--test_model", "--model", "tiny-test", "--language",
                    "en", "--word_timestamps", "--word_aggr", aggr,
                    "--temperature_increment_on_fallback", "0.5",
                    "--output_format", "all"]
    assert tcli.main(argv + ["--output_dir", str(tmp_path / "port")]) == 0
    assert jcli.main(argv + ["--output_dir", str(tmp_path / "jax")]) == 0
    for k in range(2):
        for ext in ("txt", "srt", "vtt", "tsv"):
            got = (tmp_path / "port" / f"clip{k}.{ext}").read_bytes()
            assert got == (tmp_path / "jax" / f"clip{k}.{ext}").read_bytes()
        with open(tmp_path / "port" / f"clip{k}.json") as f:
            got = json.load(f)
        with open(tmp_path / "jax" / f"clip{k}.json") as f:
            want = json.load(f)
        _assert_json_like(got, want)
    assert "-->" in (tmp_path / "port" / "clip0.srt").read_text()


def test_transcribe_cli_refuses_unported_and_runs_on_the_card_by_default(
        tmp_path, monkeypatch):
    from whisper_char_alignment_tpu_torch.utils.unported import ROADMAP_ITEMS

    monkeypatch.setenv("WCA_PLATFORM", "cpu")
    path = str(tmp_path / "a.wav")
    wav_save(path, np.zeros(1600, np.float32), 16000)
    with pytest.raises(NotImplementedError, match="item 7"):
        tcli.main([path, "--test_model", "--encoder_int8", "--output_dir",
                   str(tmp_path / "o")])
    assert "item 7" in ROADMAP_ITEMS["quantized"]
    monkeypatch.delenv("WCA_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main([path, "--test_model", "--output_dir",
                   str(tmp_path / "o")])


def test_task_translate_overrides_sot_token(monkeypatch):
    tok, dims, _, model = _setup()
    mel = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (dims.n_mels, 2 * dims.n_audio_ctx)).astype(np.float32))
    seen = {}
    real = decoding._decode_loop

    def spy(model_, xa, prompt, *a, **kw):
        seen["prompt"] = np.asarray(prompt).tolist()
        return real(model_, xa, prompt, *a, **kw)

    monkeypatch.setattr(decoding, "_decode_loop", spy)
    for task, want in (("translate", tok.translate),
                       ("transcribe", tok.transcribe)):
        decoding.decode(model, tok, mel, decoding.DecodingOptions(
            language="en", task=task, sample_len=2), device="cpu")
        assert np.asarray(seen["prompt"]).reshape(-1)[2] == want
