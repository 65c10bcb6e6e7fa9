"""High-level single-utterance API (port of ``whisper_char_alignment_tpu/api.py``).

    from whisper_char_alignment_tpu_torch import api
    model = api.load_model("medium", checkpoint="medium.pt", tokenizer_dir=...)
    result = api.align(model, "sample/test.wav")
    for w, s, e in zip(result.words[:-1], result.start_times, result.end_times):
        print(f"{s:.2f} {e:.2f} {w.strip()}")
    long = api.align_long(model, "podcast.wav")     # any length, 30 s chunks
    out = api.transcribe(model, "podcast.wav", beam_size=5,
                         word_timestamps=True)      # whisper.transcribe

Everything runs on the GPU unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

import numpy as np
import torch

from . import constants
from .config import AlignConfig, ModelDims
from .data.dataset import Utterance
from .models import convert, whisper as wmodel
from .runner import AlignmentPipeline, UttAlignment
from .text.tokenizer import WhisperTokenizer, get_test_tokenizer, get_tokenizer
from .utils.device import resolve_device


@dataclasses.dataclass
class Model:
    model: wmodel.Whisper
    tokenizer: WhisperTokenizer
    name: str = "medium"

    @property
    def dims(self) -> ModelDims:
        return self.model.dims


def _load_audio(audio) -> "tuple[np.ndarray, str]":
    """Path or array -> (mono 16 kHz float32, fid). Any-rate WAVs are
    resampled (audio/resample.py); arrays are taken as 16 kHz."""
    if isinstance(audio, str):
        from .audio.resample import load_resampled

        return load_resampled(audio), os.path.splitext(
            os.path.basename(audio))[0]
    return np.asarray(audio, np.float32).reshape(-1), "utterance"


def load_model(name: str = "medium", checkpoint: Optional[str] = None,
               tokenizer_dir: Optional[str] = None, dtype=torch.float32,
               device=None) -> Model:
    """Load an OpenAI ``.pt`` checkpoint (``WCA_CHECKPOINT`` if not given)
    and the tokenizer; the model lands on ``device`` (cuda unless 'cpu')."""
    checkpoint = checkpoint or os.environ.get("WCA_CHECKPOINT")
    if not checkpoint:
        raise FileNotFoundError(
            "no checkpoint: pass checkpoint= or set WCA_CHECKPOINT")
    sd, dims = convert.load_checkpoint(checkpoint)
    model = convert.model_from_state_dict(sd, dims, device=device, dtype=dtype)
    tok = get_tokenizer(not name.endswith(".en"), language="English",
                        tokenizer_dir=tokenizer_dir)
    return Model(model=model, tokenizer=tok, name=name)


def test_model(seed: int = 0, device=None) -> Model:
    """Deterministic random tiny model + toy tokenizer (offline smoke), with
    weights drawn from a ``torch.Generator`` seeded with ``seed``."""
    from .config import tiny_test_dims

    dev = resolve_device(device)
    tok = get_test_tokenizer()
    dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=1500,
                          n_text_ctx=448, state=32, head=2, layers=2)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = wmodel.init_params(wmodel.Whisper(dims, device=dev), gen)
    return Model(model=model, tokenizer=tok, name="test")


def align(model: Model, audio: Union[str, np.ndarray],
          aligned_unit_type: str = "char", aggregation: str = "topk",
          topk: int = 10, medfilt_width: int = 3, qk_scale: float = 1.0,
          compute_dtype=torch.float32, decode_options=None, gt_text: str = "",
          device=None, **kwargs) -> UttAlignment:
    """Align one utterance with the README-recommended recipe defaults.

    ``decode_options``: an optional ``decoding.DecodingOptions`` for the
    transcription pass. ``gt_text`` carries ground-truth text onto the
    utterance for ``use_gt_transcript=True`` runs."""
    data, fid = _load_audio(audio)
    cfg = AlignConfig(aligned_unit_type=aligned_unit_type, aggr=aggregation,
                      topk=topk, medfilt_width=medfilt_width, qk_scale=qk_scale,
                      batch_size=1, model=model.name, **kwargs)
    pipe = AlignmentPipeline(model.model, model.tokenizer, cfg, device=device,
                             compute_dtype=compute_dtype)
    if decode_options is not None:
        pipe.options = decode_options
    utt = Utterance(audio=data.astype(np.float32), duration=data.size,
                    text=gt_text, starts=[], ends=[], fid=fid)
    return pipe.align_batch([utt], return_matrix=True)[0]


def align_long(model: Model, audio: Union[str, np.ndarray],
               batch_size: int = 8, compute_dtype=torch.float32,
               device=None, **align_kwargs) -> UttAlignment:
    """Align audio of any length by fixed windows of the model (an extension:
    the reference skips utterances over 30 s, infer_ali.py:78-81).

    Each window is transcribed and aligned independently through
    ``run_dataset``; word boundaries are offset by the window start and
    concatenated, each chunk's eot group dropped. Words spanning a window
    boundary are split between the adjacent windows. Audio that fits one
    window goes to :func:`align`."""
    data, fid = _load_audio(audio)
    # the model's window, not the 30 s constant: a short-window model would
    # otherwise send longer audio to align(), which trims it to one window
    window = 2 * model.dims.n_audio_ctx * constants.HOP_LENGTH
    if data.size <= window:
        return align(model, data, compute_dtype=compute_dtype, device=device,
                     **align_kwargs)
    chunks = [data[i:i + window] for i in range(0, data.size, window)]
    utts = [Utterance(audio=np.ascontiguousarray(c, np.float32),
                      duration=c.size, text="", starts=[], ends=[],
                      fid=f"{fid}#{k}") for k, c in enumerate(chunks)]
    cfg = AlignConfig(batch_size=min(batch_size, len(utts)), model=model.name,
                      aligned_unit_type=align_kwargs.pop("aligned_unit_type",
                                                         "char"),
                      aggr=align_kwargs.pop("aggregation", "topk"),
                      topk=align_kwargs.pop("topk", 10),
                      medfilt_width=align_kwargs.pop("medfilt_width", 3),
                      qk_scale=align_kwargs.pop("qk_scale", 1.0),
                      **align_kwargs)
    pipe = AlignmentPipeline(model.model, model.tokenizer, cfg, device=device,
                             compute_dtype=compute_dtype)
    by_chunk = {int(r.fid.rsplit("#", 1)[1]): r
                for r in pipe.run_dataset(list(utts), progress=False)}
    words: list = []
    starts: list = []
    ends: list = []
    texts: list = []
    chunk_seconds = window / constants.SAMPLE_RATE
    for k in sorted(by_chunk):
        res = by_chunk[k]
        base = k * chunk_seconds
        if res.words:
            words.extend(res.words[:-1])  # drop each chunk's eot group
            starts.extend(float(s) + base for s in res.start_times)
            ends.extend(float(e) + base for e in res.end_times)
        texts.append(res.transcription)
    return UttAlignment(
        fid=fid, words=words + ["<|endoftext|>"],
        start_times=np.asarray(starts), end_times=np.asarray(ends),
        transcription=" ".join(t for t in texts if t), text="",
        starts=[], ends=[])


def transcribe(model: Model, audio: Union[str, np.ndarray],
               compute_dtype=None, device=None, **kwargs) -> dict:
    """Long-form transcription (the ``whisper.transcribe`` equivalent): 30 s
    seek windows, temperature fallback, no-speech skipping and
    condition-on-previous-text via prompt tokens. Returns the published
    ``{"text", "segments", "language"}`` schema; the knobs are
    :func:`whisper_char_alignment_tpu_torch.transcribe.transcribe`'s.
    ``compute_dtype`` casts a copy of the model for this call (None: the
    model's own dtype)."""
    from .transcribe import transcribe as _transcribe

    data, _ = _load_audio(audio)
    kwargs.setdefault("model_name", model.name)
    net = model.model
    if compute_dtype is not None:
        net = wmodel.cast_params(net, compute_dtype)
    return _transcribe(net, model.tokenizer, data, device=device, **kwargs)
