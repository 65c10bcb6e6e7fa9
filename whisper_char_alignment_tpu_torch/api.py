"""High-level single-utterance API (port of ``whisper_char_alignment_tpu/api.py``).

    from whisper_char_alignment_tpu_torch import api
    model = api.load_model("medium", checkpoint="medium.pt", tokenizer_dir=...)
    result = api.align(model, "sample/test.wav")
    for w, s, e in zip(result.words[:-1], result.start_times, result.end_times):
        print(f"{s:.2f} {e:.2f} {w.strip()}")

Everything runs on the GPU unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

import numpy as np
import torch

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
