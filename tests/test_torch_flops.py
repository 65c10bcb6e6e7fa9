"""The port's FLOP model (``utils/flops.py``) against the JAX package's.

Every case of tests/test_flops.py with JAX's function beside the port's,
returning equal integers; the port's analytic encoder count against
``torch.utils.flop_counter.FlopCounterMode`` on the port's CPU encoder; the
MFU roll-up and the peak table on stub card names."""

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from whisper_char_alignment_tpu.config import MODEL_DIMS as JAX_DIMS
from whisper_char_alignment_tpu.config import tiny_test_dims as jax_tiny
from whisper_char_alignment_tpu.utils import flops as jflops
from whisper_char_alignment_tpu_torch.config import MODEL_DIMS
from whisper_char_alignment_tpu_torch.config import tiny_test_dims
from whisper_char_alignment_tpu_torch.models import whisper as tw
from whisper_char_alignment_tpu_torch.utils import flops

torch.set_num_threads(1)


def _both(name):
    """(port dims, JAX dims) of a size."""
    if name == "tiny-test":
        kw = dict(n_vocab=64, n_audio_ctx=8, n_text_ctx=16, state=4, head=2,
                  layers=1)
        return tiny_test_dims(**kw), jax_tiny(**kw)
    return MODEL_DIMS[name], JAX_DIMS[name]


def test_dims_tables_agree():
    for name, dims in JAX_DIMS.items():
        assert dataclasses.asdict(MODEL_DIMS[name]) == dataclasses.asdict(dims)


def test_hand_computed_terms():
    dims, jdims = _both("tiny-test")
    F, d, m = 8, 4, 80
    conv = 2 * (2 * F) * (m * 3) * d + 2 * F * (d * 3) * d
    per_layer = 4 * 2 * F * d * d + 2 * 2 * F * F * d + 2 * 2 * F * d * (4 * d)
    assert flops.encoder_flops(dims) == conv + per_layer
    assert flops.encoder_flops(dims) == jflops.encoder_flops(jdims)

    got = flops.decode_flops(dims, prompt_len=0, steps=1)
    layer = (4 * 2 * d * d + 2 * 2 * 1 * d + 2 * 2 * d * d
             + 2 * 2 * F * d + 2 * 2 * d * 4 * d)
    assert got == 1 * (2 * 2 * F * d * d) + 1 * layer + 2 * d * 64
    assert got == jflops.decode_flops(jdims, prompt_len=0, steps=1)

    t = 6
    cap = flops.capture_flops(dims, t_tokens=t, reuse_cross_kv=True)
    cap_layer = (4 * 2 * t * d * d + 2 * 2 * t * t * d + 2 * 2 * t * d * d
                 + 2 * 2 * t * F * d + 2 * 2 * t * d * 4 * d)
    assert cap == cap_layer
    no_reuse = flops.capture_flops(dims, t_tokens=t, reuse_cross_kv=False)
    assert no_reuse == cap + 2 * 2 * F * d * d
    assert no_reuse == jflops.capture_flops(jdims, t_tokens=t,
                                            reuse_cross_kv=False)


@pytest.mark.parametrize("name", ["tiny-test", "tiny", "base", "small",
                                  "medium", "large-v3"])
@pytest.mark.parametrize("kw", [
    dict(t_tokens=96, decode_prompt_len=3, decode_steps=32),
    dict(t_tokens=32, decode_prompt_len=0, decode_steps=5, kv_frames=384,
         reuse_cross_kv=False),
    dict(t_tokens=64, decode_prompt_len=7, decode_steps=10, prefill=False)])
def test_every_count_equals_jax(name, kw):
    dims, jdims = _both(name)
    assert flops.mel_flops(dims) == jflops.mel_flops(jdims)
    assert (flops.pipeline_flops_per_utt(dims, **kw)
            == jflops.pipeline_flops_per_utt(jdims, **kw))
    assert (flops.capture_flops(dims, t_tokens=kw["t_tokens"],
                                return_logits=True, encoder=True)
            == jflops.capture_flops(jdims, t_tokens=kw["t_tokens"],
                                    return_logits=True, encoder=True))


def test_medium_magnitudes():
    dims = MODEL_DIMS["medium"]
    st = flops.pipeline_flops_per_utt(dims, t_tokens=96, decode_prompt_len=3,
                                      decode_steps=32)
    assert 1.0e12 < st["encoder"] < 1.3e12
    assert 0.1e12 < st["decode"] < 0.3e12
    assert 0.05e12 < st["capture"] < 0.2e12
    assert st["mel"] < 0.01e12
    assert st["total"] == (st["mel"] + st["encoder"] + st["decode"]
                           + st["capture"])
    bucketed = flops.decode_flops(dims, prompt_len=3, steps=32, kv_frames=512)
    assert bucketed < st["decode"]
    assert bucketed == jflops.decode_flops(JAX_DIMS["medium"], prompt_len=3,
                                           steps=32, kv_frames=512)


@pytest.mark.parametrize("layers", [1, 2])
def test_encoder_flops_vs_flop_counter(layers):
    """The analytic encoder count against ``FlopCounterMode`` on the port's
    CPU encoder (batch 1). The analytic count must be at most the counted
    one and within tests/test_flops.py's envelope against XLA (>= 0.65 of
    it). FlopCounterMode counts only matmuls and convolutions (no GELU,
    layer norm, softmax or bias adds), which is exactly what the analytic
    model counts, so here the two are expected to differ by nothing. Unlike
    XLA's cost model over a ``lax.scan``, it counts every layer."""
    dims = tiny_test_dims(n_vocab=64, n_audio_ctx=64, n_text_ctx=16,
                          state=32, head=2, layers=layers)
    model = tw.init_params(tw.Whisper(dims, device="cpu"),
                           torch.Generator().manual_seed(0))
    mel = torch.zeros(1, dims.n_mels, 2 * dims.n_audio_ctx)
    with FlopCounterMode(display=False) as counter:
        tw.encode_audio(model, mel, device="cpu")
    counted = counter.get_total_flops()
    ours = flops.encoder_flops(dims)
    assert ours <= counted * 1.001, (ours, counted)
    assert ours >= counted * 0.65, (ours, counted)
    assert ours == counted


def test_mfu_summary():
    s = flops.mfu_summary(1.5e12, 36.0, 989.0)
    assert s == jflops.mfu_summary(1.5e12, 36.0, 989.0)
    assert s["tflops_per_sec"] == pytest.approx(54.0, abs=0.01)
    assert s["mfu_pct"] == pytest.approx(5.46, abs=0.01)
    assert flops.mfu_summary(1e12, 1.0, None)["mfu_pct"] is None


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989.0), ("NVIDIA H100 SXM5 80GB", 989.0),
    ("NVIDIA H100 PCIe", 756.0), ("NVIDIA H100 NVL", 835.0),
    ("NVIDIA A100-SXM4-80GB", None), ("TPU v5 lite", None)])
def test_device_peak_tflops_on_stub_names(monkeypatch, name, peak):
    monkeypatch.delenv("WCA_PEAK_TFLOPS", raising=False)
    asked = []

    def get_name(device=None):
        asked.append(device)
        return name

    monkeypatch.setattr(torch.cuda, "get_device_name", get_name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert flops.device_peak_tflops() == peak
    assert flops.device_peak_tflops(1) == peak
    assert asked == [0, 1]
    monkeypatch.setenv("WCA_PEAK_TFLOPS", "123.5")
    assert flops.device_peak_tflops() == 123.5


def test_device_peak_tflops_without_a_card(monkeypatch):
    monkeypatch.delenv("WCA_PEAK_TFLOPS", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert flops.device_peak_tflops() is None
