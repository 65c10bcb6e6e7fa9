"""The QK post-process at median widths above 15 (17 and 31 on the kernel's
network, 101 on its rank selection) against the JAX package, on the CPU.

``qk_postprocess`` takes its plain version for CPU tensors. The references:
JAX ``qk_to_attention`` (the XLA path) at 17 and 31, the Pallas kernel
``qk_postprocess_fused`` in interpret mode at 17 (its unrolled edge
windows take about a minute to trace at 31, more above), and at every
width the reference's per-utterance recipe in NumPy: slice each item to
its frame_len, JAX's ``median_filter_np``, scale, an f32 softmax, padded
rows zeroed (XLA takes minutes to compile the width-101 median network).
Within 1e-6, the tolerance of the width 3 and 7 tests."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_char_alignment_tpu.align import timing as jtiming
from whisper_char_alignment_tpu.config import tiny_test_dims
from whisper_char_alignment_tpu.models import whisper as jwhisper
from whisper_char_alignment_tpu.models.whisper import qk_to_attention
from whisper_char_alignment_tpu.ops.medfilt import median_filter_np
from whisper_char_alignment_tpu.ops.qkpost_pallas import qk_postprocess_fused
from whisper_char_alignment_tpu_torch.align import timing as ttiming
from whisper_char_alignment_tpu_torch.config import ModelDims
from whisper_char_alignment_tpu_torch.models import convert as tconvert
from whisper_char_alignment_tpu_torch.ops import _lib, qkpost_cuda

torch.set_num_threads(1)


def _numpy_reference(qk, frame_len, token_len, width, qk_scale):
    """The reference's recipe per item (timing.py:63-66), in NumPy: the
    item's valid frames only, median filter, scaled f32 softmax; frames past
    frame_len and rows past token_len are zero."""
    out = np.zeros(qk.shape, np.float32)
    for b, (fl, tl) in enumerate(zip(frame_len, token_len)):
        x = median_filter_np(qk[b, :, :, :fl], width) * np.float32(qk_scale)
        e = np.exp(x - x.max(axis=-1, keepdims=True))
        out[b, :, :tl, :fl] = (e / e.sum(axis=-1, keepdims=True))[:, :tl]
    return out


@pytest.mark.parametrize("width", [17, 31, 101])
def test_qk_postprocess_wide_widths_match_jax(width):
    b, h, t = 4, 2, 5
    f = 120 if width < 101 else 240
    rng = np.random.default_rng(width)
    qk = rng.normal(0, 2, (b, h, t, f)).astype(np.float32)
    # passed through (frame_len <= w//2), the first filtered length, a
    # ragged one, the full window
    fl = np.array([width // 2, width // 2 + 1, f - 3, f], np.int32)
    tl = np.array([5, 3, 1, 4], np.int32)
    before = _lib.launch_counts()
    got = qkpost_cuda.qk_postprocess(
        torch.from_numpy(qk), torch.from_numpy(fl), torch.from_numpy(tl),
        width, qk_scale=0.75).numpy()
    assert _lib.launch_counts() == before  # the CPU path launches nothing
    assert np.abs(got - _numpy_reference(qk, fl, tl, width, 0.75)).max() <= 1e-6
    # the pass-through item is the plain softmax of its raw logits
    raw = qk[0, :, :, :fl[0]] * np.float32(0.75)
    e = np.exp(raw - raw.max(axis=-1, keepdims=True))
    np.testing.assert_allclose(got[0, :, :, :fl[0]],
                               e / e.sum(axis=-1, keepdims=True), atol=1e-6)
    if width > 31:
        return
    args = (jnp.asarray(qk), jnp.asarray(fl), jnp.asarray(tl), width)
    xla = np.asarray(qk_to_attention(*args, qk_scale=0.75))
    assert np.abs(got - xla).max() <= 1e-6
    if width == 17:
        fused = np.asarray(qk_postprocess_fused(*args, qk_scale=0.75,
                                                interpret=True))
        assert np.abs(got - fused).max() <= 1e-6


@pytest.mark.parametrize("width", [17, 31, 101])
def test_get_attentions_wide_widths_match_jax(width):
    """The teacher-forced capture of a tiny model at the wide widths: the
    port's ``get_attentions`` against JAX's (17, 31), and at 101 against
    JAX's raw cross-attention logits through the NumPy recipe."""
    dims = tiny_test_dims(n_vocab=64, n_audio_ctx=150, n_text_ctx=16,
                          state=32, head=2, layers=2)
    params = jwhisper.init_params(jax.random.PRNGKey(3), dims)
    model = tconvert.model_from_state_dict(
        tconvert.params_from_jax(jax.tree.map(np.asarray, params)),
        ModelDims(**dataclasses.asdict(dims)), device="cpu")
    rng = np.random.default_rng(width)
    mel = rng.normal(0, 1, (3, 80, 300)).astype(np.float32)
    tokens = rng.integers(0, 64, (3, 12)).astype(np.int32)
    tl = np.array([12, 7, 3], np.int32)
    fl = np.array([150, width // 2 + 1, 90], np.int32)
    got, _ = ttiming.get_attentions(
        model, torch.from_numpy(mel), torch.from_numpy(tokens),
        torch.from_numpy(tl), torch.from_numpy(fl), medfilt_width=width,
        return_logits=False, device="cpu")
    got = got.numpy()
    assert got.shape == (2, 3, 2, 12, 150)
    j_args = (params, dims, jnp.asarray(mel), jnp.asarray(tokens),
              jnp.asarray(tl), jnp.asarray(fl))
    if width <= 31:
        want, _ = jtiming.get_attentions(*j_args, medfilt_width=width,
                                         return_logits=False, qkpost=False)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
        return
    xa = jwhisper.encode_audio(params, dims, jnp.asarray(mel))
    _, raw = jwhisper.decode_text(params, dims, jnp.asarray(tokens), xa,
                                  return_qk=True, return_logits=False)
    for layer in range(2):
        want = _numpy_reference(np.asarray(raw[layer]), fl, tl, width, 1.0)
        np.testing.assert_allclose(got[layer], want, rtol=0, atol=1e-6)
