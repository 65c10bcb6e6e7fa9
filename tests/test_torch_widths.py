"""The QK post-process at median widths from 7 up against the JAX package,
on the CPU, at the dispatch edges of the CUDA kernel (``csrc/qkpost.cu``):
windows of their own width up to 31, padded register windows from 33 (in
capacities 40, 48, 64, ..., 128) to 127, a shared-memory window above.

``qk_postprocess`` takes its plain version for CPU tensors. The references:
the Pallas kernel ``qk_postprocess_fused`` in interpret mode up to 33 (its
unrolled edge windows take about 30 s to trace at 31 and 50 s at 33, more
above), JAX ``qk_to_attention`` (the XLA path) up to 41 (XLA takes minutes
to compile the width-101 median network), and at every width the
reference's per-utterance recipe in NumPy: slice each item to its
frame_len, JAX's ``median_filter_np``, scale, an f32 softmax, padded rows
zeroed. Within 1e-6, the tolerance of the width 3 and 7 tests.

The kernel's own walk cannot run here, so a NumPy emulation of it (each
lane's run, the first window's sort, the slide that deletes the leaving
value and inserts the entering one, the padded and shared-memory windows)
is held bit for bit against JAX's ``median_filter_np``; a change to the
walk in ``csrc/qkpost.cu`` changes the emulation with it."""

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


@pytest.mark.parametrize("width", [7, 9, 17, 31, 33, 41, 101, 127, 129])
def test_qk_postprocess_wide_widths_match_jax(width):
    b, h, t = 4, 2, 5
    f = 120 if width < 101 else 280
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
    if width > 41:
        return
    args = (jnp.asarray(qk), jnp.asarray(fl), jnp.asarray(tl), width)
    xla = np.asarray(qk_to_attention(*args, qk_scale=0.75))
    assert np.abs(got - xla).max() <= 1e-6
    if width <= 33:
        fused = np.asarray(qk_postprocess_fused(*args, qk_scale=0.75,
                                                interpret=True))
        assert np.abs(got - fused).max() <= 1e-6


# capacities of the kernel's padded register windows (PadWindow<C>)
_PAD_CAPACITIES = (40, 48, 64, 80, 96, 112, 128)


def _kernel_walk(x, width):
    """Median filter of one row's valid frames ``x`` as the kernel walks it:
    32 lanes, lane l owning columns [l R, l R + R) with R = ceil(len / 32)
    made odd; each lane sorts its first window, then slides. Returns the
    medians and the window kind."""
    fl, pad, m = len(x), width // 2, len(x) - 1
    inf = float("inf")
    if width <= qkpost_cuda.EXACT_WIDTH:
        kind, cap = "exact", width
    elif width <= qkpost_cuda.PAD_WIDTH:
        kind = "padded"
        cap = next(c for c in _PAD_CAPACITIES if width < c)
    else:
        kind, cap = "shared", width
    if fl <= pad:
        return x.copy(), kind
    xs = [float(v) for v in x]

    def at(i):  # reflected at 0 and at m
        i = abs(i)
        return xs[2 * m - i if i > m else i]

    out = np.full(fl, np.nan, np.float32)
    run = ((fl + 31) >> 5) | 1
    mid = cap // 2 - 1 if kind == "padded" else pad
    for lane in range(32):
        c0, c1 = lane * run, min(lane * run + run, fl)
        if c0 >= c1:
            continue
        window = [at(c0 - pad + k) for k in range(width)]
        if kind == "exact":  # branch-free insertion, one value at a time
            s = [inf] * cap
            for k, v in enumerate(window):
                for i in range(k, 0, -1):
                    s[i] = min(s[i], max(v, s[i - 1]))
                s[0] = min(s[0], v)
        elif kind == "padded":  # -inf below, +inf above, then a sort
            below = (cap - 1 - width) // 2
            s = sorted([-inf] * below + window
                       + [inf] * (cap - below - width))
        else:  # insertion sort with an early stop
            s = []
            for v in window:
                i = len(s)
                s.append(v)
                while i > 0 and not s[i - 1] <= v:
                    s[i] = s[i - 1]
                    i -= 1
                s[i] = v
        out[c0] = s[mid]
        for c in range(c0 + 1, c1):
            a, b = at(c - 1 - pad), at(c + pad)
            prev = -inf
            for i in range(cap):  # delete a, insert b: one pass
                nxt = s[i + 1] if i + 1 < cap else inf
                u = s[i] if s[i] < a else nxt
                s[i] = min(u, max(b, prev))
                prev = u
            out[c] = s[mid]
    return out, kind


@pytest.mark.parametrize("width", [1, 3, 7, 31, 33, 39, 41, 101, 127, 129])
def test_kernel_walk_medians_equal_jax(width):
    """The emulated walk gives JAX's medians exactly, on random and on tied
    (three-valued) logits, at frame lengths at the runs' edges: under 32
    lanes (31), one column a lane (32), runs ending at a run's last column
    (33: 11 runs of 3), a last run of one column (34) and of two (97), and
    at the pass-through edge (w/2, w/2 + 1)."""
    rng = np.random.default_rng(200 + width)
    lengths = sorted({1, max(width // 2, 1), width // 2 + 1, 31, 32, 33, 34,
                      97, 300})
    kinds = set()
    for fl in lengths:
        for tied in (False, True):
            x = (rng.integers(-1, 2, fl) if tied
                 else rng.normal(0, 2, fl)).astype(np.float32)
            got, kind = _kernel_walk(x, width)
            kinds.add(kind)
            np.testing.assert_array_equal(
                got, median_filter_np(x[None], width)[0])
    assert kinds == {"exact" if width <= 31 else
                     "padded" if width <= 127 else "shared"}


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
