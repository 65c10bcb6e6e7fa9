"""The decode cross-attention kernel module and the K-transposed encoder
attention against the JAX package, on the CPU.

Plain versions against the Pallas kernels in interpret mode, on the same
numpy inputs: cross-attention (int8 and float K/V) within rtol and atol
2e-5, the bound of tests/test_cross_attn_pallas.py; the K-transposed encoder
attention within 2e-5 (tests/test_encoder_attn_pallas.py's bound)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_char_alignment_tpu.ops.cross_attn_pallas import (
    cross_attn_step, cross_attn_step_int8)
from whisper_char_alignment_tpu.ops.encoder_attn_pallas import \
    encoder_self_attention_kt as jax_encoder_attention_kt
from whisper_char_alignment_tpu_torch.models import whisper as tw
from whisper_char_alignment_tpu_torch.ops import (_lib, cross_attn_cuda,
                                                  encoder_attn_cuda)

torch.set_num_threads(1)

HD = 64
K_SCALE = HD ** -0.25


def _inputs(seed, b, h, frames):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, h, 1, HD)).astype(np.float32) * K_SCALE
    k = rng.normal(0, 1, (b, h, HD, frames)).astype(np.float32)
    v = rng.normal(0, 1, (b, h, HD, frames)).astype(np.float32)
    k[0, 0, :, 1] = 0.0  # an all-zero column takes scale 1.0
    return q, k, v


@pytest.mark.parametrize("frames", [96, 131, 250])
def test_int8_plain_matches_jax_kernel(frames):
    q, k, v = _inputs(frames, 2, 4, frames)
    k8, k_s = tw.quantize_cross_kv(torch.from_numpy(k))
    v8, v_s = tw.quantize_cross_kv(torch.from_numpy(v))
    assert k8.dtype == torch.int8 and k_s.shape == (2, 4, 1, frames)
    before = _lib.launch_counts()
    got = cross_attn_cuda.cross_attn_step_int8(
        torch.from_numpy(q), k8, k_s, v8, v_s, k_scale=K_SCALE)
    assert _lib.launch_counts() == before  # the CPU path launches nothing
    assert got.dtype == torch.float32 and got.shape == (2, 4, 1, HD)
    want = np.asarray(cross_attn_step_int8(
        jnp.asarray(q), jnp.asarray(k8.numpy()), jnp.asarray(k_s.numpy()),
        jnp.asarray(v8.numpy()), jnp.asarray(v_s.numpy()), k_scale=K_SCALE,
        interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(
        got.numpy(), cross_attn_cuda.cross_attn_step_int8_plain(
            torch.from_numpy(q), k8, k_s, v8, v_s, k_scale=K_SCALE).numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("frames", [96, 131])
def test_float_plain_matches_jax_kernel(frames, dtype):
    q, k, v = _inputs(100 + frames, 3, 2, frames)
    kt, vt = (torch.from_numpy(x).to(dtype) for x in (k, v))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    got = cross_attn_cuda.cross_attn_step(
        torch.from_numpy(q).to(dtype), kt, vt, k_scale=K_SCALE)
    assert got.dtype == torch.float32
    want = np.asarray(cross_attn_step(
        jnp.asarray(q).astype(jdt), jnp.asarray(k).astype(jdt),
        jnp.asarray(v).astype(jdt), k_scale=K_SCALE, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bad", ["q", "kv", "scales", "devices"])
def test_cross_attention_rejects_bad_inputs(bad):
    q, k, v = (torch.from_numpy(x) for x in _inputs(0, 1, 2, 40))
    k8, k_s = tw.quantize_cross_kv(k)
    v8, v_s = tw.quantize_cross_kv(v)
    if bad == "q":
        q = q[..., :-1]
    elif bad == "kv":
        v8 = v8[..., :-1]
    elif bad == "scales":
        k_s = k_s[..., :-1]
    else:
        k_s = k_s.to("meta")
    with pytest.raises(ValueError):
        cross_attn_cuda.cross_attn_step_int8(q, k8, k_s, v8, v_s,
                                             k_scale=K_SCALE)


@pytest.mark.parametrize("value,cpu,cuda", [
    (None, "xla", "kernel"), ("auto", "xla", "kernel"), ("mxu", "mxu", "mxu"),
    ("int8mxu", "mxu", "mxu"), ("pallas", "kernel", "kernel"),
    ("1", "kernel", "kernel"), ("on", "kernel", "kernel"),
    ("true", "kernel", "kernel"), ("xla", "xla", "xla"),
    ("off", "xla", "xla"), ("0", "xla", "xla"), ("false", "xla", "xla")])
def test_cross_attn_mode_values(monkeypatch, value, cpu, cuda):
    if value is None:
        monkeypatch.delenv("WCA_CROSS_ATTN", raising=False)
    else:
        monkeypatch.setenv("WCA_CROSS_ATTN", value)
    assert tw.cross_attn_mode("cpu") == cpu
    assert tw.cross_attn_mode(torch.device("cuda")) == cuda


def test_cross_attn_mode_refuses_unknown_values(monkeypatch):
    monkeypatch.setenv("WCA_CROSS_ATTN", "palas")
    with pytest.raises(ValueError, match="WCA_CROSS_ATTN"):
        tw.cross_attn_mode("cpu")


@pytest.mark.parametrize("n_valid", [250, 300])
def test_encoder_attention_kt_plain_matches_jax_kernel(n_valid):
    b, h, t = 2, 3, 300
    rng = np.random.default_rng(n_valid)
    scale = HD ** -0.25
    q = rng.normal(0, 1, (b, h, t, HD)).astype(np.float32) * scale
    k = rng.normal(0, 1, (b, h, t, HD)).astype(np.float32) * scale
    v = rng.normal(0, 1, (b, h, t, HD)).astype(np.float32)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    before = _lib.launch_counts()
    got = encoder_attn_cuda.encoder_self_attention_kt(*args, n_valid).numpy()
    assert _lib.launch_counts() == before
    want = np.asarray(jax_encoder_attention_kt(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), n_valid=n_valid,
        block_q=128, interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        got, encoder_attn_cuda.encoder_self_attention(*args, n_valid).numpy(),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad", ["shape", "n_valid"])
def test_encoder_attention_kt_rejects_bad_inputs(bad):
    q = torch.zeros(1, 2, 8, 16)
    k = torch.zeros(1, 2, 9, 16) if bad == "shape" else q.clone()
    with pytest.raises(ValueError):
        encoder_attn_cuda.encoder_self_attention_kt(
            q, k, q.clone(), 0 if bad == "n_valid" else 8)


@pytest.mark.parametrize("offset,aligned", [(0, True), (4, True), (1, False),
                                            (2, False)])
def test_require_aligned(offset, aligned):
    """The wrappers refuse data off a 16-byte boundary: the kernels copy
    their K/V panels 16 bytes at a time."""
    t = torch.zeros(64)[offset:offset + 16]  # float32: 4 bytes per offset
    if aligned:
        _lib.require_aligned("x", t)
    else:
        with pytest.raises(ValueError, match="16-byte"):
            _lib.require_aligned("x", t)
