"""The mel kernel module against the JAX package, on the CPU.

The plain version of the kernel's function against ``log_mel_pallas`` in
interpret mode on the same numpy audio, within 5e-5 (the bound of
tests/test_mel_pallas.py), for 80 and 128 mels; the runner's mel step with
``WCA_MEL_IMPL=pallas`` against the JAX runner's."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_char_alignment_tpu import runner as jrunner
from whisper_char_alignment_tpu.config import tiny_test_dims
from whisper_char_alignment_tpu.ops.mel_pallas import log_mel_pallas
from whisper_char_alignment_tpu_torch.audio import mel as tmel
from whisper_char_alignment_tpu_torch.ops import _lib, mel_cuda

torch.set_num_threads(1)


def _audio(seed, n, rows=2):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    clip = (rng.normal(0, 0.1, n)
            + 0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    out = np.stack([clip * (0.5 ** i) for i in range(rows)])
    out[-1, n // 2:] = 0.0  # trailing silence, as in a padded window
    return out


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_plain_matches_jax_kernel(n_mels):
    audio = _audio(n_mels, 24000)
    before = _lib.launch_counts()
    got = mel_cuda.log_mel(torch.from_numpy(audio), n_mels=n_mels).numpy()
    assert _lib.launch_counts() == before  # the CPU path launches nothing
    assert got.shape == (2, n_mels, 150)
    want = np.asarray(log_mel_pallas(jnp.asarray(audio), n_mels=n_mels,
                                     interpret=True))
    np.testing.assert_allclose(got, want, atol=5e-5)
    np.testing.assert_array_equal(
        got, tmel.log_mel_spectrogram(torch.from_numpy(audio),
                                      n_mels=n_mels).numpy())


@pytest.mark.parametrize("n_mels", [80, 128])
def test_wire_to_mel_kernel_branch_matches_jax_mel_step(n_mels, monkeypatch):
    audio = _audio(7, 20000)
    wire = np.round(audio * 32767).astype(np.int16)
    dims = dataclasses.replace(tiny_test_dims(), n_mels=n_mels)
    monkeypatch.setenv("WCA_MEL_IMPL", "pallas")
    want = np.asarray(jrunner._mel_step(jnp.asarray(wire), dims,
                                        total_samples=32000))
    got = tmel.wire_to_mel(torch.from_numpy(wire), n_mels,
                           total_samples=32000).numpy()
    assert got.shape == want.shape == (2, n_mels, 200)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_mel_impl_refuses_unknown_values(monkeypatch):
    monkeypatch.setenv("WCA_MEL_IMPL", "fused")
    with pytest.raises(ValueError, match="WCA_MEL_IMPL"):
        tmel.wire_to_mel(torch.zeros(1, 4000), 80)
    monkeypatch.delenv("WCA_MEL_IMPL")
    assert tmel.mel_impl() == "xla"


@pytest.mark.parametrize("n_mels", [80, 128])
def test_kernel_tables_hold_the_dft_bases_and_filter_runs(n_mels):
    window, cos_c, sin_c, fb, lo, hi = mel_cuda._tables(n_mels)
    cos_b, sin_b = tmel._dft_bases(400)
    idx = (np.arange(400)[:, None] * np.arange(201)[None, :]) % 400
    # the one column the kernel reads gives every basis value (the float64
    # angles of (n k) and (n k) mod 400 differ in their last bits only)
    np.testing.assert_allclose(cos_c[idx], cos_b, rtol=0, atol=1e-12)
    np.testing.assert_allclose(sin_c[idx], sin_b, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(
        window, np.hanning(401)[:-1].astype(np.float32))
    for m in range(n_mels):
        nz = np.nonzero(fb[m])[0]
        assert lo[m] == nz[0] and hi[m] == nz[-1] + 1
        assert hi[m] - lo[m] == nz.size  # one run: nothing skipped is nonzero


@pytest.mark.parametrize("shape", [(16000,), (2, 200)])
def test_log_mel_rejects_bad_inputs(shape):
    with pytest.raises(ValueError):
        mel_cuda.log_mel(torch.zeros(shape))
