"""The mel kernel module against the JAX package, on the CPU.

The plain version of the kernels' function against ``log_mel_pallas`` in
interpret mode on the same numpy audio, within 5e-5 (the bound of
tests/test_mel_pallas.py), for 80 and 128 mels; the runner's mel step with
``WCA_MEL_IMPL=pallas`` against the JAX runner's. The spectrum kernel's FFT
plan (radices 8, 5, 5 over 200 complex points, then the split step to 201
bins) is emulated here in float32 with the kernel's own tables: its power
against ``np.fft.rfft`` in float64, and its log-mel after the clip against
``log_mel_pallas``, at edge lengths: one frame (201 samples), the reflect at
both ends inside one tile (359, 400), and lengths that are not a multiple of
160 (24159)."""

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

EDGE_LENGTHS = [201, 359, 400, 24000, 24159]


def _audio(seed, n, rows=2):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    clip = (rng.normal(0, 0.1, n)
            + 0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    out = np.stack([clip * (0.5 ** i) for i in range(rows)])
    out[-1, n // 2:] = 0.0  # trailing silence, as in a padded window
    return out


def _edge_audio(seed, n):
    """Three items: tone in noise, silence then a loud tail (the maximum in
    the last frames), and all zeros."""
    out = _audio(seed, n, rows=3)
    out[1, : n - n // 4] = 0.0
    out[1] *= 4.0
    out[2] = 0.0
    return out


# -- a float32 emulation of the spectrum kernel's FFT plan -------------------

def _c(re, im):
    out = np.empty(np.shape(re), np.complex64)
    out.real, out.imag = re, im
    return out


def _mi(a):  # -i * a
    return _c(a.imag, -a.real)


def _dft4(u0, u1, u2, u3):
    t0, t1, t2, t3 = u0 + u2, u0 - u2, u1 + u3, u1 - u3
    return [t0 + t2, t1 + _mi(t3), t0 - t2, t1 - _mi(t3)]


def _dft8(v, c8):
    a = _dft4(v[0], v[2], v[4], v[6])
    b = _dft4(v[1], v[3], v[5], v[7])
    w = [b[0],
         _c(c8 * (b[1].real + b[1].imag), c8 * (b[1].imag - b[1].real)),
         _mi(b[2]),
         _c(c8 * (b[3].imag - b[3].real), -c8 * (b[3].real + b[3].imag))]
    return [a[k] + w[k] for k in range(4)] + [a[k] - w[k] for k in range(4)]


def _dft5(v, r5):
    c1, s1, c2, s2 = r5
    a1, b1, a2, b2 = v[1] + v[4], v[1] - v[4], v[2] + v[3], v[2] - v[3]
    p1 = v[0] + (a1 * c1 + a2 * c2)
    p2 = v[0] + (a1 * c2 + a2 * c1)
    q1 = _mi(b1 * s1 + b2 * s2)
    q2 = _mi(b1 * s2 - b2 * s1)
    return [v[0] + (a1 + a2), p1 + q1, p2 + q2, p2 - q2, p1 - q1]


def _emulated_power(audio):
    """(B, n) float32 -> (B, n // 160, 201) power, by the kernel's plan."""
    window, tw, _, _, _ = mel_cuda._tables(80)
    twc = tw.view(np.complex64)  # (re, im) pairs
    o = mel_cuda
    r5 = tw[o.TW_R5:o.TW_R5 + 4]
    c8 = tw[o.TW_R8]
    tw40 = twc[o.TW_40 // 2:o.TW_200 // 2].reshape(5, 8)  # [n2, k1]
    tw200 = twc[o.TW_200 // 2:o.TW_400 // 2].reshape(5, 40)  # [n3, q]
    tw400 = twc[o.TW_400 // 2:o.TW_400 // 2 + 201]
    n_frames = audio.shape[1] // 160
    padded = np.pad(audio, ((0, 0), (200, 200)), mode="reflect")
    idx = np.arange(n_frames)[:, None] * 160 + np.arange(400)[None, :]
    x = padded[:, idx] * window  # (B, F, 400) float32
    z = _c(x[..., 0::2], x[..., 1::2]).reshape(x.shape[:2] + (8, 25))
    # stage 1: radix 8 over n1 for each m = 5 n2 + n3, then W_200^{5 n2 k1}
    a = np.stack(_dft8([z[..., n1, :] for n1 in range(8)], c8), axis=-2)
    a = a * np.repeat(tw40.T, 5, axis=1)  # [k1, m]
    a = a.reshape(a.shape[:-1] + (5, 5))  # [k1, n2, n3]
    # stage 2: radix 5 over n2, then W_200^{n3 (k1 + 8 k2)}
    bb = np.stack(_dft5([a[..., n2, :] for n2 in range(5)], r5), axis=-2)
    k1, k2, n3 = np.meshgrid(np.arange(8), np.arange(5), np.arange(5),
                             indexing="ij")
    bb = bb * tw200[n3, k1 + 8 * k2]  # [k1, k2, n3]
    # stage 3: radix 5 over n3 into Z[k1 + 8 k2 + 40 k3]
    zz = np.stack(_dft5([bb[..., j] for j in range(5)], r5), axis=-1)
    zz = np.swapaxes(zz, -1, -3).reshape(zz.shape[:2] + (200,))
    # split step to the 201 bins of the 400 real taps
    k = np.arange(201)
    zk, zc = zz[..., k % 200], np.conj(zz[..., (200 - k) % 200])
    e = (zk + zc) * np.float32(0.5)
    wd = tw400 * (zk - zc)
    xr = e.real + np.float32(0.5) * wd.imag
    xi = e.imag - np.float32(0.5) * wd.real
    return xr * xr + xi * xi


def _emulated_log_mel(audio, n_mels):
    """The spectrum kernel, then the clip kernel, emulated in float32."""
    _, _, packed, lo, off = mel_cuda._tables(n_mels)
    power = _emulated_power(audio)
    log_spec = np.empty((audio.shape[0], n_mels, power.shape[1]), np.float32)
    for m in range(n_mels):
        acc = np.zeros(power.shape[:2], np.float32)
        for j in range(off[m + 1] - off[m]):
            acc = acc + packed[off[m] + j] * power[..., lo[m] + j]
        log_spec[:, m] = np.log10(np.maximum(acc, np.float32(1e-10)))
    floor = log_spec.max(axis=(1, 2), keepdims=True) - np.float32(8.0)
    return (np.maximum(log_spec, floor) + np.float32(4.0)) / np.float32(4.0)


@pytest.mark.parametrize("n", EDGE_LENGTHS)
def test_fft_plan_power_matches_rfft(n):
    """Within 1e-5 of each frame's largest power (a weak bin's own relative
    error is float32 rounding of the strong ones)."""
    audio = _edge_audio(n, n)
    got = _emulated_power(audio)
    n_frames = n // 160
    padded = np.pad(audio.astype(np.float64), ((0, 0), (200, 200)),
                    mode="reflect")
    idx = np.arange(n_frames)[:, None] * 160 + np.arange(400)[None, :]
    window = np.hanning(401)[:-1]
    want = np.abs(np.fft.rfft(padded[:, idx] * window, axis=-1)) ** 2
    assert got.shape == want.shape == (3, n_frames, 201)
    scale = want.max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-5 * scale)


@pytest.mark.parametrize("n", EDGE_LENGTHS)
@pytest.mark.parametrize("n_mels", [80, 128])
def test_fft_plan_matches_jax_kernel(n_mels, n):
    audio = _edge_audio(n_mels + n, n)
    got = _emulated_log_mel(audio, n_mels)
    want = np.asarray(log_mel_pallas(jnp.asarray(audio), n_mels=n_mels,
                                     interpret=True))
    assert got.shape == want.shape == (3, n_mels, n // 160)
    np.testing.assert_allclose(got, want, atol=5e-5)


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
def test_mel_clip_plain_is_clip_and_scale(n_mels):
    """The clip kernel's plain version, from 64-frame tile maxima, is
    bit-equal to ``clip_and_scale`` (max is exact)."""
    audio = torch.from_numpy(_edge_audio(n_mels, 24159))
    log_spec = mel_cuda.log10_mel_plain(audio, n_mels)
    n_frames = log_spec.shape[-1]
    n_tiles = -(-n_frames // mel_cuda.TILE_FRAMES)
    padded = torch.nn.functional.pad(
        log_spec, (0, n_tiles * mel_cuda.TILE_FRAMES - n_frames),
        value=-np.inf)
    tile_max = padded.reshape(3, n_mels, n_tiles, -1).amax(dim=(1, 3))
    before = _lib.launch_counts()
    got = mel_cuda.mel_clip(log_spec.clone(), tile_max)
    assert _lib.launch_counts() == before
    assert torch.equal(got, tmel.clip_and_scale(log_spec))


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
def test_kernel_tables_hold_the_fft_twiddles_and_filter_runs(n_mels):
    window, tw, packed, lo, off = mel_cuda._tables(n_mels)
    np.testing.assert_array_equal(
        window, np.hanning(401)[:-1].astype(np.float32))
    o = mel_cuda

    def w(j, n):  # W_n^j in float64 (every j < n), rounded to float32
        ang = 2 * np.pi * j / n
        return np.stack([np.cos(ang), -np.sin(ang)], -1).astype(
            np.float32).ravel()

    n2, k1 = np.divmod(np.arange(40), 8)
    n3, q = np.divmod(np.arange(200), 40)
    np.testing.assert_array_equal(tw[o.TW_40:o.TW_200], w(5 * n2 * k1, 200))
    np.testing.assert_array_equal(tw[o.TW_200:o.TW_400], w(n3 * q, 200))
    np.testing.assert_array_equal(tw[o.TW_400:o.TW_400 + 402],
                                  w(np.arange(201), 400))
    assert not tw[o.TW_R8 + 1:o.TW_40].any()
    np.testing.assert_array_equal(
        tw[o.TW_R5:o.TW_R5 + 5],
        np.float32([np.cos(2 * np.pi / 5), np.sin(2 * np.pi / 5),
                    np.cos(4 * np.pi / 5), np.sin(4 * np.pi / 5),
                    np.sqrt(0.5)]))
    fb = tmel.mel_filterbank(n_mels)
    assert off[0] == 0 and off[-1] == packed.size == np.count_nonzero(fb)
    for m in range(n_mels):
        nz = np.nonzero(fb[m])[0]
        assert lo[m] == nz[0] and off[m + 1] - off[m] == nz.size
        # one run: nothing skipped is nonzero, and the packed weights are it
        assert nz[-1] - nz[0] + 1 == nz.size
        np.testing.assert_array_equal(packed[off[m]:off[m + 1]], fb[m, nz])


@pytest.mark.parametrize("shape", [(16000,), (2, 200)])
def test_log_mel_rejects_bad_inputs(shape):
    with pytest.raises(ValueError):
        mel_cuda.log_mel(torch.zeros(shape))


def test_log_mel_refuses_more_than_128_mels():
    with pytest.raises(ValueError, match="n_mels=129"):
        mel_cuda.log_mel(torch.zeros(1, 4000), n_mels=129)
