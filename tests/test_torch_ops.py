"""The port's kernel modules against the JAX package, on the CPU.

Each wrapper takes its plain PyTorch version for CPU tensors, so these tests
hold the plain versions against the JAX functions, the Pallas kernels run in
interpret mode, and their XLA references: medians, DTW traces and jump
frames bit-equal; softmax outputs within 1e-6; encoder attention within 2e-5
(the JAX kernel test's own bound).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_char_alignment_tpu.models.whisper import qk_to_attention
from whisper_char_alignment_tpu.ops import dtw as jdtw
from whisper_char_alignment_tpu.ops import dtw_pallas
from whisper_char_alignment_tpu.ops import medfilt as jmed
from whisper_char_alignment_tpu.ops.encoder_attn_pallas import \
    encoder_self_attention as jax_encoder_attention
from whisper_char_alignment_tpu.ops.qkpost_pallas import qk_postprocess_fused
from whisper_char_alignment_tpu_torch.ops import (_lib, dtw as tdtw, dtw_cuda,
                                                  encoder_attn_cuda,
                                                  medfilt as tmed, qkpost_cuda)

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# encoder attention
# ---------------------------------------------------------------------------

def _xla_attention(q, k, v):
    qk = jnp.einsum("bhtd,bhsd->bhts", q, k, preferred_element_type=jnp.float32)
    w = jax.nn.softmax(qk, axis=-1).astype(v.dtype)
    return jnp.einsum("bhts,bhsd->bhtd", w, v,
                      preferred_element_type=jnp.float32).astype(q.dtype)


@pytest.mark.parametrize("n_valid", [250, 300])
def test_encoder_attention_plain_matches_jax_kernel(n_valid):
    b, h, t, hd = 2, 3, 300, 64
    rng = np.random.default_rng(0)
    scale = hd ** -0.25
    q = rng.normal(0, 1, (b, h, t, hd)).astype(np.float32) * scale
    k = rng.normal(0, 1, (b, h, t, hd)).astype(np.float32) * scale
    v = rng.normal(0, 1, (b, h, t, hd)).astype(np.float32)
    before = _lib.launch_counts()
    got = encoder_attn_cuda.encoder_self_attention(_t(q), _t(k), _t(v),
                                                   n_valid).numpy()
    assert _lib.launch_counts() == before  # the CPU path launches nothing
    kern = np.asarray(jax_encoder_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), n_valid=n_valid,
        block_q=128, interpret=True))
    xla = np.asarray(_xla_attention(jnp.asarray(q),
                                    jnp.asarray(k[:, :, :n_valid]),
                                    jnp.asarray(v[:, :, :n_valid])))
    np.testing.assert_allclose(got, kern, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, xla, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bad", ["shape", "n_valid", "dtype"])
def test_encoder_attention_rejects_bad_inputs(bad):
    q = torch.zeros(1, 2, 8, 16)
    k, v = q.clone(), q.clone()
    if bad == "shape":
        k = torch.zeros(1, 2, 9, 16)
    if bad == "dtype":
        k = k.double()
    with pytest.raises(ValueError):
        encoder_attn_cuda.encoder_self_attention(
            q, k, v, 0 if bad == "n_valid" else 8)


# ---------------------------------------------------------------------------
# median filter + QK post-process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [3, 7])
def test_masked_medians_bit_equal(width):
    b, h, t, f = 5, 2, 6, 40
    rng = np.random.default_rng(width)
    x = rng.normal(0, 2, (b, h, t, f)).astype(np.float32)
    fl = np.array([1, width // 2, width // 2 + 1, f - 1, f], np.int32)
    want = np.asarray(jmed.median_filter_masked(jnp.asarray(x), width,
                                                jnp.asarray(fl)))
    got = tmed.median_filter_masked(_t(x), width, _t(fl)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width", [1, 3, 5, 7])
def test_median_filter_bit_equal(width):
    x = np.random.default_rng(1).normal(size=(3, 4, 25)).astype(np.float32)
    want = np.asarray(jmed.median_filter(jnp.asarray(x), width))
    got = tmed.median_filter(_t(x), width).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tmed.median_filter_np(x, width))


@pytest.mark.parametrize("width", [3, 7])
def test_qk_postprocess_plain_matches_jax(width):
    b, h, t, f = 5, 2, 12, 160
    rng = np.random.default_rng(10 + width)
    qk = rng.normal(0, 2, (b, h, t, f)).astype(np.float32)
    fl = np.array([1, width // 2, width // 2 + 1, f - 1, f], np.int32)
    tl = np.array([1, 5, 11, 3, 7], np.int32)  # all < T
    before = _lib.launch_counts()
    got = qkpost_cuda.qk_postprocess(_t(qk), _t(fl), _t(tl), width,
                                     qk_scale=0.75).numpy()
    assert _lib.launch_counts() == before
    args = (jnp.asarray(qk), jnp.asarray(fl), jnp.asarray(tl), width)
    fused = np.asarray(qk_postprocess_fused(*args, qk_scale=0.75,
                                            interpret=True))
    xla = np.asarray(qk_to_attention(*args, qk_scale=0.75))
    assert np.abs(got - fused).max() <= 1e-6
    assert np.abs(got - xla).max() <= 1e-6
    # padded token rows are exactly zero
    for i, n in enumerate(tl):
        assert not got[i, :, n:].any()


@pytest.mark.parametrize("width", [2, 0, -1])
def test_qk_postprocess_rejects_widths(width):
    qk = torch.zeros(1, 1, 2, 8)
    ones = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        qkpost_cuda.qk_postprocess(qk, ones, ones, width)


# ---------------------------------------------------------------------------
# DTW
# ---------------------------------------------------------------------------

def _dtw_case(seed):
    rng = np.random.default_rng(900 + seed)
    b = int(rng.integers(2, 12))
    n_max = int(rng.integers(2, 20))
    m_max = int(rng.integers(2, 60))
    x = rng.normal(size=(b, n_max, m_max)).astype(np.float32)
    if seed % 2 == 0:
        x = -rng.integers(0, 3, size=(b, n_max, m_max)).astype(np.float32)
    n = rng.integers(1, n_max + 1, size=(b,)).astype(np.int32)
    m = rng.integers(1, m_max + 1, size=(b,)).astype(np.int32)
    n[0], m[0] = n_max, m_max
    return x, n, m


@pytest.mark.parametrize("seed", range(4))
def test_dtw_trace_and_jump_frames_bit_equal(seed):
    x, n, m = _dtw_case(seed)
    jt = jax.vmap(lambda a, nn, mm: jdtw.dtw_trace(a, nn, mm))(
        jnp.asarray(x), jnp.asarray(n), jnp.asarray(m))
    tt = tdtw.dtw_trace(_t(x))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    want = np.asarray(jdtw.dtw_jump_frames_batch(jt, jnp.asarray(n),
                                                 jnp.asarray(m)))
    before = _lib.launch_counts()
    got = dtw_cuda.dtw_jump_frames(_t(x), _t(n), _t(m)).numpy()
    assert _lib.launch_counts() == before
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(dtw_pallas.dtw_jump_frames_pallas(
        jnp.asarray(x), jnp.asarray(n), jnp.asarray(m), interpret=True))
    np.testing.assert_array_equal(got, pallas)


def test_dtw_row0_boundary_cell_and_short_items():
    """A path down column 0 emits row 0 at frame -1; n < 0 (a pad row of the
    capture batch) gives all -1."""
    x = np.full((2, 4, 6), 5.0, np.float32)
    x[0, :, 0] = -1.0
    x[0, 3, :] = -1.0
    n = np.array([4, -3], np.int32)
    m = np.array([6, 1], np.int32)
    jt = jax.vmap(lambda a: jdtw.dtw_trace(a, 0, 0))(jnp.asarray(x))
    want = np.asarray(jdtw.dtw_jump_frames_batch(jt, jnp.asarray(n),
                                                 jnp.asarray(m)))
    got = dtw_cuda.dtw_jump_frames(_t(x), _t(n), _t(m)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[1] == -1).all()


@pytest.mark.parametrize("seed", range(4))
def test_dtw_trace_bit_equal_to_jax_trace_batch(seed):
    """Row 5 of the kernel table: ``dtw_trace_batch`` returns the Pallas
    wavefront's trace as (B, N + M - 1, N + 1) int8 diagonals, which is what
    ``dtw_cuda.dtw_trace`` returns."""
    x, _, _ = _dtw_case(seed)
    want = np.asarray(dtw_pallas.dtw_trace_batch(jnp.asarray(x),
                                                 use_pallas=True,
                                                 interpret=True))
    got = dtw_cuda.dtw_trace(_t(x)).numpy()
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m_max", [1, 90, 1501])
@pytest.mark.parametrize("n_max", [31, 32, 64, 128, 448])
def test_dtw_bit_equal_at_kernel_edge_shapes(n_max, m_max):
    """The oracle the card's kernels are held against, at the wavefront's
    warp edges (31/32 rows per lane group, 64, 128, the decoder's 448
    context) and at M = 1, 90 and 1501 (rows off a 16-byte boundary), on
    tied costs: the trace and the jump frames of ``dtw_cuda`` on the CPU
    equal JAX's ``dtw_trace`` and ``dtw_jump_frames_batch``; the Pallas
    backtrace (interpret mode) too where it stays quick. Items: the full
    grid, a pad row (n < 0), n = 0, m = 1 and a random length."""
    rng = np.random.default_rng(n_max * 7 + m_max)
    x = -rng.integers(0, 3, size=(5, n_max, m_max)).astype(np.float32)
    n = np.array([n_max, -1, 0, n_max, rng.integers(1, n_max + 1)], np.int32)
    m = np.array([m_max, m_max, m_max, 1, rng.integers(1, m_max + 1)],
                 np.int32)
    jt = jax.vmap(lambda a, nn, mm: jdtw.dtw_trace(a, nn, mm))(
        jnp.asarray(x), jnp.asarray(n), jnp.asarray(m))
    want = np.asarray(jdtw.dtw_jump_frames_batch(jt, jnp.asarray(n),
                                                 jnp.asarray(m)))
    before = _lib.launch_counts()
    tr = dtw_cuda.dtw_trace(_t(x)).numpy()
    got = dtw_cuda.dtw_jump_frames(_t(x), _t(n), _t(m)).numpy()
    assert _lib.launch_counts() == before
    np.testing.assert_array_equal(tr, np.asarray(jt))
    np.testing.assert_array_equal(got, want)
    assert (got[1:3] == -1).all()
    if n_max <= 32 and m_max <= 90:
        pallas = np.asarray(dtw_pallas.dtw_jump_frames_pallas(
            jnp.asarray(x), jnp.asarray(np.maximum(n, 0)), jnp.asarray(m),
            interpret=True))
        np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("seed", [0, 1])
def test_dtw_single_matrix_matches_numpy_oracle(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(9, 31)).astype(np.float32)
    if seed:
        x = np.round(x)  # plateau ties
    ti, tj = tdtw.dtw(x)
    ri, rj = tdtw.dtw_np(x)
    np.testing.assert_array_equal(ti, ri)
    np.testing.assert_array_equal(tj, rj)
    jti, jtj = jdtw.dtw(x)
    np.testing.assert_array_equal(ti, jti)
    np.testing.assert_array_equal(tj, jtj)
