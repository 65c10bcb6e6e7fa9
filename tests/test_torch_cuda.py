"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked ``gpu``: each test skips, with its reason, where no card is present
(run them on the card with ``python -m pytest tests/test_torch_cuda.py -q``).
``chip_smoke.py`` holds the same kernels at the main path's full shapes."""

import numpy as np
import pytest
import torch

from whisper_char_alignment_tpu_torch.ops import (_lib, dtw_cuda,
                                                  encoder_attn_cuda,
                                                  qkpost_cuda)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from whisper_char_alignment_tpu_torch.utils.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hd", [16, 64])
def test_encoder_attention_kernel(cuda, dtype, tol, hd):
    rng = np.random.default_rng(hd)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 3, 150, hd)).astype(
        np.float32)).to(cuda, dtype) for _ in range(3))
    before = _lib.launch_counts()["encoder_attn"]
    got = encoder_attn_cuda.encoder_self_attention(q, k, v, 130)
    assert _lib.launch_counts()["encoder_attn"] == before + 1
    want = encoder_attn_cuda.encoder_self_attention_plain(q, k, v, 130)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("width", [1, 3, 7, 15])
def test_qkpost_kernel(cuda, width):
    rng = np.random.default_rng(width)
    qk = torch.from_numpy(rng.normal(0, 2, (4, 2, 9, 300)).astype(
        np.float32)).to(cuda)
    fl = torch.tensor([1, width // 2 + 1, 299, 300], dtype=torch.int32,
                      device=cuda)
    tl = torch.tensor([9, 1, 4, 8], dtype=torch.int32, device=cuda)
    got = qkpost_cuda.qk_postprocess(qk, fl, tl, width, 0.5)
    want = qkpost_cuda.qk_postprocess_plain(qk, fl, tl, width, 0.5)
    assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.parametrize("tied", [True, False])
def test_dtw_kernels_bit_equal(cuda, tied):
    rng = np.random.default_rng(int(tied))
    b, n, m = 6, 17, 90
    x = (-rng.integers(0, 3, (b, n, m)) if tied
         else rng.normal(size=(b, n, m))).astype(np.float32)
    n_len = torch.tensor([17, 1, 9, 17, 4, 12], dtype=torch.int32,
                         device=cuda)
    m_len = torch.tensor([90, 1, 33, 2, 90, 61], dtype=torch.int32,
                         device=cuda)
    x = torch.from_numpy(x).to(cuda)
    tr = dtw_cuda.dtw_trace(x)
    assert torch.equal(tr, dtw_cuda.dtw_trace_plain(x))
    assert torch.equal(dtw_cuda.dtw_backtrace_jump(tr, n_len, m_len),
                       dtw_cuda.dtw_jump_frames_plain(tr, n_len, m_len))
