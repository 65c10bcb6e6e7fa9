"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked ``gpu``: each test skips, with its reason, where no card is present
(run them on the card with ``python -m pytest tests/test_torch_cuda.py -q``).
``chip_smoke.py`` holds the same kernels at the main path's full shapes."""

import numpy as np
import pytest
import torch

from whisper_char_alignment_tpu_torch.models import whisper as tw
from whisper_char_alignment_tpu_torch.ops import (_lib, cross_attn_cuda,
                                                  dtw_cuda, encoder_attn_cuda,
                                                  mel_cuda, qkpost_cuda)

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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_encoder_attention_kt_kernel(cuda, dtype, tol):
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 3, 150, 64)).astype(
        np.float32)).to(cuda, dtype) for _ in range(3))
    before = _lib.launch_counts()["encoder_attn_kt"]
    got = encoder_attn_cuda.encoder_self_attention_kt(q, k, v, 130)
    assert _lib.launch_counts()["encoder_attn_kt"] == before + 1
    want = encoder_attn_cuda.encoder_self_attention_kt_plain(q, k, v, 130)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("frames", [1, 131, 384])
def test_cross_attention_int8_kernel(cuda, frames):
    rng = np.random.default_rng(frames)
    q = torch.from_numpy(rng.normal(size=(2, 3, 1, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    k8, k_s = tw.quantize_cross_kv(torch.from_numpy(rng.normal(
        size=(2, 3, 64, frames)).astype(np.float32)).to(cuda))
    v8, v_s = tw.quantize_cross_kv(torch.from_numpy(rng.normal(
        size=(2, 3, 64, frames)).astype(np.float32)).to(cuda))
    before = _lib.launch_counts()["cross_attn_int8"]
    got = cross_attn_cuda.cross_attn_step_int8(q, k8, k_s, v8, v_s,
                                               k_scale=0.35)
    assert _lib.launch_counts()["cross_attn_int8"] == before + 1
    want = cross_attn_cuda.cross_attn_step_int8_plain(q, k8, k_s, v8, v_s,
                                                      k_scale=0.35)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mode,tol", [("xla", 2e-4), ("kernel", 2e-4),
                                      ("mxu", 1e-2)])
def test_int8_decode_step_on_the_card_matches_the_cpu(cuda, mode, tol):
    """A tiny f32 model's prefill + decode step over the same int8 cross K/V
    on the card and on the CPU, in each cross-attention mode (the ``mxu``
    bound allows a flipped row code between the two devices' products)."""
    from whisper_char_alignment_tpu_torch.config import tiny_test_dims

    dims = tiny_test_dims(n_vocab=300, n_audio_ctx=40, n_text_ctx=24,
                          state=128, head=2, layers=2)  # head_dim 64
    gen = torch.Generator().manual_seed(2)
    cpu = tw.init_params(tw.Whisper(dims, device="cpu"), gen)
    gpu = tw.cast_params(cpu, torch.float32, cuda)
    ckv = tw.precompute_cross_kv(
        cpu, torch.randn((2, 40, 128), generator=gen), quantize=True)
    tokens = torch.randint(0, 300, (2, 5), generator=gen)

    def logits(model, dev):
        kv = tuple(tuple(t.to(dev) for t in c) for c in ckv)
        cache = tw.init_kv_cache(dims, 2, 8, device=dev.type)
        _, cache = tw.decode_prefill(model, tokens[:, :4].to(dev), cache, kv,
                                     cross_mode=mode)
        out, _ = tw.decode_step(model, tokens[:, 4:5].to(dev), 4, cache, kv,
                                cross_mode=mode)
        return out.cpu()

    before = _lib.launch_counts()["cross_attn_int8"]
    got = logits(gpu, cuda)
    launched = _lib.launch_counts()["cross_attn_int8"] - before
    assert launched == (dims.n_text_layer if mode == "kernel" else 0)
    want = logits(cpu, torch.device("cpu"))
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_float_kernel(cuda, dtype):
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(cuda, dtype) for shape in
        ((4, 2, 1, 64), (4, 2, 64, 300), (4, 2, 64, 300)))
    got = cross_attn_cuda.cross_attn_step(q, k, v, k_scale=0.35)
    want = cross_attn_cuda.cross_attn_step_plain(q, k, v, k_scale=0.35)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_kernel(cuda, n_mels):
    rng = np.random.default_rng(n_mels)
    audio = rng.normal(0, 0.1, (3, 48000)).astype(np.float32)
    audio[2, 16000:] = 0.0
    audio = torch.from_numpy(audio).to(cuda)
    before = _lib.launch_counts()["mel"]
    got = mel_cuda.log_mel(audio, n_mels)
    assert _lib.launch_counts()["mel"] == before + 1
    want = mel_cuda.log_mel_plain(audio, n_mels)
    assert got.shape == (3, n_mels, 300)
    assert (got - want).abs().max().item() <= 1e-4


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
