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
                                                  int8_cuda, mel_cuda,
                                                  qkpost_cuda)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from whisper_char_alignment_tpu_torch.utils.device import resolve_device

    return resolve_device("cuda")


# (B, T, n_valid, hd, scaled): q and k pre-scaled by hd**-0.25 as the model
# gives them, at the ragged tails of the 64-key tiles at Whisper's T=1500,
# a short T whose K^T rows are only 4-byte aligned, and every head dim; and
# q and k unscaled at B=2, whose peaked softmax keeps the output near the
# size of v, so the bf16 tolerance holds it as tightly as it reads
_ENCODER_CASES = [(1, 150, 130, hd, True) for hd in (16, 32, 64, 128)] + [
    (1, 1500, n, 64, True) for n in (1, 63, 64, 65, 1000, 1500)] + [
    (1, 1500, 1000, hd, True) for hd in (16, 32, 128)] + [
    (2, 150, 130, hd, False) for hd in (16, 64)]


def _encoder_inputs(cuda, dtype, b, t, hd, scaled, seed):
    rng = np.random.default_rng(seed)
    scale = hd ** -0.25 if scaled else 1.0
    return [torch.from_numpy(rng.normal(size=(b, 3, t, hd)).astype(
        np.float32) * (scale if i < 2 else 1.0)).to(cuda, dtype)
        for i in range(3)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,t,n_valid,hd,scaled", _ENCODER_CASES)
def test_encoder_attention_kernel(cuda, dtype, tol, b, t, n_valid, hd,
                                  scaled):
    q, k, v = _encoder_inputs(cuda, dtype, b, t, hd, scaled, hd + n_valid)
    before = _lib.launch_counts()["encoder_attn"]
    got = encoder_attn_cuda.encoder_self_attention(q, k, v, n_valid)
    assert _lib.launch_counts()["encoder_attn"] == before + 1
    want = encoder_attn_cuda.encoder_self_attention_plain(q, k, v, n_valid)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,t,n_valid,hd,scaled",
                         _ENCODER_CASES + [(1, 151, 77, 64, True)])
def test_encoder_attention_kt_kernel(cuda, dtype, tol, b, t, n_valid, hd,
                                     scaled):
    """As above with K transposed; T=151 leaves K^T rows 2-byte aligned, so
    its tile loads take one element per copy."""
    q, k, v = _encoder_inputs(cuda, dtype, b, t, hd, scaled,
                              7 + hd + n_valid)
    before = _lib.launch_counts()["encoder_attn_kt"]
    got = encoder_attn_cuda.encoder_self_attention_kt(q, k, v, n_valid)
    assert _lib.launch_counts()["encoder_attn_kt"] == before + 1
    want = encoder_attn_cuda.encoder_self_attention_kt_plain(q, k, v, n_valid)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_encoder_attention_refuses_misaligned_inputs(cuda):
    q, k, v = _encoder_inputs(cuda, torch.bfloat16, 1, 64, 64, True, 0)
    buf = torch.empty(k.numel() + 1, dtype=k.dtype, device=cuda)
    k = buf[1:].view_as(k).copy_(k)  # contiguous, 2 bytes past a boundary
    with pytest.raises(ValueError, match="boundary"):
        encoder_attn_cuda.encoder_self_attention(q, k, v, 64)


def _int8_inputs(cuda, frames, hd):
    rng = np.random.default_rng(frames + hd)
    q = torch.from_numpy(rng.normal(size=(2, 3, 1, hd)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    k8, k_s = tw.quantize_cross_kv(torch.from_numpy(rng.normal(
        size=(2, 3, hd, frames)).astype(np.float32)).to(cuda))
    v8, v_s = tw.quantize_cross_kv(torch.from_numpy(rng.normal(
        size=(2, 3, hd, frames)).astype(np.float32)).to(cuda))
    return q, k8, k_s, v8, v_s


# (F, hd): Whisper's head dim from one frame to the most one stage holds
# (3072), and the other head dims: hd=16 is one run of K rows, hd=128 at
# F=131 one run of all 128 rows, 8 per warp in P.V
@pytest.mark.parametrize("frames,hd", [(f, 64) for f in (
    1, 17, 131, 384, 1500, 3072)] + [(f, hd) for hd in (16, 32, 128)
                                     for f in (131, 1500)])
def test_cross_attention_int8_kernel(cuda, frames, hd):
    q, k8, k_s, v8, v_s = _int8_inputs(cuda, frames, hd)
    before = _lib.launch_counts()["cross_attn_int8"]
    got = cross_attn_cuda.cross_attn_step_int8(q, k8, k_s, v8, v_s,
                                               k_scale=0.35)
    assert _lib.launch_counts()["cross_attn_int8"] == before + 1
    want = cross_attn_cuda.cross_attn_step_int8_plain(q, k8, k_s, v8, v_s,
                                                      k_scale=0.35)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_cross_attention_int8_refuses_more_than_one_stage(cuda):
    with pytest.raises(ValueError, match="3072"):
        cross_attn_cuda.cross_attn_step_int8(*_int8_inputs(cuda, 3073, 64),
                                             k_scale=0.35)


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
@pytest.mark.parametrize("frames,hd", [(f, 64) for f in (
    1, 131, 300, 384, 1500, 2100)] + [(f, hd) for hd in (16, 32, 128)
                                      for f in (131, 2100)])
def test_cross_attention_float_kernel(cuda, dtype, frames, hd):
    """F=2100 gives bf16 and f32 blocks more frames than one stage holds, so
    they walk the frames in chunks (f32 from F=513 on)."""
    rng = np.random.default_rng(frames + hd)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(cuda, dtype) for shape in
        ((4, 2, 1, hd), (4, 2, hd, frames), (4, 2, hd, frames)))
    before = _lib.launch_counts()["cross_attn"]
    got = cross_attn_cuda.cross_attn_step(q, k, v, k_scale=0.35)
    assert _lib.launch_counts()["cross_attn"] == before + 1
    want = cross_attn_cuda.cross_attn_step_plain(q, k, v, k_scale=0.35)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def _mel_audio(n, seed):
    """Four items: noise, a tone in noise that falls silent halfway, silence
    with a loud tail (the item's maximum in its last tile), all zeros."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    audio = rng.normal(0, 0.1, (4, n)).astype(np.float32)
    audio[1] += 0.4 * np.sin(2 * np.pi * 440 * t).astype(np.float32)
    audio[1, n // 2:] = 0.0
    audio[2, : n - min(n // 4, 3000)] = 0.0
    audio[2] *= 4.0
    audio[3] = 0.0
    return audio


# one frame; the reflect at both ends inside one tile; n_samples not a
# multiple of 160 (nor of 4); 3 s; 30 s, the main path's window
MEL_LENGTHS = [201, 359, 400, 24000, 24159, 48000, 480000]


@pytest.mark.parametrize("n", MEL_LENGTHS)
@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_kernels(cuda, n_mels, n):
    audio = torch.from_numpy(_mel_audio(n, n_mels + n)).to(cuda)
    before = _lib.launch_counts()
    got = mel_cuda.log_mel(audio, n_mels)
    after = _lib.launch_counts()
    assert {k: after[k] - before[k] for k in after} == dict(
        dict.fromkeys(after, 0), mel=1, mel_clip=1)
    want = mel_cuda.log_mel_plain(audio, n_mels)
    assert got.shape == (4, n_mels, n // 160)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_kernels_on_an_unaligned_item_start(cuda, n_mels):
    """Rows of 24001 samples: every other item starts off a 16-byte
    boundary, so its interior tiles load one sample at a time."""
    audio = torch.from_numpy(_mel_audio(24001, 3)).to(cuda)
    got = mel_cuda.log_mel(audio, n_mels)
    want = mel_cuda.log_mel_plain(audio, n_mels)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("n", [359, 24159, 480000])
@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_clip_kernel_bit_equal(cuda, n_mels, n):
    """The clip kernel alone on the plain log10 spectrum and its 64-frame
    tile maxima taken in PyTorch: bit-equal to ``clip_and_scale``."""
    audio = torch.from_numpy(_mel_audio(n, n_mels)).to(cuda)
    log_spec = mel_cuda.log10_mel_plain(audio, n_mels).contiguous()
    n_frames = log_spec.shape[-1]
    n_tiles = -(-n_frames // mel_cuda.TILE_FRAMES)
    padded = torch.nn.functional.pad(
        log_spec, (0, n_tiles * mel_cuda.TILE_FRAMES - n_frames),
        value=-float("inf"))
    tile_max = padded.reshape(4, n_mels, n_tiles, -1).amax(dim=(1, 3))
    before = _lib.launch_counts()["mel_clip"]
    got = mel_cuda.mel_clip(log_spec.clone(), tile_max.contiguous())
    assert _lib.launch_counts()["mel_clip"] == before + 1
    assert torch.equal(got, mel_cuda.clip_and_scale(log_spec))


def test_mel_kernel_refuses_more_than_128_mels(cuda):
    with pytest.raises(ValueError, match="n_mels=129"):
        mel_cuda.log_mel(torch.zeros((1, 4000), device=cuda), n_mels=129)


# the median network's widths, then rank selection's (any odd width above)
@pytest.mark.parametrize("width", [1, 3, 7, 15, 17, 31, 33, 101])
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


@pytest.mark.parametrize("width", [3, 31, 33, 101])
def test_qkpost_kernel_on_tied_logits(cuda, width):
    """Logits of three values: most windows hold ties at their median, and
    items at frame_len w/2 (passed through) and w/2 + 1 (filtered)."""
    rng = np.random.default_rng(100 + width)
    qk = torch.from_numpy(rng.integers(-1, 2, (4, 2, 5, 257)).astype(
        np.float32)).to(cuda)
    fl = torch.tensor([width // 2, width // 2 + 1, 200, 257],
                      dtype=torch.int32, device=cuda)
    tl = torch.tensor([5, 5, 3, 5], dtype=torch.int32, device=cuda)
    name = "qkpost" if width <= qkpost_cuda.NET_WIDTH else "qkpost_rank"
    before = _lib.launch_counts()
    got = qkpost_cuda.qk_postprocess(qk, fl, tl, width)
    after = _lib.launch_counts()
    assert after.pop(name) == before.pop(name) + 1 and after == before
    want = qkpost_cuda.qk_postprocess_plain(qk, fl, tl, width)
    assert (got - want).abs().max().item() <= 1e-6


def _dtw_lengths(n, m, rng):
    """(n, m) per item: the full grid, the pad row (n < 0), n = 0, m = 1,
    one frame, walks whose n + m - 1 diagonals end one before, at and one
    after a backtrace window edge (where M allows), and a random length."""
    w = dtw_cuda.backtrace_window(n)
    pairs = [(n, m), (-2, m), (0, m), (n, 1), (1, 1)]
    for k in (1, 2):
        for e in (-1, 0, 1):
            if 1 <= k * w + e + 1 - n <= m:
                pairs.append((n, k * w + e + 1 - n))
    pairs.append((int(rng.integers(1, n + 1)), int(rng.integers(1, m + 1))))
    return pairs


# (N + 1, M): the wavefront's warp edges (a warp of 32 rows, one per lane,
# up to 256 rows; 449 = the decoder's 448-token context, at 2 rows per
# lane) by M = 1, 2, 90 and 1501 (rows off a 16-byte boundary) and 1500;
# the edges of 2 rows per lane (257) and of 8 (1025), and 4096 rows, the
# kernel's limit; then the smoke's (16, 120, 1500) and the main path's
# N = 93 at M = 1500
_DTW_SHAPES = [(n1, m) for n1 in (2, 32, 33, 64, 65, 128, 129, 449)
               for m in (1, 2, 90, 1500, 1501)] + [
    (256, 90), (257, 90), (1024, 7), (1025, 90), (4096, 3), (121, 1500),
    (94, 1500)]


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("n1,m", _DTW_SHAPES)
def test_dtw_kernels_bit_equal(cuda, tied, n1, m):
    n = n1 - 1
    rng = np.random.default_rng(n1 * 3 + m + int(tied))
    n_len, m_len = zip(*_dtw_lengths(n, m, rng))
    b = len(n_len)
    x = (-rng.integers(0, 3, (b, n, m)) if tied
         else rng.normal(size=(b, n, m))).astype(np.float32)
    x = torch.from_numpy(x).to(cuda)
    n_len, m_len = (torch.tensor(v, dtype=torch.int32, device=cuda)
                    for v in (n_len, m_len))
    before = _lib.launch_counts()
    tr = dtw_cuda.dtw_trace(x)
    jf = dtw_cuda.dtw_backtrace_jump(tr, n_len, m_len)
    after = _lib.launch_counts()
    assert (after["dtw_trace"] - before["dtw_trace"],
            after["dtw_backtrace"] - before["dtw_backtrace"]) == (1, 1)
    tr_ref = dtw_cuda.dtw_trace_plain(x)
    assert torch.equal(tr, tr_ref)
    assert torch.equal(jf, dtw_cuda.dtw_jump_frames_plain(tr_ref, n_len,
                                                          m_len))


def test_dtw_kernels_refuse_what_they_do_not_take(cuda):
    with pytest.raises(ValueError, match="rows"):
        dtw_cuda.dtw_trace(torch.zeros((1, dtw_cuda._MAX_ROWS + 1, 2),
                                       device=cuda))
    buf = torch.full((3 * 5 + 1,), 2, dtype=torch.int8, device=cuda)
    tr = buf[1:].view(1, 3, 5)  # contiguous, 1 byte past a boundary
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="boundary"):
        dtw_cuda.dtw_backtrace_jump(tr, one, one)


@pytest.mark.parametrize("mode,kw", [
    ("xla", {}), ("kernel", dict(kv_int8=True, kv_frames=32)),
    ("mxu", dict(kv_int8=True, kv_frames=32)),
    ("kernel", dict(kv_int8_guard=1e9, kv_frames=32, kv_frames_guard=0.0))])
def test_graphed_decode_equals_the_eager_loop(cuda, mode, kw, monkeypatch):
    """The greedy loop replayed as a CUDA graph against the same loop run
    eagerly on the card, bit for bit, in each decode mode (the last: the
    guarded pair, every row re-decoded); the kernel's launches counted
    exactly under replay (layers x (warm-up + replayed steps))."""
    from whisper_char_alignment_tpu_torch.config import tiny_test_dims
    from whisper_char_alignment_tpu_torch.models import decode_graph, decoding
    from whisper_char_alignment_tpu_torch.text.tokenizer import \
        get_test_tokenizer

    tok = get_test_tokenizer()
    dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=40, n_text_ctx=48,
                          state=128, head=2, layers=2)  # head_dim 64
    gen = torch.Generator().manual_seed(4)
    model = tw.cast_params(tw.init_params(tw.Whisper(dims, device="cpu"),
                                          gen), torch.float32, cuda)
    mel = torch.randn((4, dims.n_mels, 80), generator=gen).to(cuda)
    opts = decoding.DecodingOptions(language="en", sample_len=16)
    monkeypatch.setenv("WCA_CROSS_ATTN", {"xla": "xla", "kernel": "pallas",
                                          "mxu": "mxu"}[mode])
    loop, int8_steps = decode_graph.graphed_loop, []

    def counted(*args, **kwargs):  # the steps of loops over int8 K/V
        before = decode_graph.replay_record()
        out = loop(*args, **kwargs)
        after = decode_graph.replay_record()
        if isinstance(out[4][0], tuple):
            int8_steps.append(sum(after[k] - before[k]
                                  for k in ("warmup_steps", "steps")))
        return out

    monkeypatch.setattr(decode_graph, "graphed_loop", counted)
    decode_graph.reset_record()
    before = _lib.launch_counts()["cross_attn_int8"]
    graphed = decoding.decode(model, tok, mel, opts, **kw)
    record = decode_graph.replay_record()
    launched = _lib.launch_counts()["cross_attn_int8"] - before
    assert record["captures"] >= 1 and record["replays"] >= 1
    want = dims.n_text_layer * sum(int8_steps) if mode == "kernel" else 0
    assert launched == want and (mode != "kernel" or want > 0)
    monkeypatch.setattr(decoding, "_loop_for",
                        lambda dev: decoding._decode_loop)
    eager = decoding.decode(model, tok, mel, opts, **kw)
    for a, b in zip(graphed, eager):
        assert (a.tokens, a.n_steps, a.avg_logprob, a.no_speech_prob) == (
            b.tokens, b.n_steps, b.avg_logprob, b.no_speech_prob)
        assert a.min_margin == b.min_margin or (
            np.isnan(a.min_margin) and np.isnan(b.min_margin))


def _tiny_decoder_model(cuda, seed, state=128, layers=2):
    from whisper_char_alignment_tpu_torch.config import tiny_test_dims
    from whisper_char_alignment_tpu_torch.text.tokenizer import \
        get_test_tokenizer

    tok = get_test_tokenizer()
    dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=40, n_text_ctx=48,
                          state=state, head=2, layers=layers)
    gen = torch.Generator().manual_seed(seed)
    model = tw.cast_params(tw.init_params(tw.Whisper(dims, device="cpu"),
                                          gen), torch.float32, cuda)
    mel = torch.randn((4, dims.n_mels, 80), generator=gen).to(cuda)
    return tok, model, mel


def _same_results(graphed, eager):
    for a, b in zip(graphed, eager):
        assert (a.tokens, a.n_steps, a.avg_logprob, a.no_speech_prob,
                a.language) == (b.tokens, b.n_steps, b.avg_logprob,
                                b.no_speech_prob, b.language)


@pytest.mark.parametrize("opts", [
    dict(beam_size=5, patience=2.0), dict(beam_size=5, length_penalty=0.6,
                                          without_timestamps=True),
    dict(beam_size=2, language=None, prompt="alpha", prefix=[5]),
    dict(temperature=0.7, best_of=5), dict(temperature=1.0, best_of=5)])
def test_graphed_beam_and_sampling_equal_the_eager_loops(cuda, opts,
                                                         monkeypatch):
    """Beam search and sampling replayed as CUDA graphs against the same
    loops run eagerly on the card, bit for bit (sampling: the same
    generator seed, so the same noise); both temperatures replay one
    graph."""
    from whisper_char_alignment_tpu_torch.models import decode_graph, decoding

    tok, model, mel = _tiny_decoder_model(cuda, 5)
    kw = dict(dict(language="en", sample_len=16), **opts)
    o = decoding.DecodingOptions(**kw)
    decode_graph.reset_record()
    graphed = decoding.decode(model, tok, mel, o)
    record = decode_graph.replay_record()
    assert record["captures"] == 1 and record["replays"] >= 1
    if "temperature" in opts:
        other = dict(kw, temperature=1.7 - opts["temperature"])
        decoding.decode(model, tok, mel, decoding.DecodingOptions(**other))
        assert decode_graph.replay_record()["captures"] == 1
    monkeypatch.setattr(decoding, "runner_for",
                        lambda dev: decoding.run_eager)
    eager = decoding.decode(model, tok, mel, o)
    _same_results(graphed, eager)


def test_graphed_speculative_equals_the_eager_rounds(cuda, monkeypatch):
    """The speculative rounds replayed as a CUDA graph against the same
    rounds run eagerly on the card, bit for bit, with a smaller draft and
    with the target drafting for itself."""
    from whisper_char_alignment_tpu_torch.models import decode_graph, decoding

    tok, model, mel = _tiny_decoder_model(cuda, 6)
    _, draft, _ = _tiny_decoder_model(cuda, 7, state=64, layers=1)
    o = decoding.DecodingOptions(language="en", sample_len=24)
    for d in (draft, model):
        decode_graph.reset_record()
        graphed = decoding.decode_speculative(model, d, tok, mel[0], o,
                                              draft_k=3, return_info=True)
        assert decode_graph.replay_record()["captures"] == 1
        with monkeypatch.context() as mp:
            mp.setattr(decoding, "runner_for",
                       lambda dev: decoding.run_eager)
            eager = decoding.decode_speculative(model, d, tok, mel[0], o,
                                                draft_k=3, return_info=True)
        assert graphed[1] == eager[1]
        _same_results([graphed[0]], [eager[0]])


def _long_audio(windows, dims, seed):
    n = int(windows * 2 * dims.n_audio_ctx * 160)
    return (np.random.default_rng(seed).normal(0, 0.1, n)
            .astype(np.float32))


@pytest.mark.parametrize("aggr", ["default", "topk"])
def test_graphed_transcribe_equals_the_eager_loops(cuda, aggr, monkeypatch):
    """Long-form ``transcribe`` on the card (three windows, the whole
    fallback ladder, which random weights climb, conditioning on previous
    text, ``language=None`` and word timestamps) with every decode replayed
    as a CUDA graph, against the same run with the eager loops: the result
    dicts are equal, floats bit for bit. The kernels' launches are exact:
    the encoder once per request and per word-timing capture, the QK
    post-process per layer and one DTW per capture."""
    from whisper_char_alignment_tpu_torch import transcribe as T
    from whisper_char_alignment_tpu_torch.align import timing
    from whisper_char_alignment_tpu_torch.models import decode_graph, decoding

    tok, model, _ = _tiny_decoder_model(cuda, 8)
    audio = _long_audio(2.4, model.dims, 8)
    kwargs = dict(language=None, sample_len=12, word_timestamps=True,
                  word_aggr=aggr)
    requests, captures = [], []
    execute, attentions = T._execute_request, timing.get_attentions

    def counted_request(model_, tok_, req, device=None):
        requests.append(req["kind"])
        return execute(model_, tok_, req, device)

    def counted_attentions(*a, **kw):
        captures.append(1)
        return attentions(*a, **kw)

    monkeypatch.setattr(T, "_execute_request", counted_request)
    monkeypatch.setattr(timing, "get_attentions", counted_attentions)
    decode_graph.reset_record()
    _lib.reset_launches()
    graphed = T.transcribe(model, tok, audio, **kwargs)
    counts = _lib.launch_counts()
    record = decode_graph.replay_record()
    dims = model.dims
    want = dict.fromkeys(counts, 0)
    want.update(encoder_attn=dims.n_audio_layer * (len(requests)
                                                   + len(captures)),
                qkpost=dims.n_text_layer * len(captures),
                dtw_trace=len(captures), dtw_backtrace=len(captures))
    assert counts == want
    assert requests[0] == "detect" and len(captures) >= 1
    assert record["captures"] >= 2 and record["replays"] > 0
    assert any(s["temperature"] > 0 for s in graphed["segments"])
    monkeypatch.setattr(decoding, "_loop_for",
                        lambda dev: decoding._decode_loop)
    monkeypatch.setattr(decoding, "runner_for",
                        lambda dev: decoding.run_eager)
    eager = T.transcribe(model, tok, audio, **kwargs)
    assert graphed == eager


def test_transcribe_batched_equals_solo_on_the_card(cuda):
    """``transcribe_batched`` of three audios (one batched decode of 4 rows
    a round) against each audio's solo ``transcribe`` on the card: tokens,
    texts and times equal, float fields within 1e-5 (the batched decode's
    matrix products run at another row count)."""
    from whisper_char_alignment_tpu_torch import transcribe as T

    tok, model, _ = _tiny_decoder_model(cuda, 9)
    audios = [_long_audio(w, model.dims, 20 + k)
              for k, w in enumerate((0.7, 1.6, 2.2))]
    kwargs = dict(language="en", sample_len=10, temperature=0.0,
                  condition_on_previous_text=False, word_timestamps=True)
    batched = T.transcribe_batched(model, tok, audios, **kwargs)
    for audio, b in zip(audios, batched):
        s = T.transcribe(model, tok, audio, **kwargs)
        assert (s["text"], s["language"]) == (b["text"], b["language"])
        assert len(s["segments"]) == len(b["segments"])
        for x, y in zip(s["segments"], b["segments"]):
            for k in ("id", "seek", "start", "end", "text", "tokens",
                      "temperature"):
                assert x[k] == y[k], k
            for k in ("avg_logprob", "compression_ratio", "no_speech_prob"):
                assert x[k] == pytest.approx(y[k], abs=1e-5), k


def test_serve_round_trip_on_the_card(cuda, tmp_path):
    """``serve`` on the card: /healthz; /align requests posted together
    share a batch and each equals the same request posted alone;
    /transcribe equals the solo ``api.transcribe`` on the card."""
    import json
    import threading
    import urllib.request

    from whisper_char_alignment_tpu_torch import api
    from whisper_char_alignment_tpu_torch.audio.resample import \
        load_resampled_bytes
    from whisper_char_alignment_tpu_torch.audio.wav import save as wav_save
    from whisper_char_alignment_tpu_torch.cli.serve import serve

    tok, net, _ = _tiny_decoder_model(cuda, 10)
    model = api.Model(model=net, tokenizer=tok, name="test")
    srv = serve(model, port=0, batch_size=4, linger_ms=200.0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def post(route, body):
        req = urllib.request.Request(f"{url}/{route}", data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            return json.loads(r.read())

    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            assert json.loads(r.read()) == {"ok": True, "model": "test"}
        bodies = []
        for k in range(3):
            path = str(tmp_path / f"a{k}.wav")
            wav_save(path, _long_audio(0.5 + 0.2 * k, net.dims, 30 + k),
                     16000)
            with open(path, "rb") as f:
                bodies.append(f.read())
        solo = [post("align?topk=3", b) for b in bodies]
        outs = [None] * 3
        launches = srv.batcher.n_launches
        threads = [threading.Thread(
            target=lambda k=k: outs.__setitem__(k, post("align?topk=3",
                                                         bodies[k])))
            for k in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        assert outs == solo and srv.batcher.n_launches - launches < 3
        out = post("transcribe?language=en&sample_len=8", bodies[2])
        want = api.transcribe(model, load_resampled_bytes(bodies[2]),
                              language="en", sample_len=8)
        assert out == json.loads(json.dumps(want))
    finally:
        srv.shutdown()
        srv.batcher.close()
        srv.tbatcher.close()
        t.join(timeout=60)


# (M, K, N): Whisper-medium's six linear shapes at one window, tiny ones, a
# short M (the int8 product pads it to 17), and the widest row the quantize
# kernel holds
_INT8_CASES = [(1500, 1024, 1024), (1500, 1024, 4096), (1500, 4096, 1024),
               (40, 32, 16), (9, 16, 8), (64, 8192, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", _INT8_CASES)
def test_int8_kernels_bit_equal(cuda, dtype, m, k, n):
    """Both int8 passes bit-equal to their plain versions (a zero row takes
    scale 1; a row max given from elsewhere, as a row-split layer passes
    it), one launch each; the int8 product exact."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = (torch.randn(m, k, device=cuda, generator=g) * 3).to(dtype)
    x[m // 2] = 0
    before = _lib.launch_counts()
    codes, scales = int8_cuda.quantize_rows(x)
    after = _lib.launch_counts()
    assert after["int8_quant"] == before["int8_quant"] + 1
    want = int8_cuda.quantize_rows_plain(x)
    assert torch.equal(codes, want[0]) and torch.equal(scales, want[1])
    amax = x.float().abs().amax(dim=-1, keepdim=True) * 1.5
    got = int8_cuda.quantize_rows(x, amax)
    want = int8_cuda.quantize_rows_plain(x, amax)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    w8 = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=cuda,
                       generator=g)
    y = int8_cuda.int_mm(codes, w8)
    assert torch.equal(y.double(), codes.double() @ w8.double().t())
    s = torch.rand(n, device=cuda, generator=g) * 1e-2
    for bias in (None, torch.randn(n, device=cuda, generator=g).to(dtype)):
        n0 = _lib.launch_counts()["int8_dequant"]
        got = int8_cuda.dequantize(y, scales, s, bias, dtype)
        assert _lib.launch_counts()["int8_dequant"] == n0 + 1
        assert torch.equal(got, int8_cuda.dequantize_plain(y, scales, s,
                                                           bias, dtype))


def test_int8_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(32, 12, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        int8_cuda.quantize_rows(x)
    with pytest.raises(ValueError, match="multiples of 8"):
        int8_cuda.quantize_rows(torch.zeros(32, 8200, device=cuda))
    with pytest.raises(ValueError, match="float32"):
        int8_cuda.quantize_rows(x.to(torch.float16)[:, :8])
    y = torch.zeros(32, 6, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiples of 4"):
        int8_cuda.dequantize(y, torch.ones(32, 1, device=cuda),
                             torch.ones(6, device=cuda), None, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_encoder_on_the_card(cuda, dtype):
    """The int8 encoder's states on the card equal its plain linears' (the
    kernels swapped for their plain versions), and each encoder run
    launches each pass 6 times a layer."""
    from whisper_char_alignment_tpu_torch.config import tiny_test_dims

    dims = tiny_test_dims(n_vocab=64, n_audio_ctx=64, n_text_ctx=16,
                          state=64, head=2, layers=2)
    model = tw.init_params(tw.Whisper(dims, device="cpu"),
                           torch.Generator().manual_seed(0))
    q = tw.cast_params(tw.quantize_encoder_int8(model), dtype, cuda)
    mel = torch.randn(3, dims.n_mels, 2 * dims.n_audio_ctx,
                      generator=torch.Generator().manual_seed(1)).to(cuda)
    before = _lib.launch_counts()
    got = tw.encode_audio(q, mel)
    after = _lib.launch_counts()
    for name in ("int8_quant", "int8_dequant"):
        assert after[name] - before[name] == 6 * dims.n_audio_layer
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(int8_cuda, "quantize_rows",
                   int8_cuda.quantize_rows_plain)
        mp.setattr(int8_cuda, "dequantize", int8_cuda.dequantize_plain)
        want = tw.encode_audio(q, mel)
    assert torch.equal(got, want)
