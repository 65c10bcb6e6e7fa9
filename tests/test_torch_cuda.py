"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked ``gpu``: each test skips, with its reason, where no card is present
(run them on the card with ``python -m pytest tests/test_torch_cuda.py -q``).
``chip_smoke.py`` holds the same kernels at the main path's full shapes."""

import numpy as np
import pytest
import torch

from whisper_char_alignment_tpu_torch.models import whisper as tw
from whisper_char_alignment_tpu_torch.ops import (_lib, cross_attn_cuda,
                                                  dec_attn_cuda, dtw_cuda,
                                                  encoder_attn_cuda,
                                                  int8_cuda, mel_cuda,
                                                  qkpost_cuda,
                                                  rows_linear_cuda)

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


def _qkpost_lengths(width, f, t):
    """(frame_len, token_len) per item: one frame; w/2 (passed through) and
    w/2 + 1 (the first filtered length); frame lengths where the last lane's
    run of ceil(fl/32) columns, made odd, ends before the warp's end (31),
    fills every lane with one column (32), ends at a run's last column (33:
    11 runs of 3), holds one column (34) and two (97: 19 runs of 5 and 2);
    F - 1 and F. token_len T, 1 and values between."""
    fl = [1, max(width // 2, 1), width // 2 + 1, 31, 32, 33, 34, 97, f - 1,
          f]
    tl = [t, 1, t, 3, 1, t, 2, t - 1, t, 1]
    return ([min(max(v, 1), f) for v in fl], tl)


def _qkpost_case(cuda, width, qk, scale):
    b, _, t, f = qk.shape
    fl, tl = _qkpost_lengths(width, f, t)
    fl = torch.tensor(fl[:b], dtype=torch.int32, device=cuda)
    tl = torch.tensor(tl[:b], dtype=torch.int32, device=cuda)
    name = "qkpost" if width <= qkpost_cuda.EXACT_WIDTH else "qkpost_rank"
    before = _lib.launch_counts()
    got = qkpost_cuda.qk_postprocess(qk, fl, tl, width, scale)
    after = _lib.launch_counts()
    assert after.pop(name) == before.pop(name) + 1 and after == before
    want = qkpost_cuda.qk_postprocess_plain(qk, fl, tl, width, scale)
    assert (got - want).abs().max().item() <= 1e-6


# widths of the exact register windows (31 the widest), of the padded ones
# (33 and 39 in a capacity of 40, 41 in 48, 101 in 112, 127 in 128) and of
# the shared-memory window (129 and above); F = 300 and 1500 (rows on 16-byte
# boundaries: 300 floats is 75 vectors), 257 and 1501 (rows that start off
# one, so each row's copy and stores take a 4-byte head and tail)
@pytest.mark.parametrize("f", [300, 257, 1500, 1501])
@pytest.mark.parametrize("width", [1, 3, 7, 9, 15, 17, 31, 33, 39, 41,
                                   101, 127, 129])
def test_qkpost_kernel(cuda, width, f):
    rng = np.random.default_rng(width * 7 + f)
    qk = torch.from_numpy(rng.normal(0, 2, (10, 2, 9, f)).astype(
        np.float32)).to(cuda)
    _qkpost_case(cuda, width, qk, 0.5)


@pytest.mark.parametrize("f", [257, 1501])
@pytest.mark.parametrize("width", [3, 31, 33, 101, 129])
def test_qkpost_kernel_on_tied_logits(cuda, width, f):
    """Logits of three values: most windows hold ties at their median,
    which the sliding window deletes one copy of at a time."""
    rng = np.random.default_rng(100 + width + f)
    qk = torch.from_numpy(rng.integers(-1, 2, (10, 2, 5, f)).astype(
        np.float32)).to(cuda)
    _qkpost_case(cuda, width, qk, 1.0)


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
    # the decoder's attention and linears run in every decode and capture;
    # some of the attention's calls stage an odd-length cache unaligned
    assert counts["dec_attn"] > 0 and counts["rows_linear"] > 0
    assert counts["dec_attn_unaligned"] <= counts["dec_attn"]
    want.update(dec_attn=counts["dec_attn"],
                dec_attn_unaligned=counts["dec_attn_unaligned"],
                rows_linear=counts["rows_linear"])
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
    texts, times and float fields equal, bit for bit (the decoder's rows do
    not depend on the batch: ``dec_attn``, ``rows_linear``)."""
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
                assert x[k] == y[k], k


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_and_qk_to_attention_on_the_card(cuda, dtype):
    """``forward`` launches the encoder kernel once a layer, the decoder's
    attention twice a layer, its linears ten times a layer and once for the
    lm head, and the QK post-process never; ``qk_to_attention`` of its raw
    QK launches the post-process once a layer, equal to its plain version
    on the same QK within 1e-6, and equal, bit for bit, to
    ``decode_text``'s in-layer post-process on the same tokens and encoder
    states."""
    from whisper_char_alignment_tpu_torch.config import tiny_test_dims

    dims = tiny_test_dims(n_vocab=64, n_audio_ctx=64, n_text_ctx=16,
                          state=64, head=2, layers=3)
    model = tw.cast_params(
        tw.init_params(tw.Whisper(dims, device="cpu"),
                       torch.Generator().manual_seed(0)), dtype, cuda)
    gen = torch.Generator().manual_seed(1)
    mel = torch.randn(2, dims.n_mels, 2 * dims.n_audio_ctx,
                      generator=gen).to(cuda)
    tokens = torch.randint(0, dims.n_vocab, (2, 9), generator=gen).to(cuda)
    frame_len = torch.tensor([64, 21], dtype=torch.int32, device=cuda)
    token_len = torch.tensor([9, 5], dtype=torch.int32, device=cuda)
    _lib.reset_launches()
    logits, qk = tw.forward(model, mel, tokens)
    counts = _lib.launch_counts()
    assert counts["encoder_attn"] == dims.n_audio_layer
    assert counts["dec_attn"] == 2 * dims.n_text_layer
    assert counts["rows_linear"] == 10 * dims.n_text_layer + 1
    assert sum(counts.values()) == (dims.n_audio_layer
                                    + 12 * dims.n_text_layer + 1)
    assert logits.dtype == qk.dtype == torch.float32
    attn = [tw.qk_to_attention(qk[i], frame_len, token_len, 7, 1.3)
            for i in range(dims.n_text_layer)]
    assert _lib.launch_counts()["qkpost"] == dims.n_text_layer
    for i, a in enumerate(attn):
        want = qkpost_cuda.qk_postprocess_plain(qk[i], frame_len, token_len,
                                                7, 1.3)
        assert (a - want).abs().max().item() <= 1e-6
    xa = tw.encode_audio(model, mel)
    _, stack = tw.decode_text(model, tokens, xa, medfilt_width=7,
                              frame_len=frame_len, token_len=token_len,
                              qk_scale=1.3, return_logits=False)
    assert torch.equal(stack, torch.stack(attn))


def test_a_pipeline_on_the_card_keeps_the_callers_model(cuda):
    """A model already in the compute dtype on the card is the pipeline's
    own module, not a copy: ``api.align`` and every pipeline of a server
    share its decode graphs (``cast_params`` with ``cuda`` unindexed)."""
    from whisper_char_alignment_tpu_torch.config import (AlignConfig,
                                                         tiny_test_dims)
    from whisper_char_alignment_tpu_torch.runner import AlignmentPipeline
    from whisper_char_alignment_tpu_torch.text.tokenizer import \
        get_test_tokenizer

    tok = get_test_tokenizer()
    dims = tiny_test_dims(n_vocab=tok.n_vocab, n_audio_ctx=32, n_text_ctx=24,
                          state=16, head=2, layers=2)
    model = tw.init_params(tw.Whisper(dims, device=cuda),
                           torch.Generator(device=cuda).manual_seed(0))
    assert tw.cast_params(model, torch.float32, "cuda") is model
    assert AlignmentPipeline(model, tok, AlignConfig()).model is model
    copy = tw.cast_params(model, torch.bfloat16, "cuda")
    assert copy is not model and copy.device == model.device


# -- the decoder's row-invariant kernels --------------------------------------

def _bits_equal(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int16 if a.element_size() == 2
                            else torch.int32),
        b.contiguous().view(torch.int16 if b.element_size() == 2
                            else torch.int32))


def _attn_inputs(cuda, b, h, p, s, hd, kv_dtype, dtype, layout, seed):
    """q (B, H, P, hd) in the compute dtype; K/V (B, H, hd, S) as the cache
    stores them ("cache") or transposed views of (B, H, S, hd) projections
    ("proj", ``_qkv_attention``'s); the position mask of P rows ending 3
    columns before S (causal from 0 when P is within 3 of S)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = (torch.randn((b, p, h, hd), generator=g, device=cuda)
         * hd ** -0.25).to(dtype).transpose(1, 2)
    if layout == "cache":
        k, v = (torch.randn((b, h, hd, s), generator=g, device=cuda)
                .to(kv_dtype) for _ in range(2))
    else:
        k, v = (torch.randn((b, h, s, hd), generator=g, device=cuda)
                .to(kv_dtype).transpose(-1, -2) for _ in range(2))
    start = max(0, s - 3 - p)
    mask = tw._position_mask(torch.arange(start, start + p, device=cuda), s)
    return q, k, v, mask


@pytest.mark.parametrize("dtype,kv_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32)])
@pytest.mark.parametrize("b,h,p,s,hd,layout,masked,scaled", [
    (8, 16, 1, 448, 64, "cache", True, True),
    (8, 16, 5, 448, 64, "cache", True, True),
    (8, 16, 1, 1500, 64, "cache", False, True),
    (2, 4, 37, 1500, 64, "proj", False, False),
    (2, 4, 37, 37, 64, "proj", True, False),
    (1, 2, 9, 131, 16, "cache", True, True),
    (1, 2, 3, 300, 128, "cache", True, True),
    (1, 2, 4, 64, 8, "cache", True, True),
    # B=1 cross step; key counts at a 128-key chunk's edges and past 1500
    (1, 16, 1, 1500, 64, "cache", False, True),
    (2, 4, 3, 127, 64, "cache", True, True),
    (2, 4, 3, 128, 64, "cache", True, True),
    (2, 4, 3, 129, 64, "proj", True, False),
    (2, 4, 1, 1540, 64, "cache", False, True),
    # the capture: cross over projections and over the decode's K/V, self
    (8, 16, 96, 1500, 64, "proj", False, False),
    (8, 16, 96, 1500, 64, "cache", False, True),
    (2, 4, 96, 96, 64, "proj", True, False),
    # head dims 8, 16, 128, 256 in both layouts
    (1, 2, 4, 64, 8, "proj", True, False),
    (1, 2, 17, 200, 16, "proj", True, False),
    (1, 2, 5, 129, 128, "proj", False, False),
    (1, 2, 5, 300, 256, "cache", True, True),
    (1, 2, 5, 300, 256, "proj", True, False),
    # caches an odd number of columns long, staged unaligned: the
    # benchmark's self steps (35, 99) and long form's (227, two chunks)
    (32, 16, 1, 35, 64, "cache", True, True),
    (16, 16, 1, 99, 64, "cache", True, True),
    (8, 16, 1, 227, 64, "cache", True, True)])
def test_dec_attn_kernel(cuda, dtype, kv_dtype, b, h, p, s, hd, layout,
                         masked, scaled):
    """The decoder attention against its plain version (the port's
    ``_attend``) on the card: f32 scores within 1e-5 (sums over hd in
    another order); the output within 2e-5 in float32 and 2e-2 in bf16 (a
    weight's bf16 rounding can fall the other way)."""
    q, k, v, mask = _attn_inputs(cuda, b, h, p, s, hd, kv_dtype, dtype,
                                 layout, b * p + s + hd)
    mask = mask if masked else None
    scale = hd ** -0.25 if scaled else None
    before = _lib.launch_counts()["dec_attn"]
    got, sc = dec_attn_cuda.dec_attn(q, k, v, dtype=dtype, mask=mask,
                                     k_scale=scale, scores=True)
    assert _lib.launch_counts()["dec_attn"] == before + 1
    want, want_sc = dec_attn_cuda.dec_attn_plain(q, k, v, dtype=dtype,
                                                 mask=mask, k_scale=scale)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(sc, want_sc, rtol=1e-5, atol=1e-5)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    no_scores = dec_attn_cuda.dec_attn(q, k, v, dtype=dtype, mask=mask,
                                       k_scale=scale)
    assert no_scores[1] is None and _bits_equal(no_scores[0], got)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("p", [1, 3])
@pytest.mark.parametrize("s", [35, 99, 227])
def test_dec_attn_an_odd_cache_equals_its_aligned_copy(cuda, dtype, p, s):
    """A contiguous (B, H, hd, S) cache of an odd length S, whose bf16 rows
    no 4-byte piece keeps aligned, gives the output and scores, bit for
    bit, of the same values held as the first S columns of a wider buffer
    whose rows are 16-byte aligned; only the first call counts
    ``dec_attn_unaligned`` (bf16), and a projection's layout never does."""
    b, h, hd = 4, 4, 64
    q, k, v, mask = _attn_inputs(cuda, b, h, p, s, hd, dtype, dtype, "cache",
                                 s + p)
    wide = -(-s // 8) * 8 + 8

    def aligned(t):
        buf = torch.randn((b, h, hd, wide), device=cuda).to(dtype)
        buf[..., :s] = t
        return buf[..., :s]

    def run(kk, vv):
        before = _lib.launch_counts()
        got = dec_attn_cuda.dec_attn(q, kk, vv, dtype=dtype, mask=mask,
                                     k_scale=hd ** -0.25, scores=True)
        after = _lib.launch_counts()
        return got, {n: after[n] - before[n]
                     for n in ("dec_attn", "dec_attn_unaligned")}

    (out, sc), counted = run(k, v)
    assert counted == dict(dec_attn=1,
                           dec_attn_unaligned=int(dtype == torch.bfloat16))
    (want, want_sc), counted = run(aligned(k), aligned(v))
    assert counted == dict(dec_attn=1, dec_attn_unaligned=0)
    assert _bits_equal(out, want) and _bits_equal(sc, want_sc)
    proj = [t.transpose(-1, -2).contiguous().transpose(-1, -2)
            for t in (k, v)]
    (got, _), counted = run(*proj)
    assert counted == dict(dec_attn=1, dec_attn_unaligned=0)
    ref, _ = dec_attn_cuda.dec_attn_plain(q, k, v, dtype=dtype, mask=mask,
                                          k_scale=hd ** -0.25)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("p", [1, 5])
@pytest.mark.parametrize("m", [1, 2, 5, 8, 16, 40])
def test_dec_attn_rows_do_not_depend_on_their_neighbours(cuda, dtype, p, m):
    """Row invariance, bit for bit: each item of a batch of ``m`` equals
    the same item alone; each of ``p`` query rows equals that row alone;
    and a row over a longer cache (more columns masked) equals it over the
    shorter one. Eager and inside a captured CUDA graph."""
    h, s, hd = 4, 96, 64
    q, k, v, mask = _attn_inputs(cuda, m, h, p, s, hd, dtype, dtype, "cache",
                                 m * 10 + p)

    def run(qq, kk, vv, mm):
        return dec_attn_cuda.dec_attn(qq, kk, vv, dtype=dtype, mask=mm,
                                      k_scale=hd ** -0.25, scores=True)

    full, full_sc = run(q, k, v, mask)
    for i in {0, m - 1}:
        one, one_sc = run(q[i:i + 1], k[i:i + 1], v[i:i + 1], mask)
        assert _bits_equal(one, full[i:i + 1])
        assert _bits_equal(one_sc, full_sc[i:i + 1])
    for r in range(p):
        row, _ = run(q[:, :, r:r + 1], k, v, mask[r:r + 1])
        assert _bits_equal(row, full[:, :, r:r + 1])
    # 40 more cache columns, never visible
    pad = lambda t: torch.cat([t, torch.randn_like(t[..., :40])], dim=-1)
    longer = torch.cat([mask, torch.full_like(mask[:, :40], float("-inf"))],
                       dim=-1)
    wide, _ = run(q, pad(k), pad(v), longer)
    assert _bits_equal(wide, full)
    # in a graph over one chunk (96 keys) and over two (136: the tickets
    # are ready again after each replay)
    for args, want in (((q, k, v, mask), full),
                       ((q, pad(k), pad(v), longer), wide)):
        static = [t.clone() for t in args]
        out = {}

        def body():
            out["o"], out["s"] = run(*static)

        body()  # first use outside the capture
        want_sc = out["s"].clone()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body()
        graph.replay()
        graph.replay()
        torch.cuda.synchronize()
        assert _bits_equal(out["o"], want) and _bits_equal(out["s"], want_sc)
    assert _bits_equal(want_sc[..., :s], full_sc)


def _one_row(cuda, dtype, layout, h, s, hd, seed):
    """A query row (B=2, H, 1, hd), its K/V and a mask row that shows the
    first 100 keys."""
    q, k, v, _ = _attn_inputs(cuda, 2, h, 1, s, hd, dtype, dtype, layout,
                              seed)
    mask = torch.zeros((1, s), device=cuda)
    mask[:, 100:] = float("-inf")
    return q, k, v, mask


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["cache", "proj"])
@pytest.mark.parametrize("s", [127, 128, 129, 1500])
def test_dec_attn_rows_do_not_depend_on_masked_chunks(cuda, dtype, layout,
                                                      s):
    """A row over S keys equals, bit for bit, the same row with masked keys
    appended: to the end of its last chunk, one whole chunk more (1500
    against 1540 and 1756) and three (S + 384), with random K/V behind the
    mask; and the appended chunks' scores are -inf."""
    h, hd = 4, 64
    q, k, v, mask = _one_row(cuda, dtype, layout, h, s, hd, s)

    def run(kk, vv, mm):
        return dec_attn_cuda.dec_attn(q, kk, vv, dtype=dtype, mask=mm,
                                      k_scale=hd ** -0.25, scores=True)

    def pad(t, extra):  # in t's own layout
        new = torch.randn((*t.shape[:-1], extra), device=cuda).to(t.dtype)
        if layout == "cache":
            return torch.cat([t, new], dim=-1)
        return torch.cat([t.transpose(-1, -2), new.transpose(-1, -2)],
                         dim=-2).transpose(-1, -2)

    base, base_sc = run(k, v, mask)
    for extra in sorted({-s % 128, 40, 256, 384} - {0}):
        longer = torch.cat([mask, torch.full((1, extra), float("-inf"),
                                             device=cuda)], dim=-1)
        got, sc = run(pad(k, extra), pad(v, extra), longer)
        assert _bits_equal(got, base), extra
        assert _bits_equal(sc[..., :s], base_sc), extra
        assert bool((sc[..., s:] == float("-inf")).all()), extra


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["cache", "proj"])
@pytest.mark.parametrize("p", [16, 96])
def test_dec_attn_a_step_row_equals_itself_in_any_tile(cuda, dtype, layout,
                                                       p):
    """A decode step's one row equals itself, bit for bit, at every place
    of a 16-row tile and of a 96-row transcript (other rows random), over
    1500 keys unmasked and 448 masked past its position."""
    h, hd = 4, 64
    for s, masked in ((1500, False), (448, True)):
        q, k, v, mask = _one_row(cuda, dtype, layout, h, s, hd, p + s)
        mask = mask if masked else None
        step, step_sc = dec_attn_cuda.dec_attn(q, k, v, dtype=dtype,
                                               mask=mask, scores=True)
        g = torch.Generator(device=cuda).manual_seed(p)
        for r in sorted({0, 5, 8, p - 1}):
            qq = (torch.randn((2, h, p, hd), generator=g, device=cuda)
                  * hd ** -0.25).to(dtype)
            qq[:, :, r:r + 1] = q
            mm = None if mask is None else mask.expand(p, s)
            got, sc = dec_attn_cuda.dec_attn(qq, k, v, dtype=dtype, mask=mm,
                                             scores=True)
            assert _bits_equal(got[:, :, r:r + 1], step), (s, r)
            assert _bits_equal(sc[:, :, r:r + 1], step_sc), (s, r)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("p", [4, 20, 130])
def test_dec_attn_a_prompt_equals_its_steps(cuda, dtype, p):
    """A prompt of P rows over a 448-column cache that holds all P new
    columns (``decode_prefill``) equals P steps, bit for bit, each over the
    cache as it stood at its step (later columns still zero), with the
    position mask; P = 130 crosses a chunk."""
    b, h, hd, s = 2, 4, 64, 448
    g = torch.Generator(device=cuda).manual_seed(p)
    q = (torch.randn((b, h, p, hd), generator=g, device=cuda)
         * hd ** -0.25).to(dtype)
    new_k, new_v = (torch.randn((b, h, hd, p), generator=g, device=cuda)
                    .to(dtype) for _ in range(2))
    k, v = (torch.zeros((b, h, hd, s), dtype=dtype, device=cuda)
            for _ in range(2))
    k[..., :p], v[..., :p] = new_k, new_v
    rows = torch.arange(p, device=cuda)
    prompt, _ = dec_attn_cuda.dec_attn(q, k, v, dtype=dtype,
                                       mask=tw._position_mask(rows, s),
                                       k_scale=hd ** -0.25)
    ks, vs = torch.zeros_like(k), torch.zeros_like(v)
    for i in range(p):
        ks[..., i], vs[..., i] = new_k[..., i], new_v[..., i]
        step, _ = dec_attn_cuda.dec_attn(
            q[:, :, i:i + 1], ks, vs, dtype=dtype,
            mask=tw._position_mask(rows[i:i + 1], s), k_scale=hd ** -0.25)
        assert _bits_equal(step, prompt[:, :, i:i + 1]), i


_LINEAR_SHAPES = [(1024, 1024), (4096, 1024), (1024, 4096), (5003, 1024),
                  (96, 32), (40, 16)]
# the decoder's linears at Whisper's other widths (tiny, base, small,
# large): q/k/v/out, fc1 and fc2, K not always a whole number of segments
_WIDTH_SHAPES = [s for d in (384, 512, 768, 1280)
                 for s in ((d, d), (4 * d, d), (d, 4 * d))]
# rows at the regimes' edges and on the main path: a step at B = 1-32 and
# beam 5's 40, the capture's 768 and the cross K/V's 12,000
_LINEAR_ROWS = [1, 7, 16, 32, 33, 40, 64, 65, 300, 768, 12000]


def _linear_inputs(cuda, dtype, m, n, k, with_bias, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=cuda).to(dtype)
    w = (torch.randn((n, k), generator=g, device=cuda) * k ** -0.5).to(dtype)
    bias = (torch.randn((n,), generator=g, device=cuda).to(dtype)
            if with_bias else None)
    return x, w, bias


def _linear_err(got, want) -> float:
    """The largest error over each row's largest output."""
    assert got.dtype == want.dtype and got.shape == want.shape
    scale = want.float().abs().amax(dim=-1, keepdim=True).clamp_min(1e-3)
    return ((got.float() - want.float()).abs() / scale).max().item()


@pytest.mark.parametrize("dtype,out_dtype,tol", [
    (torch.bfloat16, None, 1e-2), (torch.bfloat16, torch.float32, 1e-4),
    (torch.float32, None, 1e-5)])
@pytest.mark.parametrize("n,k", _LINEAR_SHAPES + _WIDTH_SHAPES)
@pytest.mark.parametrize("m", _LINEAR_ROWS)
@pytest.mark.parametrize("with_bias", [True, False])
def test_rows_linear_kernel(cuda, dtype, out_dtype, tol, n, k, m, with_bias):
    """The linear against ``F.linear`` (its plain version) on the card:
    bf16 outputs within one bf16 rounding (1e-2 of the row's largest),
    the lm head's f32 outputs from bf16 rows within 1e-4, f32 within 1e-5
    (sums over K in another order)."""
    if out_dtype is not None and with_bias:
        pytest.skip("the lm head has no bias")
    x, w, bias = _linear_inputs(cuda, dtype, m, n, k, with_bias,
                                m * 7 + n + k)
    before = _lib.launch_counts()["rows_linear"]
    got = rows_linear_cuda.rows_linear(x, w, bias, out_dtype=out_dtype)
    assert _lib.launch_counts()["rows_linear"] == before + 1
    want = rows_linear_cuda.rows_linear_plain(x, w, bias, out_dtype)
    err = _linear_err(got, want)
    assert err <= tol, err


@pytest.mark.parametrize("m", [1, 8, 40])
def test_rows_linear_lm_head(cuda, m):
    """The lm head (51865 x 1024, f32 out from bf16 rows, no bias) at a
    decode step's rows: within 1e-4 of ``F.linear`` on the f32 casts, and
    each row alone bit-equal to it among the others."""
    x, w, _ = _linear_inputs(cuda, torch.bfloat16, m, 51865, 1024, False, m)
    got = rows_linear_cuda.rows_linear(x, w, out_dtype=torch.float32)
    want = rows_linear_cuda.rows_linear_plain(x, w, None, torch.float32)
    err = _linear_err(got, want)
    assert err <= 1e-4, err
    for i in {0, m - 1}:
        alone = rows_linear_cuda.rows_linear(x[i:i + 1], w,
                                             out_dtype=torch.float32)
        assert _bits_equal(alone, got[i:i + 1]), i


@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.bfloat16, None), (torch.bfloat16, torch.float32),
    (torch.float32, None)])
@pytest.mark.parametrize("n,k", _LINEAR_SHAPES + _WIDTH_SHAPES)
def test_rows_linear_rows_do_not_depend_on_their_neighbours(cuda, dtype,
                                                            out_dtype, n, k):
    """Row invariance, bit for bit: rows 0 and M-1 of an M-row call equal
    the same rows alone at M in {1, 2, 5, 8, 16, 32, 33, 40, 64, 65} (a
    cluster of blocks a tile, one block a segment, or one block walking
    every segment) and at 300, 768, 1500 and 12,000 rows (tiles of 128 rows
    walking every segment), eagerly and in a captured CUDA graph replayed
    twice at a split shape."""
    g = torch.Generator(device=cuda).manual_seed(n + k)
    x = torch.randn((12000, k), generator=g, device=cuda).to(dtype)
    w = (torch.randn((n, k), generator=g, device=cuda) * k ** -0.5).to(dtype)
    bias = (None if out_dtype is not None else
            torch.randn((n,), generator=g, device=cuda).to(dtype))

    def run(rows):
        return rows_linear_cuda.rows_linear(rows, w, bias, out_dtype=out_dtype)

    alone = {}
    for m in (1, 2, 5, 8, 16, 32, 33, 40, 64, 65, 300, 768, 1500, 12000):
        y = run(x[:m])
        for i in {0, m - 1}:
            if i not in alone:
                alone[i] = run(x[i:i + 1])
            assert _bits_equal(y[i:i + 1], alone[i]), (m, i)
    for i in range(5):
        alone.setdefault(i, run(x[i:i + 1]))
    static = x[:5].clone()
    out = {}
    out["y"] = run(static)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out["y"] = run(static)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    for i in range(5):
        assert _bits_equal(out["y"][i:i + 1], alone[i])


def _probe_operands(rng, k, carried):
    """bf16 x (64, k) and w (128, k) whose entries span 2^-20..2^20, the
    second half of each row's products cancelling the first half's to a
    few bits, and an f32 sum to carry in (or None)."""
    def spread(shape):
        return (rng.standard_normal(shape) *
                2.0 ** rng.integers(-20, 21, size=shape))

    x, w = spread((64, k)), spread((128, k))
    h = k // 2
    x[:, h:] = -x[:, :h] * (1 + 2.0 ** -7 * rng.integers(-2, 3, (64, h)))
    w[:, h:] = w[:, :h]
    c0 = spread((64, 128)).astype(np.float32) if carried else None
    return x, w, c0


_PROBE_FORMS = ("mma.sync m16n8k16", "wgmma m64n8k16, x as A",
                "wgmma m64n64k16, x as A", "wgmma m64n128k16, x as A",
                "wgmma m64n64k16, weight as A", "wgmma m64n8k16, weight as A",
                "wgmma m64n16k16, weight as A", "wgmma m64n32k16, weight as A")


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("steps", [2, 3, 5, 8])
def test_rows_linear_instruction_numerics(cuda, steps, carried):
    """The instruction probe (``rows_linear_cuda.instruction_probe``): the
    same bf16 tiles through ``mma.sync`` m16n8k16, ``wgmma`` with x as A at
    N = 8, 64 and 128, and ``wgmma`` with the weight as A at N = 64, 8,
    16 and 32 (x in groups of N rows, as the kernel takes a decode step's
    rows), chained over
    ``steps`` k16 steps from zero or from a carried f32 sum. Every form is
    the product (within 2^-16 of the sum of the terms' sizes, against
    float64), and every form gives the same bits (an H100 does: so the
    kernel's regimes may take any of them). Prints, for every pair of
    forms, how many of the 8192 outputs differ in their bits."""
    rng = np.random.default_rng(steps * 2 + carried)
    x, w, c0 = _probe_operands(rng, 16 * steps, carried)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    c0t = None if c0 is None else torch.from_numpy(c0)
    got = rows_linear_cuda.instruction_probe(
        xb.to(cuda), wb.to(cuda), None if c0t is None else c0t.to(cuda))
    got = got.cpu()
    x64, w64 = xb.double(), wb.double()
    ref = x64 @ w64.T + (0 if c0t is None else c0t.double())
    size = x64.abs() @ w64.abs().T + (0 if c0t is None else
                                       c0t.double().abs())
    for f, name in enumerate(_PROBE_FORMS):
        err = ((got[f].double() - ref).abs() / size).max().item()
        assert err <= 2.0 ** -16, (name, err)
    bits = got.view(torch.int32)
    print(f"\nprobe steps={steps} carried={carried}: outputs whose bits "
          "differ, of 8192")
    for a in range(len(_PROBE_FORMS)):
        print("  " + " ".join(
            f"{int((bits[a] != bits[b]).sum()):5d}"
            for b in range(len(_PROBE_FORMS))) + f"  {_PROBE_FORMS[a]}")
    for f in range(1, len(_PROBE_FORMS)):
        assert torch.equal(bits[f], bits[0]), _PROBE_FORMS[f]


def test_rows_linear_and_dec_attn_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((2, 12), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        rows_linear_cuda.rows_linear(x, torch.zeros((4, 12), device=cuda,
                                                    dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="share"):
        rows_linear_cuda.rows_linear(x[:, :8], torch.zeros((4, 8),
                                                           device=cuda))
    q = torch.zeros((1, 2, 1, 12), device=cuda)
    kv = torch.zeros((1, 2, 12, 5), device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        dec_attn_cuda.dec_attn(q, kv, kv, dtype=torch.float32)
    q, kv = q[..., :8], kv[:, :, :8]
    with pytest.raises(ValueError, match="compute dtype"):
        dec_attn_cuda.dec_attn(q, kv.to(torch.bfloat16),
                               kv.to(torch.bfloat16), dtype=torch.float32)


def test_the_decoder_and_the_audio_side_keep_each_row(cuda):
    """``scripts/diagnose_rows`` on a small bf16 model (two layers of
    Whisper's head width, 1500 frames): every op of every case bit-equal,
    and every suspect op held on its own bit-equal."""
    from whisper_char_alignment_tpu_torch.config import tiny_test_dims
    from whisper_char_alignment_tpu_torch.scripts import diagnose_rows

    dims = tiny_test_dims(n_vocab=1000, n_audio_ctx=1500, n_text_ctx=64,
                          state=256, head=4, layers=2)
    model = tw.init_params(
        tw.Whisper(dims, device=cuda, dtype=torch.bfloat16),
        torch.Generator(device=cuda).manual_seed(0))
    result = diagnose_rows.diagnose(model)
    for name, table in result["cases"].items():
        assert diagnose_rows.first_difference(table) is None, (
            name, diagnose_rows.first_difference(table))
    for row in result["suspects"]:
        assert row["bit_equal"], row


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_speculative_decode_equals_greedy_on_the_card(cuda, dtype):
    """``decode_speculative`` (draft_k 4) equals greedy ``decode`` on the
    card, bit for bit: tokens, logprobs and no-speech probabilities, in
    bf16 and f32, with a smaller draft."""
    from whisper_char_alignment_tpu_torch.models import decoding

    tok, model, mel = _tiny_decoder_model(cuda, 6)
    _, draft, _ = _tiny_decoder_model(cuda, 7, state=64, layers=1)
    model, draft = (tw.cast_params(m, dtype) for m in (model, draft))
    o = decoding.DecodingOptions(language="en", sample_len=24)
    for i in range(2):
        greedy = decoding.decode(model, tok, mel[i], o)
        spec = decoding.decode_speculative(model, draft, tok, mel[i], o,
                                           draft_k=4)
        assert (spec.tokens, spec.text) == (greedy.tokens, greedy.text)
        assert spec.avg_logprob == greedy.avg_logprob
        assert spec.no_speech_prob == greedy.no_speech_prob


@pytest.mark.parametrize("rows", [2, 8, 16, 40])
def test_vocabulary_reductions_run_every_row_alike(cuda, rows):
    """The decode loops' reductions over the vocabulary on the card
    (``decoding.vocab_logsumexp``, ``vocab_softmax``, ``vocab_log_softmax``)
    over (rows, 51865) float32 logits (a row starts 4 bytes further each
    row): each row equals, bit for bit, the same row in a buffer of its own
    (as a solo run holds it), and the library's reductions of the rows as
    they lie within 2e-6 (only the sum order moves)."""
    from whisper_char_alignment_tpu_torch.models import decoding

    g = torch.Generator(device=cuda).manual_seed(rows)
    lg = torch.randn((rows, 51865), generator=g, device=cuda) * 4
    for fn, lib in ((decoding.vocab_logsumexp, torch.logsumexp),
                    (decoding.vocab_softmax, torch.softmax),
                    (decoding.vocab_log_softmax, torch.log_softmax)):
        full = fn(lg)
        for i in {0, 1, rows - 1}:
            assert _bits_equal(fn(lg[i:i + 1].clone()), full[i:i + 1])
        torch.testing.assert_close(full, lib(lg, dim=-1), rtol=2e-6,
                                   atol=2e-6)
