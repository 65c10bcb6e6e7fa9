"""The decoder's row-invariant kernels on the CPU: ``ops/dec_attn_cuda.py``
and ``ops/rows_linear_cuda.py``, and the models module routed through them.

- each wrapper's input checks;
- a CPU tensor takes the plain version (the kernel library is never
  loaded, nothing is counted);
- the plain versions equal the port's code before the kernels bit for bit:
  ``_attend`` (kept here verbatim), ``F.linear`` and ``_logits``'
  ``F.linear(x.float(), W.float())``, and the models module's call sites
  (``_cached_layers``, ``_cross_attention_kv``, ``_qkv_attention``) through
  them;
- the wrappers' arguments to the C entry points (the segment plan from
  (N, K) alone, the split chosen by M, K/V strides, output layouts), with
  the library replaced by a recorder;
- a tiny decode with JAX weights carried across (``params_from_jax``)
  against JAX ``decode``, as before the kernels;
- ``scripts/diagnose_rows`` on a tiny model (its tables and its
  ``--plain`` switch).
The kernels themselves run on the card: ``tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from whisper_char_alignment_tpu.config import tiny_test_dims as jax_dims
from whisper_char_alignment_tpu.models import decoding as jdec
from whisper_char_alignment_tpu.models import whisper as jw
from whisper_char_alignment_tpu.text.tokenizer import \
    get_test_tokenizer as jax_tokenizer
from whisper_char_alignment_tpu_torch.config import ModelDims, tiny_test_dims
from whisper_char_alignment_tpu_torch.models import convert as tconvert
from whisper_char_alignment_tpu_torch.models import decoding as tdec
from whisper_char_alignment_tpu_torch.models import whisper as tw
from whisper_char_alignment_tpu_torch.ops import (_lib, dec_attn_cuda,
                                                  rows_linear_cuda)
from whisper_char_alignment_tpu_torch.scripts import diagnose_rows
from whisper_char_alignment_tpu_torch.text.tokenizer import get_test_tokenizer
from whisper_char_alignment_tpu_torch.utils import device as udev

torch.set_num_threads(1)


def old_attend(q, k_t, v_t, dtype, mask=None):
    """The port's ``whisper._attend`` before the kernel, verbatim."""
    qk = torch.matmul(q.float(), k_t.float())
    if mask is not None:
        qk = qk + mask
    w = torch.softmax(qk, dim=-1).to(dtype)
    out = torch.matmul(w.float(), v_t.float().transpose(-1, -2)).to(dtype)
    return out, qk


def _bits(t):
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


def _same(a, b) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(_bits(a), _bits(b)))


@pytest.fixture
def no_library(monkeypatch):
    """Fail if anything loads the kernel library; count nothing."""
    def refuse():
        raise AssertionError("the CPU path loaded the kernel library")
    monkeypatch.setattr(_lib, "library", refuse)
    before = _lib.launch_counts()
    yield
    assert _lib.launch_counts() == before


def _randn(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        dtype)


# -- input checks -------------------------------------------------------------

@pytest.mark.parametrize("x_shape,w_shape,b_shape,match", [
    ((3, 8), (4, 6), None, "disagree"),
    ((3, 8), (8,), None, "disagree"),
    ((3, 8), (4, 8), (3,), "bias"),
    ((2, 3, 8), (4, 8), (4, 1), "bias")])
def test_rows_linear_checks_its_inputs(x_shape, w_shape, b_shape, match):
    x, w = torch.zeros(x_shape), torch.zeros(w_shape)
    b = None if b_shape is None else torch.zeros(b_shape)
    with pytest.raises(ValueError, match=match):
        rows_linear_cuda.rows_linear(x, w, b)


def test_rows_linear_refuses_other_devices():
    x = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rows_linear_cuda.rows_linear(x, torch.zeros((4, 8), device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        rows_linear_cuda.rows_linear(torch.zeros((2, 8)),
                                     torch.zeros((4, 8), device="meta"))


@pytest.mark.parametrize("q_shape,k_shape,v_shape,mask_shape,match", [
    ((1, 2, 1, 8), (1, 2, 8), (1, 2, 8), None, "must be"),
    ((1, 2, 1, 8), (1, 2, 8, 5), (1, 2, 8, 6), None, "must be"),
    ((1, 2, 1, 8), (1, 3, 8, 5), (1, 3, 8, 5), None, "must be"),
    ((1, 2, 1, 8), (1, 2, 16, 5), (1, 2, 16, 5), None, "must be"),
    ((1, 2, 3, 8), (1, 2, 8, 5), (1, 2, 8, 5), (1, 5), "mask"),
    ((1, 2, 3, 8), (1, 2, 8, 5), (1, 2, 8, 5), (3, 4), "mask")])
def test_dec_attn_checks_its_inputs(q_shape, k_shape, v_shape, mask_shape,
                                    match):
    mask = None if mask_shape is None else torch.zeros(mask_shape)
    with pytest.raises(ValueError, match=match):
        dec_attn_cuda.dec_attn(torch.zeros(q_shape), torch.zeros(k_shape),
                               torch.zeros(v_shape), dtype=torch.float32,
                               mask=mask)


def test_dec_attn_refuses_a_q_outside_the_compute_dtype():
    kv = torch.zeros((1, 2, 8, 5))
    with pytest.raises(ValueError, match="compute dtype"):
        dec_attn_cuda.dec_attn(torch.zeros((1, 2, 1, 8)), kv, kv,
                               dtype=torch.bfloat16)


# -- the CPU takes the plain versions, which are the old code ----------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k,bias", [(1, 16, 8, True), (5, 24, 16, False),
                                        (40, 7, 32, True)])
def test_rows_linear_on_the_cpu_is_f_linear(no_library, dtype, m, n, k,
                                            bias):
    rng = np.random.default_rng(m + n + k)
    x, w = _randn(rng, 2, m, k, dtype=dtype), _randn(rng, n, k, dtype=dtype)
    b = _randn(rng, n, dtype=dtype) if bias else None
    assert _same(rows_linear_cuda.rows_linear(x, w, b), F.linear(x, w, b))
    # the lm head: an f32 product of the rows and weights as stored
    assert _same(rows_linear_cuda.rows_linear(x, w, out_dtype=torch.float32),
                 F.linear(x.float(), w.float()))


@pytest.mark.parametrize("dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("p,s,masked,scaled", [(1, 12, True, True),
                                               (5, 12, True, True),
                                               (7, 30, False, True),
                                               (4, 4, True, False)])
def test_dec_attn_on_the_cpu_is_the_old_attend(no_library, dtype, kv_dtype,
                                               p, s, masked, scaled):
    """``dec_attn`` on CPU tensors is the old ``_attend`` on the inputs its
    call sites gave it: K and V cast to the compute dtype, K times the
    scale in that dtype."""
    rng = np.random.default_rng(p * 31 + s)
    hd = 8
    q = _randn(rng, 2, 3, p, hd, dtype=dtype) * hd ** -0.25
    k, v = (_randn(rng, 2, 3, hd, s, dtype=kv_dtype) for _ in range(2))
    mask = (tw._position_mask(torch.arange(s - p, s), s) if masked else None)
    scale = hd ** -0.25 if scaled else None
    got = dec_attn_cuda.dec_attn(q, k, v, dtype=dtype, mask=mask,
                                 k_scale=scale)
    kk = k.to(dtype) * scale if scaled else k.to(dtype)
    want = old_attend(q, kk, v.to(dtype), dtype, mask)
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    assert tw._attend is dec_attn_cuda.attend_plain
    plain = tw._attend(q, kk, v.to(dtype), dtype, mask)
    assert _same(plain[0], want[0]) and _same(plain[1], want[1])


def _tiny_model(dtype, seed=0, layers=2):
    dims = tiny_test_dims(n_vocab=64, n_audio_ctx=16, n_text_ctx=64,
                          state=32, head=2, layers=layers)
    return tw.cast_params(tw.init_params(
        tw.Whisper(dims, device="cpu"), torch.Generator().manual_seed(seed)),
        dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_models_call_sites_on_the_cpu_are_the_old_code(no_library, dtype):
    """The decode step, the window and the capture's ``decode_text`` on the
    CPU give the old code's bits: each site recomputed here with the old
    ``_attend`` and ``F.linear``."""
    model = _tiny_model(dtype)
    dims = model.dims
    rng = np.random.default_rng(5)
    xa = _randn(rng, 2, dims.n_audio_ctx, dims.n_audio_state, dtype=dtype)
    kv = tw.precompute_cross_kv(model, xa)
    blk = model.decoder.blocks[0]
    assert _same(kv[0][0], F.linear(xa, blk.cross_attn.key.weight).reshape(
        2, dims.n_audio_ctx, 2, 16).permute(0, 2, 3, 1))
    x = _randn(rng, 2, 3, dims.n_text_state, dtype=dtype)
    assert _same(tw._logits(model, x),
                 F.linear(x.float(),
                          model.decoder.token_embedding.weight.float()))
    # cross-attention over float K/V, as the old code attended
    scale = 16 ** -0.25
    h = tw._layer_norm(blk.cross_attn_ln, x)
    got, qk = tw._cross_attention_kv(blk.cross_attn, h, kv[0][0], kv[1][0])
    q = tw._split_heads(F.linear(h, blk.cross_attn.query.weight,
                                 blk.cross_attn.query.bias), 2) * scale
    o, want_qk = old_attend(q, kv[0][0].to(dtype) * scale, kv[1][0].to(dtype),
                            dtype)
    want = F.linear(tw._merge_heads(o), blk.cross_attn.out.weight,
                    blk.cross_attn.out.bias)
    assert _same(got, want) and _same(qk, want_qk)
    # self-attention of the capture (pre-scaled K, a causal mask)
    mask = tw._causal_mask(3, "cpu")
    got, qk = tw._qkv_attention(blk.attn, h, None, mask)
    k = tw._split_heads(F.linear(h, blk.attn.key.weight), 2) * scale
    v = tw._split_heads(F.linear(h, blk.attn.value.weight,
                                 blk.attn.value.bias), 2)
    q = tw._split_heads(F.linear(h, blk.attn.query.weight,
                                 blk.attn.query.bias), 2) * scale
    o, want_qk = old_attend(q, k.transpose(-1, -2), v.transpose(-1, -2),
                            dtype, mask)
    want = F.linear(tw._merge_heads(o), blk.attn.out.weight,
                    blk.attn.out.bias)
    assert _same(got, want) and _same(qk, want_qk)


def test_vocabulary_reductions_on_the_cpu_are_the_library_calls():
    """``decoding.vocab_softmax``, ``vocab_log_softmax`` and
    ``vocab_logsumexp`` on the CPU: the plain PyTorch calls, bit for bit
    (the card's row-stable versions: ``tests/test_torch_cuda.py``)."""
    x = torch.randn(3, 51865, generator=torch.Generator().manual_seed(0))
    x = x[:, 7:]
    assert _same(tdec.vocab_softmax(x), torch.softmax(x, dim=-1))
    assert _same(tdec.vocab_log_softmax(x), torch.log_softmax(x, dim=-1))
    assert _same(tdec.vocab_logsumexp(x), torch.logsumexp(x, dim=-1))


def test_the_encoder_on_the_cpu_runs_one_call_per_op(monkeypatch):
    """On the CPU ``utils/device.per_utterance`` is one call over the batch
    (the old code), on a card one call per utterance."""
    calls = []

    def fn(t):
        calls.append(t.shape[0])
        return t * 2

    x = torch.ones((3, 4))
    assert torch.equal(udev.per_utterance(fn, x), x * 2) and calls == [3]
    model = _tiny_model(torch.float32)
    mel = _randn(np.random.default_rng(0), 3, model.dims.n_mels,
                 2 * model.dims.n_audio_ctx)
    out = tw.encode_audio(model, mel, device="cpu")
    for i in range(3):
        torch.testing.assert_close(
            tw.encode_audio(model, mel[i:i + 1], device="cpu"),
            out[i:i + 1], rtol=1e-5, atol=1e-5)


# -- the wrappers' calls into the library, with a recorder --------------------

class _Recorder:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


@pytest.fixture
def recorder(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors: the device check says
    ``cuda`` and the library records its calls instead of launching."""
    rec = _Recorder()
    monkeypatch.setattr(_lib, "require_cuda_or_cpu", lambda *t: "cuda")
    monkeypatch.setattr(_lib, "library", lambda: rec)
    monkeypatch.setattr(_lib, "stream_of", lambda t: 0)
    monkeypatch.setattr(rows_linear_cuda, "_tickets_on",
                        lambda dev: torch.zeros(8, dtype=torch.int32))
    return rec


# every decoder linear of Whisper tiny to large-v3 (d 384-1280, the MLP 4d
# wide) and the lm head of each vocabulary, checked for cover and bounds
_DECODER_SHAPES = [(n, k, torch.bfloat16, None)
                   for d in (384, 512, 768, 1024, 1280)
                   for n, k in ((d, d), (4 * d, d), (d, 4 * d), (51864, d),
                                (51865, d), (51866, d))]


@pytest.mark.parametrize("n,k,dtype,want", [
    (1024, 1024, torch.bfloat16, (2, 8)),
    (4096, 1024, torch.bfloat16, (8, 2)),
    (1024, 4096, torch.bfloat16, (8, 8)),
    (51865, 1024, torch.bfloat16, (16, 1)),
    (1024, 1024, torch.float32, (4, 16)),
    (40, 16, torch.bfloat16, (1, 1)),
    (384, 1536, torch.bfloat16, (3, 8))] + _DECODER_SHAPES)
def test_segment_plan_covers_k(n, k, dtype, want):
    """Segments of whole 64-deep (bf16) or 16-deep (f32) chunks that cover
    K exactly once; bf16: at most a cluster's 8, as many as put some 128
    blocks of 64 columns on the card at few rows; f32: some 256 blocks."""
    seg_chunks, n_seg = rows_linear_cuda.plan(n, k, dtype)
    n_chunks = -(-k // rows_linear_cuda.CHUNK[dtype])
    if want is not None:
        assert (seg_chunks, n_seg) == want
    assert (n_seg - 1) * seg_chunks < n_chunks <= n_seg * seg_chunks
    if dtype == torch.bfloat16:
        assert 1 <= n_seg <= min(rows_linear_cuda.CLUSTER, n_chunks)


@pytest.mark.parametrize("m,split", [(1, 1), (16, 1), (17, 1), (64, 1),
                                     (65, 1), (256, 1), (300, 0), (1500, 0)])
def test_rows_linear_splits_by_rows_and_plans_by_the_weight(recorder, m,
                                                            split):
    """bf16 (1024 x 1024, 2 chunks a segment, 8 segments): split into a
    cluster a tile up to 256 rows, then 128-row tiles of 64 columns; no
    partials or tickets in device memory either way."""
    x = torch.zeros((m, 1024), dtype=torch.bfloat16)
    w = torch.zeros((1024, 1024), dtype=torch.bfloat16)
    before = _lib.launch_counts()["rows_linear"]
    y = rows_linear_cuda.rows_linear(x, w, torch.zeros(1024,
                                                       dtype=torch.bfloat16))
    assert _lib.launch_counts()["rows_linear"] == before + 1
    assert y.shape == (m, 1024) and y.dtype == torch.bfloat16
    (name, args), = recorder.calls
    assert name == "wca_rows_linear"
    mode = rows_linear_cuda.SPLIT if split else rows_linear_cuda.WIDE_64
    assert args[6:14] == (m, 1024, 1024, 2, 8, mode, 1, 0)
    assert args[4] is None and args[5] is None


@pytest.mark.parametrize("m,n,k,mode", [
    (8, 1024, 1024, 1), (32, 1024, 1024, 1), (33, 1024, 1024, 1),
    (40, 4096, 1024, 1), (64, 4096, 1024, 1), (65, 4096, 1024, 2),
    (8, 1024, 4096, 1), (8, 51865, 1024, 0), (64, 51865, 1024, 0),
    (65, 51865, 1024, 3), (768, 1024, 1024, 2), (12000, 1024, 1024, 3),
    (8, 40, 16, 0), (65, 40, 16, 2)])
def test_rows_linear_routes_by_rows(m, n, k, mode):
    """The regime of a bf16 call (0 one block walks every segment, 1 a
    cluster a tile, 2 and 3 128-row tiles of 64 or 128 columns) and the
    kernel it names for a trace: by M, the plan by (N, K)."""
    assert rows_linear_cuda.route(m, n, k, torch.bfloat16) == mode
    assert rows_linear_cuda.kernel_name(m, n, k, torch.bfloat16) == (
        "rows_linear_wide_kernel" if mode >= 2 else
        "rows_linear_narrow_kernel")
    assert rows_linear_cuda.kernel_name(m, n, k, torch.float32) == (
        "rows_linear_f32_kernel")


def test_rows_linear_f32_split_parks_partials(recorder):
    """f32 keeps its split: at a step's rows one block a segment, partials
    (n_seg, M, N) and the tile tickets passed."""
    x = torch.zeros((8, 1024))
    w = torch.zeros((1024, 1024))
    rows_linear_cuda.rows_linear(x, w)
    (_, args), = recorder.calls
    assert args[6:14] == (8, 1024, 1024, 4, 16, 1, 0, 1)
    assert args[4] is not None and args[5] is not None


def test_rows_linear_lm_head_arguments(recorder):
    x = torch.zeros((3, 1, 64), dtype=torch.bfloat16)
    w = torch.zeros((1001, 64), dtype=torch.bfloat16)
    y = rows_linear_cuda.rows_linear(x, w, out_dtype=torch.float32)
    assert y.shape == (3, 1, 1001) and y.dtype == torch.float32
    (_, args), = recorder.calls
    assert args[2] is None and args[6:14] == (3, 1001, 64, 1, 1, 0, 1, 1)


def test_rows_linear_refuses_what_the_kernel_does_not_take(recorder):
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="multiple of 8"):
        rows_linear_cuda.rows_linear(torch.zeros((2, 12), dtype=bf),
                                     torch.zeros((4, 12), dtype=bf))
    with pytest.raises(ValueError, match="share"):
        rows_linear_cuda.rows_linear(torch.zeros((2, 8), dtype=bf),
                                     torch.zeros((4, 8)))
    with pytest.raises(ValueError, match="out_dtype"):
        rows_linear_cuda.rows_linear(torch.zeros((2, 8)), torch.zeros((4, 8)),
                                     out_dtype=bf)
    assert recorder.calls == []


@pytest.mark.parametrize("p", [1, 5])
def test_dec_attn_arguments(recorder, p):
    """K/V go by their strides (the cache's (B, H, hd, S) and a transposed
    projection alike); the output is a (B, P, H, hd) buffer seen as
    (B, H, P, hd); scores only when asked."""
    b, h, hd, s = 2, 3, 16, 10
    q = torch.zeros((b, p, h, hd), dtype=torch.bfloat16).transpose(1, 2)
    k = torch.zeros((b, h, s, hd), dtype=torch.bfloat16).transpose(-1, -2)
    v = torch.zeros((b, h, hd, s), dtype=torch.bfloat16)
    mask = torch.zeros((p, s))
    out, sc = dec_attn_cuda.dec_attn(q, k, v, dtype=torch.bfloat16,
                                     mask=mask, k_scale=0.5, scores=True)
    assert out.shape == (b, h, p, hd) and out.transpose(1, 2).is_contiguous()
    assert sc.shape == (b, h, p, s) and sc.dtype == torch.float32
    (name, args), = recorder.calls
    assert name == "wca_dec_attn"
    assert args[5] == sc.data_ptr()
    # ten keys are one chunk: one launch, no workspace
    assert args[6] is None and args[7] is None and args[8] is None
    assert list(args[9]) == [*q.stride()[:3], *k.stride(),
                             *v.stride()]
    assert args[10:] == (b, h, p, s, hd, 0.5, 1, 1, 1, 1, 0)
    recorder.calls.clear()
    out, sc = dec_attn_cuda.dec_attn(q, v, v, dtype=torch.bfloat16)
    (_, args), = recorder.calls
    # no scores asked, none kept within one chunk
    assert sc is None and args[3] is None and args[5] is None
    assert args[15:20] == (1.0, 0, 0, 1, 1)


def _counted_dec_attn(q, k, v, dtype):
    before = _lib.launch_counts()
    out = dec_attn_cuda.dec_attn(q, k, v, dtype=dtype, k_scale=0.125)
    after = _lib.launch_counts()
    return out, {n: after[n] - before[n]
                 for n in ("dec_attn", "dec_attn_unaligned")}


@pytest.mark.parametrize("s,layout,dtype,unaligned", [
    # bf16 caches whose rows are 70, 198 and 454 bytes apart: no 4-byte
    # piece keeps them aligned
    (35, "cache", torch.bfloat16, 1), (99, "cache", torch.bfloat16, 1),
    (227, "cache", torch.bfloat16, 1),
    # 16-byte (40, 104), 8-byte (36, 1500) and 4-byte (34) rows
    (40, "cache", torch.bfloat16, 0), (104, "cache", torch.bfloat16, 0),
    (36, "cache", torch.bfloat16, 0), (1500, "cache", torch.bfloat16, 0),
    (34, "cache", torch.bfloat16, 0),
    # a projection's rows are hd long; f32 rows are 4-byte aligned
    (35, "proj", torch.bfloat16, 0), (99, "proj", torch.bfloat16, 0),
    (35, "cache", torch.float32, 0), (99, "cache", torch.float32, 0)])
def test_dec_attn_counts_the_calls_it_stages_unaligned(recorder, s, layout,
                                                       dtype, unaligned):
    """``dec_attn_unaligned`` rises with ``dec_attn`` exactly when the
    kernel's ``piece_width`` finds K's or V's rows 2-byte aligned alone,
    and the library gets the same arguments either way: the strides as
    they are, the shapes, the scale and the flags."""
    b, h, p, hd = 2, 3, 1, 64
    q = torch.zeros((b, p, h, hd), dtype=dtype).transpose(1, 2)
    if layout == "cache":
        k = torch.zeros((b, h, hd, s), dtype=dtype)
    else:
        k = torch.zeros((b, h, s, hd), dtype=dtype).transpose(-1, -2)
    _, counted = _counted_dec_attn(q, k, k, dtype)
    assert counted == dict(dec_attn=1, dec_attn_unaligned=unaligned)
    (name, args), = recorder.calls
    assert name == "wca_dec_attn"
    assert list(args[9]) == [*q.stride()[:3], *k.stride(), *k.stride()]
    bf = int(dtype == torch.bfloat16)
    assert args[10:20] == (b, h, p, s, hd, 0.125, 1, 0, bf, bf)


def test_dec_attn_counts_an_unaligned_base_or_query(recorder):
    """The rows' start counts too: a cache 40 columns wide (16-byte rows)
    read from its second column, or a query whose rows are an odd number of
    elements apart; V alone unaligned is enough."""
    bf = torch.bfloat16
    q = torch.zeros((2, 3, 1, 64), dtype=bf)
    wide = torch.zeros((2, 3, 64, 40), dtype=bf)
    strides = dec_attn_cuda._panel_strides(wide)
    assert strides == (3 * 64 * 40, 64 * 40, 40)
    assert dec_attn_cuda.staged_unaligned(wide[..., 1:36], strides)
    assert not dec_attn_cuda.staged_unaligned(wide[..., 2:36], strides)
    assert not dec_attn_cuda.staged_unaligned(wide.float()[..., 1:36],
                                              strides)
    _, counted = _counted_dec_attn(q, wide[..., :35], wide[..., 1:36], bf)
    assert counted == dict(dec_attn=1, dec_attn_unaligned=1)
    _, counted = _counted_dec_attn(q, wide[..., 2:37], wide[..., :35], bf)
    assert counted == dict(dec_attn=1, dec_attn_unaligned=0)
    odd_q = torch.zeros((2, 3, 1, 65), dtype=bf)[..., :64]
    _, counted = _counted_dec_attn(odd_q, wide[..., :40], wide[..., :40], bf)
    assert counted == dict(dec_attn=1, dec_attn_unaligned=1)
    assert len(recorder.calls) == 3


def test_time_dec_attn_needs_a_card(monkeypatch, capsys):
    """The timing program exits 1 with no stdout where no card is; its
    self steps hold the odd cache lengths and the aligned ones beside
    them, and its bit cases hold each odd length in both layouts' reach."""
    from whisper_char_alignment_tpu_torch.scripts import time_dec_attn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert time_dec_attn.main(["--iters", "1"]) == 1
    assert capsys.readouterr().out == ""
    lengths = {s for _, _, _, s, _, _ in time_dec_attn.SHAPES}
    assert {35, 40, 99, 104, 227, 1500} <= lengths
    assert {35, 99, 227} <= {c[3] for c in time_dec_attn.BITS}


def test_dec_attn_splits_the_keys_into_chunks(recorder):
    """Past one chunk of 128 keys the scores' workspace, the chunks' terms,
    the partials and the tile tickets are passed (enough tickets for every
    (item, head, 16-row tile)); K or V with stride 1 along neither axis is
    copied to a layout the kernel reads; f32 passes f32 flags."""
    b, h, p, hd, s = 2, 3, 20, 16, 300
    q = torch.zeros((b, h, p, hd))
    k = torch.zeros((b, h, s, hd)).transpose(-1, -2)
    v = torch.zeros((b, h, hd, 2 * s))[..., ::2]
    _, sc = dec_attn_cuda.dec_attn(q, k, v, dtype=torch.float32)
    (_, args), = recorder.calls
    assert sc is None and None not in args[5:8]
    assert dec_attn_cuda.kernels(s) == ("dec_attn_qk", "dec_attn_pv")
    assert dec_attn_cuda.kernels(128) == ("dec_attn_one",)
    tickets = dec_attn_cuda._tickets[torch.device("cpu")]
    assert args[8] == tickets.data_ptr() and tickets.numel() >= b * h * 2
    assert not tickets.any()
    assert list(args[9])[3:] == [*k.stride(), *v.contiguous().stride()]
    assert args[10:15] == (b, h, p, s, hd) and args[18:20] == (0, 0)


def test_dec_attn_refuses_a_grid_past_65535_items_x_heads(recorder):
    q = torch.zeros((1, 65536, 1, 8), dtype=torch.bfloat16)
    kv = torch.zeros((1, 65536, 8, 1), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="65535"):
        dec_attn_cuda.dec_attn(q, kv, kv, dtype=torch.bfloat16)
    assert recorder.calls == []


# -- a decode with JAX weights, as before -------------------------------------

def test_a_tiny_decode_with_jax_weights_still_equals_jax():
    tok = get_test_tokenizer()
    dims = jax_dims(n_vocab=tok.n_vocab, n_audio_ctx=24, n_text_ctx=32,
                    state=16, head=2, layers=2)
    params = jw.init_params(jax.random.PRNGKey(11), dims)
    model = tconvert.model_from_state_dict(
        tconvert.params_from_jax(jax.tree.map(np.asarray, params)),
        ModelDims(**dataclasses.asdict(dims)), device="cpu")
    mel = np.random.default_rng(4).normal(
        0, 1, (3, dims.n_mels, 2 * dims.n_audio_ctx)).astype(np.float32)
    want = jdec.decode(params, dims, jax_tokenizer(), jnp.asarray(mel),
                       jdec.DecodingOptions(language="en", sample_len=12))
    got = tdec.decode(model, tok, torch.from_numpy(mel),
                      tdec.DecodingOptions(language="en", sample_len=12),
                      device="cpu")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert (g.tokens, g.text, g.language) == (w.tokens, w.text,
                                                  w.language)
        assert g.avg_logprob == pytest.approx(w.avg_logprob, abs=2e-4)
        assert g.no_speech_prob == pytest.approx(w.no_speech_prob, abs=2e-4)


# -- the diagnosis program on the CPU -----------------------------------------

def test_diagnose_rows_tables_on_a_tiny_model():
    """Every case and suspect is reported with its ops; ``plain_ops`` and
    the recorder put the models module's functions back."""
    model = _tiny_model(torch.float32, layers=1)
    names = ("dec_attn", "rows_linear", "_linear", "_layer_norm", "_logits")
    before = {n: getattr(tw, n) for n in names}
    helpers = (udev.per_utterance, tdec.vocab_softmax,
               tdec.vocab_log_softmax, tdec.vocab_logsumexp)
    with diagnose_rows.plain_ops():
        assert tw.dec_attn is dec_attn_cuda.dec_attn_plain
        result = diagnose_rows.diagnose(model)
    assert {n: getattr(tw, n) for n in names} == before
    assert (udev.per_utterance, tdec.vocab_softmax, tdec.vocab_log_softmax,
            tdec.vocab_logsumexp) == helpers
    cases = result["cases"]
    assert list(cases) == [
        "decode_step B=1 vs B=4", "decode_step B=1 vs B=8",
        "decode_step B=1 vs B=16", "decode_window P=5 vs 5 steps",
        "decode_prefill P=4 vs 4 steps", "encode_audio B=1 vs B=4",
        "precompute_cross_kv B=1 vs B=4", "encode_audio B=1 vs B=8",
        "precompute_cross_kv B=1 vs B=8", "encode_audio B=1 vs B=16",
        "precompute_cross_kv B=1 vs B=16", "decode_text T=20 vs T=52"]
    def ops(name):  # the plain attention returns its scores too
        return [r for r in cases[name] if "scores" not in r["op"]]

    # one layer: ln, q, k, v, attention, out, ln, q, attention, out, ln,
    # fc1, fc2, then the final ln and the lm head
    assert len(ops("decode_step B=1 vs B=4")) == 15
    assert len(ops("decode_window P=5 vs 5 steps")) == 75
    # the prompt's final layer norm and lm head run on its last row only
    assert len(ops("decode_prefill P=4 vs 4 steps")) == 4 * 13 + 2
    assert len(ops("precompute_cross_kv B=1 vs B=4")) == 2
    for table in cases.values():
        assert all(set(r) == {"op", "rows", "max_abs_diff", "bit_equal"}
                   for r in table)
    assert len(result["suspects"]) == 17
    summary = diagnose_rows.summary(result)
    assert set(summary["cases"]) == set(cases)
    # the same batch, padded: nothing on the CPU depends on the padding
    assert summary["cases"]["decode_text T=20 vs T=52"][
        "first_difference"] is None
