"""The int8 encoder (``quantize_encoder_int8``, ``_linear_int8``, the kernels'
plain versions in ``ops/int8_cuda.py``) against the JAX package, on the CPU.

- the weight codes and scales bit-equal to JAX's (JAX's weight scale is a
  numpy true division ``amax / 127``, not the reciprocal product of the
  activation quantizer);
- one int8 linear bit-equal to JAX ``_linear_int8`` as XLA compiles it
  (``jax.jit``: the activation scale a product with the float32
  reciprocal of 127, and in float32 the bias add fused into the last
  product) on the same input, in float32 and bfloat16, with and without a
  bias;
- whole encoder states near JAX's int8 encoder. Not within float noise:
  the float ops around the int8 linears (layer norm, attention, GELU) agree
  with XLA's to ~1 ulp, and an input that lands within an ulp of a rounding
  boundary takes the neighbouring int8 code (1 code in ~4,000 at these
  widths), which moves its row's output by a whole quantization step. On
  this input the largest difference is 1.09e-2 of the largest state (JAX's
  own int8-vs-exact bound, tests/test_encoder_int8.py:57, is 5e-2), and the
  mean difference a quarter of the int8 encoder's own mean error against
  the exact one; the test holds them to half of each;
- the compute-dtype cast keeps the int8 leaves (JAX
  tests/test_encoder_int8.py:84-118), a quantized JAX tree carries across,
  and quantizing is idempotent;
- the pipeline with ``encoder_int8`` gives JAX's words, and boundaries
  within one frame (20 ms, the DTW's step) of JAX's: the encoder states
  differ as above, and on random weights the DTW path through near-flat
  attention maps can move by a frame (one boundary of 17 moves on this
  corpus with top-k heads);
- the kernels' plain versions: the row quantizer (also with a row max taken
  elsewhere, as a row-split tensor-parallel layer passes it), the exact
  int32 product, the epilogue."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_char_alignment_tpu import api as japi
from whisper_char_alignment_tpu import runner as jrunner
from whisper_char_alignment_tpu.cli import common as jcommon
from whisper_char_alignment_tpu.config import AlignConfig as JaxAlignConfig
from whisper_char_alignment_tpu.config import tiny_test_dims
from whisper_char_alignment_tpu.data.dataset import TIMIT as JaxTIMIT
from whisper_char_alignment_tpu.data.synthetic import make_timit_corpus
from whisper_char_alignment_tpu.models import whisper as jw
from whisper_char_alignment_tpu_torch import runner as trunner
from whisper_char_alignment_tpu_torch.config import AlignConfig, ModelDims
from whisper_char_alignment_tpu_torch.data.dataset import TIMIT
from whisper_char_alignment_tpu_torch.models import convert as tconvert
from whisper_char_alignment_tpu_torch.models import whisper as tw
from whisper_char_alignment_tpu_torch.ops import _lib, int8_cuda
from whisper_char_alignment_tpu_torch.text.tokenizer import get_test_tokenizer

torch.set_num_threads(1)

DIMS = tiny_test_dims(n_vocab=get_test_tokenizer().n_vocab, n_audio_ctx=64,
                      n_text_ctx=32, state=32, head=4, layers=3)
PAIRS = (("query", "q"), ("key", "k"), ("value", "v"), ("out", "out"))


def _port(params, dims=DIMS):
    return tconvert.model_from_state_dict(
        tconvert.params_from_jax(jax.tree.map(np.asarray, params)),
        ModelDims(**dataclasses.asdict(dims)), device="cpu")


@pytest.fixture(scope="module")
def setup():
    params = jw.init_params(jax.random.PRNGKey(0), DIMS)
    return params, _port(params)


def _linears(model):
    """(port module, JAX leaf path) of every quantized encoder linear."""
    out = []
    for i, blk in enumerate(model.encoder.blocks):
        for ours, theirs in PAIRS:
            out.append((getattr(blk.attn, ours), ("attn", theirs), i))
        out.append((blk.mlp[0], ("mlp", "fc1"), i))
        out.append((blk.mlp[2], ("mlp", "fc2"), i))
    return out


def test_quantized_weights_bit_equal_jax(setup):
    params, model = setup
    q_jax = jw.quantize_encoder_int8(params)
    q = tw.quantize_encoder_int8(model)
    assert tw.encoder_is_int8(q) and not tw.encoder_is_int8(model)
    blocks = q_jax["encoder"]["blocks"]
    for lin, (group, name), i in _linears(q):
        assert isinstance(lin, tw.Int8Linear)
        leaf = blocks[group][name]
        assert lin.w8.dtype == torch.int8 and lin.s.dtype == torch.float32
        np.testing.assert_array_equal(lin.w8.numpy(),
                                      np.asarray(leaf["w8"])[i].T)
        np.testing.assert_array_equal(lin.s.numpy(),
                                      np.asarray(leaf["s"])[i, 0])
    # the weight scale is the true division, not amax * f32(1/127)
    w = model.encoder.blocks[0].mlp[0].weight.float()
    amax = w.abs().amax(dim=1)
    assert torch.equal(q.encoder.blocks[0].mlp[0].s, amax / 127.0)
    # the decoder and the rest of the encoder are the caller's, untouched
    for (k, a), (k2, b) in zip(model.decoder.state_dict().items(),
                               q.decoder.state_dict().items()):
        assert k == k2 and torch.equal(a, b)
    assert torch.equal(q.encoder.conv1.weight, model.encoder.conv1.weight)
    assert isinstance(model.encoder.blocks[0].attn.query, torch.nn.Linear)
    assert tw.quantize_encoder_int8(q) is q  # idempotent


def test_quantized_jax_tree_carries_across(setup):
    params, model = setup
    carried = _port(jw.quantize_encoder_int8(params))
    q = tw.quantize_encoder_int8(model)
    assert tw.encoder_is_int8(carried)
    ours, theirs = q.state_dict(), carried.state_dict()
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype, k
        assert torch.equal(ours[k], theirs[k]), k


@pytest.mark.parametrize("dtype,bias,shape", [
    (torch.float32, True, (4, 10, 64)), (torch.float32, False, (7, 64)),
    (torch.bfloat16, True, (4, 10, 64)), (torch.bfloat16, False, (3, 5, 64))])
def test_linear_int8_bit_equal_jax(dtype, bias, shape):
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.1, (64, 96)).astype(np.float32)
    b = rng.normal(0, 0.1, (96,)).astype(np.float32)
    x = rng.normal(0, 1.0, shape).astype(np.float32)
    x[0, ...] = 0.0  # an all-zero row takes scale 1
    amax = np.abs(w).max(axis=0, keepdims=True)
    s = amax / 127.0
    w8 = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    leaf = {"w8": jnp.asarray(w8), "s": jnp.asarray(s)}
    if bias:
        leaf["b"] = jnp.asarray(b, jdt)
    want = np.asarray(jax.jit(jw._linear)(leaf, jnp.asarray(x, jdt)).astype(
        jnp.float32))
    lin = tw.Int8Linear(torch.from_numpy(np.ascontiguousarray(w8.T)),
                        torch.from_numpy(s[0].copy()),
                        torch.from_numpy(b).to(dtype) if bias else None)
    got = tw._linear(lin, torch.from_numpy(x).to(dtype))
    assert got.dtype == dtype and got.shape == (*shape[:-1], 96)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_encoder_states_match_jax_int8(setup):
    params, model = setup
    rng = np.random.default_rng(1)
    mel = rng.normal(0, 1, (2, DIMS.n_mels, 2 * DIMS.n_audio_ctx)).astype(
        np.float32)
    want = np.asarray(jw.encode_audio(jw.quantize_encoder_int8(params), DIMS,
                                      jnp.asarray(mel)))
    exact = np.asarray(jw.encode_audio(params, DIMS, jnp.asarray(mel)))
    before = _lib.launch_counts()
    got = tw.encode_audio(tw.quantize_encoder_int8(model),
                          torch.from_numpy(mel), device="cpu").numpy()
    assert _lib.launch_counts() == before  # plain versions on the CPU
    scale = np.abs(want).max()
    diff = np.abs(got - want)
    assert diff.max() <= 2.5e-2 * scale, diff.max() / scale
    assert diff.mean() <= 0.5 * np.abs(want - exact).mean(), (
        diff.mean(), np.abs(want - exact).mean())
    # and int8 really perturbs the states (the path is not the float one)
    ours_exact = tw.encode_audio(model, torch.from_numpy(mel), device="cpu")
    assert not torch.equal(ours_exact, torch.from_numpy(got))


def test_cast_keeps_int8_leaves(setup):
    params, model = setup
    q = tw.quantize_encoder_int8(model)
    cast = tw.cast_params(q, torch.bfloat16)
    blk, src = cast.encoder.blocks[0], q.encoder.blocks[0]
    assert blk.attn.query.w8.dtype == torch.int8
    assert blk.attn.query.s.dtype == torch.float32
    assert blk.mlp[0].w8.dtype == torch.int8
    assert blk.attn.query.bias.dtype == torch.bfloat16
    assert cast.decoder.token_embedding.weight.dtype == torch.bfloat16
    assert cast.dtype == torch.bfloat16
    # the codes and scales are the quantized model's, not re-derived
    assert torch.equal(blk.attn.query.w8, src.attn.query.w8)
    assert torch.equal(blk.attn.query.s, src.attn.query.s)
    assert src.attn.query.bias.dtype == torch.float32  # the caller's stays
    # the bf16 int8 encoder within JAX's int8 budget of the exact forward
    mel = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, (1, DIMS.n_mels, 2 * DIMS.n_audio_ctx)).astype(np.float32))
    exact = tw.encode_audio(model, mel, device="cpu")
    got = tw.encode_audio(cast, mel, device="cpu").float()
    rel = (got - exact).abs().max() / exact.abs().max()
    assert rel < 0.06, rel
    # JAX's cast keeps the same leaves
    jcast = jcommon.cast_params(jw.quantize_encoder_int8(params), jnp.bfloat16)
    assert jcast["encoder"]["blocks"]["attn"]["q"]["s"].dtype == jnp.float32


def test_pipeline_encoder_int8_matches_jax(tmp_path):
    jm = japi.test_model(0)
    model = _port(jm.params, jm.dims)
    scp = make_timit_corpus(str(tmp_path), n_utts=4, seconds=(1.0, 2.0),
                            words_per_utt=(3, 5), seed=0)
    kw = dict(model="test", batch_size=4, use_gt_transcript=True, aggr="topk",
              decode_sample_len=8, encoder_int8=True)
    jp = jrunner.AlignmentPipeline(jm.params, jm.dims, jm.tokenizer,
                                   JaxAlignConfig.recommended(**kw))
    tp = trunner.AlignmentPipeline(model, get_test_tokenizer(),
                                   AlignConfig.recommended(**kw), device="cpu")
    assert tw.encoder_is_int8(tp.model) and not tw.encoder_is_int8(model)
    ours = list(tp.run_dataset(TIMIT(scp), progress=False))
    theirs = list(jp.run_dataset(JaxTIMIT(scp), progress=False))
    assert len(ours) == len(theirs) == 4
    frame = 1.0 / 50
    for a, b in zip(ours, theirs):
        assert a.fid == b.fid and a.words == b.words and len(a.words) >= 2
        np.testing.assert_allclose(a.start_times, b.start_times, rtol=0,
                                   atol=frame + 1e-9)
        np.testing.assert_allclose(a.end_times, b.end_times, rtol=0,
                                   atol=frame + 1e-9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_rows_plain(dtype):
    x = (torch.randn(9, 40, generator=torch.Generator().manual_seed(0))
         * 3).to(dtype)
    x[2] = 0
    codes, scales = int8_cuda.quantize_rows(x)
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    want_s = torch.where(amax == 0, torch.ones_like(amax),
                         amax * np.float32(1 / 127))
    assert torch.equal(scales, want_s) and scales[2].item() == 1.0
    assert torch.equal(codes, torch.clamp(torch.round(xf / want_s), -127,
                                          127).to(torch.int8))
    assert codes.abs().amax(dim=-1)[[0, 1, 3]].eq(127).all()
    # the JAX package's quantizer on the same rows, as XLA compiles it
    jq, js = jax.jit(jw._int8_rowwise)(jnp.asarray(xf.numpy()))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js))
    # a row max from elsewhere (a row-split layer's, over its model group)
    wider = amax * 2
    c2, s2 = int8_cuda.quantize_rows(x, wider)
    assert torch.equal(s2, int8_cuda.scale_of(wider))
    assert c2.abs().max() <= 64


def test_int_mm_and_epilogue_plain():
    g = torch.Generator().manual_seed(1)
    x8 = torch.randint(-127, 128, (11, 48), dtype=torch.int8, generator=g)
    w8 = torch.randint(-127, 128, (24, 48), dtype=torch.int8, generator=g)
    y = int8_cuda.int_mm(x8, w8)
    assert y.dtype == torch.int32
    assert torch.equal(y.double(), x8.double() @ w8.double().t())
    xs = torch.rand(11, 1, generator=g)
    s = torch.rand(24, generator=g)
    b = torch.randn(24, generator=g)
    t = y.float() * xs
    got = int8_cuda.dequantize(y, xs, s, b.to(torch.bfloat16), torch.bfloat16)
    assert torch.equal(got, (t * s).to(torch.bfloat16) + b.to(torch.bfloat16))
    # float32: one fused multiply-add, as XLA compiles JAX's epilogue
    got = int8_cuda.dequantize(y, xs, s, b, torch.float32)
    want = jax.jit(lambda t, s, b: t * s + b)(t.numpy(), s.numpy(), b.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(int8_cuda.dequantize(y, xs, s, None, torch.float32),
                       t * s)
    with pytest.raises(ValueError, match="int8"):
        int8_cuda.int_mm(x8.float(), w8)
    with pytest.raises(ValueError, match="scales"):
        int8_cuda.dequantize(y, xs[:3], s, None, torch.float32)


def _round_f32(v):
    """A rational rounded to the nearest float32, ties to even."""
    from fractions import Fraction

    f = np.float32(float(v))
    near = [np.nextafter(f, np.float32(-np.inf)), f,
            np.nextafter(f, np.float32(np.inf))]
    return min(near, key=lambda x: (abs(Fraction(float(x)) - v),
                                    int(np.float32(x).view(np.int32)) & 1))


def test_fma_f32_rounds_once():
    """The f32 epilogue's plain FMA is exact: against rational arithmetic
    on random values and on products planted next to a float32 tie with
    ``c`` (where rounding a float64 sum to float32 would round twice)."""
    from fractions import Fraction

    rng = np.random.default_rng(1)
    a = np.concatenate([rng.normal(size=500),
                        1 + rng.integers(1, 2 ** 20, 2500) * 2.0 ** -23])
    a = a.astype(np.float32)
    b = np.concatenate([rng.normal(size=500), 2.0 ** -24 / a[500:]])
    b = b.astype(np.float32)
    c = np.concatenate([rng.normal(size=500)
                        * 2.0 ** rng.integers(-30, 30, 500),
                        1 + 2.0 ** -23 * rng.integers(0, 4, 2500)])
    c = c.astype(np.float32)
    got = int8_cuda.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                            torch.from_numpy(c)).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (naive != want).sum() > 0  # the planted ties do round twice
