"""The port's Whisper model, mel frontend and checkpoint loading against the
JAX package, on the CPU, with the JAX weights carried across by
``convert.params_from_jax``. Bounds are the JAX package's own
(tests/test_model_parity.py): encoder states and logits within 2e-4,
attention stacks within 1e-5, mel within 2e-4."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_char_alignment_tpu import runner as jrunner
from whisper_char_alignment_tpu.audio import mel as jmel
from whisper_char_alignment_tpu.config import tiny_test_dims
from whisper_char_alignment_tpu.models import convert as jconvert
from whisper_char_alignment_tpu.models import whisper as jw
from whisper_char_alignment_tpu_torch.audio import mel as tmel
from whisper_char_alignment_tpu_torch.config import ModelDims
from whisper_char_alignment_tpu_torch.models import convert as tconvert
from whisper_char_alignment_tpu_torch.models import whisper as tw

torch.set_num_threads(1)

DIMS = tiny_test_dims(n_vocab=300, n_audio_ctx=40, n_text_ctx=24, state=32,
                      head=2, layers=2)


def _port_dims(dims):
    return ModelDims(**dataclasses.asdict(dims))


@pytest.fixture(scope="module")
def models():
    params = jw.init_params(jax.random.PRNGKey(3), DIMS)
    sd = tconvert.params_from_jax(jax.tree.map(np.asarray, params))
    model = tconvert.model_from_state_dict(sd, _port_dims(DIMS), device="cpu")
    return params, model


@pytest.fixture(scope="module")
def inputs(models):
    params, _ = models
    rng = np.random.default_rng(0)
    mel = rng.normal(size=(2, DIMS.n_mels, 2 * DIMS.n_audio_ctx)).astype(
        np.float32)
    tokens = rng.integers(0, DIMS.n_vocab, (2, 12)).astype(np.int32)
    xa = np.array(jw.encode_audio(params, DIMS, jnp.asarray(mel)))
    return mel, tokens, xa


def test_encode_audio_matches_jax(models, inputs):
    params, model = models
    mel, _, xa = inputs
    got = tw.encode_audio(model, torch.from_numpy(mel), device="cpu").numpy()
    np.testing.assert_allclose(got, xa, rtol=2e-4, atol=2e-4)


def test_decode_text_logits_and_qk_match_jax(models, inputs):
    params, model = models
    _, tokens, xa = inputs
    lj, qj = jw.decode_text(params, DIMS, jnp.asarray(tokens), jnp.asarray(xa))
    lt, qt = tw.decode_text(model, torch.from_numpy(tokens).long(),
                            torch.from_numpy(xa), device="cpu")
    assert qt.shape == (DIMS.n_text_layer, 2, DIMS.n_text_head, 12,
                        DIMS.n_audio_ctx)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("width", [3, 7])
def test_decode_text_attention_stack_matches_jax(models, inputs, width):
    params, model = models
    _, tokens, xa = inputs
    fl = np.array([DIMS.n_audio_ctx, 17], np.int32)
    tl = np.array([12, 6], np.int32)
    _, aj = jw.decode_text(params, DIMS, jnp.asarray(tokens), jnp.asarray(xa),
                           medfilt_width=width, frame_len=jnp.asarray(fl),
                           token_len=jnp.asarray(tl), qk_scale=1.0,
                           qkpost=False)
    _, at = tw.decode_text(model, torch.from_numpy(tokens).long(),
                           torch.from_numpy(xa), medfilt_width=width,
                           frame_len=torch.from_numpy(fl),
                           token_len=torch.from_numpy(tl), return_logits=False,
                           device="cpu")
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-5,
                               atol=1e-5)


def test_cross_kv_reuse_matches_xa_path(models, inputs):
    params, model = models
    _, tokens, xa = inputs
    ckv_j = jw.precompute_cross_kv(params, DIMS, jnp.asarray(xa))
    ckv_t = tw.precompute_cross_kv(model, torch.from_numpy(xa))
    assert ckv_t[0].shape == (DIMS.n_text_layer, 2, DIMS.n_text_head,
                              DIMS.n_text_head_dim, DIMS.n_audio_ctx)
    for a, b in zip(ckv_t, ckv_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    tok = torch.from_numpy(tokens).long()
    l_xa, q_xa = tw.decode_text(model, tok, torch.from_numpy(xa),
                                device="cpu")
    l_kv, q_kv = tw.decode_text(model, tok, None, cross_kv=ckv_t,
                                device="cpu")
    np.testing.assert_allclose(l_kv.numpy(), l_xa.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(q_kv.numpy(), q_xa.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_prefill_and_step_logits_match_jax(models, inputs):
    params, model = models
    _, tokens, xa = inputs
    ckv_j = jw.precompute_cross_kv(params, DIMS, jnp.asarray(xa))
    cache_j = jw.init_kv_cache(DIMS, 2, 10)
    pj, cache_j = jw.decode_prefill(params, DIMS, jnp.asarray(tokens[:, :4]),
                                    cache_j, ckv_j, logits_at=1)
    sj = []
    for pos in range(4, 7):
        lj, cache_j = jw.decode_step(params, DIMS,
                                     jnp.asarray(tokens[:, pos:pos + 1]),
                                     jnp.int32(pos), cache_j, ckv_j)
        sj.append(np.asarray(lj))
    ckv_t = tw.precompute_cross_kv(model, torch.from_numpy(xa))
    cache_t = tw.init_kv_cache(model.dims, 2, 10, device="cpu")
    tok = torch.from_numpy(tokens).long()
    pt, cache_t = tw.decode_prefill(model, tok[:, :4], cache_t, ckv_t,
                                    logits_at=1)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=2e-4,
                               atol=2e-4)
    for pos, want in zip(range(4, 7), sj):
        lt, cache_t = tw.decode_step(model, tok[:, pos:pos + 1], pos, cache_t,
                                     ckv_t)
        np.testing.assert_allclose(lt.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(cache_t["k"][..., :7].numpy(),
                               np.asarray(cache_j["k"])[..., :7], rtol=1e-5,
                               atol=1e-5)


def test_entry_points_refuse_a_missing_gpu(models, inputs, monkeypatch):
    _, model = models
    mel, _, _ = inputs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tw.encode_audio(model, torch.from_numpy(mel))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tconvert.model_from_state_dict(model.state_dict(), model.dims)


def test_cast_params_leaves_the_callers_module(models):
    _, model = models
    before = model.decoder.ln.weight.clone()
    bf = tw.cast_params(model, torch.bfloat16)
    assert bf is not model and bf.dtype == torch.bfloat16
    assert model.dtype == torch.float32
    assert torch.equal(model.decoder.ln.weight, before)
    assert tw.cast_params(model, torch.float32) is model


def test_init_params_is_seeded_and_shaped():
    dims = _port_dims(DIMS)
    a = tw.init_params(tw.Whisper(dims, device="cpu"),
                       torch.Generator().manual_seed(5))
    b = tw.init_params(tw.Whisper(dims, device="cpu"),
                       torch.Generator().manual_seed(5))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.encoder.blocks[0].mlp[0].weight
    assert abs(w.std().item() - DIMS.n_audio_state ** -0.5) < 0.02
    assert not a.encoder.blocks[0].attn.query.bias.any()
    np.testing.assert_array_equal(
        a.encoder.positional_embedding.numpy(),
        tw.sinusoids(DIMS.n_audio_ctx, DIMS.n_audio_state))


def test_openai_checkpoint_loads_to_the_same_tensors(models, tmp_path):
    params, _ = models
    path = str(tmp_path / "tiny.pt")
    jconvert.save_openai_pt(path, params, DIMS)
    sd, dims = tconvert.load_checkpoint(path)
    assert dims == _port_dims(DIMS)
    want = tconvert.params_from_jax(jax.tree.map(np.asarray, params))
    assert sorted(sd) == sorted(want)
    for k in want:
        assert torch.equal(sd[k], want[k]), k
    model = tconvert.model_from_state_dict(sd, dims, device="cpu")
    assert sorted(model.state_dict()) == sorted(want)


def test_other_checkpoint_formats_are_refused(tmp_path):
    # an Orbax checkpoint directory: read by the JAX package only
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tconvert.load_checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="unsupported"):
        tconvert.load_checkpoint(str(tmp_path / "x.bin"))


# ---------------------------------------------------------------------------
# mel frontend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_jax(n_mels):
    rng = np.random.default_rng(n_mels)
    audio = (0.1 * rng.normal(size=(2, 32000))).astype(np.float32)
    audio = np.pad(audio, ((0, 0), (0, 48000 - 32000)))
    want = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(audio),
                                               n_mels=n_mels))
    got = tmel.log_mel_spectrogram(torch.from_numpy(audio),
                                   n_mels=n_mels).numpy()
    assert got.shape == (2, n_mels, 300)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    one = tmel.log_mel_spectrogram(torch.from_numpy(audio[0]), n_mels=n_mels)
    np.testing.assert_allclose(one.numpy(), got[0], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_int16_wire_mel_matches_jax_mel_step(n_mels):
    rng = np.random.default_rng(7)
    wire = rng.integers(-8000, 8000, size=(2, 16000)).astype(np.int16)
    dims = dataclasses.replace(DIMS, n_mels=n_mels, n_audio_ctx=150)
    total = 2 * dims.n_audio_ctx * 160
    want = np.asarray(jrunner._mel_step(jnp.asarray(wire), dims,
                                        total_samples=total))
    got = tmel.wire_to_mel(torch.from_numpy(wire), n_mels,
                           total_samples=total).numpy()
    assert got.shape == (2, n_mels, 2 * dims.n_audio_ctx)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    as_f32 = tmel.wire_to_mel(torch.from_numpy(wire.astype(np.float32)
                                               / 32768.0), n_mels,
                              total_samples=total).numpy()
    np.testing.assert_array_equal(got, as_f32)


def test_pad_or_trim_numpy_and_torch():
    x = np.arange(10, dtype=np.float32)
    np.testing.assert_array_equal(tmel.pad_or_trim(x, 4), x[:4])
    np.testing.assert_array_equal(tmel.pad_or_trim(x, 12)[10:], [0, 0])
    t = torch.arange(10.0)[None]
    assert tmel.pad_or_trim(t, 12).shape == (1, 12)
    assert torch.equal(tmel.pad_or_trim(t, 3), t[:, :3])
