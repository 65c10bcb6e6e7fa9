"""``whisper.forward`` and ``whisper.qk_to_attention`` against the JAX
package's, and the port against a random tiny HF Whisper, on the CPU.

- ``forward`` (encoder, then the teacher-forced decoder with raw QK) on
  JAX weights carried across: logits and raw QK within 2e-4
  (tests/test_model_parity.py's tolerance); no kernel launches on the CPU.
- ``qk_to_attention`` at median widths 3, 7 and 17 on ragged lengths
  within 1e-6 (tests/test_torch_ops.py's tolerance for the post-process),
  and ``decode_text``'s in-layer post-process equal to it per layer.
- A random ``transformers.WhisperForConditionalGeneration`` with
  tests/test_model_parity.py's config, read by ``convert.from_hf_model``:
  the port's logits within 2e-4 of HF's, its softmaxed QK within 1e-5 of
  HF's ``cross_attentions`` — the independent twin the JAX suite trusts.
  That config's MLP is 2 x d_model wide, not Whisper's 4 x, which the
  loader takes from the checkpoint's shapes."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_char_alignment_tpu.config import tiny_test_dims
from whisper_char_alignment_tpu.models import whisper as jwhisper
from whisper_char_alignment_tpu_torch.config import ModelDims
from whisper_char_alignment_tpu_torch.models import convert as tconvert
from whisper_char_alignment_tpu_torch.models import whisper as tw
from whisper_char_alignment_tpu_torch.ops import _lib

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def carried():
    dims = tiny_test_dims(n_vocab=300, n_audio_ctx=48, n_text_ctx=24,
                          state=32, head=2, layers=3)
    params = jax.tree.map(np.asarray,
                          jwhisper.init_params(jax.random.PRNGKey(5), dims))
    model = tconvert.model_from_state_dict(
        tconvert.params_from_jax(params),
        ModelDims(**dataclasses.asdict(dims)), device="cpu")
    return dims, params, model


def _inputs(dims, b=3, t=11, seed=0):
    rng = np.random.default_rng(seed)
    mel = rng.normal(0, 1, (b, dims.n_mels, 2 * dims.n_audio_ctx)).astype(
        np.float32)
    tokens = rng.integers(0, dims.n_vocab, (b, t)).astype(np.int32)
    return mel, tokens


@pytest.mark.parametrize("return_qk", [True, False])
def test_forward_matches_jax(carried, return_qk):
    dims, params, model = carried
    mel, tokens = _inputs(dims)
    want_logits, want_qk = jwhisper.forward(
        jax.tree.map(jnp.asarray, params), dims, jnp.asarray(mel),
        jnp.asarray(tokens), return_qk=return_qk)
    before = _lib.launch_counts()
    logits, qk = tw.forward(model, torch.from_numpy(mel),
                            torch.from_numpy(tokens).long(),
                            return_qk=return_qk, device="cpu")
    assert _lib.launch_counts() == before  # the CPU path launches nothing
    assert logits.dtype == torch.float32
    assert logits.shape == (3, 11, dims.n_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=0, atol=2e-4)
    if not return_qk:
        assert qk is None and want_qk is None
        return
    assert qk.dtype == torch.float32
    assert qk.shape == (dims.n_text_layer, 3, dims.n_text_head, 11,
                        dims.n_audio_ctx)
    np.testing.assert_allclose(qk.numpy(), np.asarray(want_qk), rtol=0,
                               atol=2e-4)


def test_forward_refuses_a_missing_gpu(carried, monkeypatch):
    dims, _, model = carried
    mel, tokens = _inputs(dims, b=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tw.forward(model, torch.from_numpy(mel), torch.from_numpy(tokens))


@pytest.mark.parametrize("width", [3, 7, 17])
def test_qk_to_attention_matches_jax(width):
    rng = np.random.default_rng(width)
    b, h, t, f = 3, 2, 9, 40
    qk = rng.normal(0, 3, (b, h, t, f)).astype(np.float32)
    frame_len = np.array([40, 23, 1], np.int32)
    token_len = np.array([9, 4, 6], np.int32)
    want = jwhisper.qk_to_attention(jnp.asarray(qk), jnp.asarray(frame_len),
                                    jnp.asarray(token_len), width, 1.7)
    got = tw.qk_to_attention(torch.from_numpy(qk),
                             torch.from_numpy(frame_len),
                             torch.from_numpy(token_len), width, 1.7)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    half = tw.qk_to_attention(torch.from_numpy(qk),
                              torch.from_numpy(frame_len),
                              torch.from_numpy(token_len), width, 1.7,
                              attn_dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16
    assert torch.equal(half, got.to(torch.bfloat16))


def test_decode_text_post_process_is_qk_to_attention(carried):
    """``decode_text(..., medfilt_width=)`` gives, per layer,
    ``qk_to_attention`` of ``forward``'s raw QK, bit for bit."""
    dims, _, model = carried
    mel, tokens = _inputs(dims, seed=1)
    mel, tokens = torch.from_numpy(mel), torch.from_numpy(tokens).long()
    frame_len = torch.tensor([48, 30, 7], dtype=torch.int32)
    token_len = torch.tensor([11, 5, 8], dtype=torch.int32)
    _, raw = tw.forward(model, mel, tokens, device="cpu")
    xa = tw.encode_audio(model, mel, device="cpu")
    _, attn = tw.decode_text(model, tokens, xa, medfilt_width=7,
                             frame_len=frame_len, token_len=token_len,
                             qk_scale=1.3, return_logits=False, device="cpu")
    assert attn.shape == raw.shape
    for layer in range(dims.n_text_layer):
        assert torch.equal(attn[layer], tw.qk_to_attention(
            raw[layer], frame_len, token_len, 7, 1.3))


@pytest.fixture(scope="module")
def hf_model():
    """tests/test_model_parity.py's random tiny HF Whisper."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.WhisperConfig(
        vocab_size=213,
        num_mel_bins=80,
        d_model=32,
        encoder_layers=2,
        encoder_attention_heads=2,
        decoder_layers=3,
        decoder_attention_heads=2,
        encoder_ffn_dim=64,
        decoder_ffn_dim=64,
        max_source_positions=48,
        max_target_positions=24,
        attention_dropout=0.0,
        dropout=0.0,
        activation_dropout=0.0,
        pad_token_id=0,
        bos_token_id=1,
        eos_token_id=2,
        decoder_start_token_id=3,
    )
    cfg._attn_implementation = "eager"  # needed for output_attentions=True
    torch.manual_seed(0)
    model = transformers.WhisperForConditionalGeneration(cfg)
    model.eval()
    return model


def test_from_hf_model_reads_the_config_and_weights(hf_model):
    sd, dims = tconvert.from_hf_model(hf_model)
    cfg = hf_model.config
    assert dims == ModelDims(n_mels=80, n_audio_ctx=48, n_audio_state=32,
                             n_audio_head=2, n_audio_layer=2, n_vocab=213,
                             n_text_ctx=24, n_text_state=32, n_text_head=2,
                             n_text_layer=3)
    assert tconvert.dims_from_hf_config(cfg) == dims
    hf_sd = hf_model.state_dict()
    assert torch.equal(sd["decoder.token_embedding.weight"],
                       hf_sd["model.decoder.embed_tokens.weight"])
    assert torch.equal(sd["decoder.blocks.2.cross_attn.query.weight"],
                       hf_sd["model.decoder.layers.2.encoder_attn.q_proj"
                             ".weight"])
    assert not any("proj_out" in k for k in sd)


def test_forward_matches_hf(hf_model):
    sd, dims = tconvert.from_hf_model(hf_model)
    model = tconvert.model_from_state_dict(sd, dims, device="cpu")
    rng = np.random.default_rng(0)
    cfg = hf_model.config
    mel = rng.normal(0, 1, (2, cfg.num_mel_bins,
                            2 * cfg.max_source_positions)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int64)
    with torch.no_grad():
        out = hf_model(input_features=torch.from_numpy(mel),
                       decoder_input_ids=torch.from_numpy(tokens),
                       output_attentions=True)
    cross = torch.stack(out.cross_attentions)  # (L, B, H, T, F)
    logits, qk = tw.forward(model, torch.from_numpy(mel),
                            torch.from_numpy(tokens), device="cpu")
    np.testing.assert_allclose(logits.numpy(), out.logits.numpy(), rtol=0,
                               atol=2e-4)
    # the port's qk is pre-softmax; HF reports post-softmax probabilities
    np.testing.assert_allclose(torch.softmax(qk, -1).numpy(), cross.numpy(),
                               rtol=0, atol=1e-5)
