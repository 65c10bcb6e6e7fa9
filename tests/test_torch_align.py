"""The port's alignment core against the JAX package, on the CPU: head scores
within 1e-5, top-k selections (with planted ties) and jump frames bit-equal
when both are fed the same attention stack."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_char_alignment_tpu.align import timing as jt
from whisper_char_alignment_tpu.models.whisper import qk_to_attention
from whisper_char_alignment_tpu.text.tokenizer import \
    get_test_tokenizer as jax_tokenizer
from whisper_char_alignment_tpu_torch.align import timing as tt
from whisper_char_alignment_tpu_torch.text import retokenize
from whisper_char_alignment_tpu_torch.text.tokenizer import get_test_tokenizer

torch.set_num_threads(1)

L, B, H, T, F = 4, 3, 3, 14, 120
SOT = 3


def _attention_stack(seed=0):
    """A post-processed (L, B, H, T, F) stack as the capture pass emits it."""
    rng = np.random.default_rng(seed)
    qk = rng.normal(0, 2, (L * B, H, T, F)).astype(np.float32)
    fl = np.array([F, 77, 40], np.int32)
    tl = np.array([T, 11, 8], np.int32)
    attn = np.asarray(qk_to_attention(jnp.asarray(qk), jnp.asarray(np.tile(fl, L)),
                                      jnp.asarray(np.tile(tl, L)), 3, 1.0))
    attn = np.array(attn).reshape(L, B, H, T, F)
    return attn, tl, fl


@pytest.mark.parametrize("w_coverage", [0.0, 0.5])
def test_head_scores_match_jax(w_coverage):
    attn, _, fl = _attention_stack()
    want = np.asarray(jt.head_scores(jnp.asarray(attn), jnp.asarray(fl), 1.0,
                                     1.0, w_coverage))
    got = tt.head_scores(torch.from_numpy(attn), torch.from_numpy(fl), 1.0,
                         1.0, w_coverage).numpy()
    assert got.shape == (B, L, H)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("topk", [1, 4, 12])
def test_topk_heads_equal_with_planted_ties(topk):
    rng = np.random.default_rng(topk)
    scores = np.round(rng.normal(size=(5, L, H)), 1).astype(np.float32)
    scores[0] = 1.0  # every head tied
    scores[1, :, 0] = scores[1, :, 1]  # ties inside each layer
    scores[2, 0] = scores[2, 3]  # ties across layers
    lj, hj = jt.topk_heads(jnp.asarray(scores), topk)
    lt, ht = tt.topk_heads(torch.from_numpy(scores), topk)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    # the reference's sorted(scores)[-topk:] with (layer, head) tie-break
    for b in range(scores.shape[0]):
        ref = sorted((float(scores[b, l, h]), l, h) for l in range(L)
                     for h in range(H))[-topk:]
        assert [(l, h) for _, l, h in ref] == list(zip(lt[b].tolist(),
                                                       ht[b].tolist()))


@pytest.mark.parametrize("aggr,topk", [("topk", 5), ("mean", -1)])
def test_force_align_batch_bit_equal(aggr, topk):
    attn, tl, fl = _attention_stack(1)
    jf_j, m_j, s_j = jt.force_align_batch(
        jnp.asarray(attn), jnp.asarray(tl), jnp.asarray(fl), SOT, aggr, topk,
        dtw_impl="scan")
    jf_t, m_t, s_t = tt.force_align_batch(
        torch.from_numpy(attn), torch.from_numpy(tl), torch.from_numpy(fl),
        SOT, aggr, topk)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(jf_t.numpy(), np.asarray(jf_j))
    if aggr == "topk":
        for a, b in zip(s_t[1:], s_j[1:]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    else:
        assert s_t is None and s_j is None


def test_safe_col_normalize_keeps_zero_columns():
    m = torch.zeros(2, 3, 4)
    m[0, :, 1] = torch.tensor([3.0, 4.0, 0.0])
    out = tt._safe_col_normalize(m)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out[0, :, 1].numpy(), [0.6, 0.8, 0.0])
    assert not out[1].any()


def test_grad_norm_passes_the_matrix_through():
    mat = torch.rand(2, 6, 9)
    out, scores = tt.aggregate_matrix(mat, "grad_norm", -1,
                                      torch.tensor([9, 9]))
    assert scores is None and torch.equal(out, mat)
    with pytest.raises(ValueError):
        tt.aggregate_matrix(mat, "bogus", -1, torch.tensor([9, 9]))


@pytest.mark.parametrize("unit", ["char", "subword"])
def test_force_align_single_utterance_matches_jax(unit):
    tok, jtok = get_test_tokenizer(), jax_tokenizer()
    text = "she had your dark suit"
    text_tokens = retokenize.encode(text, tok, unit)
    t = SOT + 1 + len(text_tokens) + 1
    rng = np.random.default_rng(3)
    ws = rng.random((2, 3, t, 90)).astype(np.float32)
    want = jt.force_align(jnp.asarray(ws), text_tokens, jtok, unit, "topk", 3,
                          frame_len=70)
    got = tt.force_align(torch.from_numpy(ws), text_tokens, tok, unit, "topk",
                         3, frame_len=70)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6, atol=1e-7)
    assert [s[1:] for s in got[4]] == [s[1:] for s in want[4]]


def test_words_boundaries_and_times():
    tok = get_test_tokenizer()
    text_tokens = retokenize.encode("in greasy wash", tok, "char")
    words, word_tokens, wb = tt.words_and_boundaries(text_tokens, tok, "char")
    assert [w.strip() for w in words[:-1]] == ["in", "greasy", "wash"]
    jf = np.arange(len(text_tokens) + 1) * 5
    starts, ends = tt.jump_frames_to_times(jf, wb)
    np.testing.assert_allclose(starts, jf[wb[:-1]] / 50.0)
    np.testing.assert_allclose(ends, jf[wb[1:]] / 50.0)
    assert tt.words_and_boundaries([], tok, "char")[2] is None
