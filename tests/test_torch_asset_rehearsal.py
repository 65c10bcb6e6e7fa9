"""The port's asset-day rehearsal (``scripts/rehearse_asset_day.py``) on the
CPU: its chain (``api.load_model`` -> ``api.align``) against the
independent HF-torch twin and against the JAX script's chain, on assets
the port writes in the real formats.

- ``run_rehearsal`` at tiny dims returns 0 against the twin (zero word
  mismatches, boundaries <= 20 ms, multi-word and pairwise distinct
  payloads), with the real files on disk;
- the port-written ``.pt`` and ``.safetensors`` load through the JAX
  package's ``convert.load_checkpoint`` to the port model's arrays;
- the port's chain and the JAX script's ``jax_align_chain`` on the same
  port-written assets in ground-truth mode: the same words and boundaries;
- counterparts of the JAX tier-1 tests ``test_twin_medfilt_matches_production``
  and ``test_prob_domain_capture_identity``.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

from whisper_char_alignment_tpu.models import convert as jconvert
from whisper_char_alignment_tpu_torch.models import convert as tconvert
from whisper_char_alignment_tpu_torch.ops.medfilt import median_filter
from whisper_char_alignment_tpu_torch.scripts import rehearse_asset_day as reh

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_reh():
    """The JAX script, loaded as its own tests load it."""
    spec = importlib.util.spec_from_file_location(
        "jax_rehearse_asset_day", os.path.join(REPO, "scripts",
                                               "rehearse_asset_day.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    dims = reh.rehearsal_dims(medium=False)
    d = str(tmp_path_factory.mktemp("assets"))
    return dims, reh.make_assets(d, dims, seed=reh.SEED)


def test_rehearsal_tiny_dims_end_to_end(tmp_path):
    """Both formats through ``load_checkpoint``, the tokenizer directory
    through ``get_tokenizer``, the chain on both engines. The default seed
    transcribes to several words, so the comparison is over real
    boundaries; ``run_rehearsal`` also fails degenerate or identical
    payloads."""
    dims = reh.rehearsal_dims(medium=False)
    assert reh.run_rehearsal(dims, seed=reh.SEED, n_utts=2, sample_len=16,
                             out_dir=str(tmp_path), device="cpu") == 0
    for name in ("model.pt", "model.safetensors",
                 "tokenizer/multilingual.tiktoken"):
        assert (tmp_path / name).exists()


def test_port_assets_load_through_the_jax_loader(assets):
    dims, files = assets
    sd, tdims = tconvert.load_checkpoint(files["pt"])
    assert tdims == dims
    want = jconvert._flatten(tconvert.params_to_jax(sd))
    for fmt in ("pt", "safetensors"):
        params, jdims = jconvert.load_checkpoint(files[fmt])
        assert (jdims.n_audio_state, jdims.n_audio_layer, jdims.n_vocab) == (
            dims.n_audio_state, dims.n_audio_layer, dims.n_vocab)
        got = jconvert._flatten(params)
        assert set(got) == set(want), fmt
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)


def test_format_parity_refuses_a_different_file(assets, tmp_path):
    """``check_format_parity`` holds the two files to each other: a
    safetensors of other weights fails it."""
    dims, files = assets
    other = reh.make_assets(str(tmp_path), dims, seed=reh.SEED + 1,
                            formats=("safetensors",))
    reh.check_format_parity(files, dims)
    with pytest.raises(AssertionError):
        reh.check_format_parity(
            {"pt": files["pt"], "safetensors": other["safetensors"]}, dims)


def test_port_chain_matches_the_jax_chain(assets, jax_reh):
    """Ground-truth mode on the port-written assets: the same words and
    boundaries from the port's ``api.align`` and the JAX package's."""
    dims, files = assets
    audios = reh.make_audio(dims, n_utts=2, seed=reh.SEED)
    gt = list(reh.GT_TEXTS[:2])
    ours = reh.port_align_chain(files["pt"], files["tokenizer_dir"], audios,
                                sample_len=8, gt_texts=gt, device="cpu")
    theirs = jax_reh.jax_align_chain(files["pt"], files["tokenizer_dir"],
                                     audios, sample_len=8, gt_texts=gt)
    for a, b in zip(ours, theirs):
        assert list(a["words"]) == list(b["words"]) and len(a["words"]) >= 8
        np.testing.assert_array_equal(a["starts"], b["starts"])
        np.testing.assert_array_equal(a["ends"], b["ends"])
        assert a["transcription"] == b["transcription"]


def test_twin_medfilt_matches_production():
    """The twin's reflect-pad frame median equals the port's production
    median filter on full-width rows (both implement whisper.timing
    median_filter semantics, reference timing.py:65)."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 3, 7, 30))
    for width in (3, 5, 7):
        ours = median_filter(torch.from_numpy(x), width).numpy()
        twin = reh._medfilt_frames(x, width)
        np.testing.assert_allclose(ours, twin, atol=1e-12)


def test_prob_domain_capture_identity():
    """The twin rebuilds the reference's sliced-QK medfilt + softmax from
    post-softmax probabilities (``torch_align_chain``'s docstring has the
    proof): for qk_scale=1, renormalized medfilt(softmax(qk)[..., :F]) ==
    softmax(medfilt(qk[..., :F]))."""
    rng = np.random.default_rng(1)
    qk = rng.normal(0, 2, (4, 5, 9, 40))
    f = 23
    for width in (3, 7):
        med = reh._medfilt_frames(qk[..., :f], width)
        ref = np.exp(med - med.max(-1, keepdims=True))
        ref = ref / ref.sum(-1, keepdims=True)
        p = np.exp(qk - qk.max(-1, keepdims=True))
        p = p / p.sum(-1, keepdims=True)
        tw = reh._medfilt_frames(p[..., :f], width)
        tw = tw / tw.sum(-1, keepdims=True)
        np.testing.assert_allclose(tw, ref, atol=1e-12)


def test_compare_chains_names_each_failure():
    ok = {"transcription": "a b", "words": [" a", " b"],
          "starts": np.array([0.0, 0.4]), "ends": np.array([0.4, 0.8])}
    assert reh.compare_chains(ok, dict(ok)) == []
    late = dict(ok, ends=np.array([0.4, 0.84]))
    assert reh.compare_chains(ok, late) == ["ends worst delta 40 ms > 20 ms"]
    assert "words differ" in reh.compare_chains(
        ok, dict(ok, words=[" a", " c"]))[0]
    assert "transcription differs" in reh.compare_chains(
        ok, dict(ok, transcription="a c"))[0]
