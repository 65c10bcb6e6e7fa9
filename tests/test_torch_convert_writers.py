"""The port's checkpoint writers against the JAX package's readers, and the
JAX package's writers against the port's reader, on the CPU.

A tiny JAX model (``tiny_test_dims``, PRNGKey 0) is carried into the port
with ``params_from_jax``. Every file the port writes (``.pt`` in float32
and float16, ``.npz`` of a float and of an int8-encoder tree,
``.safetensors``) is read by JAX ``load_checkpoint`` into the tree JAX's
own writer gives, bit for bit (the float16 file: the float16-rounded
weights); every file JAX writes is read by the port into the state dict
``params_from_jax`` gives. Then the asset-day path: the JAX and the port
``infer_ali`` given ``--checkpoint`` on one port-written file and
``--tokenizer_dir`` on a ``multilingual.tiktoken`` of the toy ranks write
predictions with the same words and boundaries."""

import base64
import dataclasses
import glob
import os
import pickle

import joblib
import numpy as np
import pytest
import torch

import jax

from whisper_char_alignment_tpu.cli import infer_ali as jinfer
from whisper_char_alignment_tpu.config import tiny_test_dims
from whisper_char_alignment_tpu.data.synthetic import make_timit_corpus
from whisper_char_alignment_tpu.models import convert as jconvert
from whisper_char_alignment_tpu.models import whisper as jwhisper
from whisper_char_alignment_tpu_torch.cli import infer_ali
from whisper_char_alignment_tpu_torch.config import ModelDims
from whisper_char_alignment_tpu_torch.models import convert as tconvert
from whisper_char_alignment_tpu_torch.models import whisper as tw
from whisper_char_alignment_tpu_torch.text.bpe import toy_ranks
from whisper_char_alignment_tpu_torch.text.tokenizer import get_test_tokenizer

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_model():
    """(JAX dims, JAX numpy tree, port dims, port model on the CPU)."""
    dims = tiny_test_dims(n_vocab=get_test_tokenizer().n_vocab,
                          n_audio_ctx=32, n_text_ctx=24, state=16, head=2,
                          layers=2)
    params = jax.tree.map(np.asarray,
                          jwhisper.init_params(jax.random.PRNGKey(0), dims))
    tdims = ModelDims(**dataclasses.asdict(dims))
    model = tconvert.model_from_state_dict(tconvert.params_from_jax(params),
                                           tdims, device="cpu")
    return dims, params, tdims, model


def _int8(params):
    return jax.tree.map(np.asarray, jwhisper.quantize_encoder_int8(params))


def _same_tree(got, want):
    """Equal structure, dtypes and bits."""
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _fp16_rounded(params):
    return jax.tree.map(
        lambda a: a.astype(np.float16).astype(np.float32), params)


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_params_to_jax_inverts_params_from_jax(jax_model, kind):
    _, params, _, _ = jax_model
    tree = params if kind == "float" else _int8(params)
    _same_tree(tconvert.params_to_jax(tconvert.params_from_jax(tree)), tree)


# (file, port writer's kind): the JAX writer that writes the same layout
_PORT_WRITES = [("model.pt", "float32"), ("model.pt", "float16"),
                ("model.npz", "float"), ("model.npz", "int8"),
                ("model.safetensors", "float")]


@pytest.mark.parametrize("name,kind", _PORT_WRITES)
def test_port_written_checkpoints_read_by_jax(jax_model, tmp_path, name,
                                              kind):
    dims, params, tdims, model = jax_model
    path = str(tmp_path / name)
    want = params
    if name.endswith(".pt"):
        dtype = getattr(torch, kind)
        tconvert.save_openai_pt(path, model, dtype=dtype)
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        assert ckpt["dims"] == dataclasses.asdict(dims)
        assert all(v.dtype == dtype for v in ckpt["model_state_dict"].values())
        if kind == "float16":
            want = _fp16_rounded(params)
    elif name.endswith(".npz"):
        if kind == "int8":
            want = _int8(params)
            model = tw.quantize_encoder_int8(model)
        tconvert.save_npz(path, model)
    else:
        tconvert.save_hf_safetensors(path, model)
    got, got_dims = jconvert.load_checkpoint(path)
    _same_tree(got, want)
    # and JAX's own writer of the same layout gives the same tree and dims
    theirs = str(tmp_path / ("jax_" + name))
    if name.endswith(".pt"):
        jconvert.save_openai_pt(theirs, want, dims)
    elif name.endswith(".npz"):
        jconvert.save_npz(theirs, want, dims)
    else:
        jconvert.save_hf_safetensors(theirs, want, dims)
    jtree, jdims = jconvert.load_checkpoint(theirs)
    _same_tree(got, jtree)
    assert got_dims == jdims
    if not name.endswith(".safetensors"):  # heads are inferred from shapes
        assert got_dims == dims


@pytest.mark.parametrize("name,kind", [("model.pt", "float"),
                                       ("model.npz", "float"),
                                       ("model.npz", "int8"),
                                       ("model.safetensors", "float")])
def test_jax_written_checkpoints_read_by_port(jax_model, tmp_path, name,
                                              kind):
    dims, params, tdims, _ = jax_model
    tree = params if kind == "float" else _int8(params)
    path = str(tmp_path / name)
    if name.endswith(".pt"):
        jconvert.save_openai_pt(path, tree, dims)
    elif name.endswith(".npz"):
        jconvert.save_npz(path, tree, dims)
    else:
        jconvert.save_hf_safetensors(path, tree, dims)
    sd, got_dims = tconvert.load_checkpoint(path)
    want = tconvert.params_from_jax(tree)
    assert set(sd) == set(want)
    for k, v in want.items():
        assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k
    assert dataclasses.asdict(got_dims) == dataclasses.asdict(
        jconvert.load_checkpoint(path)[1])
    if kind == "int8":
        model = tconvert.model_from_state_dict(sd, got_dims, device="cpu")
        assert tw.encoder_is_int8(model)


def test_hf_state_dict_names_invert_the_reader(jax_model):
    dims, params, _, model = jax_model
    hf = tconvert.to_hf_state_dict(model)
    assert all(k.startswith("model.") for k in hf)
    assert not any(k.endswith("k_proj.bias") or "proj_out" in k for k in hf)
    assert all(v.dtype == np.float32 for v in hf.values())
    back = tconvert.state_dict_from_hf(hf)
    sd = model.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    # the JAX writer's names and arrays
    want = jconvert.to_hf_state_dict(params, dims)
    assert set(hf) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(hf[k], v)


@pytest.mark.parametrize("writer", ["pt", "safetensors", "openai_state_dict",
                                    "hf_state_dict"])
def test_int8_encoder_refused_where_the_layout_cannot_hold_it(jax_model,
                                                              tmp_path,
                                                              writer):
    model = tw.quantize_encoder_int8(jax_model[3])
    call = {"pt": lambda: tconvert.save_openai_pt(str(tmp_path / "m.pt"),
                                                   model),
            "safetensors": lambda: tconvert.save_hf_safetensors(
                str(tmp_path / "m.safetensors"), model),
            "openai_state_dict": lambda: tconvert.to_openai_state_dict(model),
            "hf_state_dict": lambda: tconvert.to_hf_state_dict(model)}[writer]
    with pytest.raises(ValueError, match=r"\.npz"):
        call()
    assert not os.listdir(tmp_path)


def test_openai_state_dict_keeps_the_model_dtype(jax_model):
    model = tw.cast_params(jax_model[3], torch.bfloat16)
    sd = tconvert.to_openai_state_dict(model)
    assert set(sd) == set(model.state_dict())
    assert all(v.dtype == torch.bfloat16 and v.device.type == "cpu"
               for v in sd.values())
    assert all(v.dtype == torch.float16 for v in
               tconvert.to_openai_state_dict(model, torch.float16).values())


def _tokenizer_dir(root):
    """The toy ranks in the published ``multilingual.tiktoken`` format, as
    scripts/rehearse_asset_day.py writes them."""
    with open(os.path.join(root, "multilingual.tiktoken"), "wb") as f:
        for k, v in toy_ranks().items():
            f.write(base64.b64encode(k) + b" " + str(v).encode() + b"\n")
    return root


@pytest.mark.parametrize("ext", [".pt", ".npz"])
def test_asset_day_cli_on_a_port_written_checkpoint(jax_model, tmp_path,
                                                    monkeypatch, ext):
    """Both ``infer_ali`` CLIs with ``--checkpoint`` on the same port-written
    file and ``--tokenizer_dir``: the same words and boundaries."""
    _, _, _, model = jax_model
    ckpt = str(tmp_path / ("model" + ext))
    (tconvert.save_openai_pt if ext == ".pt" else tconvert.save_npz)(
        ckpt, model)
    tok_dir = _tokenizer_dir(str(tmp_path))
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    # the tiny model's window is 0.64 s; utterances fit
    scp = make_timit_corpus(str(corpus), n_utts=3, seconds=(0.3, 0.5),
                            words_per_utt=(2, 3), seed=0)
    argv = ["--dataset", "TIMIT", "--scp", scp, "--model", "medium",
            "--aggr", "topk", "--topk", "2", "--aligned_unit_type", "char",
            "--medfilt_width", "3", "--batch_size", "2",
            "--use_gt_transcript", "--decode_sample_len", "4",
            "--save_prediction", "--checkpoint", ckpt, "--tokenizer_dir",
            tok_dir]
    want = jinfer.main(argv + ["--output_dir", str(tmp_path / "jax")])
    monkeypatch.setenv("WCA_PLATFORM", "cpu")
    got = infer_ali.main(argv + ["--output_dir", str(tmp_path / "port")])
    assert got == want
    (jpkl,) = glob.glob(str(tmp_path / "jax" / "*-predictions.pkl"))
    (tpkl,) = glob.glob(str(tmp_path / "port" / "*-predictions.pkl"))
    theirs = joblib.load(jpkl)
    with open(tpkl, "rb") as f:
        ours = pickle.load(f)
    assert sorted(ours) == sorted(theirs) and len(ours) >= 2
    for i in ours:
        a, b = ours[i], theirs[i]
        assert a["fids"] == b["fids"]
        assert a["predwords"] == b["predwords"] and len(a["predwords"]) >= 2
        np.testing.assert_array_equal(a["starts_hat"], b["starts_hat"])
        np.testing.assert_array_equal(a["ends_hat"], b["ends_hat"])
