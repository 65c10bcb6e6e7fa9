"""Checkpoint formats: the port's ``load_checkpoint`` on ``.npz`` and HF
``.safetensors`` files written by the JAX package's own writers
(``save_npz``, ``save_hf_safetensors``) gives exactly the state dict
``params_from_jax`` makes of the same weights, and the JAX reader's dims."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from whisper_char_alignment_tpu.config import tiny_test_dims
from whisper_char_alignment_tpu.models import convert as jconvert
from whisper_char_alignment_tpu.models import whisper as jw
from whisper_char_alignment_tpu_torch.config import ModelDims
from whisper_char_alignment_tpu_torch.models import convert as tconvert

# 64-dimensional heads, so that the head count read back from safetensors
# shapes (d_model // 64 off the published table) is the written one
DIMS = tiny_test_dims(n_vocab=300, n_audio_ctx=40, n_text_ctx=24, state=128,
                      head=2, layers=2)


@pytest.fixture(scope="module")
def params():
    return jw.init_params(jax.random.PRNGKey(5), DIMS)


@pytest.mark.parametrize("fmt", ["npz", "safetensors"])
def test_checkpoint_loads_to_the_same_tensors(params, tmp_path, fmt):
    path = str(tmp_path / f"tiny.{fmt}")
    if fmt == "npz":
        jconvert.save_npz(path, params, DIMS)
    else:
        jconvert.save_hf_safetensors(path, params, DIMS)
    sd, dims = tconvert.load_checkpoint(path)
    _, jdims = jconvert.load_checkpoint(path)
    assert dims == ModelDims(**dataclasses.asdict(jdims))
    assert dims == ModelDims(**dataclasses.asdict(DIMS))
    want = tconvert.params_from_jax(jax.tree.map(np.asarray, params))
    assert sorted(sd) == sorted(want)
    for k in want:
        assert sd[k].dtype == torch.float32
        assert torch.equal(sd[k], want[k]), k
    model = tconvert.model_from_state_dict(sd, dims, device="cpu")
    assert sorted(model.state_dict()) == sorted(want)
