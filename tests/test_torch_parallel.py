"""Data and tensor parallelism of the port (``parallel/``) against one
process and the JAX package, on the CPU.

Ranks are gloo processes started here, meeting at a ``FileStore`` in the
test's own ``tmp_path`` (no port to race for between xdist workers); each
runs ``AlignmentPipeline(..., mesh=...)`` on the same weights (the JAX
package's, carried across) and corpus and writes its results back.

- ``make_mesh``'s rejections (JAX tests/test_multichip.py:47-66) and
  ``_pad_batch`` (JAX's with its meshes);
- the tensor-parallel layout covers the int8 leaves ``w8``/``s`` (JAX
  ``tensor_parallel_spec``), and ``shard_params`` slices as it says;
- a data-parallel pipeline (2 ranks, batches of 3 padded to 4: one rank
  gets a lone utterance or none; ``run_dataset`` and ``align_batch``) and
  a tensor-parallel one (2 ranks) give the single process's words and
  boundaries, which are JAX's; the int8
  encoder under a (2 x 2) mesh gives the single int8 process's words and
  boundaries, its encoder states bit-equal to one rank's;
- ``dryrun_multichip(4)`` (jump frames equal, logits within 2e-4) and
  ``broadcast_scalar`` to the millisecond."""

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from whisper_char_alignment_tpu import api as japi
from whisper_char_alignment_tpu import runner as jrunner
from whisper_char_alignment_tpu.config import AlignConfig as JaxAlignConfig
from whisper_char_alignment_tpu.data.dataset import TIMIT as JaxTIMIT
from whisper_char_alignment_tpu.data.synthetic import make_timit_corpus
from whisper_char_alignment_tpu.models import whisper as jw
from whisper_char_alignment_tpu.parallel import mesh as jmesh
from whisper_char_alignment_tpu_torch import runner as trunner
from whisper_char_alignment_tpu_torch.config import AlignConfig, ModelDims
from whisper_char_alignment_tpu_torch.data.dataset import TIMIT
from whisper_char_alignment_tpu_torch.models import convert as tconvert
from whisper_char_alignment_tpu_torch.models import whisper as tw
from whisper_char_alignment_tpu_torch.parallel import distributed
from whisper_char_alignment_tpu_torch.parallel import mesh as tmesh
from whisper_char_alignment_tpu_torch.parallel.dryrun import dryrun_multichip
from whisper_char_alignment_tpu_torch.text.tokenizer import get_test_tokenizer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one rank: the job's pipeline on its mesh; results (and, asked for, the
# encoder states of a mel batch) pickled to <out>.<rank>
WORKER = r"""
import pickle, sys
import torch
torch.set_num_threads(1)
from whisper_char_alignment_tpu_torch.config import AlignConfig, ModelDims
from whisper_char_alignment_tpu_torch.data.dataset import TIMIT
from whisper_char_alignment_tpu_torch.models import convert, whisper as tw
from whisper_char_alignment_tpu_torch.parallel import distributed, mesh
from whisper_char_alignment_tpu_torch.runner import AlignmentPipeline
from whisper_char_alignment_tpu_torch.text.tokenizer import get_test_tokenizer

rank, world, init, job = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
with open(job, "rb") as f:
    j = pickle.load(f)
distributed.initialize(init, world, rank, backend="gloo")
m = mesh.make_mesh(j["n_data"], j["n_model"], device="cpu")
model = convert.model_from_state_dict(j["sd"], ModelDims(**j["dims"]),
                                      device="cpu")
pipe = AlignmentPipeline(model, get_test_tokenizer(),
                         AlignConfig.recommended(**j["cfg"]), mesh=m)
out = dict(rows=pipe.rows, place=(m.data_index, m.model_index, m.replica),
           heads=pipe.model.encoder.blocks[0].attn.n_head,
           results=[(r.fid, r.words, r.start_times, r.end_times)
                    for r in pipe.run_dataset(TIMIT(j["scp"]),
                                              progress=False)])
ds = TIMIT(j["scp"])
out["batch"] = [(r.fid, r.words, r.start_times, r.end_times)
                for r in pipe.align_batch([ds[i] for i in range(3)])]
if j.get("mel") is not None:
    out["states"] = tw.encode_audio(pipe.model, j["mel"], device="cpu")
with open(j["out"] + "." + str(rank), "wb") as f:
    pickle.dump(out, f)
distributed.shutdown()
"""


def run_ranks(tmp_path, world: int, job: dict, timeout: int = 600):
    """Start ``world`` gloo ranks of :data:`WORKER` on ``job``; their
    outputs by rank."""
    job = dict(job, out=str(tmp_path / "rank"))
    job_path = tmp_path / "job.pkl"
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    init = Path(tmp_path, "store").as_uri()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world), init,
         str(job_path)], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    got = []
    for r in range(world):
        with open(f"{job['out']}.{r}", "rb") as f:
            got.append(pickle.load(f))
    return got


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jm = japi.test_model(0)
    dims = dataclasses.asdict(jm.dims)
    sd = tconvert.params_from_jax(jax.tree.map(np.asarray, jm.params))
    model = tconvert.model_from_state_dict(sd, ModelDims(**dims),
                                           device="cpu")
    scp = make_timit_corpus(str(tmp_path_factory.mktemp("corpus")), n_utts=4,
                            seconds=(1.0, 2.0), words_per_utt=(3, 5), seed=0)
    return jm, dims, sd, model, scp


def _cfg(**kw):
    return dict(dict(model="test", batch_size=3, use_gt_transcript=True,
                     aggr="topk", decode_sample_len=8), **kw)


def _single(setup, batch: bool = False, **kw):
    """One process's results of ``run_dataset`` (or, with ``batch``, of
    ``align_batch`` on the first 3 utterances)."""
    _, _, _, model, scp = setup
    pipe = trunner.AlignmentPipeline(model, get_test_tokenizer(),
                                     AlignConfig.recommended(**_cfg(**kw)),
                                     device="cpu")
    ds = TIMIT(scp)
    res = (pipe.align_batch([ds[i] for i in range(3)]) if batch
           else pipe.run_dataset(ds, progress=False))
    return [(r.fid, r.words, r.start_times, r.end_times) for r in res]


def _jax(setup, **kw):
    jm, _, _, _, scp = setup
    pipe = jrunner.AlignmentPipeline(jm.params, jm.dims, jm.tokenizer,
                                     JaxAlignConfig.recommended(**_cfg(**kw)))
    return [(r.fid, r.words, r.start_times, r.end_times)
            for r in pipe.run_dataset(JaxTIMIT(scp), progress=False)]


def _same(ours, theirs, frames: int = 0, n: int = 4):
    assert len(ours) == len(theirs) == n
    for a, b in zip(ours, theirs):
        assert a[0] == b[0] and a[1] == b[1] and len(a[1]) >= 2
        for x, y in ((a[2], b[2]), (a[3], b[3])):
            if frames:
                np.testing.assert_allclose(x, y, rtol=0,
                                           atol=frames / 50 + 1e-9)
            else:
                np.testing.assert_array_equal(x, y)


def test_make_mesh_rejects_what_the_world_cannot_hold():
    """JAX tests/test_multichip.py:47-66 in a world of one process: a
    negative count, a mesh wider than the world, an inferred data axis of 0;
    never a silently smaller mesh."""
    assert distributed.process_count() == 1
    with pytest.raises(ValueError, match="n_data"):
        tmesh.make_mesh(-1, device="cpu")
    with pytest.raises(ValueError, match="n_data"):
        tmesh.make_mesh(-1, n_model=2, device="cpu")
    for args, kw in (((2,), {}), ((2,), dict(n_model=2)),
                     ((None,), dict(n_model=2)), ((1,), dict(n_model=16))):
        with pytest.raises(ValueError, match="devices"):
            tmesh.make_mesh(*args, device="cpu", **kw)
    m = tmesh.make_mesh(None, device="cpu")
    assert tmesh.data_size(m) == 1 and m.shape == {"data": 1, "model": 1}
    assert (m.data_index, m.model_index, m.replica, m.n_replicas) == (0, 0,
                                                                      0, 1)
    assert tmesh.make_mesh(1, n_model=0, device="cpu").n_model == 1


def _fake_mesh(n_data=1, n_model=1, data_index=0, model_index=0):
    """A rank's place in a mesh without a world: the groups are this
    process alone (shapes and slices only; nothing is reduced)."""
    g = distributed.Group([0])
    return tmesh.Mesh(n_data=n_data, n_model=n_model, data_index=data_index,
                      model_index=model_index, replica=0, n_replicas=1,
                      device=torch.device("cpu"), data=g, model=g)


def test_pad_batch_rounds_to_the_data_axis_like_jax(setup):
    """JAX tests/test_multichip.py:69-97: a batch rounds up to a multiple of
    the data size, never max(batch, data)."""
    jm, _, _, model, _ = setup
    tok = get_test_tokenizer()
    for batch, n_data, n, want in ((12, 8, 5, 16), (3, 2, 3, 4), (4, 2, 4, 4),
                                   (5, 4, 3, 8)):
        tp = trunner.AlignmentPipeline(
            model, tok, AlignConfig.recommended(model="test",
                                                batch_size=batch),
            mesh=_fake_mesh(n_data=n_data))
        jp = jrunner.AlignmentPipeline(
            jm.params, jm.dims, jm.tokenizer,
            JaxAlignConfig.recommended(model="test", batch_size=batch),
            mesh=jmesh.make_mesh(n_data))
        assert tp._pad_batch(n) == jp._pad_batch(n) == want
        assert tp.rows == jp._pad_batch(batch) // n_data
    rows = list(range(3))
    m = _fake_mesh(n_data=2, data_index=1)
    assert tmesh.shard_rows(rows, 4, m) == [2]
    assert tmesh.shard_rows(rows[:1], 4, m) == []


def test_tensor_parallel_axis_covers_int8_leaves_like_jax(setup):
    """JAX tests/test_multichip.py:100-135: ``w8`` follows ``w``; ``s``
    splits with column-split layers and stays whole for row-split ones;
    convs, layer norms and embeddings are replicated. The one difference in
    kind: the port slices a column-split layer's bias (JAX keeps it whole
    and XLA slices it at the add)."""
    jm, _, _, model, _ = setup
    q = tw.quantize_encoder_int8(model)
    jq = jw.quantize_encoder_int8(jm.params)
    specs = {}
    jax.tree_util.tree_map_with_path(
        lambda path, x: specs.__setitem__(
            jax.tree_util.keystr(path), jmesh.tensor_parallel_spec(path, x)),
        jq)
    ours_to_theirs = {"query": "q", "key": "k", "value": "v", "out": "out",
                      "0": "fc1", "2": "fc2"}
    jax_axis = {jmesh.P(None, None, "model"): 0,
                jmesh.P(None, "model", None): 1, jmesh.P(): None}
    checked = 0
    for name in q.state_dict():
        parts = name.split(".")
        if len(parts) < 6 or parts[2] != "0":
            continue  # layer 0 of each stack stands for all
        stack, _, _, group, lin, leaf = parts
        jleaf = {"weight": "w", "bias": "b"}.get(leaf, leaf)
        jgroup = {"attn": "attn", "cross_attn": "cross_attn",
                  "mlp": "mlp"}[group]
        key = (f"['{stack}']['blocks']['{jgroup}']"
               f"['{ours_to_theirs[lin]}']['{jleaf}']")
        want = jax_axis[specs[key]]
        if leaf == "bias" and lin in ("query", "key", "value", "0"):
            want = 0
        assert tmesh.tensor_parallel_axis(name) == want, name
        checked += 1
    assert checked > 20
    enc = "encoder.blocks.0"
    assert tmesh.tensor_parallel_axis(f"{enc}.attn.query.w8") == 0
    assert tmesh.tensor_parallel_axis(f"{enc}.attn.query.s") == 0
    assert tmesh.tensor_parallel_axis(f"{enc}.attn.out.w8") == 1
    assert tmesh.tensor_parallel_axis(f"{enc}.attn.out.s") is None
    assert tmesh.tensor_parallel_axis(f"{enc}.mlp.2.s") is None
    for name in ("encoder.conv1.weight", "encoder.blocks.0.attn_ln.weight",
                 "decoder.token_embedding.weight",
                 "decoder.positional_embedding"):
        assert tmesh.tensor_parallel_axis(name) is None


def test_shard_params_slices_as_the_spec_says(setup):
    _, _, _, model, _ = setup
    q = tw.quantize_encoder_int8(model)
    full = q.state_dict()
    for idx in (0, 1):
        m = tmesh.shard_params(q, _fake_mesh(n_model=2, model_index=idx))
        assert m.tp_group is not None and q.tp_group is None
        for blk in (*m.encoder.blocks, *m.decoder.blocks):
            assert blk.attn.n_head == 1 and blk.attn.head_dim == 16
        assert isinstance(m.decoder.blocks[0].attn.out, tw.SplitLinear)
        assert m.encoder.blocks[0].attn.out.group is m.tp_group
        assert m.encoder.blocks[0].attn.query.group is None
        assert tw.text_heads(m) == 1 and tw.text_heads(q) == 2
        for name, t in m.state_dict().items():
            axis = tmesh.tensor_parallel_axis(name)
            if axis is None:
                assert torch.equal(t, full[name]), name
            else:
                n = full[name].shape[axis] // 2
                assert torch.equal(t, full[name].narrow(axis, idx * n, n)), (
                    name)
                assert t.dtype == full[name].dtype
    assert tmesh.shard_params(q, _fake_mesh()) is q  # no model axis


def test_data_parallel_pipeline_matches_one_process_and_jax(setup, tmp_path):
    jm, dims, sd, _, scp = setup
    got = run_ranks(tmp_path, 2, dict(n_data=2, n_model=1, sd=sd, dims=dims,
                                      cfg=_cfg(), scp=scp))
    single = _single(setup)
    _same(single, _jax(setup))
    batch = _single(setup, batch=True)
    for rank, out in enumerate(got):
        assert out["place"] == (rank, 0, 0) and out["rows"] == 2
        _same(out["results"], single)
        _same(out["batch"], batch, n=3)  # align_batch builds its own wire


def test_tensor_parallel_pipeline_matches_one_process_and_jax(setup,
                                                              tmp_path):
    jm, dims, sd, _, scp = setup
    got = run_ranks(tmp_path, 2, dict(n_data=1, n_model=2, sd=sd, dims=dims,
                                      cfg=_cfg(), scp=scp))
    single = _single(setup)
    _same(single, _jax(setup))
    for rank, out in enumerate(got):
        assert out["place"] == (0, rank, 0) and out["heads"] == 1
        _same(out["results"], single)


def test_int8_tensor_parallel_is_one_int8_rank_bit_for_bit(setup, tmp_path):
    """The int8 encoder over a (2 x 2) mesh: row-split layers take the whole
    row's max over the model group and sum exact int32 partial products,
    so the states are one rank's bit for bit (JAX
    tests/test_multichip.py:239-271), and so are the words and boundaries;
    those are JAX's within a frame (tests/test_torch_encoder_int8.py says
    why not exactly)."""
    jm, dims, sd, model, scp = setup
    mel = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (2, dims["n_mels"], 2 * dims["n_audio_ctx"])).astype(
            np.float32))
    got = run_ranks(tmp_path, 4, dict(n_data=2, n_model=2, sd=sd, dims=dims,
                                      cfg=_cfg(encoder_int8=True), scp=scp,
                                      mel=mel))
    states = tw.encode_audio(tw.quantize_encoder_int8(model), mel,
                             device="cpu")
    single = _single(setup, encoder_int8=True)
    _same(single, _jax(setup, encoder_int8=True), frames=1)
    for out in got:
        assert torch.equal(out["states"], states)
        _same(out["results"], single)


def test_dryrun_multichip_four_processes():
    dryrun_multichip(4)


BROADCAST = r"""
import sys
from whisper_char_alignment_tpu_torch.parallel import distributed
distributed.initialize(sys.argv[2], 2, int(sys.argv[1]), backend="gloo")
v = distributed.broadcast_scalar(1755443211.789 + int(sys.argv[1]))
c = distributed.allreduce_counters(dict(tp=3, fn=1 + int(sys.argv[1])),
                                   contribute=sys.argv[1] == "0")
print("GOT %.3f" % v, c)
distributed.shutdown()
"""


def test_broadcast_scalar_keeps_the_millisecond(tmp_path):
    """JAX tests/test_multihost.py:188-232: rank 0's timestamp reaches
    every rank to the millisecond (an int64 count, never a float32 on a
    ~128 s grid); counters of a rank that does not contribute add zeros."""
    init = Path(tmp_path, "store").as_uri()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", BROADCAST, str(r), init],
                              env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert "GOT 1755443211.789 {'fn': 1.0, 'tp': 3.0}" in out, out
    assert distributed.broadcast_scalar(1755443211.789) == 1755443211.789
