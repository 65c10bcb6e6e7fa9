"""A (data x model) mesh of gloo CPU processes against one process (port of ``__graft_entry__.dryrun_multichip``).

:func:`dryrun_multichip` starts ``n`` processes on this host, one rank
each, lays them out as a mesh of ``n / n_model`` data by ``n_model`` model
ranks (``WCA_DRYRUN_MODEL_AXIS``, default 2 when ``n`` is even), and runs
the full batched alignment step on tiny shapes: the batch split over the
data axis, the attention and MLP weights over the model axis
(``parallel/mesh.shard_params``), the capture's heads gathered, the count of
aligned rows all-reduced. Each rank checks its result against the same step
in one process: jump frames equal, logits within 2e-4 (the collectives sum
in another order). Run it as ``python -m
whisper_char_alignment_tpu_torch.parallel.dryrun 8``.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..align import timing
from ..config import tiny_test_dims
from ..models import whisper as wmodel
from . import distributed
from .mesh import make_mesh, shard_params

SOT_LEN = 3


def _step(model, mel, tokens, token_len, frame_len):
    """The alignment step of the JAX dryrun: capture, top-2 heads, DTW."""
    attn, logits = timing.get_attentions(
        model, mel, tokens, token_len, frame_len, medfilt_width=3,
        qk_scale=1.0, device="cpu")
    jump, _, _ = timing.force_align_batch(attn, token_len, frame_len,
                                          SOT_LEN, "topk", 2)
    return jump, logits


def _inputs(n_data: int, dims):
    b, t = 2 * n_data, 16  # two batch rows per data rank
    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.normal(
        0, 1, (b, dims.n_mels, 2 * dims.n_audio_ctx)).astype(np.float32))
    tokens = torch.zeros((b, t), dtype=torch.long)
    token_len = torch.full((b,), t, dtype=torch.int32)
    frame_len = torch.full((b,), dims.n_audio_ctx, dtype=torch.int32)
    return mel, tokens, token_len, frame_len


def _worker(rank: int, world: int, n_model: int, init: str) -> None:
    torch.set_num_threads(1)
    distributed.initialize(init, world, rank, backend="gloo")
    try:
        n_data = world // n_model
        mesh = make_mesh(n_data, n_model, device="cpu")
        dims = tiny_test_dims(n_vocab=512, n_audio_ctx=64, n_text_ctx=32,
                              state=32, head=4, layers=2)
        model = wmodel.init_params(wmodel.Whisper(dims, device="cpu"),
                                   torch.Generator().manual_seed(0))
        inputs = _inputs(n_data, dims)
        b = inputs[0].shape[0]
        k = b // n_data
        rows = slice(mesh.data_index * k, (mesh.data_index + 1) * k)
        jump, logits = _step(shard_params(model, mesh),
                             *(x[rows] for x in inputs))
        n_aligned = mesh.data.all_reduce(
            (jump >= 0).any(dim=-1).sum().reshape(1))
        jump = mesh.data.all_gather(jump, dim=0)
        logits = mesh.data.all_gather(logits, dim=0)
        assert jump.shape[0] == b and int(n_aligned) == b, (jump.shape,
                                                            n_aligned)
        ref_jump, ref_logits = _step(model, *inputs)
        torch.testing.assert_close(jump, ref_jump, rtol=0, atol=0)
        np.testing.assert_allclose(logits.numpy(), ref_logits.numpy(),
                                   rtol=2e-4, atol=2e-4)
    finally:
        distributed.shutdown()


def dryrun_multichip(n_devices: int) -> None:
    """Run the mesh of ``n_devices`` gloo CPU processes; raises unless every
    rank reproduced the single-process step."""
    n_model = int(os.environ.get("WCA_DRYRUN_MODEL_AXIS", "0")) or (
        2 if n_devices % 2 == 0 else 1)
    if n_devices % n_model:
        raise ValueError(f"model axis {n_model} must divide {n_devices}")
    n_data = n_devices // n_model
    tmp = tempfile.mkdtemp(prefix="wca_dryrun_")
    init = Path(tmp, "rendezvous").as_uri()
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    procs = [subprocess.Popen(
        [sys.executable, "-m", __spec__.name, "--worker", str(r),
         str(n_devices), str(n_model), init], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n_devices)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    failed = [(r, p.returncode, out[-2000:])
              for r, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    if failed:
        raise RuntimeError(f"dryrun ranks failed: {failed}")
    print(f"dryrun_multichip OK: mesh=({n_data}x{n_model}), "
          f"batch={2 * n_data}, aligned={2 * n_data}, sharded==single-process "
          "parity verified")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                sys.argv[5])
    else:
        dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
