"""Data and tensor parallelism over ``torch.distributed`` (port of ``whisper_char_alignment_tpu/parallel/mesh.py``).

The JAX package lays a (data, model) mesh over the devices of one process
and lets XLA partition every step. Here a process owns one device, so a
mesh of ``n_data x n_model`` devices is as many ranks of the world
(``parallel/distributed.py``): rank ``r`` of a mesh sits at data index
``(r % size) // n_model`` and model index ``r % n_model``, and a world of
``W`` ranks holds ``W / size`` such meshes, the replicas of a sweep. Each
rank builds its data group (the ranks of its replica at its model index)
and its model group (the ranks at its data index).

- **Data**: a batch, padded to a multiple of ``n_data`` rows
  (:func:`pad_to_multiple`), gives each data index its contiguous rows
  (:func:`shard_rows`), and the per-utterance results come back in input
  order (:func:`gather_rows`). The weights are replicated.
- **Model** (tensor parallelism, :func:`shard_params`): q/k/v and fc1 split
  on their output columns (each rank runs ``n_head / n_model`` heads with no
  collective), out and fc2 on their input rows (their partial products are
  all-reduced and the bias added once after), everything else replicated;
  int8 leaves follow their float twins (:func:`tensor_parallel_axis`).

Not ported: ``disable_compile_cache_for_cpu_collectives``, a workaround of
XLA:CPU's compile cache.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from ..models import whisper as wmodel
from ..utils.device import resolve_device
from . import distributed
from .distributed import Group


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (data, model) mesh: the counts, its indices,
    its replica among the world's, its device, and its two groups."""
    n_data: int
    n_model: int
    data_index: int
    model_index: int
    replica: int
    n_replicas: int
    device: torch.device
    data: Group
    model: Group

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def size(self) -> int:
        return self.n_data * self.n_model


def _rank_device(device, rank: int, world: int) -> torch.device:
    """The rank's device: ``device`` as named, or for CUDA without an index
    the card of the rank's local index (``LOCAL_RANK``, else the rank).
    Ranks never wrap onto cards by a modulo: two ranks share a card only
    when the caller names it."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None or world == 1:
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank))
    n_cards = torch.cuda.device_count()
    if local >= n_cards:
        raise ValueError(
            f"rank {rank} would take cuda:{local}, but this host has "
            f"{n_cards} card(s): run one process per card, or name the "
            "device (e.g. device='cuda:0') to put several ranks on one card")
    return torch.device("cuda", local)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device=None) -> Mesh:
    """This rank's mesh of ``n_data x n_model`` ranks (``n_data=None``: the
    world's ranks over the model axis). Raises ``ValueError`` when a count
    is below 1 or the world has too few ranks (JAX ``mesh.py:47-80``: never
    a silently smaller mesh), or when the world does not split into whole
    meshes. ``device``: see :func:`_rank_device`."""
    world = distributed.process_count()
    rank = distributed.process_index()
    if n_data is not None and n_data < 1:
        raise ValueError(f"n_data must be >= 1 or None (auto), got {n_data}")
    n_model = max(1, n_model)
    n = n_data or world // n_model
    if n < 1 or n * n_model > world:
        raise ValueError(f"mesh ({n}x{n_model}) needs {max(n, 1) * n_model} "
                         f"devices (one process each), have {world}")
    size = n * n_model
    if world % size:
        raise ValueError(f"a world of {world} processes does not split into "
                         f"meshes of {size} devices")
    dev = _rank_device(device, rank, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    replicas = world // size
    data = model = None
    # every rank creates every group, in one order
    for r in range(replicas):
        for m in range(n_model):
            g = distributed.new_group(
                [r * size + d * n_model + m for d in range(n)])
            data = g or data
    for r in range(replicas):
        for d in range(n):
            g = distributed.new_group(
                [r * size + d * n_model + m for m in range(n_model)])
            model = g or model
    local = rank % size
    return Mesh(n_data=n, n_model=n_model, data_index=local // n_model,
                model_index=local % n_model, replica=rank // size,
                n_replicas=replicas, device=dev, data=data, model=model)


def data_size(mesh: Optional[Mesh]) -> int:
    """Ranks on the batch ('data') axis: the batch-padding multiple."""
    return 1 if mesh is None else mesh.n_data


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_rows(rows: Sequence, n_pad: int, mesh: Optional[Mesh]) -> List:
    """This data index's contiguous rows of a batch padded to ``n_pad``
    rows (a multiple of the data size): possibly fewer, or none, where the
    batch's real rows end."""
    if mesh is None or mesh.n_data == 1:
        return list(rows)
    k = n_pad // mesh.n_data
    return list(rows[mesh.data_index * k:(mesh.data_index + 1) * k])


def gather_rows(local: list, mesh: Optional[Mesh]) -> list:
    """Every data index's results of :func:`shard_rows`, in input order."""
    if mesh is None or mesh.n_data == 1:
        return local
    return [x for part in mesh.data.all_gather_object(local) for x in part]


def tensor_parallel_axis(name: str) -> Optional[int]:
    """The axis along which a model-axis rank holds its slice of the
    parameter or buffer ``name`` (the ``state_dict`` key), or None when it
    is replicated (JAX ``tensor_parallel_spec``, ``mesh.py:102-130``).
    Torch weights are (out, in): q/k/v and fc1 split on their output
    columns (axis 0: the weight, int8 ``w8`` and scales ``s``, and the bias,
    which JAX keeps whole and XLA slices at the add), out and fc2 on their
    input rows (axis 1 of ``weight``/``w8``; their ``s`` and bias stay
    whole: the reduced output is full on every rank). Convs, layer norms,
    embeddings and positions are replicated."""
    parts = name.split(".")
    leaf = parts[-1]
    parent = parts[-2] if len(parts) >= 2 else ""
    if "attn" in parts or "cross_attn" in parts:
        if parent in ("query", "key", "value"):
            return 0
        if parent == "out" and leaf in ("weight", "w8"):
            return 1
    if "mlp" in parts:
        if parent == "0":
            return 0
        if parent == "2" and leaf in ("weight", "w8"):
            return 1
    return None


def _slice(t: torch.Tensor, axis: int, index: int, n: int) -> torch.Tensor:
    size = t.shape[axis]
    if size % n:
        raise ValueError(f"a {tuple(t.shape)} tensor does not split {n} ways "
                         f"on axis {axis}")
    return t.narrow(axis, index * (size // n), size // n).clone()


def _shard_linear(lin: nn.Module, prefix: str, mesh: Mesh) -> nn.Module:
    """``lin`` (a float or int8 linear, ``prefix`` its module name) as this
    rank holds it: sliced per :func:`tensor_parallel_axis`; a row-split
    layer gets the model group, so its partial products are all-reduced."""
    n, idx = mesh.n_model, mesh.model_index
    row_split = False
    for pname, t in [*lin.named_parameters(recurse=False),
                     *lin.named_buffers(recurse=False)]:
        axis = tensor_parallel_axis(f"{prefix}.{pname}")
        if axis is None:
            continue
        row_split |= axis == 1
        part = _slice(t.detach(), axis, idx, n)
        if isinstance(t, nn.Parameter):
            setattr(lin, pname, nn.Parameter(part, requires_grad=False))
        else:
            setattr(lin, pname, part)
    if isinstance(lin, wmodel.Int8Linear):
        lin.out_features, lin.in_features = lin.w8.shape
        lin.group = mesh.model if row_split else None
        return lin
    if not row_split:
        lin.out_features, lin.in_features = lin.weight.shape
        return lin
    out = wmodel.SplitLinear(lin.weight.shape[1], lin.weight.shape[0],
                             bias=lin.bias is not None,
                             device=lin.weight.device, dtype=lin.weight.dtype)
    with torch.no_grad():
        out.weight.copy_(lin.weight)
        if lin.bias is not None:
            out.bias.copy_(lin.bias)
    out.requires_grad_(False)
    out.group = mesh.model
    return out


def shard_params(model: wmodel.Whisper, mesh: Mesh) -> wmodel.Whisper:
    """The model as this rank of ``mesh`` holds it: the same module on a
    mesh without a model axis (replicated); else a copy with this rank's
    slices (:func:`tensor_parallel_axis`), ``n_head / n_model`` heads per
    attention and the model group at ``model.tp_group`` (the captured
    attention is gathered over it, ``align/timing.get_attentions``)."""
    if mesh.n_model == 1:
        return model
    n = mesh.n_model
    dims = model.dims
    for heads in (dims.n_audio_head, dims.n_text_head):
        if heads % n:
            raise ValueError(f"{heads} heads do not split over a model axis "
                             f"of {n}")
    out = copy.deepcopy(model)
    for stack in ("encoder", "decoder"):
        for i, blk in enumerate(getattr(out, stack).blocks):
            pre = f"{stack}.blocks.{i}"
            for a in ("attn", "cross_attn"):
                attn = getattr(blk, a)
                if attn is None:
                    continue
                attn.n_head //= n
                for p in ("query", "key", "value", "out"):
                    setattr(attn, p, _shard_linear(getattr(attn, p),
                                                   f"{pre}.{a}.{p}", mesh))
            for j in (0, 2):
                blk.mlp[j] = _shard_linear(blk.mlp[j], f"{pre}.mlp.{j}", mesh)
    out.tp_group = mesh.model
    return out
