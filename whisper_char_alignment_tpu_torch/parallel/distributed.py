"""Process groups for multi-GPU runs (port of ``whisper_char_alignment_tpu/parallel/distributed.py``).

One process owns one device. A run of one process needs nothing here. A
run of several calls :func:`initialize` first: ``torch.distributed`` over
``tcp://coordinator`` (or a ``file://`` rendezvous), NCCL for CUDA and gloo
for the CPU or when asked. A dataset sweep then gives each replica its
round-robin shard of the scp (:func:`shard_entries`) and sums its metric
counters at the end (:func:`allreduce_counters`); ``parallel/mesh.py``
builds the data and model groups that a mesh's collectives run over
(:class:`Group`).

Host values (counters, the output stem, gathered results) always travel
over gloo: with an NCCL world :func:`initialize` opens a gloo group of the
same ranks beside it.
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

# the gloo group of the whole world, for host values (set by initialize)
_HOST = None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_s: float = 1800.0) -> None:
    """Join the world of ``num_processes`` processes as rank ``process_id``
    (a no-op for one process). ``coordinator_address`` is ``host:port`` of
    the rendezvous (``tcp://`` is added) or a ``file://`` path on a file
    system every process sees. ``backend`` defaults to NCCL when a card is
    present and gloo otherwise; pass ``"gloo"`` for CPU ranks, or for
    ranks that share a card."""
    global _HOST
    if num_processes in (None, 1):
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("a world of several processes needs "
                         "--coordinator_address and --process_id")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init,
                            world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout_s))
    _HOST = (dist.group.WORLD if backend == "gloo"
             else dist.new_group(backend="gloo"))


def shutdown() -> None:
    """Leave the world (nothing when there is none)."""
    global _HOST
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST = None


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def shard_entries(entries, index: Optional[int] = None,
                  count: Optional[int] = None):
    """Round-robin shard of scp entries: the ``index``-th of ``count``
    (default: this process of the world)."""
    index = process_index() if index is None else index
    count = process_count() if count is None else count
    return entries[index::count]


def allreduce_counters(counters: Dict[str, float],
                       contribute: bool = True) -> Dict[str, float]:
    """Sum scalar metric counters (tp/fp/fn/...) over the world; identity
    for one process. A rank whose counters another rank of the world
    already carries (a rank of the same replica) passes
    ``contribute=False`` and adds zeros. The sum is taken in float64, exact
    for counts."""
    if process_count() == 1:
        return dict(counters)
    keys = sorted(counters)
    local = torch.tensor([float(counters[k]) if contribute else 0.0
                          for k in keys], dtype=torch.float64)
    dist.all_reduce(local, group=_HOST)
    return {k: float(v) for k, v in zip(keys, local.tolist())}


def broadcast_scalar(value: float) -> float:
    """Rank 0's value on every process (identity for one process), to the
    millisecond: used to agree on one output-file timestamp. It travels as
    an int64 count of milliseconds, never as a float32 (JAX
    ``parallel/distributed.py:56-74``: a float32 unix time falls on a grid
    of ~128 s, and two runs in one bucket would share an output stem)."""
    if process_count() == 1:
        return float(value)
    ms = torch.tensor([int(round(float(value) * 1000.0))], dtype=torch.int64)
    dist.broadcast(ms, src=0, group=_HOST)
    return int(ms.item()) / 1000.0


class Group:
    """The ranks of one mesh axis that this rank belongs to, with the
    collectives the port runs over them. ``pg`` carries tensors on the
    mesh's device; ``host`` is a gloo group of the same ranks for host
    objects. A gloo ``pg`` takes CUDA tensors through host copies (gloo
    reduces on the host). A group of one rank runs no collective. A model
    holds its group through copies of itself (``copy.deepcopy`` returns the
    same group)."""

    def __init__(self, ranks: Sequence[int], pg=None, host=None,
                 staged: bool = False):
        self.size = len(ranks)
        self.pg = pg
        self.host = host
        self.staged = staged

    def __deepcopy__(self, memo):
        return self

    def _run(self, t: torch.Tensor, fn) -> torch.Tensor:
        if self.staged and t.device.type == "cuda":
            h = t.cpu()
            fn(h)
            return h.to(t.device)
        t = t.contiguous()
        fn(t)
        return t

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (or max, ``op="max"``) of ``t`` over the group, in a new
        tensor on ``t``'s device; every rank gets the same values."""
        if self.size == 1:
            return t
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        return self._run(t.clone(),
                         lambda x: dist.all_reduce(x, red, group=self.pg))

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order."""
        if self.size == 1:
            return t
        dev = t.device
        src = (t.cpu() if self.staged and dev.type == "cuda"
               else t).contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.pg)
        return torch.cat(parts, dim=dim).to(dev)

    def all_gather_object(self, obj) -> List:
        """Every rank's picklable ``obj``, in rank order."""
        if self.size == 1:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.host)
        return out


def new_group(ranks: Sequence[int]) -> Optional[Group]:
    """A :class:`Group` over ``ranks`` if this rank is among them, else
    None. Every rank of the world must call it for every group, in the
    same order (``torch.distributed.new_group``)."""
    ranks = list(ranks)
    if len(ranks) == 1:
        return Group(ranks) if process_index() in ranks else None
    nccl = dist.get_backend() == "nccl"
    pg = dist.new_group(ranks)
    host = dist.new_group(ranks, backend="gloo") if nccl else pg
    if process_index() not in ranks:
        return None
    return Group(ranks, pg=pg, host=host, staged=not nccl)
