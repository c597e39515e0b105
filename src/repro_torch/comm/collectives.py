"""The worker axis's collectives over ``torch.distributed``.

A ``WorkerMesh`` takes the place of the reference's JAX ``Mesh`` over the
engine's worker axes: the ranks of the default process group laid out
pod-major over a ("pod", "data") rank grid, each holding one contiguous
block of the worker grid, with a process group over both axes and one
per axis (``launch.mesh.make_engine_mesh`` builds it).

Every collective goes through ``WorkerMesh.all_reduce`` (or, for a
checkpoint, ``WorkerMesh.gather``), which counts its calls, bytes and
asynchronous issues per kind and group in ``COUNTS``.  The kinds:

  * "state" — the model-state means of a round (its communication);
  * "scalar" — the reported loss;
  * "eval" — the evaluation model x̂, the log's sums and the diagnostics
    pass, outside the round;
  * "setup" — once per run, before training;
  * "checkpoint" — a save's gather of every rank's block to rank 0;
  * "membership" — the repairs between rounds of an elastic run
    (``Engine.set_membership``'s global sums, ``recenter_drift``'s means);
  * "clients" — a client store's scatter: every rank's cohort rows
    gathered to every rank's copy of the store.

``worker_sum`` and ``worker_mean`` are the reductions over the workers of
a buffer, one rule for the engine and the log: a local reduction over the
buffer's worker dims and, on a mesh, one ``all_reduce(SUM)`` over the
ranks of the axes those dims span — the reference's on-mesh
``psum(sum) / total``.  Without a mesh (``mesh=None``) they are the plain
``sum`` and ``mean`` and communicate nothing.

The masked mean of an elastic run (``worker_mean(..., keep=, count=)``)
runs only while some worker is out (``core.engine`` takes the plain mean
at a full mask, which is thus bitwise membership-off).  It adds up the
active workers' slices one after another (``masked_sum``): a dead
worker's slice is never read (NaN · 0 would be NaN), and no temporary the
size of the buffer is made.  Then one all-reduce, and × the reciprocal of
the state-carried active count, the reference's op sequence.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("pod", "data")
# kind -> group label -> {"calls", "bytes", "async"}
COUNTS: Dict[str, Dict[str, Dict[str, int]]] = {}


def reset_counts() -> None:
    COUNTS.clear()


def canonical(axes: Sequence[str]) -> Tuple[str, ...]:
    """The worker axes in mesh order; an unknown name is refused."""
    bad = [a for a in axes if a not in AXES]
    if bad or not axes:
        raise ValueError(f"worker axes {tuple(axes)}: the mesh's axes are "
                         f"{AXES}")
    return tuple(a for a in AXES if a in axes)


class WorkerMesh:
    """This rank's place in the rank grid and the groups over its axes.

    ``shape``: (p_r, d_r) ranks along ("pod", "data"); ``coords``: this
    rank's (pod, data) index, rank = pod · d_r + data; ``groups``: the
    process group of each axis subset (``canonical`` order)."""

    axes = AXES

    def __init__(self, shape: Tuple[int, int], rank: int,
                 groups: Dict[Tuple[str, ...], object]):
        self.shape = tuple(shape)
        self.rank = rank
        self.coords = divmod(rank, shape[1])
        self.groups = groups

    def size(self, axes: Sequence[str] = AXES) -> int:
        """Ranks along ``axes``."""
        return math.prod(self.shape[AXES.index(a)] for a in canonical(axes))

    def index(self, axes: Sequence[str] = AXES) -> Tuple[int, ...]:
        """This rank's index on each of ``axes``, in the order given."""
        canonical(axes)
        return tuple(self.coords[AXES.index(a)] for a in axes)

    def all_reduce(self, tensor: torch.Tensor, axes: Sequence[str] = AXES,
                   *, kind: str = "state", op=None, async_op: bool = False):
        """``dist.all_reduce`` of ``tensor`` in place over the group of
        ``axes`` (``op`` default SUM), counted under ``kind``; returns the
        work handle when ``async_op``."""
        axes = canonical(axes)
        label = "+".join(axes)
        rec = COUNTS.setdefault(kind, {}).setdefault(
            label, {"calls": 0, "bytes": 0, "async": 0})
        rec["calls"] += 1
        rec["bytes"] += tensor.numel() * tensor.element_size()
        rec["async"] += int(async_op)
        return dist.all_reduce(tensor, op=dist.ReduceOp.SUM if op is None
                               else op, group=self.groups[axes],
                               async_op=async_op)

    def all_gather(self, tensor: torch.Tensor, *, kind: str) -> torch.Tensor:
        """Every rank's ``tensor`` (same shape on all) stacked in rank order
        over the whole grid, on every rank: one ``dist.all_gather`` counted
        under ``kind`` (through the host under gloo)."""
        rec = COUNTS.setdefault(kind, {}).setdefault(
            "+".join(AXES), {"calls": 0, "bytes": 0, "async": 0})
        rec["calls"] += 1
        rec["bytes"] += tensor.numel() * tensor.element_size()
        x = tensor.to(wire_device(self))
        out = [torch.empty_like(x) for _ in range(self.size())]
        dist.all_gather(out, x, group=self.groups[AXES])
        return torch.stack(out).to(tensor.device)

    def gather(self, tensor: torch.Tensor, gather_list, *,
               kind: str = "checkpoint") -> None:
        """``dist.gather`` of every rank's ``tensor`` (same shape on all)
        into rank 0's ``gather_list`` (None elsewhere), in rank order over
        the whole grid, counted under ``kind``."""
        rec = COUNTS.setdefault(kind, {}).setdefault(
            "+".join(AXES), {"calls": 0, "bytes": 0, "async": 0})
        rec["calls"] += 1
        rec["bytes"] += tensor.numel() * tensor.element_size()
        dist.gather(tensor, gather_list, dst=0, group=self.groups[AXES])


class PendingMean(NamedTuple):
    """A worker mean whose all-reduce was issued with ``async_op=True``:
    the local sum it reduces in place, the work handle and the global
    count (a number, or the masked mean's count tensor).  ``result()``
    waits, then scales."""

    total: torch.Tensor
    work: Any
    count: Any

    def result(self) -> torch.Tensor:
        self.work.wait()
        return _scale(self.total, self.count)


def resolve(mean: Any) -> Any:
    """A mean, waited for when its all-reduce is in flight."""
    return mean.result() if isinstance(mean, PendingMean) else mean


def worker_sum(mesh, buf: torch.Tensor, dim, axes: Sequence[str] = AXES, *,
               kind: str = "eval") -> torch.Tensor:
    """Σ of ``buf`` over its local worker dims ``dim`` and, on a mesh, the
    ranks of ``axes``."""
    s = buf.sum(dim=dim)
    if mesh is not None:
        mesh.all_reduce(s, axes, kind=kind)
    return s


def _scale(total: torch.Tensor, count) -> torch.Tensor:
    """``total`` ÷ a worker count in place: a number divides (the plain
    mean's on-mesh form); a count tensor (the masked mean's) multiplies
    by its reciprocal, as the reference's masked mean does."""
    if isinstance(count, torch.Tensor):
        return total.mul_(torch.reciprocal(count))
    return total.div_(count)


def masked_sum(buf: torch.Tensor, keep: np.ndarray, dim,
               keepdim: bool = False) -> torch.Tensor:
    """Σ of ``buf`` over its worker dims ``dim`` of the slices that
    ``keep`` marks (a host bool array over ``buf``'s leading dims), added
    one after another into an fp32 sum, then cast to ``buf``'s dtype: an
    unmarked slice is never read."""
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    shape = [1 if d in dims else n for d, n in enumerate(buf.shape)]
    s = torch.zeros(shape, dtype=torch.float32, device=buf.device)
    for idx in zip(*np.nonzero(keep)):
        s[tuple(0 if d in dims else int(i)
                for d, i in enumerate(idx))].add_(buf[tuple(map(int, idx))])
    s = s.to(buf.dtype)
    return s if keepdim else s.squeeze(dims)


def worker_mean(mesh, buf: torch.Tensor, dim, axes: Sequence[str], *,
                keepdim: bool = False, kind: str = "state",
                async_op: bool = False, keep: Optional[np.ndarray] = None,
                count: Optional[torch.Tensor] = None):
    """The mean of ``buf`` over its local worker dims ``dim`` and, on a mesh,
    the ranks of ``axes``: a local sum, one all-reduce, ÷ the workers it
    covers in all; a ``PendingMean`` when ``async_op``.  Without a mesh the
    plain ``mean`` (``async_op`` then changes nothing).

    Masked (``keep``: the host bool array of ``masked_sum``, True on the
    active workers; ``count``: the active workers in all, a tensor on
    ``buf``'s device broadcasting against the mean): the masked sum,
    all-reduced on a mesh, × ``1 / count``."""
    if keep is not None:
        s = masked_sum(buf, keep, dim, keepdim)
        if mesh is None:
            return _scale(s, count)
        work = mesh.all_reduce(s, axes, kind=kind, async_op=async_op)
        return PendingMean(s, work, count) if async_op else _scale(s, count)
    if mesh is None:
        return buf.mean(dim=dim, keepdim=keepdim)
    dims = (dim,) if isinstance(dim, int) else dim
    count = math.prod(buf.shape[d] for d in dims) * mesh.size(axes)
    s = buf.sum(dim=dim, keepdim=keepdim)
    work = mesh.all_reduce(s, axes, kind=kind, async_op=async_op)
    return PendingMean(s, work, count) if async_op else s.div_(count)


def wire_device(mesh) -> torch.device:
    """Where a tensor made for one of ``mesh``'s collectives lives: the
    card under NCCL, the host under gloo."""
    return (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend(mesh.groups[AXES]) == "nccl"
            else torch.device("cpu"))


def global_reduce(mesh, x: float, op=None) -> float:
    """``x`` reduced over every rank of the mesh by ``op`` (default MAX),
    counted "eval"; ``x`` itself without a mesh."""
    if mesh is None:
        return x
    t = torch.tensor(x, device=wire_device(mesh))
    mesh.all_reduce(t, kind="eval",
                    op=dist.ReduceOp.MAX if op is None else op)
    return t.item()
