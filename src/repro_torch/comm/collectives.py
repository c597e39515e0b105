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
  * "checkpoint" — a save's gather of every rank's block to rank 0.

``worker_sum`` and ``worker_mean`` are the reductions over the workers of
a buffer, one rule for the engine and the log: a local reduction over the
buffer's worker dims and, on a mesh, one ``all_reduce(SUM)`` over the
ranks of the axes those dims span — the reference's on-mesh
``psum(sum) / total``.  Without a mesh (``mesh=None``) they are the plain
``sum`` and ``mean`` and communicate nothing.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Sequence, Tuple

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
    count.  ``result()`` waits, then divides."""

    total: torch.Tensor
    work: Any
    count: int

    def result(self) -> torch.Tensor:
        self.work.wait()
        return self.total.div_(self.count)


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


def worker_mean(mesh, buf: torch.Tensor, dim, axes: Sequence[str], *,
                keepdim: bool = False, kind: str = "state",
                async_op: bool = False):
    """The mean of ``buf`` over its local worker dims ``dim`` and, on a mesh,
    the ranks of ``axes``: a local sum, one all-reduce, ÷ the workers it
    covers in all; a ``PendingMean`` when ``async_op``.  Without a mesh the
    plain ``mean`` (``async_op`` then changes nothing)."""
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
