"""The engine's rank grid and its collectives over ``torch.distributed``.

A ``WorkerMesh`` takes the place of the reference's JAX ``Mesh`` over the
engine's axes: the ranks of the default process group laid out row-major
over a ("pod", "data") rank grid, each holding one contiguous block of the
worker grid, with an optional "fsdp" axis over which each worker's batch
splits (one worker spans the fsdp ranks, each holding the worker's whole
state and running its slice of the batch: the reference's FSDP axes) and
an optional trailing "shard" axis over which each worker rank's buffer
rows split (``EngineConfig.shards``): (pod, data, fsdp, shard), the
reference's ("data", "model") device order, "model" fastest.  Its process
groups: the whole grid, both worker axes and each one within an (fsdp,
shard) column, the fsdp axis within a worker's (pod, data, shard) place,
the state's axes (all but fsdp) within an fsdp index, and the shard axis
within a worker rank's fsdp index (``launch.mesh.make_engine_mesh`` builds
them).  The same class carries other grids under their own axis names
(the shard-mapped MoE's ("data", "model"), ``models.moe_shardmap``).

Every collective goes through ``WorkerMesh.all_reduce``,
``all_gather`` or, for a checkpoint, ``gather`` (or ``count`` beside an
autograd-aware one), which counts its calls, bytes and asynchronous
issues per kind and group in ``COUNTS``.  The kinds:

  * "state" — the model-state means of a round (its communication);
  * "forward" — a row-sharded engine's parameter rows, gathered over the
    shard group before every forward;
  * "grad" — a worker's gradient averaged over its fsdp ranks before
    the clip, and the clip's squared sums over the shard ranks;
  * "scalar" — the reported loss (on an fsdp axis also its mean over the
    fsdp ranks' slices);
  * "eval" — the evaluation model x̂, the log's sums and the diagnostics
    pass, outside the round;
  * "setup" — once per run, before training;
  * "checkpoint" — a save's gather of every rank's block to rank 0;
  * "membership" — the repairs between rounds of an elastic run
    (``Engine.set_membership``'s global sums, ``recenter_drift``'s means);
  * "clients" — a client store's scatter: every rank's cohort rows
    gathered to every rank's copy of the store;
  * "moe" — the shard-mapped MoE layer's weight gathers, output sum and
    aux mean; on an fsdp axis the routed layer's expert counts (an
    all-gather) and its aux loss's sums (an all-reduce) over the fsdp
    ranks, each run again in a remat layer's recompute; in serving the
    routed layer's expert counts over the ranks the served batch splits
    over;
  * "tensor" — tensor-parallel serving over the "model" ranks: the sums
    after a row-parallel product (attention's ``wo``, the MLP's
    ``w_down``, the routed experts, the vocab-split embedding), the
    logits' all-gather over the vocab, and the distributed flash-decode's
    query all-gather, max and sum;
  * "weights" — serving a model whose weights split over the FSDP axes
    too (kimi-k2's 2D layout): each weight's d dimension all-gathered
    over them just before its product.

``worker_sum`` and ``worker_mean`` are the reductions over the workers of
a buffer, one rule for the engine and the log: a local reduction over the
buffer's worker dims and, on a mesh, one ``all_reduce(SUM)`` over the
ranks of the axes those dims span — the reference's on-mesh
``psum(sum) / total``.  On a row-sharded grid the worker groups lie within
a shard column, so each rank reduces its own rows.  Without a mesh
(``mesh=None``) they are the plain ``sum`` and ``mean`` and communicate
nothing.

The masked mean of an elastic run (``worker_mean(..., keep=, count=)``)
runs only while some worker is out (``core.engine`` takes the plain mean
at a full mask, which is thus bitwise membership-off).  It adds up the
active workers' slices one after another (``masked_sum``): a dead
worker's slice is never read (NaN · 0 would be NaN), and no temporary the
size of the buffer is made.  Then one all-reduce, and × the reciprocal of
the state-carried active count, the reference's op sequence.

A ``DryMesh`` is rank 0's view of a rank grid with no process group, for
the dry run (``launch.dryrun``): its collectives are counted in
``COUNTS`` as on a real mesh, then return results of the right shape on
the operand's device (meta tensors there) and move nothing.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("pod", "data")              # the engine's worker axes
FSDP = "fsdp"                       # a worker's batch split over ranks
SHARD = "shard"                     # the engine's row-shard axis
ENGINE_AXES = AXES + (FSDP, SHARD)
# kind -> group label -> {"calls", "bytes", "async"}
COUNTS: Dict[str, Dict[str, Dict[str, int]]] = {}


def reset_counts() -> None:
    COUNTS.clear()


def canonical(axes: Sequence[str],
              names: Sequence[str] = ENGINE_AXES) -> Tuple[str, ...]:
    """``axes`` in the order of the mesh's axes ``names``; an unknown name
    is refused."""
    bad = [a for a in axes if a not in names]
    if bad or not axes:
        raise ValueError(f"axes {tuple(axes)} are not among the mesh's "
                         f"axes {tuple(names)} (the worker axes, then the "
                         f"fsdp and shard axes)")
    return tuple(a for a in names if a in axes)


class WorkerMesh:
    """This rank's place in a rank grid and the process groups over its
    axes.

    ``axes``: the grid's axis names, by default the engine's ("pod",
    "data") worker axes, then "shard" when ``shape`` has a third entry,
    and ("pod", "data", "fsdp", "shard") for a fourth; ``shape``: the ranks
    along each; ranks are laid out row-major, the last axis fastest (the
    engine's rank = ((pod · d_r + data) · F + fsdp) · s_r + shard, so a
    worker rank's shard peers are adjacent, then its fsdp peers);
    ``coords``: this rank's index on each axis; ``groups``: the process
    group of each axis subset (``canonical`` order) that runs a
    collective.  The engine's grid has the whole grid, each worker axis
    and both worker axes within this rank's (fsdp, shard) column, and,
    with a shard axis, the shard group within this rank's worker rank;
    with an fsdp axis the fsdp group and the state's axes
    (``state_axes``) within this rank's fsdp index
    (``launch.mesh.make_engine_mesh``).  Other grids name their own axes
    (the shard-mapped MoE's ("data", "model"))."""

    def __init__(self, shape: Sequence[int], rank: int,
                 groups: Dict[Tuple[str, ...], object],
                 axes: Optional[Sequence[str]] = None):
        self.shape = tuple(int(s) for s in shape)
        self.axes = (tuple(axes) if axes is not None
                     else ENGINE_AXES if len(self.shape) == 4
                     else (AXES + (SHARD,))[:len(self.shape)])
        if len(self.axes) != len(self.shape):
            raise ValueError(f"a rank grid of shape {self.shape} over axes "
                             f"{self.axes}")
        self.rank = rank
        self.coords = tuple(int(c) for c in
                            np.unravel_index(rank, self.shape))
        self.groups = groups

    def canonical(self, axes: Sequence[str]) -> Tuple[str, ...]:
        return canonical(axes, self.axes)

    def size(self, axes: Sequence[str] = AXES) -> int:
        """Ranks along ``axes`` (default the worker axes)."""
        return math.prod(self.shape[self.axes.index(a)]
                         for a in self.canonical(axes))

    def index(self, axes: Sequence[str] = AXES) -> Tuple[int, ...]:
        """This rank's index on each of ``axes``, in the order given."""
        self.canonical(axes)
        return tuple(self.coords[self.axes.index(a)] for a in axes)

    @property
    def shards(self) -> int:
        """Ranks along the shard axis (1 without one)."""
        return self.size((SHARD,)) if SHARD in self.axes else 1

    @property
    def fsdp(self) -> int:
        """Ranks along the fsdp axis, over which a worker's batch splits (1
        without one)."""
        return self.size((FSDP,)) if FSDP in self.axes else 1

    @property
    def state_axes(self) -> Tuple[str, ...]:
        """The axes the engine state is spread over: every axis but fsdp,
        along which it is replicated (the whole grid without one)."""
        return tuple(a for a in self.axes if a != FSDP)

    def group(self, axes: Optional[Sequence[str]] = None):
        """The process group over ``axes`` (default: the whole grid)."""
        return self.groups[self.axes if axes is None
                           else self.canonical(axes)]

    def group_ranks(self, axes: Optional[Sequence[str]] = None
                    ) -> Tuple[int, ...]:
        """The ranks of this rank's group over ``axes`` (default: the whole
        grid): those that share its index on every other axis."""
        axes = self.axes if axes is None else self.canonical(axes)
        free = [i for i, a in enumerate(self.axes) if a in axes]
        out = []
        for idx in np.ndindex(*(self.shape[i] for i in free)):
            c = list(self.coords)
            for i, v in zip(free, idx):
                c[i] = v
            out.append(int(np.ravel_multi_index(c, self.shape)))
        return tuple(out)

    def count(self, tensor: torch.Tensor, axes: Optional[Sequence[str]],
              kind: str, async_op: bool = False) -> None:
        """Count one collective of ``tensor``'s bytes over ``axes`` (the
        whole grid for None) under ``kind``."""
        label = "+".join(self.axes if axes is None else self.canonical(axes))
        rec = COUNTS.setdefault(kind, {}).setdefault(
            label, {"calls": 0, "bytes": 0, "async": 0})
        rec["calls"] += 1
        rec["bytes"] += tensor.numel() * tensor.element_size()
        rec["async"] += int(async_op)

    def all_reduce(self, tensor: torch.Tensor, axes: Sequence[str] = AXES,
                   *, kind: str = "state", op=None, async_op: bool = False):
        """``dist.all_reduce`` of ``tensor`` in place over the group of
        ``axes`` (``op`` default SUM), counted under ``kind``; returns the
        work handle when ``async_op``."""
        self.count(tensor, axes, kind, async_op)
        return dist.all_reduce(tensor, op=dist.ReduceOp.SUM if op is None
                               else op, group=self.group(axes),
                               async_op=async_op)

    def all_gather(self, tensor: torch.Tensor, *, kind: str,
                   axes: Optional[Sequence[str]] = None,
                   dim: Optional[int] = None) -> torch.Tensor:
        """Every rank's ``tensor`` (same shape on all) stacked in rank order
        over the ranks of ``axes`` (default the whole grid), on each of
        them: one counted all-gather (through the host under gloo).  With
        ``dim`` the blocks are joined along that dim instead, on the wire's
        device, so that the operand's device receives only the joined
        tensor."""
        self.count(tensor, axes, kind)
        group = self.group(axes)
        x = tensor.to(wire_device(self)).contiguous()
        out = torch.empty((dist.get_world_size(group), *x.shape),
                          dtype=x.dtype, device=x.device)
        if dist.get_backend(group) == "nccl":
            dist.all_gather_into_tensor(out, x, group=group)
        else:
            dist.all_gather(list(out.unbind(0)), x, group=group)
        if dim is not None:
            out = _join(out, dim)
        return out.to(tensor.device)

    def gather(self, tensor: torch.Tensor, gather_list, *,
               kind: str = "checkpoint",
               axes: Optional[Sequence[str]] = None) -> None:
        """``dist.gather`` of every rank's ``tensor`` (same shape on all)
        into rank 0's ``gather_list`` (None elsewhere), in rank order over
        the ranks of ``axes`` (default the whole grid; rank 0's group),
        counted under ``kind``."""
        self.count(tensor, axes, kind)
        dist.gather(tensor, gather_list, dst=0, group=self.group(axes))


def _join(parts: torch.Tensor, dim: int) -> torch.Tensor:
    """(n, *shape) stacked blocks -> one tensor, the blocks joined in order
    along ``dim`` of ``shape``."""
    dim = dim % (parts.dim() - 1)
    if dim == 0:
        return parts.reshape(-1, *parts.shape[2:])
    return torch.cat(list(parts.unbind(0)), dim)


class _Done:
    """The work handle of a dry collective: nothing to wait for."""

    def wait(self) -> bool:
        return True


class DryMesh(WorkerMesh):
    """Rank 0's view of a rank grid of ``shape`` over ``axes`` with no
    process group (the dry run): each collective is counted as
    ``WorkerMesh``'s are, then ``all_reduce`` leaves its operand as it is
    (a done handle when ``async_op``), ``all_gather`` returns a new tensor
    of the stacked shape on the operand's device and ``gather`` fills
    nothing.  Nothing needs ``torch.distributed`` to be initialised."""

    dry = True

    def __init__(self, shape: Sequence[int],
                 axes: Optional[Sequence[str]] = None):
        super().__init__(shape, 0, {}, axes)
        # (op, kind, group label) -> the output bytes of its calls: what
        # the roofline prices (an all-gather's output is n times its input)
        self.wire: Dict[Tuple[str, str, str], int] = {}

    def group(self, axes: Optional[Sequence[str]] = None):
        raise RuntimeError("a dry mesh has no process groups")

    def _wire(self, op: str, tensor: torch.Tensor, axes, kind: str,
              n: int = 1) -> None:
        label = "+".join(self.axes if axes is None else self.canonical(axes))
        key = (op, kind, label)
        self.wire[key] = (self.wire.get(key, 0)
                          + n * tensor.numel() * tensor.element_size())

    def all_reduce(self, tensor: torch.Tensor, axes: Sequence[str] = AXES,
                   *, kind: str = "state", op=None, async_op: bool = False):
        self.count(tensor, axes, kind, async_op)
        self._wire("all-reduce", tensor, axes, kind)
        return _Done() if async_op else None

    def all_gather(self, tensor: torch.Tensor, *, kind: str,
                   axes: Optional[Sequence[str]] = None,
                   dim: Optional[int] = None) -> torch.Tensor:
        self.count(tensor, axes, kind)
        n = self.size(self.axes if axes is None else axes)
        self._wire("all-gather", tensor, axes, kind, n)
        out = torch.empty((n, *tensor.shape), dtype=tensor.dtype,
                          device=tensor.device)
        return out if dim is None else _join(out, dim)

    def gather(self, tensor: torch.Tensor, gather_list, *,
               kind: str = "checkpoint",
               axes: Optional[Sequence[str]] = None) -> None:
        self.count(tensor, axes, kind)
        self._wire("gather", tensor, axes, kind,
                   self.size(self.axes if axes is None else axes))


class PendingMean(NamedTuple):
    """A worker mean whose all-reduce was issued with ``async_op=True``:
    the local sum it reduces in place (the fp32 wire copy of a narrower
    one, see ``_wire``), the work handle, the global count (a number, or
    the masked mean's count tensor) and the mean's dtype.  ``result()``
    waits, then scales."""

    total: torch.Tensor
    work: Any
    count: Any
    dtype: Any = None

    def result(self) -> torch.Tensor:
        self.work.wait()
        return _scale(_unwire(self.total, self.dtype), self.count)


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


def _wire(s: torch.Tensor) -> torch.Tensor:
    """What a worker sum's all-reduce carries: an fp32 sum as it is, a
    narrower one (bf16 parameters) widened to fp32, as the reference's
    lowering carries it (XLA runs a bf16 ``psum`` as an fp32 all-reduce
    between two converts); the sum is rounded back after it
    (``_unwire``)."""
    return s if s.dtype == torch.float32 else s.to(torch.float32)


def _unwire(total: torch.Tensor, dtype) -> torch.Tensor:
    return total if dtype in (None, total.dtype) else total.to(dtype)


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
                count: Optional[torch.Tensor] = None,
                sum_form: bool = False):
    """The mean of ``buf`` over its local worker dims ``dim`` and, on a mesh,
    the ranks of ``axes``: a local sum, one all-reduce, ÷ the workers it
    covers in all; a ``PendingMean`` when ``async_op``.  Without a mesh the
    plain ``mean`` (``async_op`` then changes nothing); with ``sum_form``
    (the reference's hierarchy, which divides its sum even without a mesh)
    a buffer narrower than fp32 takes the sum, rounded to its dtype, ÷ the
    count, as on a mesh.

    A bf16 buffer's sum is rounded to bf16 (fp32 accumulation), its
    all-reduce carries fp32 (``_wire``) and is rounded back to bf16, and
    the quotient is rounded again: the reference's op sequence.

    Masked (``keep``: the host bool array of ``masked_sum``, True on the
    active workers; ``count``: the active workers in all, a tensor on
    ``buf``'s device broadcasting against the mean): the masked sum,
    all-reduced on a mesh, × ``1 / count``."""
    if keep is not None:
        s = masked_sum(buf, keep, dim, keepdim)
        if mesh is None:
            return _scale(s, count)
        wire = _wire(s)
        work = mesh.all_reduce(wire, axes, kind=kind, async_op=async_op)
        if async_op:
            return PendingMean(wire, work, count, s.dtype)
        return _scale(_unwire(wire, s.dtype), count)
    dims = (dim,) if isinstance(dim, int) else dim
    if mesh is None and not (sum_form and buf.dtype != torch.float32):
        return buf.mean(dim=dim, keepdim=keepdim)
    count = math.prod(buf.shape[d] for d in dims) * (
        1 if mesh is None else mesh.size(axes))
    s = buf.sum(dim=dim, keepdim=keepdim)
    if mesh is None:
        return s.div_(count)
    wire = _wire(s)
    work = mesh.all_reduce(wire, axes, kind=kind, async_op=async_op)
    if async_op:
        return PendingMean(wire, work, count, s.dtype)
    return _unwire(wire, s.dtype).div_(count)


def wire_device(mesh) -> torch.device:
    """Where a tensor made for one of ``mesh``'s collectives lives: the
    card under NCCL, the host under gloo, meta tensors on a dry mesh."""
    if getattr(mesh, "dry", False):
        return torch.device("meta")
    return (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend(mesh.group()) == "nccl"
            else torch.device("cpu"))


def global_reduce(mesh, x: float, op=None) -> float:
    """``x`` reduced over every rank of the mesh by ``op`` (default MAX),
    counted "eval"; ``x`` itself without a mesh."""
    if mesh is None:
        return x
    t = torch.tensor(x, device=wire_device(mesh))
    mesh.all_reduce(t, mesh.axes, kind="eval",
                    op=dist.ReduceOp.MAX if op is None else op)
    return t.item()


def fsdp_mean(mesh, buf: torch.Tensor, *, kind: str = "grad"
              ) -> torch.Tensor:
    """``buf`` (this rank's gradient of its slice of a worker's batch; a
    contiguous tensor) replaced in place by its mean over the rank's fsdp
    group: one all-reduce, counted under ``kind``, that carries fp32 (a
    narrower buffer widened for the wire, as the worker means carry it),
    ÷ F in fp32, then rounded once to ``buf``'s dtype.  The slices are
    equal, so the mean of their mean-loss gradients is the whole batch's."""
    wire = _wire(buf)
    mesh.all_reduce(wire, (FSDP,), kind=kind)
    wire.div_(mesh.fsdp)
    if wire is not buf:
        buf.copy_(wire)
    return buf


class MeshGroup(NamedTuple):
    """The ranks of ``mesh`` along ``axes`` that share this rank's index on
    every other axis, as a model layer takes them to run one worker's
    batch split over them (``models.moe``: the routed layer's dispatch and
    aux loss over a worker's fsdp ranks) or, in serving, a weight split
    over them (the "model" ranks of tensor parallelism, the FSDP ranks of
    a 2D layout; ``all_sum``, ``all_max``, ``gather_dim``).  ``size``
    ranks; this rank is ``index`` among them, in rank order."""

    mesh: Any
    axes: Tuple[str, ...]

    @property
    def size(self) -> int:
        return self.mesh.size(self.axes)

    @property
    def index(self) -> int:
        axes = self.mesh.canonical(self.axes)
        return int(np.ravel_multi_index(
            self.mesh.index(axes), [self.mesh.size((a,)) for a in axes]))

    def all_gather(self, tensor: torch.Tensor, kind: str) -> torch.Tensor:
        """Every group rank's ``tensor`` stacked in rank order."""
        return self.mesh.all_gather(tensor, kind=kind, axes=self.axes)

    def sum(self, tensor: torch.Tensor, kind: str) -> torch.Tensor:
        """Σ of ``tensor`` over the group, as a new tensor: one counted
        all-reduce.  Its backward assumes what its one caller guarantees:
        every rank reads the sum into the same term of its loss (the
        router's aux loss), so the all-reduce's true backward, the group's
        sum of the incoming gradients, is ``size`` times this rank's own,
        and it is taken so, with no collective in the backward.  The group
        mean of the ranks' gradients then counts that term's gradient once,
        not 1/``size`` of it."""
        return _GroupSum.apply(tensor, self, kind)


    # ------------------------------------------------------------ serving
    # Tensor-parallel serving's collectives (``models``' ``tp=`` and
    # ``fsdp=`` groups): no autograd (they run under ``torch.no_grad``),
    # each a new tensor on the operand's device, identical on every rank
    # of the group.

    def all_sum(self, tensor: torch.Tensor,
                kind: str = "tensor") -> torch.Tensor:
        """Σ of ``tensor`` over the group: one counted all-reduce."""
        return self._reduce(tensor, kind, None)

    def all_max(self, tensor: torch.Tensor,
                kind: str = "tensor") -> torch.Tensor:
        """The elementwise max of ``tensor`` over the group: one counted
        all-reduce."""
        return self._reduce(tensor, kind, dist.ReduceOp.MAX)

    def gather_dim(self, tensor: torch.Tensor, dim: int,
                   kind: str = "tensor") -> torch.Tensor:
        """Every group rank's block of ``tensor`` joined along ``dim`` in
        rank order: one counted all-gather."""
        with torch.no_grad():
            return self.mesh.all_gather(tensor, kind=kind, axes=self.axes,
                                        dim=dim)

    def _reduce(self, tensor: torch.Tensor, kind: str, op) -> torch.Tensor:
        with torch.no_grad():
            w = tensor.to(wire_device(self.mesh)).contiguous()
            if w.data_ptr() == tensor.data_ptr() and w.numel():
                w = w.clone()
            self.mesh.all_reduce(w, self.axes, kind=kind, op=op)
            return w.to(tensor.device)


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, kind):
        out = x.detach().clone()
        group.mesh.all_reduce(out, group.axes, kind=kind)
        ctx.n = group.size
        return out

    @staticmethod
    def backward(ctx, g):
        return g * ctx.n, None, None
