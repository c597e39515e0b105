"""Rank grids over ``torch.distributed`` (``repro.launch.mesh``
``make_engine_mesh``): the grid and its process groups.

The engine's rank grid (``rank_grid``): world = (worker ranks) × F × S.
The worker ranks are flat, (1, world / (F·S)) with W % (world / (F·S)) ==
0, or, over the hierarchy's (P, D) worker grid, d_r = gcd(D, worker
ranks) ranks along the data axis and p_r = worker ranks / d_r along the
pod axis, so that ranks fill the data axis first (P % p_r == 0).  Each
worker rank holds W / (worker ranks) workers ((P / p_r, D / d_r) for the
hierarchy).  With ``fsdp`` F > 1 an "fsdp" axis of F ranks spans each
worker rank: every one of them holds the worker rank's whole state and
runs its slice of each worker's batch (``train.train_loop``).  With
``shards`` S > 1 a trailing "shard" axis of S ranks splits each worker
rank's buffer rows (``EngineConfig.shards``): rank = ((pod · d_r + data) ·
F + fsdp) · S + shard, so shard peers are adjacent, then fsdp peers — the
reference's ("data", "model") device order, "model" fastest.  A grid with
F = 1 has no fsdp axis: the grid, its groups and its counts are those of
a mesh without the role.  ``make_engine_mesh`` returns the
``comm.collectives.WorkerMesh`` the engine runs over; ``make_mesh`` builds
any other named grid (the shard-mapped MoE's ("data", "model")).
``production_grid`` reads a ``configs.base.MeshConfig``'s roles (the
reference's ``make_production_mesh``): its worker axes become worker
ranks, one worker a rank, its FSDP axes the fsdp axis and its tensor axis
the row shards when ``shards`` > 1 (``make_engine_mesh`` with its
``fsdp_size`` builds that grid over a process group).  ``gather_state``
and ``state_block`` carry a checkpoint between a mesh and its one file
(the state replicated along fsdp: a save reads fsdp index 0, a restore
gives every fsdp rank the same block); ``gather_store`` and
``store_block`` do the same for a client store, whose rows split over a
shard axis as the state's do.

The serving grid (``serve_grid``) is the ``MeshConfig``'s own, over its
axis names (("data", "model"), ("pod", "data", "model") on the multi-pod
mesh: the reference's serving layout, ``configs.registry.mesh_roles(...,
serving=True)``).  ``make_serve_mesh`` builds it over a process group as
a ``ServeMesh``: the rank's groups over the tensor axes (``tp``), the
FSDP axes its weights' d dims split over (``fsdp``, kimi-k2's 2D layout)
and the data-like axes its batch splits over (``batch_group``), its rows
of a served batch (``rows``) and its blocks of the weights (``params``);
``serve.engine`` and ``models.transformer``'s serving functions run on
them.

The dry run (``launch.dryrun``) reads the engine's grid without a process
group: ``dry_engine_mesh``, or a ``comm.collectives.DryMesh`` of
``production_grid``, describes it (rank 0's view); ``dry_serve_mesh`` the
serving grid's.  The constants below
are the card's, for the roofline
(``launch.roofline``); they take the place of the reference's TPU v5e
constants, which do not carry over.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as tree_mod
from repro_torch.checkpoint import Block
from repro_torch.comm import collectives as coll
from repro_torch.comm.collectives import (AXES, FSDP, SHARD, DryMesh,
                                          MeshGroup, WorkerMesh)
# the card's rates (NVIDIA H100 80GB HBM3, SXM5, 700 W, data sheet) live
# with the kernels' cost model, which chip_smoke reads without this module
from repro_torch.kernels.costs import (HBM_BW, PEAK_FLOPS_BF16,  # noqa: F401
                                       PEAK_FLOPS_FP32, PEAK_FLOPS_TF32)
from repro_torch.sharding import specs

HBM_PER_CHIP = 80 * 10**9   # bytes (80 GB) — the engine-memory fit budget
CHIPS_PER_POD = 256         # the single-pod (16, 16) grid
GPUS_PER_NODE = 8           # one NVLink / NVSwitch domain (HGX H100 8-GPU)
NVLINK_BW = 450e9           # B/s per GPU, each direction (NVLink 4, 900
#                             GB/s total) — the reference's ICI tier
IB_BW = 50e9                # B/s per GPU: one 400 Gb/s NDR InfiniBand port
#                             a GPU — the reference's DCI tier


def grid_axes(fsdp: int = 1, shards: int = 1) -> Tuple[str, ...]:
    """The axis names of the engine's rank grid: the worker axes, then
    "fsdp" when ``fsdp`` > 1 and "shard" when ``shards`` > 1."""
    return (AXES + ((FSDP,) if fsdp > 1 else ())
            + ((SHARD,) if shards > 1 else ()))


def rank_grid(workers: int, world: int, pods: int = 0,
              shards: int = 1, fsdp: int = 1) -> Tuple[int, ...]:
    """The (pod, data) rank grid, with an fsdp axis when ``fsdp`` > 1 and
    a trailing shard axis when ``shards`` > 1 (``grid_axes``), that spreads
    ``workers`` (a (``pods``, W/pods) grid for the hierarchy, flat when
    ``pods`` is 0) over ``world`` ranks, or a ValueError that says why it
    cannot."""
    if world < 1:
        raise ValueError(f"a mesh needs at least one rank, got {world}")
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    if fsdp < 1:
        raise ValueError(f"fsdp must be >= 1, got {fsdp}")
    if world % (shards * fsdp):
        raise ValueError(
            f"a world of {world} ranks does not split into {shards} shard "
            f"ranks a worker rank: the rank grid is (worker ranks) x "
            f"shards, so world % shards must be 0" if fsdp == 1 else
            f"a world of {world} ranks does not split into {fsdp} fsdp x "
            f"{shards} shard ranks a worker rank: the rank grid is (worker "
            f"ranks) x fsdp x shards, so world % (fsdp x shards) must be 0")
    wr = world // (shards * fsdp)
    tail = (() if fsdp == 1 else (fsdp,)) + (() if shards == 1
                                              else (shards,))
    if not pods:
        if workers % wr:
            raise ValueError(
                f"{workers} workers do not split over {wr} ranks: the flat "
                f"rank grid is (1, {wr}), so each rank holds W / world "
                f"workers and W % world must be 0" if not tail else
                f"{workers} workers do not split over {wr} worker ranks: "
                f"the flat rank grid is (1, {wr}) x {shards} shards, so "
                f"each worker rank holds W / (world / shards) workers and "
                f"W % (world / shards) must be 0")
        return (1, wr) + tail
    if workers % pods:
        raise ValueError(f"{workers} workers do not split into {pods} pods")
    d_r = math.gcd(workers // pods, wr)
    p_r = wr // d_r
    if pods % p_r:
        raise ValueError(
            f"the (P, D) = ({pods}, {workers // pods}) worker grid does not "
            f"split over {wr} worker ranks: ranks fill the data axis first "
            f"(d_r = gcd(D, worker ranks) = {d_r}), which leaves p_r = "
            f"{p_r} rank rows for {pods} pods (P % p_r must be 0)")
    return (p_r, d_r) + tail


def local_workers(mesh: WorkerMesh, workers: int,
                  pods: int = 0) -> np.ndarray:
    """The global indices (pod-major for the hierarchy) of this rank's
    workers, in the order of its local buffers."""
    pi, di = mesh.index(AXES)
    p_r, d_r = mesh.shape[:2]
    if not pods:
        w = workers // mesh.size()
        return np.arange(di * w, (di + 1) * w)
    d = workers // pods
    pl, dl = pods // p_r, d // d_r
    grid = np.arange(workers).reshape(pods, d)
    return grid[pi * pl:(pi + 1) * pl, di * dl:(di + 1) * dl].ravel()


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              subsets: Sequence[Tuple[str, ...]] = ()) -> WorkerMesh:
    """A rank grid of ``shape`` over ``axes`` on the default process group
    (initialised by the caller; world = the product of ``shape``), with a
    process group over the whole grid and over each axis subset of
    ``subsets`` (default: each axis alone) — one group for every
    combination of the other axes' indices.  Every rank creates every
    group, in the same order: the whole grid, then the subsets in the
    order given, each over the other axes' indices in rank order."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != world:
        raise ValueError(f"a rank grid of shape {shape} needs "
                         f"{math.prod(shape)} ranks, the world has {world}")
    coords = list(np.ndindex(*shape))
    groups = {axes: dist.new_group(list(range(world)))}
    for sub in (subsets or [(a,) for a in axes]):
        sub = coll.canonical(sub, axes)
        rest = [i for i, a in enumerate(axes) if a not in sub]
        buckets: dict = {}
        for r, c in enumerate(coords):
            buckets.setdefault(tuple(c[i] for i in rest), []).append(r)
        for key in sorted(buckets):
            g = dist.new_group(buckets[key])
            if rank in buckets[key]:
                groups[sub] = g
    return WorkerMesh(shape, rank, groups, axes)


def dry_engine_mesh(workers: int, world: int, *, pods: int = 0,
                    shards: int = 1, fsdp: int = 1) -> DryMesh:
    """Rank 0's view of the engine's rank grid over ``world`` ranks
    (``rank_grid``), with no process group: its collectives are counted
    and move nothing (``comm.collectives.DryMesh``)."""
    shape = rank_grid(workers, world, pods, shards, fsdp)
    return DryMesh(shape, grid_axes(fsdp, shards))


def make_engine_mesh(workers: int, *, pods: int = 0, shards: int = 1,
                     fsdp: int = 1) -> WorkerMesh:
    """The engine's mesh over the default process group (initialised by
    the caller): the rank grid of ``rank_grid`` and its groups — the whole
    grid, each worker axis, and with a shard or fsdp axis both worker axes
    within each (fsdp, shard) column; with a shard axis the shard axis
    within each worker rank's fsdp index; with an fsdp axis the fsdp axis
    within each (pod, data, shard) place and the state's axes (all but
    fsdp) within each fsdp index."""
    shape = rank_grid(workers, dist.get_world_size(), pods, shards, fsdp)
    axes = grid_axes(fsdp, shards)
    subsets = [("pod",), ("data",)]
    if shards > 1 or fsdp > 1:
        subsets += [AXES]
    if shards > 1:
        subsets += [(SHARD,)]
    if fsdp > 1:
        subsets += [(FSDP,), tuple(a for a in axes if a != FSDP)]
    return make_mesh(shape, axes, subsets)


def production_grid(mesh_cfg, *, pods: int = 0,
                    shards: int = 1) -> Tuple[Tuple[int, ...],
                                              Tuple[str, ...]]:
    """(shape, axes) of the engine's rank grid for a ``MeshConfig``'s roles
    (``configs.registry.mesh_roles``): its W = ``num_workers`` workers one
    a worker rank (a (``pods``, W/pods) grid for the hierarchy), its FSDP
    axes' ranks (``fsdp_size``) on the fsdp axis, and its tensor axis as
    the row shards when ``shards`` > 1, which must then equal its size.
    The reference's ``make_production_mesh`` / ``build_mesh`` lay the same
    devices out as its ("pod", "data", "model") grid."""
    if shards > 1 and shards != mesh_cfg.tensor_size:
        raise ValueError(f"engine shards={shards} ride the mesh's tensor "
                         f"axis {mesh_cfg.tensor_axes} of size "
                         f"{mesh_cfg.tensor_size}: they must be equal")
    w, f = mesh_cfg.num_workers, mesh_cfg.fsdp_size
    shape = rank_grid(w, w * f * shards, pods, shards, f)
    return shape, grid_axes(f, shards)


# ---------------------------------------------------------------- serving
def serve_grid(mesh_cfg) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axes) of the serving rank grid of a ``MeshConfig``: its own
    shape over its own axis names, one rank a device (rank 0 holds the
    first block of every split dim, the last axis fastest)."""
    return tuple(mesh_cfg.shape), tuple(mesh_cfg.axis_names)


class ServeMesh:
    """One rank of the serving grid: ``mesh`` (a ``WorkerMesh`` over the
    grid's axes, or rank 0's ``DryMesh``) and ``roles`` (the
    ``MeshConfig``: which axes are the tensor, FSDP and worker ones)."""

    def __init__(self, mesh, roles):
        self.mesh, self.roles = mesh, roles

    def _group(self, axes) -> Optional[MeshGroup]:
        axes = tuple(axes)
        if not axes or self.mesh.size(axes) == 1:
            return None
        return MeshGroup(self.mesh, self.mesh.canonical(axes))

    @property
    def tp(self) -> Optional[MeshGroup]:
        """The tensor axes' ranks (heads, kv heads, ff, vocab, experts
        split over them), None at one rank."""
        return self._group(self.roles.tensor_axes)

    @property
    def fsdp(self) -> Optional[MeshGroup]:
        """The FSDP axes' ranks, over which the weights' d dims split
        (kimi-k2's serving layout), None where there are none."""
        return self._group(self.roles.fsdp_axes)

    def batch_group(self, batch: int) -> Optional[MeshGroup]:
        """The data-like axes' ranks when they split a served batch of
        ``batch`` rows (None where they do not divide it: every rank then
        serves the whole batch)."""
        entry = specs.batch_sharding_spec(self.roles, batch, 0,
                                          worker_stacked=False)[0]
        return self._group(specs.entry_axes(entry))

    def rows(self, batch: int) -> slice:
        """This rank's rows of a served batch of ``batch`` rows."""
        g = self.batch_group(batch)
        if g is None:
            return slice(0, batch)
        n = batch // g.size
        return slice(g.index * n, (g.index + 1) * n)

    def groups(self, batch: int) -> dict:
        """The keywords of ``models.transformer``'s serving functions for
        a served batch of ``batch`` rows: ``tp``, ``fsdp`` and the MoE's
        ``group``."""
        return {"tp": self.tp, "fsdp": self.fsdp,
                "group": self.batch_group(batch)}

    def specs(self, cfg):
        """The partition specs of ``cfg``'s parameters on this grid."""
        from repro_torch.models import transformer
        return specs.partition_specs(transformer.model_defs(cfg), cfg,
                                     self.roles)

    def params(self, whole, cfg):
        """This rank's block of every leaf of ``whole`` (``cfg``'s whole
        parameter tree), by the specs (``sharding.specs.rank_params``)."""
        return specs.rank_params(whole, self.specs(cfg), self.mesh)


def make_serve_mesh(mesh_cfg) -> ServeMesh:
    """The serving grid of ``mesh_cfg`` over the default process group
    (initialised by the caller; world = the grid's size), with process
    groups over the tensor axes, the data-like axes and the FSDP axes."""
    shape, axes = serve_grid(mesh_cfg)
    subsets = []
    for sub in (mesh_cfg.tensor_axes, specs.data_axes(mesh_cfg),
                mesh_cfg.fsdp_axes):
        sub = coll.canonical(sub, axes) if sub else ()
        if sub and sub not in subsets:
            subsets.append(sub)
    return ServeMesh(make_mesh(shape, axes, subsets), mesh_cfg)


def dry_serve_mesh(mesh_cfg) -> ServeMesh:
    """Rank 0's view of ``mesh_cfg``'s serving grid, with no process
    group (``comm.collectives.DryMesh``)."""
    return ServeMesh(DryMesh(*serve_grid(mesh_cfg)), mesh_cfg)


# ------------------------------------------------------------ checkpoints
# A checkpoint is world-independent: the full worker grid, in the format of
# a one-process save.  A meshed save gathers every rank's block to rank 0,
# which writes the file; a meshed restore reads the file on every rank and
# takes the rank's block of each leaf.

def _span(key: str, hier: bool) -> str:
    """How a state leaf lies over the ranks: "worker" (a block of the
    worker grid: its leading dim, or the hierarchy's leading two), "pod"
    (the hierarchy's per-pod (P, 1, ...) leaves, replicated along the data
    axis) or "global" (the same on every rank)."""
    top = key.split("/", 1)[0]
    if key == "member/n_active":
        return "global"
    if not hier:
        return "global" if top == "center" or key == "comm/ref" else "worker"
    if key == "comm/ref2":
        return "global"
    if top in ("delta2", "overlap") or key in ("comm/ref1", "comm/resid2",
                                                 "member/n_pod"):
        return "pod"
    return "worker"


def _row_split(key: str, leaf_ndim: int) -> bool:
    """Whether a state leaf's rows (dim -2) split over the shard axis:
    every buffer of the flat layout (params, Δ, B, moments and SM3's
    stats, EF residuals and references, the center, overlap pend, the
    hierarchy's per-pod leaves); not the (…, 1, 1) overlap ``pend_k`` and
    membership leaves, nor a 0-d or 1-d leaf."""
    return (leaf_ndim >= 2 and not key.startswith("member/")
            and key != "overlap/pend_k")


def state_block(mesh: WorkerMesh, pods: int = 0):
    """The ``checkpoint.Block`` of this rank: its part of each saved leaf
    (``pods``: the hierarchy's P, 0 for the flat algorithms), its rows'
    share of every row-split leaf on a shard axis."""
    hier = bool(pods)
    (pi, di), (p_r, d_r), world = (mesh.index(AXES), mesh.shape[:2],
                                   mesh.size())
    s_r, si = mesh.shards, (mesh.index((SHARD,))[0] if mesh.shards > 1
                            else 0)

    def worker_shape(key: str, shape: tuple) -> tuple:
        span = _span(key, hier)
        if not shape or span == "global":
            return tuple(shape)
        if not hier:
            return (shape[0] * world, *shape[1:])
        if span == "pod":
            return (shape[0] * p_r, *shape[1:])
        return (shape[0] * p_r, shape[1] * d_r, *shape[2:])

    def full_shape(key: str, shape: tuple) -> tuple:
        full = list(worker_shape(key, shape))
        if s_r > 1 and _row_split(key, len(full)):
            full[-2] *= s_r
        return tuple(full)

    def take(key: str, arr: np.ndarray) -> np.ndarray:
        if s_r > 1 and _row_split(key, arr.ndim):
            r = arr.shape[-2] // s_r
            arr = arr[..., si * r:(si + 1) * r, :]
        span = _span(key, hier)
        if arr.ndim == 0 or span == "global":
            return arr
        if not hier:
            w = arr.shape[0] // world
            return arr[di * w:(di + 1) * w]
        pl = arr.shape[0] // p_r
        if span == "pod":
            return arr[pi * pl:(pi + 1) * pl]
        dl = arr.shape[1] // d_r
        return arr[pi * pl:(pi + 1) * pl, di * dl:(di + 1) * dl]

    return Block(take, full_shape)


def gather_state(mesh: WorkerMesh, state, pods: int = 0):
    """The full state (every rank's block of each leaf, as host tensors)
    on rank 0, None on the other ranks: one gather a leaf over the ranks
    of fsdp index 0 (the state is replicated along fsdp; the other fsdp
    ranks take no part), counted "checkpoint"; on a shard axis each worker
    rank's rows joined in shard order first."""
    hier = bool(pods)
    root = mesh.rank == 0
    p_r, d_r = mesh.shape[:2]
    s_r = mesh.shards
    if mesh.fsdp > 1 and mesh.index((FSDP,))[0]:
        return None

    def one(key, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        span = _span(key, hier)
        split = s_r > 1 and _row_split(key, leaf.dim())
        if span == "global" and not split:
            return leaf.detach().cpu() if root else None
        x = leaf.detach().to(coll.wire_device(mesh)).contiguous()
        parts = ([torch.empty_like(x)
                  for _ in range(mesh.size(mesh.state_axes))]
                 if root else None)
        mesh.gather(x, parts, axes=mesh.state_axes)
        if not root:
            return None
        parts = [q.cpu() for q in parts]
        # one block per worker rank, in rank order
        parts = [torch.cat(parts[w * s_r:(w + 1) * s_r], -2) if split
                 else parts[w * s_r] for w in range(len(parts) // s_r)]
        if span == "global":
            return parts[0]
        if not hier:
            return torch.cat(parts, 0)
        if span == "pod":
            return torch.cat([parts[pi * d_r] for pi in range(p_r)], 0)
        return torch.cat([torch.cat(parts[pi * d_r:(pi + 1) * d_r], 1)
                          for pi in range(p_r)], 0)

    full = tree_mod.state_map(one, state)
    return full if root else None


# ---------------------------------------------------------- client store
# A client store's checkpoint (``core.clients.ClientStore.to_tree``: the
# state-shaped "clients" tree of (M, ...) leaves and "server_params") is
# one file whatever the grid.  Every worker rank keeps a copy of the
# store; on a shard axis a rank's copy holds its shard block of the rows
# of every leaf whose rows split (``_row_split``, the state's rule).

def _store_split(key: str, ndim: int) -> bool:
    """Whether a store leaf's rows (dim -2) split over the shard axis: a
    "clients/..." leaf by its state key's rule, ``server_params`` (one
    parameter row block) always."""
    if key == "server_params":
        return True
    return _row_split(key.split("/", 1)[1], ndim)


def store_block(mesh: WorkerMesh) -> Block:
    """The ``checkpoint.Block`` of this rank's client store: its shard
    block of the rows of every row-split leaf (every worker rank the
    same), the rest whole."""
    s_r, si = mesh.shards, (mesh.index((SHARD,))[0] if mesh.shards > 1
                            else 0)

    def full_shape(key: str, shape: tuple) -> tuple:
        full = list(shape)
        if s_r > 1 and _store_split(key, len(full)):
            full[-2] *= s_r
        return tuple(full)

    def take(key: str, arr: np.ndarray) -> np.ndarray:
        if s_r > 1 and _store_split(key, arr.ndim):
            r = arr.shape[-2] // s_r
            arr = arr[..., si * r:(si + 1) * r, :]
        return arr

    return Block(take, full_shape)


def gather_store(mesh: WorkerMesh, tree):
    """The whole client store tree (host tensors) on rank 0, None on the
    other ranks: on a shard axis one gather a row-split leaf over worker
    rank 0's shard ranks (the other worker ranks' copies are the same and
    take no part), counted "checkpoint", the blocks joined in shard
    order; without one rank 0's tree as it is."""
    root = mesh.rank == 0
    if mesh.shards == 1:
        return tree if root else None
    if any(mesh.index(AXES)):
        return None

    def one(key, leaf):
        if not (isinstance(leaf, torch.Tensor)
                and _store_split(key, leaf.dim())):
            return leaf if root else None
        x = leaf.detach().to(coll.wire_device(mesh)).contiguous()
        parts = ([torch.empty_like(x) for _ in range(mesh.shards)]
                 if root else None)
        mesh.gather(x, parts, axes=(SHARD,))
        return torch.cat([q.cpu() for q in parts], -2) if root else None

    full = tree_mod.state_map(one, tree)
    return full if root else None
