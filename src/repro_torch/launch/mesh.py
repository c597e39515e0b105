"""Worker meshes over ``torch.distributed`` (``repro.launch.mesh``
``make_engine_mesh``): the rank grid and its process groups.

The rank grid (``rank_grid``): flat, (1, world) with W % world == 0;
hierarchical over a (P, D) worker grid, d_r = gcd(D, world) ranks along
the data axis and p_r = world / d_r along the pod axis, so that ranks fill
the data axis first (P % p_r == 0).  Each rank holds W / world workers
((P / p_r, D / d_r) for the hierarchy).  ``make_engine_mesh`` returns the
``comm.collectives.WorkerMesh`` the engine's worker means run over.
``gather_state`` and ``state_block`` carry a checkpoint between a mesh
and its one file.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as tree_mod
from repro_torch.checkpoint import Block
from repro_torch.comm import collectives as coll
from repro_torch.comm.collectives import AXES, WorkerMesh


def rank_grid(workers: int, world: int, pods: int = 0) -> Tuple[int, int]:
    """The (pod, data) rank grid that spreads ``workers`` (a (``pods``,
    W/pods) grid for the hierarchy, flat when ``pods`` is 0) over
    ``world`` ranks, or a ValueError that says why it cannot."""
    if world < 1:
        raise ValueError(f"a mesh needs at least one rank, got {world}")
    if not pods:
        if workers % world:
            raise ValueError(
                f"{workers} workers do not split over {world} ranks: the "
                f"flat rank grid is (1, {world}), so each rank holds "
                f"W / world workers and W % world must be 0")
        return 1, world
    if workers % pods:
        raise ValueError(f"{workers} workers do not split into {pods} pods")
    d_r = math.gcd(workers // pods, world)
    p_r = world // d_r
    if pods % p_r:
        raise ValueError(
            f"the (P, D) = ({pods}, {workers // pods}) worker grid does not "
            f"split over {world} ranks: ranks fill the data axis first "
            f"(d_r = gcd(D, world) = {d_r}), which leaves p_r = {p_r} rank "
            f"rows for {pods} pods (P % p_r must be 0)")
    return p_r, d_r


def local_workers(mesh: WorkerMesh, workers: int,
                  pods: int = 0) -> np.ndarray:
    """The global indices (pod-major for the hierarchy) of this rank's
    workers, in the order of its local buffers."""
    pi, di = mesh.coords
    if not pods:
        w = workers // mesh.size()
        return np.arange(mesh.rank * w, (mesh.rank + 1) * w)
    d = workers // pods
    pl, dl = pods // mesh.shape[0], d // mesh.shape[1]
    grid = np.arange(workers).reshape(pods, d)
    return grid[pi * pl:(pi + 1) * pl, di * dl:(di + 1) * dl].ravel()


def make_engine_mesh(workers: int, *, pods: int = 0) -> WorkerMesh:
    """The worker mesh over the default process group (initialised by the
    caller): the rank grid of ``rank_grid`` and its groups.  Every rank
    creates every group, in the same order: the whole grid, then each
    column of the pod axis, then each row of the data axis."""
    world, rank = dist.get_world_size(), dist.get_rank()
    p_r, d_r = rank_grid(workers, world, pods)
    groups = {AXES: dist.new_group(list(range(world)))}
    for di in range(d_r):
        g = dist.new_group([pi * d_r + di for pi in range(p_r)])
        if rank % d_r == di:
            groups[("pod",)] = g
    for pi in range(p_r):
        g = dist.new_group([pi * d_r + di for di in range(d_r)])
        if rank // d_r == pi:
            groups[("data",)] = g
    return WorkerMesh((p_r, d_r), rank, groups)


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


def state_block(mesh: WorkerMesh, pods: int = 0):
    """The ``checkpoint.Block`` of this rank: its part of each saved leaf
    (``pods``: the hierarchy's P, 0 for the flat algorithms)."""
    hier = bool(pods)
    (pi, di), (p_r, d_r), world = mesh.coords, mesh.shape, mesh.size()

    def full_shape(key: str, shape: tuple) -> tuple:
        span = _span(key, hier)
        if not shape or span == "global":
            return tuple(shape)
        if not hier:
            return (shape[0] * world, *shape[1:])
        if span == "pod":
            return (shape[0] * p_r, *shape[1:])
        return (shape[0] * p_r, shape[1] * d_r, *shape[2:])

    def take(key: str, arr: np.ndarray) -> np.ndarray:
        span = _span(key, hier)
        if arr.ndim == 0 or span == "global":
            return arr
        if not hier:
            w = arr.shape[0] // world
            return arr[mesh.rank * w:(mesh.rank + 1) * w]
        pl = arr.shape[0] // p_r
        if span == "pod":
            return arr[pi * pl:(pi + 1) * pl]
        dl = arr.shape[1] // d_r
        return arr[pi * pl:(pi + 1) * pl, di * dl:(di + 1) * dl]

    return Block(take, full_shape)


def gather_state(mesh: WorkerMesh, state, pods: int = 0):
    """The full state (every rank's block of each leaf, as host tensors)
    on rank 0, None on the other ranks: one gather a leaf, counted
    "checkpoint"."""
    hier = bool(pods)
    root = mesh.rank == 0
    p_r, d_r = mesh.shape

    def one(key, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        if _span(key, hier) == "global":
            return leaf.detach().cpu() if root else None
        x = leaf.detach().to(coll.wire_device(mesh)).contiguous()
        parts = ([torch.empty_like(x) for _ in range(mesh.size())] if root
                 else None)
        mesh.gather(x, parts)
        if not root:
            return None
        parts = [q.cpu() for q in parts]
        if not hier:
            return torch.cat(parts, 0)
        if _span(key, hier) == "pod":
            return torch.cat([parts[pi * d_r] for pi in range(p_r)], 0)
        return torch.cat([torch.cat(parts[pi * d_r:(pi + 1) * d_r], 1)
                          for pi in range(p_r)], 0)

    full = tree_mod.state_map(one, state)
    return full if root else None
