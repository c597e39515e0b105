"""Client sampling (``repro.core.clients``): M logical clients over W
physical worker slots.

The paper's federated follow-ups (BVR-L-SGD, local-steps analyses) assume
only a *sampled cohort* of clients participates in each round.  This
module adds that regime on top of the flat-buffer engine without touching
the round:

  ``ClientStore``   — a host-side store of per-client engine state.  Every
      (W, R, C) worker-stacked buffer of a ``FlatWorkerState`` (params, Δ,
      BVR's B, the EF residual, the moments and SM3 stats) has an (M, R, C)
      host twin; the global leaves (step, last_sync, EASGD's center, the
      compressed sync's reference) are stored once.
  ``sample_cohort`` — a seed-deterministic draw of W distinct clients per
      round (numpy: the reference's draws, so both packages sample the
      same cohorts).

Each round the driver gathers the cohort's rows into the device buffers —
one row copy per client and buffer, which is what the flat layout buys —
runs the UNCHANGED round (still one model-state mean), and scatters the
updated rows back.  The store holds CPU tensors (the reference's numpy
arrays; a tensor also holds bf16 moments), page-locked when ``pin`` is
asked for so that the copies to and from the card run at the bus's rate.

Two invariants the store keeps:

  * Full participation (M == W, the identity cohort) is BITWISE the plain
    engine path: the round trip moves bytes untouched and applies no
    repair.
  * A strict-subset cohort breaks Σ_i Δ_i = 0 (the sum is zero over all M
    clients, not over any W of them): the driver runs
    ``Engine.recenter_drift`` on the gathered state before the round.

The worker-slot ``member`` mask is NOT per-client state: it describes the
health of the physical slots (crash/rejoin faults compose with sampling),
so it stays on the device and never round-trips the store; ``scatter``
skips the rows of dead slots, leaving those clients as they were.

On a mesh (``mesh=``, a ``comm.collectives.WorkerMesh``: each worker
rank holds its block of the W slots) every worker rank keeps a copy of
the store: ``gather`` installs this rank's slots of the cohort, and
``scatter`` all-gathers every worker rank's updated rows over the worker
axes (counted "clients") so that every copy takes the same writes and
stays the same.  On a grid with a shard axis (the engine's rows split
over S shard ranks, ``EngineConfig.shards``) each rank's store holds
every client's rows of its shard block, R/S of each (M, R, C) leaf, as
its state holds them: the row-split globals and ``server_params`` its
block too (``launch.mesh.store_block`` and ``gather_store`` carry the
store between the ranks and its one checkpoint file).  The gather copies
the cohort's rows of that block, the scatter all-gathers over the worker
axes within the rank's shard column only (1/S of the bytes of an
unsharded grid), and the dead-slot skip and the consensus refresh act on
each block as they act on whole rows.
"""
from __future__ import annotations

import hashlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List

import numpy as np
import torch

from repro_torch import tree as tree_mod
from repro_torch.comm import collectives as coll
from repro_torch.core import engine as engine_mod
from repro_torch.core.types import MemberState, OverlapState


def sample_cohort(num_clients: int, cohort_size: int, round_index: int,
                  seed: int = 0) -> np.ndarray:
    """The round's cohort: ``cohort_size`` DISTINCT client ids out of
    ``num_clients``, sorted, int64.

    Deterministic in (seed, round_index) alone — a resumed run re-draws
    the same cohorts for the same rounds, and independent processes agree
    without communicating.  Full participation returns the identity
    (``arange``), which makes the M == W gather a bitwise no-op.
    """
    if not 0 < cohort_size <= num_clients:
        raise ValueError(
            f"cohort_size must be in [1, {num_clients}], got {cohort_size}")
    if cohort_size == num_clients:
        return np.arange(num_clients, dtype=np.int64)
    rng = np.random.default_rng([seed, round_index])
    pick = rng.choice(num_clients, size=cohort_size, replace=False)
    return np.sort(pick).astype(np.int64)


def _strip_member(state):
    return state._replace(member=())


def _host(x: torch.Tensor, pin: bool) -> torch.Tensor:
    """A host copy of ``x`` (page-locked when ``pin``)."""
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)
    return out.copy_(x)


class ClientStore:
    """Host-side per-client engine state behind a (W, R, C) device window.

    Built from a FRESHLY initialised engine state (``engine.init``
    broadcasts one model over the workers, so row 0 is every client's
    starting point).  Leaves with a leading worker axis (3-d, leading W)
    become (M, ...) per-client tensors; every other leaf is a global,
    snapshotted at ``scatter`` so that a checkpoint sees a consistent
    (store, step) pair.  ``pin``: page-locked host memory (for a state on
    the card).
    """

    def __init__(self, state, num_clients: int, *, pin: bool = False,
                 mesh=None):
        if isinstance(state.overlap, OverlapState):
            raise ValueError(
                "client sampling does not compose with overlapped rounds: "
                "the overlap pend buffers are one round stale, so a "
                "gathered cohort would fold positions transmitted by "
                "DIFFERENT clients")
        if mesh is not None and mesh.fsdp > 1:
            raise NotImplementedError(
                f"a client store with a worker over {mesh.fsdp} fsdp ranks "
                f"is not ported: its slots follow the global rank, and "
                f"every fsdp rank would hold the same worker's rows")
        w = int(state.params.shape[0])
        # this worker rank's index on the (pod, data) grid (its shard
        # peers hold the same slots)
        rank = 0 if mesh is None else int(np.ravel_multi_index(
            mesh.index(coll.AXES), mesh.shape[:2]))
        self.mesh = mesh
        self.cohort_size = w * (1 if mesh is None else mesh.size(coll.AXES))
        # this rank's slots of the cohort
        self._slots = np.arange(rank * w, (rank + 1) * w)
        if num_clients < self.cohort_size:
            raise ValueError(
                f"num_clients ({num_clients}) must be >= the cohort size "
                f"({self.cohort_size} worker slots)")
        self.num_clients = int(num_clients)
        self.pin = pin
        leaves = tree_mod.state_leaves(_strip_member(state))
        # the state's structure, each leaf replaced by its key (no tensor
        # of the device state is kept alive by the store)
        self.template = tree_mod.state_map(lambda key, _: key,
                                           _strip_member(state))
        self._keys = [k for k, _ in leaves]
        self._is_client = [isinstance(lf, torch.Tensor) and lf.dim() == 3
                           and lf.shape[0] == w for _, lf in leaves]
        self._leaves: List[Any] = []
        for (_, lf), per_client in zip(leaves, self._is_client):
            if per_client:
                row = lf[0].detach().cpu()
                buf = torch.empty((num_clients, *row.shape), dtype=row.dtype,
                                  pin_memory=pin)
                buf.copy_(row.expand(buf.shape))
                self._leaves.append(buf)
            elif isinstance(lf, torch.Tensor):
                self._leaves.append(_host(lf.detach().cpu(), pin))
            else:
                self._leaves.append(lf)
        # the server consensus x̂: the post-sync parameter row every
        # participant holds at a round boundary.  Strict-subset cohorts are
        # seeded from it (``gather(..., seed_params=True)``): the round's Δ
        # update (x̂' − x_i)/(k·γ) assumes the cohort STARTED at the
        # previous consensus, and a client re-entering with params from
        # many rounds ago would book that whole gap into its Δ
        self.server_params = _host(state.params[0].detach().cpu(), pin)

    # ------------------------------------------------------ gather/scatter
    def gather(self, cohort: np.ndarray, member: Any = (), like: Any = None,
               seed_params: bool = False):
        """Load the cohort's client rows into a device state.

        One row copy per client and buffer; the globals ride along from
        the store.  ``member``: the device-resident worker-slot mask to
        carry (``()`` when membership is off).  ``like``: a state of the
        same layout whose buffers are written IN PLACE and returned
        (replaced) — the round's buffers stay where they are, and no second
        state is allocated on the card; without it new CPU tensors.

        ``seed_params=True`` replaces the cohort's parameter rows with the
        server consensus (the federated round: the server BROADCASTS x̂ to
        the sampled cohort; what persists per client is its control
        variate, bias, moments and residual).  For strict-subset cohorts
        of the broadcast-sync algorithms; NOT at full participation (the
        bitwise gate) nor for EASGD (persistent local params are elastic
        averaging's point).
        """
        cohort = np.asarray(cohort, dtype=np.int64)
        if cohort.shape != (self.cohort_size,):
            raise ValueError(
                f"cohort must have shape ({self.cohort_size},), got "
                f"{cohort.shape}")
        dst = (dict(tree_mod.state_leaves(_strip_member(like)))
               if like is not None else {})
        nb = self.pin
        out = {}
        for key, lf, per_client in zip(self._keys, self._leaves,
                                       self._is_client):
            if not isinstance(lf, torch.Tensor):
                out[key] = lf
                continue
            shape = ((len(self._slots), *lf.shape[1:]) if per_client
                     else tuple(lf.shape))
            buf = dst.get(key)
            if buf is None:
                buf = torch.empty(shape, dtype=lf.dtype)
            elif tuple(buf.shape) != shape or buf.dtype != lf.dtype:
                raise ValueError(f"gather: {key} of the target state is "
                                 f"{tuple(buf.shape)} {buf.dtype}, the "
                                 f"store's {shape} {lf.dtype}")
            if per_client:
                src = (self.server_params.expand(len(self._slots),
                                                 *lf.shape[1:])
                       if seed_params and key == "params" else None)
                for j, c in enumerate(cohort[self._slots]):
                    buf[j].copy_(lf[c] if src is None else src[j],
                                 non_blocking=nb)
            else:
                buf.copy_(lf, non_blocking=nb)
            out[key] = buf
        state = tree_mod.state_map(lambda key, _: out[key], self.template)
        return state._replace(member=member)

    def scatter(self, state, cohort: np.ndarray) -> None:
        """Write the round's updated rows back to the cohort's clients.

        Rows whose worker slot is marked dead in ``state.member`` are
        SKIPPED — that slot's client keeps its pre-round state (it did not
        participate) rather than absorbing what a crashed slot's buffers
        hold.  The globals (step, center, sync reference, ...) are
        snapshotted unconditionally.  Returns once the host holds every
        byte.
        """
        cohort = np.asarray(cohort, dtype=np.int64)
        alive = np.ones(self.cohort_size, dtype=bool)
        member = state.member
        if isinstance(member, MemberState) and self.mesh is None:
            alive = engine_mod.host_mask(member).keep
        elif isinstance(member, MemberState):
            alive = engine_mod.global_mask(self.mesh, member.active,
                                           self._slots,
                                           self.cohort_size) > 0
        leaves = tree_mod.state_leaves(_strip_member(state))
        if [k for k, _ in leaves] != self._keys:
            raise ValueError("scatter: the state's layout is not the "
                             "store's")
        nb = self.pin
        p = state.params
        for i, ((key, lf), per_client) in enumerate(zip(leaves,
                                                        self._is_client)):
            if per_client:
                # every slot's row: this rank's, or on a mesh every worker
                # rank's (of this rank's shard block)
                rows = (lf if self.mesh is None else
                        self.mesh.all_gather(lf, kind="clients",
                                             axes=coll.AXES).flatten(0, 1))
                if key == "params":
                    p = rows
                for j, c in enumerate(cohort):
                    if alive[j]:
                        self._leaves[i][c].copy_(rows[j], non_blocking=nb)
            elif isinstance(lf, torch.Tensor):
                self._leaves[i].copy_(lf, non_blocking=nb)
            else:
                self._leaves[i] = lf
        # refresh the consensus from the post-round rows: every round closes
        # with a sync, after which the broadcast-sync algorithms' alive rows
        # are identical, so their mean IS that value (never read on the
        # bitwise full-participation path, which does not seed).  The
        # rows' sum in order, ÷ the count as a device tensor (the
        # reference's numpy mean over the rows)
        live = np.flatnonzero(alive)
        if live.size:
            s = p[live[0]].to(torch.float32, copy=True)
            for j in live[1:]:
                s.add_(p[j])
            s.div_(torch.tensor(float(live.size), dtype=torch.float32,
                                device=s.device))
            self.server_params.copy_(s.to(p.dtype), non_blocking=nb)
        if nb and state.params.is_cuda:
            torch.cuda.synchronize(state.params.device)

    # -------------------------------------------------------- checkpoints
    def to_tree(self) -> dict:
        """The store as a checkpointable state tree: the state-shaped client
        tree with (M, ...) per-client leaves, plus the server consensus
        (which must survive a resume: a restored run seeds its first
        strict-subset cohort from it).  Its keys are the JAX package's
        ("clients/params", ..., "server_params")."""
        leaves = dict(zip(self._keys, self._leaves))
        return {"clients": tree_mod.state_map(lambda key, _: leaves[key],
                                              self.template),
                "server_params": self.server_params}

    def load_tree(self, tree) -> None:
        """Install a restored store tree (the structure and shapes must be
        the store's); copied into the store's own (page-locked) tensors."""
        if not isinstance(tree, dict) or set(tree) != {"clients",
                                                       "server_params"}:
            raise ValueError(
                "client store tree must be {'clients', 'server_params'}, "
                f"got {sorted(tree) if isinstance(tree, dict) else type(tree).__name__}")
        leaves = tree_mod.state_leaves(tree["clients"])
        if [k for k, _ in leaves] != self._keys:
            raise ValueError(
                f"client store structure mismatch:\n  restored: "
                f"{[k for k, _ in leaves]}\n  expected: {self._keys}")
        for (key, theirs), mine in zip(leaves, self._leaves):
            shape = tuple(getattr(theirs, "shape", ()))
            if shape != tuple(getattr(mine, "shape", ())):
                raise ValueError(
                    f"client store leaf shape mismatch: restored {shape} "
                    f"!= expected {tuple(getattr(mine, 'shape', ()))}")
        server = tree["server_params"]
        if tuple(server.shape) != tuple(self.server_params.shape):
            raise ValueError(
                f"server consensus shape mismatch: restored "
                f"{tuple(server.shape)} != expected "
                f"{tuple(self.server_params.shape)}")
        for i, (_, theirs) in enumerate(leaves):
            if isinstance(self._leaves[i], torch.Tensor):
                self._leaves[i].copy_(torch.as_tensor(theirs))
            else:
                self._leaves[i] = int(theirs)
        self.server_params.copy_(torch.as_tensor(server))

    def block_digests(self, parts: int = 1) -> dict:
        """{leaf key: [the SHA-256 of each of ``parts`` row blocks]} of the
        store's tree (``to_tree``'s keys): a leaf with rows (dim -2) cut
        into ``parts`` equal blocks, each hashed over every client in
        order; a 0-d or 1-d leaf or a host integer hashed whole, once.  A
        row-sharded rank's store (``parts`` 1) and one process's at the
        same ``shards`` layout (``parts`` S) then compare block by block
        without moving the store.  The blocks hash on threads (hashlib
        releases the GIL)."""
        def one(x: np.ndarray, j: int) -> str:
            h = hashlib.sha256()
            if x.ndim < 2:
                h.update(np.ascontiguousarray(x))
                return h.hexdigest()
            r = x.shape[-2] // parts
            for blk in x.reshape(-1, *x.shape[-2:]):
                h.update(np.ascontiguousarray(blk[j * r:(j + 1) * r]))
            return h.hexdigest()

        jobs = {}
        for key, lf in tree_mod.state_leaves(self.to_tree()):
            if not isinstance(lf, torch.Tensor):
                lf = torch.tensor(int(lf), dtype=torch.int64)
            x = lf.detach()
            if x.dtype == torch.bfloat16:
                x = x.view(torch.int16)
            x = x.cpu().numpy()
            jobs[key] = [(x, j) for j in range(parts if x.ndim >= 2
                                               else 1)]
        with ThreadPoolExecutor() as pool:
            futs = {key: [pool.submit(one, x, j) for x, j in js]
                    for key, js in jobs.items()}
            return {key: [f.result() for f in fs]
                    for key, fs in futs.items()}

    def global_leaf(self, name: str):
        """A stored global leaf by state field name (e.g. ``step``)."""
        return getattr(self.to_tree()["clients"], name)

    @property
    def nbytes(self) -> int:
        """The store's bytes, a host integer counted as the int32 it is
        saved as (the reference's count)."""
        return int(sum(lf.numel() * lf.element_size()
                       if isinstance(lf, torch.Tensor) else 4
                       for lf in self._leaves))

    def meta(self) -> dict:
        """JSON-safe store description for telemetry / run metadata."""
        return {"num_clients": self.num_clients,
                "cohort_size": self.cohort_size,
                "store_bytes": self.nbytes}


def cohort_schedule(num_clients: int, cohort_size: int, rounds: int,
                    seed: int = 0,
                    start_round: int = 0) -> List[np.ndarray]:
    """The cohorts of ``rounds`` consecutive rounds (inspection/tests)."""
    return [sample_cohort(num_clients, cohort_size, r, seed)
            for r in range(start_round, start_round + rounds)]
