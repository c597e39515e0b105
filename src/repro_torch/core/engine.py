"""Flat-buffer algorithm engine (``repro.core.engine``, flat branch).

Every algorithm of the reference is the same loop over worker-stacked,
model-sized state: a *local* elementwise update per step (eqs. 5-6: the
inner-optimizer step on the Δ-corrected gradient) and a periodic *sync*
(eq. 4: model averaging plus the Δ update).  ``AlgoSpec`` describes an
algorithm over that loop; ``make_engine`` binds the executor: parameters,
Δ, B and the inner-optimizer moments are flattened ONCE at init into
contiguous (W, R, C) buffers (``core/flat``), every local step is one
fused kernel pass (``kernels/vrl_update.fused_local_{sgd,momentum,adam,
adam_sm3}``) and every sync is one worker mean plus at most one fused pass
(``fused_sync_{vrl,bvr,easgd}``; local_sgd's average is a broadcast copy).
The kernels update the buffers in place.

On one device the worker axis is the leading buffer dimension, and the
worker mean is a ``torch.mean`` over it.  On a mesh (``mesh=``, a
``comm.collectives.WorkerMesh`` over ``torch.distributed`` ranks) each
rank holds its block of the workers, and every worker mean is the
reference's on-mesh form (``comm.collectives.worker_mean``): a local sum,
one counted ``all_reduce(SUM)`` over the worker axes' group, then ÷ the
global count — the round's one all-reduce, none in the local steps
(S-SGD: one per step, its gradient mean).

Compressed sync (``cfg.compress``, ``comm/compressors``): every sync
first runs one fused EF round trip over the payload's drift against the
shared reference ``ref`` (``fused_ef_{int8,topk}``), and the worker mean
runs over the decompressed drift: x̂ = ref + mean_i(dec_i).  S-SGD
compresses its per-step gradient mean instead (ref ≡ 0).

Overlapped rounds (``cfg.overlap``): ``round_begin`` takes the worker mean
of the positions every worker transmitted at the previous round boundary
(``OverlapState.pend``), the round's k local steps run, and ``round_fold``
folds the one-round-stale mean in (``fused_fold_overlap{,_bvr,_avg}``) and
captures the new positions, through the EF round trip under compression.
Under ``cfg.deadline`` each participant misses its capture with that
probability per round (``core/deadline``, the reference's draws bit for
bit): it keeps its last transmitted position, the period its pend covers
stretches, and under compression its payload is parked in its residual.

Two-level hier_vrl_sgd (sync rule "vrl2", ``configs.base.HierConfig``)
runs over pod-major (P, D, R, C) buffers with Δ1 per worker and Δ2
(P, 1, R, C) per pod (``_make_hier_engine``): the local step is one
``fused_hier_local_{sgd,momentum,adam,adam_sm3}`` pass, the level-1
sync one pod mean plus ``fused_sync_hier1``, the level-2 sync one
cross-pod mean plus ``fused_sync_hier2``; under overlap only level 2 is
deferred (``fused_fold_overlap_hier2``).  Each level may compress
(``compress``, and ``compress2`` for level 2): level 1 through the grid EF
round trip against a per-pod reference (``fused_ef_{int8,topk}_grid``),
level 2 through the flat one over the pod rows against a global one.

Dtypes are the reference's: the parameter buffer (and the gradient
buffer a tree flattens into) takes the template's dtype, fp32 or bf16
(``make_train_step(param_dtype=)``), Δ and B ``cfg.delta_dtype``, the
moments ``cfg.moment_dtype``; the EASGD center, the overlap pend, the EF
residuals and references and the SM3 stats are fp32.  x̂ reaches the
kernels in the parameters' dtype (the EASGD x̂, a mean of the fp32-cast
parameters, and a compressed x̂, ref + mean(dec), are fp32 until then); a
bf16 mean is the reference's: one rounding off a mesh (the hierarchy's
divides its rounded sum), and on a mesh the rank's rounded sum, an fp32
all-reduce, rounded back, ÷ the count (``comm.collectives.worker_mean``).

SM3-factored Adam (``sm3=True``) replaces the dense (W, R, C) nu with a
(W, R, 1) row stat and a (W, S, C) lane stat, one lane row per shard span
of ``EngineConfig.shards`` (rows pad to a multiple of ``block * shards``).

Row shards (``EngineConfig.shards`` S > 1 on a mesh with a "shard" axis of
S ranks, ``sharding.specs.engine_shard_axis``; ``RowShards``): each rank
holds rows [s·R/S, (s+1)·R/S) of its workers' buffers — params, Δ, B,
moments (SM3's lane stat its shard's one row), EF residuals and
references, the center, overlap pend, the hierarchy's Δ2 — and the update
kernels take those (W_l, R/S, C) buffers as they are.  Every worker mean
runs over the worker group of the rank's shard column: one counted
"state" all-reduce a round of 1/S of the bytes, none in the local steps,
as the reference's per-shard all-reduce.  The forward needs every row:
``gather_params`` gathers them over the shard group into a transient
(W_l, R, C) buffer (counted "forward"; the train loop calls it before each
step's forward), ``own_rows`` cuts a rank's rows out of a full gradient;
``local_step`` takes a gradient tensor of the rank's rows as it comes and
cuts a gradient tree of every row.
The diagnostics' and the guard's scalars reduce over every rank (the
reference's ``_gsum`` / ``_per_worker`` over the shard axis too).
Without a mesh, or on one without the axis, the shards are layout only.

The port runs every flat algorithm (vrl_sgd, local_sgd, ssgd, easgd,
stl_sgd, bvr_l_sgd) and hier_vrl_sgd with the sgd, momentum and adam
inner optimizers (Adam dense or SM3-factored, moments fp32 or bf16), with
or without compression, overlap, deadlines and membership; it refuses
only what the reference refuses.

Elastic membership (``cfg.membership``): the state carries a
``types.MemberState`` (the active-worker mask and the active counts) and
every sync mean runs over the ACTIVE workers only
(``comm.collectives.worker_mean``'s masked form: the active slices added
one by one, never a multiply, and the state-carried count, so still one
all-reduce).  The mask is read to the host once (``host_mask``); with
every worker active the means are the plain ones, so a full mask is
bitwise membership-off.  Dead rows stay in the buffers and keep taking
local steps; no mean reads them.
``Engine.set_membership(state, active)`` is the repair between rounds:
continuing workers' Δ (and B) recentred to Σ = 0 over the continuing set
without reading a dropped row, dropped and rejoining workers re-seeded
from the continuing consensus x̂ (params, overlap pend) with Δ, B, moments
and EF residual zeroed.  The hierarchy masks per level: per-pod active
counts for the intra-pod means, a uniform mean over alive pods across
them.  ``Engine.recenter_drift`` re-zeroes Σ Δ (Σ B) over the rows a
client cohort loaded (``core.clients``).  easgd refuses the mask.

``Engine.diagnostics`` is the reference's read-only health pass over a
flat (or pod-major) state: drift against x̂, the Σ Δ (Σ B, per-level)
residuals, the Δ-dispersion ζ² proxy, EF and moment norms, non-finite
workers (``obs.diagnostics`` turns it into records).  It runs between
rounds, in plain PyTorch reductions; on a mesh its sums are "eval"
all-reduces, so a round keeps its one model-state all-reduce.

The per-leaf reference executor (``ref_*``, ``ref_hier_*``) is the
reference's oracle path, ported: per-leaf tensor math over the parameter
tree (``types.WorkerState`` / ``HierState``), functional, the inner
optimizer ``optim.make_inner``'s per-leaf steps, compression through
``comm.compressors.ef_leaf``.  It launches no kernel.  ``get_algorithm``
(``core/api``) returns it, and ``update_backend="reference"`` trains
with it (``resolve_backend``).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import tree as tree_mod
from repro_torch.comm import collectives as coll
from repro_torch.comm import compressors as comm_mod
from repro_torch.configs.base import HierConfig, VRLConfig
from repro_torch.core import deadline as deadline_mod
from repro_torch.core import flat
from repro_torch.core import schedule as schedule_mod
from repro_torch.core.types import (CommState, FlatWorkerState,
                                    HierCommState, HierFlatState, HierState,
                                    MemberState, OverlapState, WorkerState)
from repro_torch.kernels import vrl_update as vu
from repro_torch.optim import optimizers as opt_mod
from repro_torch.sharding import specs as sharding_specs


# ===================================================================== specs
class AlgoSpec(NamedTuple):
    """An algorithm as a description over the shared engine.

    ``sync`` names the rule that runs at period boundaries; "bvr" is the
    VRL rule plus BVR-L-SGD's bias-variate EMA; "vrl2" the two-level
    hierarchical rule (pod-major grid, ``configs.base.HierConfig``).
    """

    name: str
    use_delta: bool        # local step applies v = g − Δ (eq. 6)
    grad_all_reduce: bool  # S-SGD: mean gradients over workers every step
    # "vrl" | "average" | "elastic" | "none" | "bvr" | "vrl2"
    sync: str
    has_center: bool       # EASGD center variable x̃
    warmup_aware: bool     # honors VRLConfig.warmup (first period k=1)
    use_bias: bool = False  # BVR-L-SGD: local step also subtracts B
    stagewise: bool = False  # STL-SGD: default to a stagewise CommSchedule


ALGO_SPECS = {
    "vrl_sgd": AlgoSpec("vrl_sgd", use_delta=True, grad_all_reduce=False,
                        sync="vrl", has_center=False, warmup_aware=True),
    "local_sgd": AlgoSpec("local_sgd", use_delta=False, grad_all_reduce=False,
                          sync="average", has_center=False,
                          warmup_aware=False),
    "ssgd": AlgoSpec("ssgd", use_delta=False, grad_all_reduce=True,
                     sync="none", has_center=False, warmup_aware=False),
    "easgd": AlgoSpec("easgd", use_delta=False, grad_all_reduce=False,
                      sync="elastic", has_center=True, warmup_aware=False),
    "hier_vrl_sgd": AlgoSpec("hier_vrl_sgd", use_delta=True,
                             grad_all_reduce=False, sync="vrl2",
                             has_center=False, warmup_aware=False),
    # STL-SGD (Shen et al., 2020): Local SGD whose period grows stagewise;
    # the cadence comes from the CommSchedule (comm_schedule() below), so
    # with a constant schedule the trajectory is bitwise local_sgd.
    "stl_sgd": AlgoSpec("stl_sgd", use_delta=False, grad_all_reduce=False,
                        sync="average", has_center=False,
                        warmup_aware=False, stagewise=True),
    # BVR-L-SGD (Murata & Suzuki, 2021): VRL-SGD plus a bias variate B_i,
    # an EMA (rate cfg.bvr_beta) of the per-round drift (x̂ − x_i)/(k_eff γ),
    # subtracted in every local step alongside Δ_i.  Σ_i B_i = 0 after every
    # sync; bvr_beta=0 disables it — the trajectory is then bitwise vrl_sgd.
    "bvr_l_sgd": AlgoSpec("bvr_l_sgd", use_delta=True,
                          grad_all_reduce=False, sync="bvr",
                          has_center=False, warmup_aware=True,
                          use_bias=True),
}


BACKENDS = ("auto", "fused", "xla", "reference")


def resolve_backend(cfg_or_name, device: Any = "cuda") -> str:
    """Resolve ``update_backend`` (a VRLConfig or a bare name) for a run on
    ``device`` to the executor that runs it.

    "auto" is the flat engine: "fused" (the CUDA kernels) on the card,
    "xla" on the CPU, where the kernel wrappers run their plain PyTorch
    versions — the port's counterpart of the reference's plain-jnp
    executor.  "xla" is refused on the card: there the plain versions are
    only the kernels' test oracles.  "reference" is the per-leaf
    executor."""
    name = getattr(cfg_or_name, "update_backend", cfg_or_name)
    if name not in BACKENDS:
        raise ValueError(f"unknown update_backend {name!r}; known: "
                         f"{BACKENDS}")
    cuda = torch.device(device).type == "cuda"
    if name == "auto":
        return "fused" if cuda else "xla"
    if name == "xla" and cuda:
        raise ValueError(
            "update_backend='xla' runs the port's plain PyTorch versions, "
            "which are the CUDA kernels' test oracles, not an executor for "
            "the card: use 'auto' or 'fused' there ('xla' is the CPU's)")
    return name


def hier_config(cfg: VRLConfig) -> HierConfig:
    """The two-level periods/grid; defaults to the flat period at k1=k2."""
    if cfg.hier is not None:
        return cfg.hier
    return HierConfig(k1=cfg.comm_period, k2=cfg.comm_period)


def get_spec(name: str) -> AlgoSpec:
    if name not in ALGO_SPECS:
        raise KeyError(f"unknown algorithm {name!r}; known: "
                       f"{sorted(ALGO_SPECS)}")
    return ALGO_SPECS[name]


def flat_algorithms() -> Tuple[str, ...]:
    """Names of the flat (non-hierarchical) algorithms, sorted."""
    return tuple(n for n, s in sorted(ALGO_SPECS.items()) if s.sync != "vrl2")


def comm_schedule(cfg: VRLConfig):
    """The round schedule driving this config's sync cadence.

    ``cfg.comm_schedule`` when set; stl_sgd defaults to the STL-SGD
    stagewise-doubling ramp 1 → ``comm_period``; None otherwise (the
    constant ``comm_period`` cadence).  A schedule supersedes ``warmup``.
    """
    if cfg.comm_schedule is not None:
        return cfg.comm_schedule
    if get_spec(cfg.algorithm).stagewise:
        return schedule_mod.stagewise_doubling(k0=1, k_max=cfg.comm_period)
    return None


def use_bias(spec: AlgoSpec, cfg: VRLConfig) -> bool:
    """True when the BVR bias variate is active (``bvr_beta == 0`` turns
    B off, so the run is bitwise the underlying VRL-SGD)."""
    return spec.use_bias and bool(cfg.bvr_beta)


def should_sync(spec: AlgoSpec, cfg: VRLConfig, step: int,
                last_sync: int) -> bool:
    """True when ``step`` (post-increment) completes a communication period.

    With a ``CommSchedule`` the period is the schedule's for the round
    starting at ``last_sync``; otherwise the constant ``comm_period``.
    VRL-SGD-W (Remark 5.3): with ``warmup`` the first period runs k=1.
    """
    sched = comm_schedule(cfg)
    if sched is not None:
        k = sched.period_starting_at(last_sync)
    elif spec.warmup_aware and cfg.warmup and last_sync == 0 and step <= 1:
        k = 1
    else:
        k = cfg.comm_period
    return (step - last_sync) >= k


def sum_invariant(buf: Any, dim: int = 0, mesh=None,
                  axes: Tuple[str, ...] = coll.AXES,
                  keep: Optional[np.ndarray] = None) -> Tuple[float, float]:
    """(max|Σ_i buf_i|, max|buf|) over the worker axis ``dim``: the paper's
    invariant Σ_i Δ_i = 0 after every sync (and BVR's Σ_i B_i = 0; the
    hierarchy's Σ_d Δ1 = 0 within every pod with ``dim=1``, Σ_p Δ2 = 0),
    and the scale its fp32 rounding residue is relative to.  ``buf``: a
    flat buffer or a per-leaf tree (the maxima over its leaves).  Reads
    the state once per value (host sync).  On a ``mesh`` the sum also
    runs over the ranks of ``axes`` (the ones ``dim`` spans) and the
    maxima over every rank, all counted "eval".  ``keep``: a host bool
    array over a flat buffer's leading dims (``coll.masked_sum``'s), the
    worker slices read (the active ones under membership)."""

    def amax(x: torch.Tensor) -> float:
        # max|x| without an |x| temporary the size of the state
        return torch.linalg.vector_norm(x, float("inf")).item()
    if keep is not None:
        s = coll.masked_sum(buf, keep, dim)
        if mesh is not None:
            mesh.all_reduce(s, axes, kind="eval")
        return (coll.global_reduce(mesh, amax(s)),
                coll.global_reduce(mesh, max(
                    (amax(buf[tuple(map(int, i))])
                     for i in zip(*np.nonzero(keep))), default=0.0)))
    leaves = tree_mod.leaves(buf)
    return (coll.global_reduce(mesh, max(
                amax(coll.worker_sum(mesh, x, dim, axes)) for x in leaves)),
            coll.global_reduce(mesh, max(amax(x) for x in leaves)))


def _ef_op(comp: comm_mod.CompressorSpec, lanes: int, *,
           grid: bool = False) -> Callable:
    """The EF round-trip kernel for one compressor: (payload buffer, ref,
    resid, out=) -> (dec fp32, resid'), resid' in place; ``grid``: the
    pod-major form over (P, D, R, C) with a (P, 1, R, C) ref."""
    if comp.name == "int8":
        return vu.fused_ef_int8_grid if grid else vu.fused_ef_int8
    fn = vu.fused_ef_topk_grid if grid else vu.fused_ef_topk
    return functools.partial(fn, k=comm_mod.topk_k(comp, lanes))


def _validate_overlap(cfg: VRLConfig, algo: AlgoSpec, comp) -> None:
    """Reject what the overlapped round cannot honour (the reference's
    checks).  ``comp``: the compressor of the sync that overlap defers
    (flat: ``compress``; the hierarchy: level 2's)."""
    if not cfg.overlap:
        if cfg.deadline:
            raise ValueError(
                "deadline is a property of the overlapped round; set "
                "overlap=True (--overlap) to use it")
        return
    if algo.sync in ("none", "elastic"):
        raise ValueError(
            f"overlap defers a mean-style round-closing sync; "
            f"{algo.name!r} (sync={algo.sync!r}) has none to defer")
    if not 0.0 <= cfg.deadline <= 1.0:
        raise ValueError(
            f"deadline is a per-round miss probability in [0, 1]; got "
            f"{cfg.deadline}")
    if cfg.deadline and comp is not None and not comp.error_feedback:
        raise ValueError(
            "deadline misses park the skipped payload in the EF residual; "
            "the overlapped sync's compressor needs error_feedback=True")


def _misses(cfg: VRLConfig, axis_index: tuple = ()) -> Callable:
    """(step, n) -> the (n, 1) fp32 numpy miss mask of the overlapped fold
    ending at ``step`` (``core/deadline``; all zeros without a deadline);
    ``axis_index``: this rank's mesh indices, folded into the draw."""
    return functools.partial(deadline_mod.miss_mask, deadline=cfg.deadline,
                             axis_index=tuple(axis_index))


class RowShards(NamedTuple):
    """Where this rank's rows of the flat layout lie: ``axis``, the mesh
    axis the rows split over (None: every rank holds all R rows); ``count``
    its ranks S; ``index`` this rank's s.  The rank holds rows [s·R/S,
    (s+1)·R/S) of every buffer (``flat.make_spec`` pads R to a multiple of
    block · S)."""

    axis: Optional[str]
    count: int
    index: int
    mesh: Any

    def own(self, buf: torch.Tensor, rows: int) -> torch.Tensor:
        """This rank's rows of a full (..., R, C) buffer (``rows`` = R): a
        view, contiguous when the leading dims hold one worker; ``buf``
        itself when every rank holds every row."""
        if self.axis is None:
            return buf
        if buf.shape[-2] != rows:
            raise ValueError(
                f"expected a buffer of all {rows} rows to cut this shard "
                f"rank's block from, got shape {tuple(buf.shape)}")
        r = rows // self.count
        return buf[..., self.index * r:(self.index + 1) * r, :]

    def gather(self, buf: torch.Tensor, kind: str) -> torch.Tensor:
        """The full (..., R, C) buffer from every shard rank's (..., R/S, C)
        rows: one all-gather over the shard group, counted ``kind``;
        ``buf`` itself without a shard axis."""
        if self.axis is None:
            return buf
        parts = self.mesh.all_gather(buf, kind=kind, axes=(self.axis,))
        return parts.movedim(0, -3).reshape(
            *buf.shape[:-2], self.count * buf.shape[-2], buf.shape[-1])


def _row_shards(cfg: VRLConfig, mesh) -> RowShards:
    """The rows' placement (``sharding.specs.engine_shard_axis``): a mesh
    whose shard axis has another size than ``EngineConfig.shards`` is
    refused, and so is one with a shard axis of several ranks and shards
    1 (its ranks would hold replicas of one another's rows)."""
    ax = sharding_specs.engine_shard_axis(mesh, cfg.engine)
    if ax is None:
        if mesh is not None and mesh.shards > 1:
            raise ValueError(
                f"the mesh's shard axis has {mesh.shards} ranks but "
                f"EngineConfig.shards={cfg.engine.shards}; the row dim "
                f"splits into exactly one block a shard rank")
        return RowShards(None, 1, 0, mesh)
    return RowShards(ax, mesh.size((ax,)), mesh.index((ax,))[0], mesh)


def _validate_fsdp(cfg: VRLConfig, algo: AlgoSpec, mesh) -> None:
    """Refuse what the port does not run with a worker over fsdp ranks:
    the hierarchy (its pod-major grid over the fsdp axis is not ported)
    and membership (its host masks and repairs reduce over the whole
    grid, where the fsdp replicas would count each worker F times)."""
    if mesh is None or mesh.fsdp == 1:
        return
    if algo.sync == "vrl2":
        raise NotImplementedError(
            f"hier_vrl_sgd with a worker over {mesh.fsdp} fsdp ranks is not "
            f"ported: the hierarchy's (P, D) grid runs one worker rank a "
            f"worker")
    if cfg.membership:
        raise NotImplementedError(
            f"membership with a worker over {mesh.fsdp} fsdp ranks is not "
            f"ported: its masks and repairs reduce over the whole grid")


def _validate_membership(cfg: VRLConfig, algo: AlgoSpec) -> None:
    if cfg.membership and algo.sync == "elastic":
        raise ValueError(
            "membership composes with mean-style syncs; easgd's center "
            f"update assumes a fixed worker count — {algo.name!r} cannot "
            "run with membership=True")


def _masked(member: Any) -> bool:
    return isinstance(member, MemberState)


class HostMask(NamedTuple):
    """A ``MemberState`` on the host: ``keep``, this rank's active flags
    (flattened, pod-major for the hierarchy); ``n``, ``n_active``;
    ``n_pod``, this rank's pods' active members (the hierarchy; None on
    the flat engine)."""

    keep: np.ndarray
    n: float
    n_pod: Optional[np.ndarray]

    @property
    def live(self) -> np.ndarray:
        return np.flatnonzero(self.keep)


# a MemberState is replaced, never written in place, so its mask tensor
# keys its host copy: one device read per mask, none at the syncs
_HOST_MASKS = WeakIdKeyDictionary()


def host_mask(member: MemberState) -> HostMask:
    """``member`` read to the host, once per mask."""
    hm = _HOST_MASKS.get(member.active)
    if hm is None:
        hm = HostMask(
            keep=member.active.reshape(-1).cpu().numpy() > 0,
            n=float(member.n_active),
            n_pod=(member.n_pod.reshape(-1).cpu().numpy()
                   if isinstance(member.n_pod, torch.Tensor) else None))
        _HOST_MASKS[member.active] = hm
    return hm


def global_mask(mesh, active: torch.Tensor, where: np.ndarray,
                 n: int) -> np.ndarray:
    """The whole grid's (n,) fp32 mask from every rank's block (``where``:
    this rank's global indices): without a mesh the local one; on a mesh
    one zero-padded all-reduce counted "membership"."""
    local = active.reshape(-1).to(torch.float32)
    if mesh is None:
        return local.cpu().numpy()
    full = torch.zeros(n, dtype=torch.float32, device=coll.wire_device(mesh))
    full[torch.from_numpy(where)] = local.to(full.device)
    mesh.all_reduce(full, kind="membership")
    return full.cpu().numpy()


def _new_mask(active: Any, shape: tuple) -> np.ndarray:
    """The mask ``set_membership`` was given, (n,) fp32 over the whole
    grid (pod-major for the hierarchy), or a ValueError."""
    m = np.asarray(active, np.float32)
    if m.size != int(np.prod(shape)):
        raise ValueError(f"set_membership: a mask of {m.size} entries for "
                         f"a worker grid of {shape}")
    return m.reshape(-1)


def _rows_sum(buf: torch.Tensor, rows, mesh=None, axes=coll.AXES,
              kind: str = "membership") -> torch.Tensor:
    """Σ over the leading dim's ``rows`` of ``buf`` in fp32, one row after
    another (no row outside ``rows`` is read), and on a mesh over the
    ranks of ``axes`` (one all-reduce counted ``kind``)."""
    s = torch.zeros(buf.shape[1:], dtype=torch.float32, device=buf.device)
    for i in rows:
        s.add_(buf[i])
    if mesh is not None:
        mesh.all_reduce(s, axes, kind=kind)
    return s


def _zero_rows(tree: Any, rows, ndim: int) -> None:
    """Zero, in place, the workers ``rows`` (flattened indices: pod-major
    over the hierarchy's (P, D)) of every tensor leaf of ``tree`` that has
    the worker-stacked rank ``ndim`` (moments, SM3 stats, residuals;
    Adam's count is left as it is)."""
    for _, x in tree_mod.state_leaves(tree):
        if isinstance(x, torch.Tensor) and x.dim() == ndim:
            xr = x.view(-1, *x.shape[-2:])
            for i in rows:
                xr[i].zero_()


def _fold_scal(pend_k: torch.Tensor, km, lr: float) -> torch.Tensor:
    """The fold kernels' (n, 2) fp32 [1/(pend_k·γ), km] per participant
    from the (n, 1) pend_k column, km copied to the device (zeros made
    there without a deadline)."""
    inv = torch.reciprocal(pend_k * lr)
    kmt = (torch.zeros_like(inv) if not km.any() else
           torch.from_numpy(km).to(inv.device))
    return torch.cat([inv, kmt], dim=1)


def _stretch(pend_k: torch.Tensor, km, k_eff: int) -> None:
    """pend_k' = km·(pend_k + k_eff) + (1 − km)·k_eff in place: a missed
    capture keeps pend and stretches the period it covers (exact: small
    integers in fp32).  Without a miss, the fill of the no-deadline
    program."""
    if not km.any():
        pend_k.fill_(float(k_eff))
        return
    kmt = torch.from_numpy(km).to(pend_k.device).view(pend_k.shape)
    pend_k.copy_(kmt * (pend_k + k_eff) + (1.0 - kmt) * k_eff)


def _park(pend, resid, dec, xbar, km) -> None:
    """The compressed capture under a deadline, in place: sent = x̂_stale +
    dec (written over dec), pend' = km·pend + (1 − km)·sent, resid' =
    resid + km·dec (a missed worker never transmitted its payload, so it
    returns to its residual).  ``pend``, ``resid``, ``dec``: (n, R, C);
    ``km``: (n, 1) numpy.  Every product is by 0 or 1, so each output is
    rounded once, as the reference's expressions are."""
    kmt = torch.from_numpy(km).to(dec.device).view(-1, 1, 1)
    if isinstance(resid, torch.Tensor):
        resid.addcmul_(dec, kmt)
    dec.add_(xbar)
    pend.mul_(kmt).addcmul_(dec, 1.0 - kmt)


def _reanchor_ref1(ref1: torch.Tensor, glob: torch.Tensor) -> None:
    """After a level-2 sync every worker holds x̂: ref1 ← x̂ in every pod,
    so the next intra-pod payload is small again."""
    ref1.copy_(glob.expand_as(ref1))


def _shift_ref1(ref1: torch.Tensor, glob: torch.Tensor,
                pend: torch.Tensor) -> None:
    """The level-2 fold moves pod p by c_p = x̂_stale − pend_p: ref1 moves
    with it (ref1 + c_p, rounded as the reference rounds it)."""
    ref1.add_(glob - pend)


def _round_grads(grads_k: Any) -> list:
    """A round's gradients, one entry per step: the (k, ...) buffer's
    slices, or the tree with (k, ...) leaves cut per step."""
    if isinstance(grads_k, torch.Tensor):
        return list(grads_k)
    k = tree_mod.leaves(grads_k)[0].shape[0]
    return [tree_mod.tree_map(lambda x, i=i: x[i], grads_k)
            for i in range(k)]


_ADAM_B1, _ADAM_B2 = opt_mod.ADAM_B1, opt_mod.ADAM_B2
_MOMENT_DTYPES = ("float32", "bfloat16")


def _moment_opts(cfg: VRLConfig, kind: str) -> Tuple[torch.dtype, bool]:
    """(moment storage dtype, SM3 active).  The kernels compute fp32
    in-register; ``moment_dtype`` only picks what persists between steps.
    SM3 factors Adam's second moment only, so it is inert for sgd and
    momentum, as in the reference."""
    name = cfg.moment_dtype
    if name not in _MOMENT_DTYPES:
        raise ValueError(f"unknown moment_dtype {name!r}; known: "
                         f"{_MOMENT_DTYPES}")
    return flat.dtype_of(name), bool(cfg.sm3) and kind == "adam"


def _adam_state(shape, shards: int, mdt, sm3: bool,
                device) -> opt_mod.AdamState:
    """Adam's zero state over worker buffers of ``shape`` (W, R, C) or (P,
    D, R, C): a dense nu, or SM3's fp32 row stat (..., R, 1) and lane stat
    (..., S, C), one lane row per shard span (~R·C/(R + S·C) times
    smaller)."""
    def zeros(sh, dtype):
        return torch.zeros(sh, dtype=dtype, device=device)
    *lead, rows, lanes = shape
    nu = (opt_mod.SM3Pair(row=zeros((*lead, rows, 1), torch.float32),
                          col=zeros((*lead, shards, lanes), torch.float32))
          if sm3 else zeros(shape, mdt))
    return opt_mod.AdamState(zeros(shape, mdt), nu, 0)


def _adam_local(vu_dense: Callable, vu_sm3: Callable, inner, p, g, corr,
                kw) -> opt_mod.AdamState:
    """One Adam local step through the dense or the SM3 kernel; ``corr``:
    the corrections before the moments ((Δ,) flat, (Δ1, Δ2) hier).  The
    bias corrections are made on the device.  Returns the new state."""
    count = inner.count + 1
    scal = opt_mod.adam_scal(count, p.device, _ADAM_B1, _ADAM_B2)
    if isinstance(inner.nu, opt_mod.SM3Pair):
        _, _, _, col = vu_sm3(p, g, *corr, inner.mu, inner.nu.row,
                              inner.nu.col, scal, **kw)
        return opt_mod.AdamState(inner.mu, inner.nu._replace(col=col),
                                 count)
    vu_dense(p, g, *corr, inner.mu, inner.nu, scal, **kw)
    return inner._replace(count=count)


# ======================================================== reference executor
# Per-leaf tree math: the reference's oracle path (``repro.core.engine``
# ``ref_*``), op for op.  Functional: every call returns new trees and
# leaves its input state as it was; unchanged trees are shared.  A synced
# parameter leaf is x̂ broadcast over the worker axes — a view, as
# ``torch.broadcast_to`` makes it, not W copies.

def _bcast(tree: Any, w: int) -> Any:
    """Every leaf copied onto a new leading worker axis of size ``w``."""
    return tree_mod.tree_map(
        lambda x: x.expand(w, *x.shape).clone(
            memory_format=torch.contiguous_format), tree)


def worker_mean(tree: Any) -> Any:
    return tree_mod.tree_map(lambda x: x.mean(dim=0, keepdim=True), tree)


def average_model(state: WorkerState) -> Any:
    """x̂ — the evaluation model (paper reports metrics on the average)."""
    return tree_mod.tree_map(lambda x: x.mean(dim=0), state.params)


def _none_tree(tree: Any) -> Any:
    return tree_mod.tree_map(lambda x: None, tree)


def _ref_payload(x: torch.Tensor, ref: Optional[torch.Tensor],
                 resid: Optional[torch.Tensor]) -> torch.Tensor:
    """One leaf's compression payload: x − ref + resid in fp32 (``ref``,
    ``resid`` optional; ref broadcasts against the worker axes)."""
    p = x.to(torch.float32)
    if ref is not None:
        p = p - ref
    if resid is not None:
        p = p + resid
    return p


def _leaf_rt(comp: comm_mod.CompressorSpec, tree_x: Any, ref: Any,
             resid: Any, n_lead: int, reduce: Callable) -> Tuple[Any, Any]:
    """The per-leaf EF round trip of a sync (or S-SGD's gradient) payload
    and its mean: per leaf, payload = x − ref + resid, (dec, resid') =
    ``ef_leaf`` of it, then ``reduce(ref, dec)`` (the new shared value).
    ``ref`` / ``resid``: trees or None.  Leaf by leaf, so neither the
    payload nor dec outlives its leaf.  Returns (reduced tree, resid'
    tree)."""
    def one(x, r, e):
        dec, res = comm_mod.ef_leaf(comp, _ref_payload(x, r, e), n_lead)
        return reduce(r, dec), res

    pairs = tree_mod.tree_map(
        one, tree_x, _none_tree(tree_x) if ref is None else ref,
        _none_tree(tree_x) if resid is None else resid)
    return tree_mod.pick(pairs, 0), tree_mod.pick(pairs, 1)


def _kg(k_eff: int, lr: float, like: Any) -> torch.Tensor:
    """k_eff·γ as the reference forms it: k_eff an fp32 device value times
    the Python float γ (an fp32 product), on the state's device so that
    dividing by it is IEEE division."""
    dev = tree_mod.leaves(like)[0].device
    return torch.full((), float(max(k_eff, 1)), dtype=torch.float32,
                      device=dev) * lr


def _to_xbar(x: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """A parameter leaf after a sync: x̂ broadcast to x's shape (a view)."""
    return torch.broadcast_to(xb, x.shape).to(x.dtype)


def ref_init(spec: AlgoSpec, cfg: VRLConfig, params: Any,
             num_workers: int) -> WorkerState:
    stacked = _bcast(params, num_workers)
    delta_dt = flat.dtype_of(cfg.delta_dtype)
    delta = tree_mod.tree_map(
        lambda x: torch.zeros_like(x, dtype=delta_dt), stacked)
    inner = opt_mod.make_inner(cfg).init(stacked)
    center = (tree_mod.tree_map(lambda x: x[0].to(torch.float32, copy=True),
                                stacked) if spec.has_center else None)
    bias = (tree_mod.tree_map(lambda x: torch.zeros_like(x, dtype=delta_dt),
                              stacked) if use_bias(spec, cfg) else None)
    comp, _ = comm_mod.resolve_pair(cfg)
    comm = ()
    if comp is not None:
        # fp32 residuals keep the EF invariant exact; ref is the shared
        # post-sync value (init: the broadcast params), () for S-SGD's
        # gradient compression
        resid = (tree_mod.tree_map(
            lambda x: torch.zeros_like(x, dtype=torch.float32), stacked)
            if comp.error_feedback else ())
        ref = (() if (spec.grad_all_reduce or spec.sync == "none")
               else tree_mod.tree_map(
                   lambda x: x.to(torch.float32, copy=True), params))
        comm = CommState(resid=resid, ref=ref)
    return WorkerState(params=stacked, delta=delta, inner=inner,
                       center=center, step=0, last_sync=0, bias=bias,
                       comm=comm)


def corrected_grads(state: WorkerState, grads: Any) -> Any:
    """v_i = g_i − Δ_i  (eq. 6)."""
    return tree_mod.tree_map(lambda g, d: g - d.to(g.dtype), grads,
                             state.delta)


def ref_local_step(spec: AlgoSpec, cfg: VRLConfig, state: WorkerState,
                   grads: Any) -> WorkerState:
    opt = opt_mod.make_inner(cfg)
    if spec.grad_all_reduce:
        # S-SGD's "local" step IS a train step: that's the point of the paper
        comp, _ = comm_mod.resolve_pair(cfg)
        new_comm = state.comm
        if comp is not None:
            # the gradient IS the communicated payload: compress it (ref ≡ 0)
            e = state.comm.resid if comp.error_feedback else None
            gbar, res = _leaf_rt(comp, grads, None, e, 1,
                                 lambda r, d: d.mean(dim=0, keepdim=True))
            if comp.error_feedback:
                new_comm = state.comm._replace(resid=res)
        else:
            gbar = worker_mean(grads)
        gbar = tree_mod.tree_map(lambda g, x: torch.broadcast_to(g, x.shape),
                                 gbar, state.params)
        new_params, new_inner = opt.update(state.params, gbar, state.inner)
        return state._replace(params=new_params, inner=new_inner,
                              step=state.step + 1, last_sync=state.step + 1,
                              comm=new_comm)
    v = corrected_grads(state, grads) if spec.use_delta else grads
    if use_bias(spec, cfg):
        v = tree_mod.tree_map(lambda g, b: g - b.to(g.dtype), v, state.bias)
    new_params, new_inner = opt.update(state.params, v, state.inner)
    return state._replace(params=new_params, inner=new_inner,
                          step=state.step + 1)


def ref_sync(spec: AlgoSpec, cfg: VRLConfig, state: WorkerState
             ) -> WorkerState:
    if spec.sync == "none":
        return state._replace(last_sync=state.step)

    # compressed sync: transmit each worker's drift against the shared ref,
    # average the decompressed drifts (mean_i x_i = ref + mean_i(x_i − ref))
    comp, _ = comm_mod.resolve_pair(cfg)
    new_comm = state.comm
    xbar = None
    if comp is not None:
        e = state.comm.resid if comp.error_feedback else None
        ref_new, res = _leaf_rt(comp, state.params, state.comm.ref, e, 1,
                                lambda r, d: r + d.mean(dim=0))
        xbar = tree_mod.tree_map(lambda x: x[None], ref_new)
        new_comm = CommState(resid=(res if comp.error_feedback else ()),
                             ref=ref_new)

    if spec.sync == "elastic":
        # Zhang et al. parameterise elasticity as beta/N (beta =
        # easgd_alpha); a and n·a are Python doubles, rounded to fp32 where
        # they meet a tensor, as the reference's weak-typed scalars are
        n = tree_mod.leaves(state.params)[0].shape[0]
        a = cfg.easgd_alpha / n

        def upd_worker(x, c):
            x32 = x.to(torch.float32)
            return (x32 - a * (x32 - c)).to(x.dtype)

        if xbar is None:
            def upd_center(c, x):
                xb = x.to(torch.float32).mean(dim=0)
                return (1.0 - n * a) * c + n * a * xb

            new_center = tree_mod.tree_map(upd_center, state.center,
                                           state.params)
        else:
            new_center = tree_mod.tree_map(
                lambda c, xb: (1.0 - n * a) * c + n * a * xb[0],
                state.center, xbar)
        new_params = tree_mod.tree_map(upd_worker, state.params,
                                       state.center)
        return state._replace(params=new_params, center=new_center,
                              last_sync=state.step, comm=new_comm)

    if xbar is None:
        xbar = worker_mean(state.params)                # the all-reduce
    new_params = tree_mod.tree_map(_to_xbar, state.params, xbar)
    if spec.sync == "average":
        return state._replace(params=new_params, last_sync=state.step,
                              comm=new_comm)

    # "vrl"/"bvr": Δ_i ← Δ_i + u_i, u_i = (x̂ − x_i)/(k_eff γ)  (eq. 4)
    kg = _kg(state.step - state.last_sync, cfg.learning_rate, state.params)

    def drift(x, xb):
        return (xb.to(torch.float32) - x.to(torch.float32)) / kg

    def upd_delta(d, x, xb):
        return (d.to(torch.float32) + drift(x, xb)).to(d.dtype)

    new_delta = tree_mod.tree_map(upd_delta, state.delta, state.params, xbar)
    new_bias = state.bias
    if spec.sync == "bvr" and use_bias(spec, cfg):
        # B_i ← (1−β)·B_i + β·u_i — the bias-variate EMA of realised drift
        beta = cfg.bvr_beta

        def upd_bias(b, x, xb):
            return ((1.0 - beta) * b.to(torch.float32)
                    + beta * drift(x, xb)).to(b.dtype)

        new_bias = tree_mod.tree_map(upd_bias, state.bias, state.params,
                                     xbar)
    return state._replace(params=new_params, delta=new_delta,
                          bias=new_bias, last_sync=state.step,
                          comm=new_comm)


def ref_train_step(spec: AlgoSpec, cfg: VRLConfig, state: WorkerState,
                   grads: Any) -> WorkerState:
    state = ref_local_step(spec, cfg, state, grads)
    if spec.sync == "none":
        return state
    if should_sync(spec, cfg, state.step, state.last_sync):
        return ref_sync(spec, cfg, state)
    return state


# ---------------------------------------------- reference executor ("vrl2")
# The two-level rule over a pod-major (P, D, ...) tree state
# (``core/hierarchical.py`` is a thin wrapper over these).

def ref_hier_init(cfg: VRLConfig, params: Any,
                  grid: Tuple[int, int]) -> HierState:
    p, d = grid

    def per_pod(x, fill):
        return (fill(x).expand(p, 1, *x.shape)
                .clone(memory_format=torch.contiguous_format))

    stacked = tree_mod.tree_map(
        lambda x: x.expand(p, d, *x.shape).clone(
            memory_format=torch.contiguous_format), params)
    dt = flat.dtype_of(cfg.delta_dtype)
    d2 = tree_mod.tree_map(
        lambda x: torch.zeros((p, 1, *x.shape[2:]), dtype=dt,
                              device=x.device), stacked)
    inner = opt_mod.make_inner(cfg).init(stacked)
    comp1, comp2 = comm_mod.resolve_pair(cfg)
    comm = ()
    if comp1 is not None or comp2 is not None:
        comm = HierCommState(
            resid1=(tree_mod.tree_map(
                lambda x: torch.zeros_like(x, dtype=torch.float32), stacked)
                if comp1 and comp1.error_feedback else ()),
            ref1=(tree_mod.tree_map(
                lambda x: per_pod(x, lambda y: y.to(torch.float32)), params)
                if comp1 else ()),
            resid2=(tree_mod.tree_map(
                lambda x: per_pod(x, lambda y: torch.zeros_like(
                    y, dtype=torch.float32)), params)
                if comp2 and comp2.error_feedback else ()),
            ref2=(tree_mod.tree_map(
                lambda x: x.to(torch.float32, copy=True), params)
                if comp2 else ()))
    return HierState(params=stacked,
                     delta1=tree_mod.tree_map(
                         lambda x: torch.zeros_like(x, dtype=dt), stacked),
                     delta2=d2, inner=inner, step=0, last_sync1=0,
                     last_sync2=0, comm=comm)


def ref_hier_local_step(cfg: VRLConfig, state: HierState,
                        grads: Any) -> HierState:
    """x ← inner_opt(x, g − Δ1 − Δ2): zero cross-worker communication."""
    v = tree_mod.tree_map(
        lambda g, d1, d2: g - d1.to(g.dtype) - d2.to(g.dtype),
        grads, state.delta1, state.delta2)
    new_params, new_inner = opt_mod.make_inner(cfg).update(
        state.params, v, state.inner)
    return state._replace(params=new_params, inner=new_inner,
                          step=state.step + 1)


def ref_hier_sync1(cfg: VRLConfig, state: HierState) -> HierState:
    """Intra-pod sync: mean over axis 1 (the pod-internal worker axis)."""
    kg = _kg(state.step - state.last_sync1, cfg.learning_rate, state.params)
    comp1, _ = comm_mod.resolve_pair(cfg)
    new_comm = state.comm
    if comp1 is not None:
        e = state.comm.resid1 if comp1.error_feedback else None
        xbar, res = _leaf_rt(comp1, state.params, state.comm.ref1, e, 2,
                             lambda r, d: r + d.mean(dim=1, keepdim=True))
        new_comm = state.comm._replace(
            ref1=xbar, resid1=(res if comp1.error_feedback else ()))
    else:
        xbar = tree_mod.tree_map(lambda x: x.mean(dim=1, keepdim=True),
                                 state.params)

    def upd(d, x, xb):
        return (d.to(torch.float32)
                + (xb.to(torch.float32) - x.to(torch.float32)) / kg
                ).to(d.dtype)

    new_d1 = tree_mod.tree_map(upd, state.delta1, state.params, xbar)
    new_p = tree_mod.tree_map(_to_xbar, state.params, xbar)
    return state._replace(params=new_p, delta1=new_d1,
                          last_sync1=state.step, comm=new_comm)


def ref_hier_sync2(cfg: VRLConfig, state: HierState) -> HierState:
    """Cross-pod sync.  Assumes a level-1 sync at the same step (so every
    worker already holds its pod average)."""
    kg = _kg(state.step - state.last_sync2, cfg.learning_rate, state.params)
    comp1, comp2 = comm_mod.resolve_pair(cfg)
    new_comm = state.comm
    pod_avg = tree_mod.tree_map(lambda x: x.mean(dim=1, keepdim=True),
                                state.params)
    if comp2 is not None:
        e = state.comm.resid2 if comp2.error_feedback else None
        glob_sm, res = _leaf_rt(comp2, pod_avg, state.comm.ref2, e, 2,
                                lambda r, d: r + d.mean(dim=(0, 1)))
        glob = tree_mod.tree_map(lambda x: x[None, None], glob_sm)
        new_comm = new_comm._replace(
            ref2=glob_sm, resid2=(res if comp2.error_feedback else ()))
    else:
        glob = tree_mod.tree_map(
            lambda x: x.mean(dim=(0, 1), keepdim=True), state.params)
    if comp1 is not None:
        # level 2 just moved every worker to x̂: re-anchor the level-1
        # drift reference so the next intra-pod payload is small again
        new_comm = new_comm._replace(ref1=tree_mod.tree_map(
            lambda g, r1: torch.broadcast_to(g.to(torch.float32), r1.shape),
            glob, new_comm.ref1))

    def upd(d2, pa, g):
        return (d2.to(torch.float32)
                + (g.to(torch.float32) - pa.to(torch.float32)) / kg
                ).to(d2.dtype)

    new_d2 = tree_mod.tree_map(upd, state.delta2, pod_avg, glob)
    new_p = tree_mod.tree_map(_to_xbar, state.params, glob)
    return state._replace(params=new_p, delta2=new_d2,
                          last_sync2=state.step, comm=new_comm)


def ref_hier_train_step(cfg: VRLConfig, state: HierState, grads: Any, *,
                        k1: Optional[int] = None,
                        k2: Optional[int] = None) -> HierState:
    hcfg = hier_config(cfg)
    k1 = hcfg.k1 if k1 is None else k1
    k2 = hcfg.k2 if k2 is None else k2
    state = ref_hier_local_step(cfg, state, grads)
    do2 = (state.step - state.last_sync2) >= k2
    if do2 or (state.step - state.last_sync1) >= k1:
        state = ref_hier_sync1(cfg, state)
    return ref_hier_sync2(cfg, state) if do2 else state


def hier_average_model(state: HierState) -> Any:
    """x̂ — the evaluation model, averaged over the whole (P, D) grid."""
    return tree_mod.tree_map(lambda x: x.mean(dim=(0, 1)), state.params)


# ================================================================ diagnostics
# The engines' read-only health pass (the reference's ``_core_diagnostics``
# and ``_core_diag_hier``): plain PyTorch reductions between rounds, one
# worker's slice at a time, so that no temporary outgrows a worker's
# buffer.  On a mesh its sums over the workers and its scalars reach every
# rank through all-reduces counted "eval", never "state".

def _sq(x: torch.Tensor) -> torch.Tensor:
    """Σ x² in fp32 (a 0-d tensor)."""
    x = x.to(torch.float32)
    return torch.sum(x * x)


def _sq_rows(buf: torch.Tensor, live=None) -> torch.Tensor:
    """Σ x² over a worker-stacked buffer, one worker slice at a time (the
    flattened worker indices ``live`` only, when given)."""
    rows = buf.reshape(-1, *buf.shape[-2:])
    idx = range(rows.shape[0]) if live is None else live
    return sum((_sq(rows[i]) for i in idx),
               torch.zeros((), dtype=torch.float32, device=buf.device))


def _amax(x: torch.Tensor) -> torch.Tensor:
    """max|x| (0-d) without an |x| temporary."""
    return torch.linalg.vector_norm(x.to(torch.float32), float("inf"))


def _per_worker(p: torch.Tensor, xhat: torch.Tensor, rows, mesh,
                where: np.ndarray, n: int) -> torch.Tensor:
    """(2, workers) fp32: each worker's ‖x_i − x̂‖² and whether its
    parameters hold a non-finite value (the ``rows`` of the (…, R, C)
    buffer ``p``, flattened, read; the others 0).  On a mesh the whole
    grid's (``where``: this rank's global indices of its workers, ``n``
    the workers in all): one zero-padded all-reduce over the state's
    ranks ("eval"; not over the fsdp ranks, which hold replicas), which
    also sums a worker's rows over the shard ranks."""
    flat_p = p.reshape(-1, *p.shape[-2:])
    per = torch.zeros((2, flat_p.shape[0]), dtype=torch.float32,
                      device=p.device)
    for i in rows:
        per[0, i] = _sq(flat_p[i].to(torch.float32) - xhat)
        per[1, i] = (~torch.isfinite(flat_p[i])).any().to(torch.float32)
    if mesh is None:
        return per
    full = torch.zeros((2, n), dtype=torch.float32, device=p.device)
    full[:, torch.from_numpy(where)] = per
    mesh.all_reduce(full, mesh.state_axes, kind="eval")
    return full


def _global_scalars(mesh, sums: dict, maxes: dict) -> Tuple[dict, dict]:
    """This rank's partial sums and maxima -> every rank's: one "eval"
    all-reduce each (SUM, MAX); as they are without a mesh."""
    if mesh is None:
        return sums, maxes
    for vals, op in ((sums, None), (maxes, dist.ReduceOp.MAX)):
        if vals:
            v = torch.stack(list(vals.values()))
            mesh.all_reduce(v, mesh.state_axes, kind="eval", op=op)
            vals.update(zip(vals, v))
    return sums, maxes


def _moment_sums(kind: str, sm3: bool, inner: Any, sums: dict,
                 live=None) -> None:
    """The moments' Σ x² into ``sums`` ("mu"; Adam's "nu": dense, or SM3's
    row and lane stats together), over the workers ``live`` when given."""
    if kind == "sgd":
        return
    sums["mu"] = _sq_rows(inner if kind == "momentum" else inner.mu, live)
    if kind == "adam":
        if not sm3:
            sums["nu"] = _sq_rows(inner.nu, live)
        elif live is None:
            sums["nu"] = _sq(inner.nu.row) + _sq(inner.nu.col)
        else:
            sums["nu"] = (_sq_rows(inner.nu.row, live)
                          + _sq_rows(inner.nu.col, live))


def _moment_rms(kind: str, sm3: bool, fspec: flat.FlatSpec, n: float,
                sums: dict, out: dict) -> None:
    elems = float(fspec.rows * fspec.lanes)
    if kind != "sgd":
        out["mu_rms"] = torch.sqrt(sums["mu"] / (n * elems))
    if kind == "adam":
        cnt = (n * float(fspec.rows + fspec.shards * fspec.lanes) if sm3
               else n * elems)
        out["nu_rms"] = torch.sqrt(sums["nu"] / cnt)



# ============================================================ fused executor
class Engine(NamedTuple):
    """Bound flat-buffer-executor closures for one (algorithm, model) pair.

    Every callable taking ``grads`` accepts either a worker-stacked
    gradient tree or an already-flat (W, R, C) gradient buffer (the
    hierarchy: a grid-stacked tree or a (P, D, R, C) buffer).
    """

    algorithm: str
    spec: flat.FlatSpec
    algo: AlgoSpec
    init: Callable              # (params_tree, num_workers) -> state
    train_step: Callable        # (state, grads) -> state
    local_step: Callable        # (state, grads) -> state
    sync: Callable              # (state, out=None) -> state (hier: sync2
                                # after sync1)
    average_model: Callable     # (state,) -> single-model tree
    params_tree: Callable       # (state,) -> worker-stacked params tree
                                # (views; hier: grid-stacked)
    round_step: Callable        # (state, grads_k) -> state: k local steps + sync
    round_end: Callable         # (state, out=None) -> state: the
                                # round-closing sync
    round_step_flat: Callable   # (state, gk) -> state over (k, W, R, C) grads
    sync_due: Callable          # (state,) -> bool: after a local step, the
                                # per-step cadence has a sync due
    step_sync: Callable         # (state, out=None) -> state: that sync
                                # (train_step's second half)
    round_begin: Any = None     # overlap only: (state, k) -> x̂_stale, the
                                # round-START mean over pend (hier: None
                                # when the round of k steps ends off the
                                # k2 cadence); None when overlap is off
                                # (callers dispatch on that)
    round_fold: Any = None      # overlap only: (state, x̂_stale, out=None)
                                # -> state, the round-END stale fold and
                                # capture (hier: after the blocking sync1)
    compressors: Any = (None, None)  # resolved (level-1, level-2) specs
    misses: Any = None          # overlap only: (step, n) -> the (n, 1) numpy
                                # deadline-miss mask of the fold ending at
                                # step (workers; hier: pods)
    sync1: Any = None           # hier only: (state, out=None) -> state,
                                # intra-pod
    sync2: Any = None           # hier only: (state, out=None) -> state,
                                # cross-pod
    grid: Any = None            # hier only: (P, D)
    diagnostics: Any = None     # (state,) -> {name: 0-d tensor, and the
                                # flat engine's (W,) drift_per_worker}: the
                                # read-only health pass (obs.diagnostics)
    set_membership: Any = None  # membership only: (state, mask) -> state,
                                # the invariant-preserving repair for a
                                # changed active set ((W,) or (P, D) over
                                # the whole grid); between rounds.  None
                                # when cfg.membership is off
    recenter_drift: Any = None  # flat only: (state,) -> state, Σ Δ (Σ B)
                                # re-zeroed over the (active) rows in the
                                # buffers — after a strict-subset client
                                # cohort's gather, before its round
    all_active: Any = None      # (member,) -> bool: no MemberState, or
                                # every worker active (the plain means
                                # apply); host-side, no device read
    gather_params: Any = None   # (state, kind="forward") -> the params
                                # buffer with every row: on a row-sharded
                                # mesh gathered over the shard group (a
                                # new buffer), else state.params
    own_rows: Any = None        # (buf,) -> this rank's rows of a full
                                # (..., R, C) buffer, a view (contiguous
                                # with one worker a rank); None off a
                                # row-sharded mesh


def make_engine(cfg: VRLConfig, template: Any, *,
                device: Optional[torch.device] = None,
                mesh=None) -> Engine:
    """Build the flat-buffer engine for ``cfg.algorithm`` over ``template``
    (a single-model tree of meta tensors, tensors or ``(shape, dtype)``
    pairs).  ``device`` places the state; default: where ``init``'s
    parameters lie.

    ``mesh``: a ``comm.collectives.WorkerMesh``.  The flat algorithms
    spread their W workers over every rank of its (pod, data) rank grid
    (the reference's ``worker_axes=("pod", "data")``, as its
    ``--mesh-grid`` passes), the hierarchy its (P, D) grid over the same
    axes; ``init`` returns this rank's block and every worker mean is a
    counted all-reduce (even on one rank).  Without a mesh nothing is
    communicated."""
    algo = get_spec(cfg.algorithm)
    shards = _row_shards(cfg, mesh)
    ecfg = cfg.engine
    fspec = flat.make_spec(template, lanes=ecfg.lanes, block=ecfg.block,
                           max_waste=ecfg.max_pad_waste, shards=ecfg.shards)
    kind, beta = opt_mod.inner_kind(cfg)
    mdt, sm3 = _moment_opts(cfg, kind)
    lr, wd = cfg.learning_rate, cfg.weight_decay
    delta_dt = flat.dtype_of(cfg.delta_dtype)
    bias_on = use_bias(algo, cfg)
    # the flat algorithms ignore level 2, as the reference's do; the pair
    # stays canonical, so pair_meta(engine.compressors) == pair_meta(cfg)
    comp, comp2 = comm_mod.resolve_pair(cfg)
    _validate_membership(cfg, algo)
    _validate_fsdp(cfg, algo, mesh)
    if algo.sync == "vrl2":
        _validate_overlap(cfg, algo, comp2)
        return _make_hier_engine(cfg, algo, fspec, lr=lr, wd=wd,
                                 delta_dt=delta_dt, device=device,
                                 kind=kind, beta=beta, mdt=mdt, sm3=sm3,
                                 mesh=mesh, shards=shards)
    _validate_overlap(cfg, algo, comp)
    world = 1 if mesh is None else mesh.size()
    # the reference folds the axis indices in only where the worker axes
    # span more than one device
    misses = _misses(cfg, mesh.index() if world > 1 else ())
    ef_rt = None if comp is None else _ef_op(comp, fspec.lanes)
    ef_on = comp is not None and comp.error_feedback

    def all_active(member: Any) -> bool:
        """No ``MemberState``, or one with every worker of the grid
        active (its host copy: no device read at a sync)."""
        if not _masked(member):
            return True
        hm = host_mask(member)
        return hm.n == hm.keep.size * world

    def _wmean(buf: torch.Tensor, kind: str = "state",
               async_op: bool = False, member: Any = ()):
        """Worker mean of a (W, R, C) buffer -> (R, C): on one device a
        reduction over dim 0; on a mesh the local sum, one all-reduce
        (counted under ``kind``) and ÷ W.  With a ``MemberState`` that
        leaves a worker out, the mean over the active workers, × 1 / the
        state's count."""
        if not all_active(member):
            return coll.worker_mean(mesh, buf, 0, coll.AXES, kind=kind,
                                    async_op=async_op,
                                    keep=host_mask(member).keep,
                                    count=member.n_active)
        return coll.worker_mean(mesh, buf, 0, coll.AXES, kind=kind,
                                async_op=async_op)

    def _gbuf(grads: Any) -> torch.Tensor:
        """A gradient buffer shaped like ``state.params`` (this rank's rows)
        as it comes, or a tree of every row -> this rank's rows."""
        if isinstance(grads, torch.Tensor):
            return grads
        return shards.own(flat.flatten_stacked(
            fspec, grads, dtype=flat.dtype_of(fspec.dtype)),
            fspec.rows).contiguous()

    def init(params: Any, num_workers: int) -> FlatWorkerState:
        """The state of ``num_workers`` workers from ``params`` (on a mesh:
        this rank's block of W / world of them; every rank passes the same
        params)."""
        if num_workers % world:
            raise ValueError(f"{num_workers} workers do not split over the "
                             f"mesh's {world} ranks")
        num_workers //= world
        flat1 = flat.flatten_tree(fspec, params)
        if device is not None:
            flat1 = flat1.to(device)
        flat1 = shards.own(flat1, fspec.rows)
        stacked = flat1.unsqueeze(0).repeat(num_workers, 1, 1)

        def zeros(dtype):
            return torch.zeros(stacked.shape, dtype=dtype,
                               device=stacked.device)
        if kind == "sgd":
            inner = ()
        elif kind == "momentum":
            inner = zeros(mdt)
        else:
            inner = _adam_state(stacked.shape, fspec.shards // shards.count,
                                mdt, sm3, stacked.device)
        comm = ()
        if comp is not None:
            # fp32 residuals keep the EF invariant exact; ref is the shared
            # post-sync value, () for S-SGD's gradient compression
            ref = (() if (algo.grad_all_reduce or algo.sync == "none")
                   else flat1.to(torch.float32, copy=True))
            comm = CommState(resid=zeros(torch.float32) if ef_on else (),
                             ref=ref)
        overlap = ()
        if cfg.overlap:
            # pend = the initial broadcast position (everyone "transmitted"
            # x0 before step 0), so the first fold's correction is exactly
            # zero; pend_k = 1 keeps its Δ scale finite
            overlap = OverlapState(
                pend=stacked.to(torch.float32, copy=True),
                pend_k=torch.ones((num_workers, 1, 1), dtype=torch.float32,
                                  device=stacked.device))
        member = ()
        if cfg.membership:
            # everyone starts active; the count rides in the state, so the
            # masked means never need a second collective
            member = MemberState(
                active=torch.ones((num_workers, 1, 1), dtype=torch.float32,
                                  device=stacked.device),
                n_active=torch.tensor(float(num_workers * world),
                                      dtype=torch.float32,
                                      device=stacked.device))
        return FlatWorkerState(
            params=stacked, delta=zeros(delta_dt) if algo.use_delta else (),
            step=0, last_sync=0, inner=inner,
            center=(flat1.to(torch.float32, copy=True) if algo.has_center
                    else ()),
            bias=zeros(delta_dt) if bias_on else (), comm=comm,
            overlap=overlap, member=member)

    def local_step(state: FlatWorkerState, grads: Any) -> FlatWorkerState:
        """One local step.  S-SGD first overwrites the (W, R, C) gradient
        buffer with its worker mean, in place (no second W× buffer); under
        compression the gradient is the payload (ref ≡ 0), its EF round
        trip written over the buffer before the mean."""
        g = _gbuf(grads)
        if algo.grad_all_reduce:
            e = state.comm.resid if ef_on else None
            if comp is not None and g.dtype != torch.float32:
                # bf16 gradients: the decompressed payload is fp32, and so
                # is the mean the local step takes (as in the reference)
                dec, _ = ef_rt(g, None, e)
                g = _wmean(dec, member=state.member).unsqueeze(0).expand_as(
                    dec).contiguous()
            else:
                if comp is not None:
                    ef_rt(g, None, e, out=g)
                g.copy_(_wmean(g, member=state.member).unsqueeze(0)
                        .expand_as(g))
        p = state.params
        d = state.delta if algo.use_delta else None
        b = state.bias if bias_on else None
        inner = state.inner
        if kind == "sgd":
            vu.fused_local_sgd(p, g, d, b=b, lr=lr, wd=wd, block=fspec.block)
        elif kind == "momentum":
            vu.fused_local_momentum(p, g, d, inner, b=b, lr=lr, beta=beta,
                                    wd=wd, block=fspec.block)
        else:
            inner = _adam_local(vu.fused_local_adam, vu.fused_local_adam_sm3,
                                inner, p, g, (d,),
                                dict(b=b, lr=lr, b1=_ADAM_B1, b2=_ADAM_B2,
                                     wd=wd, block=fspec.block))
        out = state._replace(inner=inner, step=state.step + 1)
        if algo.grad_all_reduce:
            out = out._replace(last_sync=state.step + 1)
        return out

    def comp_mean(state: FlatWorkerState, out: Optional[torch.Tensor]):
        """The compressed worker mean: one EF round trip over the drift
        (payload = p − ref + resid → dec, resid' in place), then the mean
        of the decompressed drift.  ref is shared by every worker, so
        x̂ = ref + mean_i(dec_i) reconstructs mean_i(p_i) up to the
        compression error; x̂ becomes the next ref.  dec goes into ``out``
        when given, else into a new (W, R, C) buffer."""
        cm = state.comm
        dec, _ = ef_rt(state.params, cm.ref, cm.resid if ef_on else None,
                       out=out)
        xbar = cm.ref + _wmean(dec, member=state.member)
        return xbar, state._replace(comm=cm._replace(ref=xbar))

    def sync(state: FlatWorkerState,
             out: Optional[torch.Tensor] = None) -> FlatWorkerState:
        """The round-closing sync.  ``out``: a dead (W, R, C) fp32 buffer
        (the last step's gradients) that a compressed sync may write its
        decompressed payload over; its pad lanes stay zero, since the
        payload's do."""
        p = state.params
        if algo.sync == "none":
            return state._replace(last_sync=state.step)
        if algo.sync == "elastic":
            n = p.shape[0] * world
            a = cfg.easgd_alpha / n
            # x̂ of the PRE-sync parameters, before the worker pass
            if comp is not None:
                xbar, state = comp_mean(state, out)
            else:
                xbar = _wmean(p.to(torch.float32))
            vu.fused_sync_easgd(p, xbar, state.center, a=a, na=n * a,
                                block=fspec.block)
            return state._replace(last_sync=state.step)
        if comp is not None:
            xbar, state = comp_mean(state, out)
        else:
            xbar = _wmean(p, member=state.member)
        if algo.sync == "average":
            p.copy_(xbar.unsqueeze(0).expand_as(p))
            return state._replace(last_sync=state.step)
        # "vrl"/"bvr": k_eff·γ as an fp32 product made on the device — no
        # host round trip
        k_eff = max(state.step - state.last_sync, 1)
        scal = torch.full((1, 1), float(k_eff), dtype=torch.float32,
                          device=p.device) * lr
        if algo.sync == "bvr" and bias_on:
            vu.fused_sync_bvr(p, xbar.to(p.dtype), state.delta, state.bias,
                              scal, beta=cfg.bvr_beta, block=fspec.block)
        else:
            vu.fused_sync_vrl(p, xbar.to(p.dtype), state.delta, scal,
                              block=fspec.block)
        return state._replace(last_sync=state.step)

    def sync_due(state: FlatWorkerState) -> bool:
        return algo.sync != "none" and should_sync(algo, cfg, state.step,
                                                   state.last_sync)

    def train_step(state: FlatWorkerState, grads: Any) -> FlatWorkerState:
        state = local_step(state, grads)
        return sync(state) if sync_due(state) else state

    def round_begin(state: FlatWorkerState, k: int = 0) -> torch.Tensor:
        """The overlapped round's START: the worker mean of the positions
        transmitted at the previous boundary (its operands are ready before
        the round's local steps, so on a mesh its all-reduce is issued
        asynchronously and runs while they do: the result is then a pending
        mean that ``round_fold`` waits for).  ``k`` (the round's length) is
        unused here; the hierarchy's twin needs it for the k2 cadence."""
        del k
        # masked: a dead worker's pend is retired from the mean until it
        # rejoins with a fresh one
        return _wmean(state.overlap.pend, async_op=True, member=state.member)

    def round_fold(state: FlatWorkerState, xbar: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> FlatWorkerState:
        """The overlapped round's END: fold c = x̂_stale − pend into the
        parameters, Δ (and B), then capture the new positions for the next
        round's mean — in the fold kernel, or, under compression, as the
        transmitted position x̂_stale + dec of the EF round trip of the
        folded parameters' drift against x̂_stale.  A worker that misses
        its deadline keeps its pend (and parks dec in its residual).
        ``out``: a dead (W, R, C) fp32 buffer for dec under a deadline."""
        xbar = coll.resolve(xbar)
        ov = state.overlap
        p = state.params
        k_eff = max(state.step - state.last_sync, 1)
        km = misses(state.step, p.shape[0])                    # (W, 1)
        wscal = _fold_scal(ov.pend_k[:, :, 0], km, lr)
        capture = comp is None
        xb = xbar.to(p.dtype)
        if algo.sync == "average":
            vu.fused_fold_overlap_avg(p, xb, ov.pend, wscal, capture=capture,
                                      block=fspec.block)
        elif algo.sync == "bvr" and bias_on:
            vu.fused_fold_overlap_bvr(p, xb, ov.pend, state.delta,
                                      state.bias, wscal, beta=cfg.bvr_beta,
                                      capture=capture, block=fspec.block)
        else:
            vu.fused_fold_overlap(p, xb, ov.pend, state.delta, wscal,
                                  capture=capture, block=fspec.block)
        resid = state.comm.resid if ef_on else None
        if comp is not None and not km.any():
            # pend is dead once the fold has read it: the round trip writes
            # dec there and pend' = x̂_stale + dec is finished in place
            ef_rt(p, xbar, resid, out=ov.pend)
            ov.pend.add_(xbar)
        elif comp is not None:
            dec, _ = ef_rt(p, xbar, resid, out=out)
            _park(ov.pend, resid, dec, xbar, km)
        if comp is not None:
            state = state._replace(comm=state.comm._replace(ref=xbar))
        _stretch(ov.pend_k, km, k_eff)
        return state._replace(last_sync=state.step)

    def round_step(state: FlatWorkerState, grads_k: Any) -> FlatWorkerState:
        """k local steps over a (k, W, R, C) grads buffer or a grads tree
        with (k, W, ...) leaves, closed by the round's sync (under overlap:
        opened by ``round_begin``, closed by ``round_fold``).  The round IS
        the communication period — the caller sizes it (warmup's first k=1
        period is a 1-step round, a CommSchedule sizes each round from its
        stage)."""
        steps = _round_grads(grads_k)
        xbar = round_begin(state) if cfg.overlap else None
        for g in steps:
            state = local_step(state, g)
        return sync(state) if xbar is None else round_fold(state, xbar)

    def gather_params(state: FlatWorkerState,
                      kind: str = "forward") -> torch.Tensor:
        """The (W, R, C) parameter buffer of this rank's workers: on a
        row-sharded mesh every shard rank's rows gathered into a new
        buffer (one all-gather, counted ``kind``), else ``state.params``
        itself."""
        return shards.gather(state.params, kind)

    def params_tree(state: FlatWorkerState) -> Any:
        """Worker-stacked parameter tree of views into ``state.params``
        (on a row-sharded mesh: into its gathered copy)."""
        return flat.unflatten_stacked(fspec, gather_params(state))

    def avg_model(state: FlatWorkerState) -> Any:
        """x̂ — the evaluation model (the paper reports metrics on it; on a
        mesh its all-reduce, and on a row-sharded one its rows' gather,
        count as "eval", outside the round)."""
        return flat.unflatten_tree(fspec, shards.gather(
            _wmean(state.params, "eval", member=state.member), "eval"))

    # this rank's workers' indices in the whole grid
    def _mine(w_l: int) -> np.ndarray:
        r = 0 if mesh is None else mesh.index(("data",))[0]
        return np.arange(r * w_l, (r + 1) * w_l)

    @torch.no_grad()
    def set_membership(state: FlatWorkerState, active) -> FlatWorkerState:
        """Change the active set to ``active`` ((W,) over the whole grid,
        bools or floats), repairing the invariants in place: continuing
        workers' Δ (and B) recentred to mean zero over the continuing set
        — the dropped workers' Δ redistributed over the survivors, computed
        without reading a dropped row — so Σ_i Δ_i = 0 exactly over the
        new active set; dropped and rejoining workers re-seeded from the
        continuing consensus x̂ (params and overlap pend; pend_k 1), their
        Δ, B, moments and EF residual zeroed.  The sums over the workers
        divide by the continuing count as a 0-d device tensor (a true
        division, as the reference's); on a mesh each is one all-reduce
        counted "membership".  Between rounds."""
        p = state.params
        w_l, dev = p.shape[0], p.device
        mine = _mine(w_l)
        new = _new_mask(active, (w_l * world,))
        cont = global_mask(mesh, state.member.active, mine,
                           w_l * world) * new
        keep = cont[mine] > 0
        live, dead = np.flatnonzero(keep), np.flatnonzero(~keep)
        n_cont = torch.tensor(max(float(cont.sum()), 1.0),
                              dtype=torch.float32, device=dev)
        xhat = _rows_sum(p, live, mesh).div_(n_cont)
        for i in dead:
            p[i].copy_(xhat)

        def recenter(buf):
            shift = _rows_sum(buf, live, mesh).div_(n_cont).to(buf.dtype)
            for i in live:
                buf[i].sub_(shift)
            for i in dead:
                buf[i].zero_()
        if algo.use_delta:
            recenter(state.delta)
        if bias_on:
            recenter(state.bias)
        _zero_rows(state.inner, dead, 3)
        if ef_on:
            _zero_rows(state.comm.resid, dead, 3)
        if cfg.overlap:
            for i in dead:
                state.overlap.pend[i].copy_(xhat)
                state.overlap.pend_k[i].fill_(1.0)
        return state._replace(member=MemberState(
            active=torch.from_numpy(new[mine].copy()).to(dev).view(-1, 1, 1),
            n_active=torch.tensor(float(new.sum()), dtype=torch.float32,
                                  device=dev)))

    @torch.no_grad()
    def recenter_drift(state: FlatWorkerState) -> FlatWorkerState:
        """Re-zero Σ Δ (and Σ B) over the rows in the buffers, in place.

        A client cohort gathers W of M client rows; each client's Δ was
        recentred against ALL clients, so the cohort's sum to the cohort
        mean rather than zero, and the sync would drag x̂ by it every
        round.  Subtracting the (active) cohort mean restores Σ Δ = 0;
        with a ``MemberState`` the mean is masked and a dead slot's row is
        left as it is.  On a mesh the mean is counted "membership"."""
        member = state.member
        live = (host_mask(member).live if _masked(member)
                else range(state.params.shape[0]))
        for buf in ((state.delta,) if algo.use_delta else ()) + (
                (state.bias,) if bias_on else ()):
            shift = _wmean(buf, "membership", member=member).to(buf.dtype)
            for i in live:
                buf[i].sub_(shift)
        return state

    # the record's keys, decided by the configuration (the reference's)
    diag_keys = ["params_rms", "drift_sq_mean", "drift_max",
                 "drift_per_worker", "nonfinite_workers"]
    if algo.use_delta:
        diag_keys += ["delta_residual", "zeta_sq_proxy"]
    if bias_on:
        diag_keys += ["bias_residual"]
    if ef_on:
        diag_keys += ["ef_resid_rms"]
    if kind != "sgd":
        diag_keys += ["mu_rms"]
    if kind == "adam":
        diag_keys += ["nu_rms"]

    @torch.no_grad()
    def diagnostics(state: FlatWorkerState) -> dict:
        """Algorithm-health figures in ONE read-only pass (the reference's
        ``_core_diagnostics``), between rounds: ``zeta_sq_proxy`` is the
        across-worker dispersion of the control variates, (1/n) Σᵢ ‖Δᵢ −
        Δ̄‖², the runtime proxy for ζ²; ``delta_residual`` is ‖(1/n) Σᵢ
        Δᵢ‖∞, the Σ Δ = 0 invariant's residual (``bias_residual`` the BVR
        Σ B = 0 twin); drift is ‖xᵢ − x̂‖ per worker.  With a
        ``MemberState`` every figure is over the active workers (a dead
        row is never read: it neither counts as non-finite nor moves a
        mean; its drift is 0) and n is the active count.  Leaves the state
        untouched."""
        p = state.params
        w_l = p.shape[0]
        member = state.member
        live = host_mask(member).live if _masked(member) else None
        n = (host_mask(member).n if live is not None
             else float(w_l * world))
        elems = float(fspec.rows * fspec.lanes)
        rows = range(w_l) if live is None else live

        def wsum(buf):
            if live is None:
                return coll.worker_sum(mesh, buf.to(torch.float32), 0)
            return _rows_sum(buf, live, mesh, kind="eval")
        sums = {"params": _sq_rows(p, live)}
        xhat = wsum(p).mul_(1.0 / n)
        per = _per_worker(p, xhat, rows, mesh, _mine(w_l), w_l * world)
        del xhat
        drift_w = per[0]
        maxes = {}

        def invariant(buf, res_key, disp_key=None):
            s = wsum(buf)
            maxes[res_key] = _amax(s)
            if disp_key is not None:
                mean = s.mul_(1.0 / n)
                sums[disp_key] = sum(
                    (_sq(buf[i].to(torch.float32) - mean) for i in rows),
                    torch.zeros((), dtype=torch.float32, device=p.device))

        if algo.use_delta:
            invariant(state.delta, "delta_residual", "zeta_sq_proxy")
        if bias_on:
            invariant(state.bias, "bias_residual")
        if ef_on:
            sums["ef"] = _sq_rows(state.comm.resid, live)
        _moment_sums(kind, sm3, state.inner, sums, live)
        sums, maxes = _global_scalars(mesh, sums, maxes)
        out = {"nonfinite_workers": (per[1] > 0).sum().to(torch.float32),
               "params_rms": torch.sqrt(sums["params"] / (n * elems)),
               "drift_sq_mean": drift_w.sum() * (1.0 / n),
               "drift_max": torch.sqrt(drift_w.max()),
               "drift_per_worker": torch.sqrt(drift_w)}
        for key in ("delta_residual", "bias_residual"):
            if key in maxes:
                out[key] = maxes[key] * (1.0 / n)
        if "zeta_sq_proxy" in sums:
            out["zeta_sq_proxy"] = sums["zeta_sq_proxy"] * (1.0 / n)
        if ef_on:
            out["ef_resid_rms"] = torch.sqrt(sums["ef"] / (n * elems))
        _moment_rms(kind, sm3, fspec, n, sums, out)
        return {k: out[k] for k in diag_keys}

    return Engine(algorithm=cfg.algorithm, spec=fspec, algo=algo, init=init,
                  train_step=train_step, local_step=local_step, sync=sync,
                  average_model=avg_model, params_tree=params_tree,
                  round_step=round_step, round_end=sync,
                  round_step_flat=round_step, sync_due=sync_due,
                  step_sync=sync,
                  round_begin=round_begin if cfg.overlap else None,
                  round_fold=round_fold if cfg.overlap else None,
                  compressors=(comp, comp2),
                  misses=misses if cfg.overlap else None,
                  diagnostics=diagnostics,
                  set_membership=set_membership if cfg.membership else None,
                  recenter_drift=recenter_drift, all_active=all_active,
                  gather_params=gather_params,
                  own_rows=None if shards.axis is None else
                  functools.partial(shards.own, rows=fspec.rows))


# ============================================== hierarchical executor ("vrl2")
def _make_hier_engine(cfg: VRLConfig, algo: AlgoSpec, fspec: flat.FlatSpec,
                      *, lr: float, wd: float, delta_dt: torch.dtype,
                      device: Optional[torch.device], kind: str, beta: float,
                      mdt: torch.dtype, sm3: bool, mesh,
                      shards: RowShards) -> Engine:
    """The two-level engine over pod-major (P, D, R, C) flat buffers
    (``repro.core.engine._make_hier_engine``), with the sgd, momentum or
    Adam (dense or SM3) inner optimizer over (P, D, ...) moments.

    The level-1 sync averages within each pod and folds the Δ1 update into
    one kernel pass; the level-2 sync averages across pods and folds the Δ2
    update in.  Local steps touch no cross-worker axis.  On one device the
    pod mean is a reduction over dim 1 and the cross-pod mean one over dims
    (0, 1); on a mesh each rank holds a (P/p_r, D/d_r) block of the grid
    and each mean is one all-reduce over its level's group (data, pod).
    A compressed level averages the decompressed drift against its
    reference instead (``HierCommState``): level 1 per pod, x̂_pod = ref1 +
    pod_mean(dec), through the grid EF kernel; level 2 over the pod rows,
    x̂ = ref2 + cross_mean(dec), through the flat one on the strided view
    ``params[:, 0]``.
    """
    hcfg = hier_config(cfg)
    p_total, d_total = hcfg.grid
    k1, k2 = hcfg.k1, hcfg.k2
    comp1, comp2 = comm_mod.resolve_pair(cfg)
    ef1 = None if comp1 is None else _ef_op(comp1, fspec.lanes, grid=True)
    ef2 = None if comp2 is None else _ef_op(comp2, fspec.lanes)
    ef1_on = comp1 is not None and comp1.error_feedback
    ef2_on = comp2 is not None and comp2.error_feedback
    p_r, d_r = (1, 1) if mesh is None else mesh.shape[:2]
    if p_total % p_r or d_total % d_r:
        raise ValueError(f"hier grid {hcfg.grid} does not split over the "
                         f"mesh's {(p_r, d_r)} rank grid")
    p_loc, d_loc = p_total // p_r, d_total // d_r
    # level 2's participants are pods: the pod index alone is folded in,
    # where the pod axis spans more than one rank (as the reference does)
    misses = _misses(cfg, mesh.index(("pod",)) if p_r > 1 else ())

    def all_active(member: Any) -> bool:
        """No ``MemberState``, or one with every worker of the grid active
        (its host copy).  Only known where this rank holds every pod: with
        the pods over several ranks the masked means apply whatever the
        mask (one rule on every rank, no collective)."""
        if not _masked(member):
            return True
        hm = host_mask(member)
        return (p_r == 1 and hm.n == p_total
                and bool((hm.n_pod == d_total).all()))

    def _pod_mean(buf: torch.Tensor, member: Any = ()) -> torch.Tensor:
        """(P, D, R, C) -> (P, 1, R, C): THE intra-pod all-reduce.  With one
        pod it reduces exactly as the flat engine's worker mean does.
        Masked, where a pod of this rank's misses a member: over each
        pod's ACTIVE members, × 1 / max(n_pod, 1) (an all-dead pod's mean
        is 0, and the cross-pod mean leaves it out)."""
        if _masked(member) and (host_mask(member).n_pod < d_total).any():
            return coll.worker_mean(
                mesh, buf, 1, ("data",), keepdim=True,
                keep=host_mask(member).keep.reshape(p_loc, d_loc),
                count=member.n_pod.clamp(min=1.0))
        return coll.worker_mean(mesh, buf, 1, ("data",), keepdim=True,
                                sum_form=True)

    def _cross_mean(pod_avg: torch.Tensor, async_op: bool = False,
                    member: Any = ()):
        """(P, 1, R, C) pod averages -> (R, C): THE cross-pod all-reduce.
        Masked, where a pod is dead: the uniform mean over ALIVE pods
        (``n_active`` counts them), the weighting that keeps Σ_p Δ2 = 0
        through pod churn."""
        if _masked(member) and host_mask(member).n < p_total:
            return coll.worker_mean(
                mesh, pod_avg, (0, 1), ("pod",), async_op=async_op,
                keep=(host_mask(member).n_pod > 0).reshape(p_loc, 1),
                count=member.n_active)
        return coll.worker_mean(mesh, pod_avg, (0, 1), ("pod",),
                                async_op=async_op, sum_form=True)

    def _kg(k_eff: int, dev: torch.device) -> torch.Tensor:
        """k_eff·γ as an fp32 product made on the device (no host sync)."""
        return torch.full((1, 1), float(k_eff), dtype=torch.float32,
                          device=dev) * lr

    def _gbuf(grads: Any) -> torch.Tensor:
        """A gradient buffer shaped like ``state.params`` (this rank's rows)
        as it comes, or a grid tree of every row -> this rank's rows."""
        if isinstance(grads, torch.Tensor):
            return grads
        return shards.own(flat.flatten_grid(
            fspec, grads, dtype=flat.dtype_of(fspec.dtype)),
            fspec.rows).contiguous()

    def _check_round() -> None:
        if k2 % k1:
            raise ValueError(
                f"round execution treats one k1 period as the unit and "
                f"nests the level-2 cadence, which needs k2 % k1 == 0; got "
                f"k1={k1}, k2={k2}")

    def init(params: Any, num_workers: int) -> HierFlatState:
        if num_workers != p_total * d_total:
            raise ValueError(
                f"hier grid {hcfg.grid} holds {p_total * d_total} workers, "
                f"init asked for {num_workers}")
        flat1 = flat.flatten_tree(fspec, params)
        if device is not None:
            flat1 = flat1.to(device)
        flat1 = shards.own(flat1, fspec.rows)
        # this rank's block of the grid (all of it without a mesh)
        stacked = flat1.expand(p_loc, d_loc, *flat1.shape).clone()
        pod_shape = (p_loc, 1, *flat1.shape)
        overlap = ()
        if cfg.overlap:
            # per-pod transmitted positions; pend = x0, so the first level-2
            # fold's correction is exactly zero
            overlap = OverlapState(
                pend=flat1.to(torch.float32).expand(pod_shape).clone(),
                pend_k=torch.ones((p_loc, 1, 1, 1), dtype=torch.float32,
                                  device=stacked.device))

        def zeros(shape):
            return torch.zeros(shape, dtype=torch.float32,
                               device=stacked.device)
        comm = ()
        if comp1 is not None or comp2 is not None:
            # fp32 residuals; ref1 per pod and ref2 global start at x0
            comm = HierCommState(
                resid1=zeros(stacked.shape) if ef1_on else (),
                ref1=(flat1.to(torch.float32).expand(pod_shape).clone()
                      if comp1 is not None else ()),
                resid2=zeros(pod_shape) if ef2_on else (),
                ref2=(flat1.to(torch.float32, copy=True)
                      if comp2 is not None else ()))
        member = ()
        if cfg.membership:
            member = MemberState(
                active=torch.ones((p_loc, d_loc, 1, 1), dtype=torch.float32,
                                  device=stacked.device),
                n_active=torch.tensor(float(p_total), dtype=torch.float32,
                                      device=stacked.device),
                n_pod=torch.full((p_loc, 1, 1, 1), float(d_total),
                                 dtype=torch.float32, device=stacked.device))
        return HierFlatState(
            params=stacked,
            delta1=torch.zeros(stacked.shape, dtype=delta_dt,
                               device=stacked.device),
            delta2=torch.zeros(pod_shape, dtype=delta_dt,
                               device=stacked.device),
            inner=inner_init(stacked), step=0, last_sync1=0, last_sync2=0,
            comm=comm, overlap=overlap, member=member)

    def inner_init(stacked: torch.Tensor) -> Any:
        if kind == "sgd":
            return ()
        if kind == "momentum":
            return torch.zeros(stacked.shape, dtype=mdt,
                               device=stacked.device)
        return _adam_state(stacked.shape, fspec.shards // shards.count, mdt,
                           sm3, stacked.device)

    def local_step(state: HierFlatState, grads: Any) -> HierFlatState:
        """One local step: the inner optimizer on v = g − Δ1 − Δ2 (the
        reference's ``_core_local``)."""
        p, g, inner = state.params, _gbuf(grads), state.inner
        corr = (state.delta1, state.delta2)
        if kind == "sgd":
            vu.fused_hier_local_sgd(p, g, *corr, lr=lr, wd=wd,
                                    block=fspec.block)
        elif kind == "momentum":
            vu.fused_hier_local_momentum(p, g, *corr, inner, lr=lr,
                                         beta=beta, wd=wd,
                                         block=fspec.block)
        else:
            inner = _adam_local(vu.fused_hier_local_adam,
                                vu.fused_hier_local_adam_sm3, inner, p, g,
                                corr, dict(lr=lr, b1=_ADAM_B1, b2=_ADAM_B2,
                                           wd=wd, block=fspec.block))
        return state._replace(inner=inner, step=state.step + 1)

    def _pod_rows(out: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """A contiguous (P, R, C) buffer for level 2's dec: the first P
        worker slices of the dead (P, D, R, C) buffer ``out`` (None: the
        round trip makes a new one)."""
        return None if out is None else out.view(-1, *out.shape[2:])[
            :p_loc]

    def _ef2(state: HierFlatState, ref: torch.Tensor,
             dec: Optional[torch.Tensor]) -> torch.Tensor:
        """Level 2's EF round trip over the pod rows params[:, 0] (a
        strided view, no copy) against ``ref``, resid2 in place, dec into
        the (P, R, C) buffer ``dec`` (None: a new one); -> dec."""
        cm = state.comm
        dec, _ = ef2(state.params[:, 0], ref,
                     cm.resid2[:, 0] if ef2_on else None, out=dec)
        return dec

    def sync1(state: HierFlatState, out=None) -> HierFlatState:
        """The intra-pod sync; compressed: x̂_pod = ref1 + pod_mean(dec),
        dec over ``out`` (a dead (P, D, R, C) fp32 buffer) when given, and
        x̂_pod is written over ref1 in place."""
        p = state.params
        k_eff = max(state.step - state.last_sync1, 1)
        if comp1 is not None:
            cm = state.comm
            dec, _ = ef1(p, cm.ref1, cm.resid1 if ef1_on else None, out=out)
            xbar = cm.ref1.add_(_pod_mean(dec, state.member))
        else:
            xbar = _pod_mean(p, state.member)
        vu.fused_sync_hier1(p, xbar.to(p.dtype), state.delta1,
                            _kg(k_eff, p.device), block=fspec.block)
        return state._replace(last_sync1=state.step)

    def sync2(state: HierFlatState, out=None) -> HierFlatState:
        """Assumes a level-1 sync at this step: params ARE the pod
        averages, so the global mean needs only the cross-pod axis.
        Compressed: x̂ = ref2 + cross_mean(dec) over the pod rows, written
        over ref2 in place.  Level 2 moves every worker to x̂, so a compressed
        level 1 re-anchors ref1 there (the next intra-pod payload is small
        again)."""
        p = state.params
        k_eff = max(state.step - state.last_sync2, 1)
        if comp2 is not None:
            dec = _ef2(state, state.comm.ref2, _pod_rows(out))
            glob = state.comm.ref2.add_(_cross_mean(dec[:, None],
                                                    member=state.member))
        else:
            glob = _cross_mean(p[:, :1], member=state.member)
        if comp1 is not None:
            _reanchor_ref1(state.comm.ref1, glob)
        vu.fused_sync_hier2(p, glob.to(p.dtype), state.delta2,
                            _kg(k_eff, p.device), block=fspec.block)
        return state._replace(last_sync2=state.step)

    def sync(state: HierFlatState, out=None) -> HierFlatState:
        return sync2(sync1(state, out), out)

    def level2_due(state: HierFlatState, k: int = 0) -> bool:
        """True when the step k steps from now lands on the k2 cadence."""
        return state.step + k - state.last_sync2 >= k2

    def sync_due(state: HierFlatState) -> bool:
        return state.step - state.last_sync1 >= k1 or level2_due(state)

    def step_sync(state: HierFlatState, out=None) -> HierFlatState:
        """sync1, then sync2 when the k2 cadence is due (the reference's
        per-step ``do1 | do2`` / ``do2`` conds)."""
        state = sync1(state, out)
        return sync2(state, out) if level2_due(state) else state

    def train_step(state: HierFlatState, grads: Any) -> HierFlatState:
        state = local_step(state, grads)
        return step_sync(state) if sync_due(state) else state

    def round_end(state: HierFlatState, out=None) -> HierFlatState:
        """The round-closing sync: a round is one k1 period, so level 1
        always fires; level 2 whenever the k2 cadence is due."""
        _check_round()
        return step_sync(state, out)

    # Only the cross-pod sync2 is overlapped; the intra-pod sync1 stays
    # blocking (the level-2 fold needs post-sync1 pod-uniform params).
    def round_begin(state: HierFlatState, k: int) -> Optional[torch.Tensor]:
        """The level-2 mean over pend taken at round START, when the round
        of ``k`` steps will end on the k2 cadence (on a mesh issued
        asynchronously, a pending mean); None otherwise (the fold then has
        nothing to read, and nothing is allocated)."""
        _check_round()
        return (_cross_mean(state.overlap.pend, async_op=True,
                            member=state.member)
                if level2_due(state, k) else None)

    def _fold2(state: HierFlatState, glob: torch.Tensor,
               out: Optional[torch.Tensor]) -> HierFlatState:
        """Apply the stale cross-pod mean: c_p = x̂_stale − pend2_p folds
        into every worker of pod p (post-sync1, so the whole pod moves
        together), Δ2 updates over the period pend covered, and the new
        per-pod positions are captured for the next level-2 mean — in the
        fold kernel, or under a compressed level 2 as x̂_stale + dec of the
        EF round trip of the folded pod rows against x̂_stale.  A pod that
        misses its deadline keeps its pend (and parks dec in resid2).  A
        compressed level 1 shifts ref1 by c_p with its pod."""
        ov = state.overlap
        p = state.params
        k_eff = max(state.step - state.last_sync2, 1)
        km = misses(state.step, p_loc)                         # (P, 1)
        wscal = _fold_scal(ov.pend_k[:, 0, :, 0], km, lr)
        if comp1 is not None:
            _shift_ref1(state.comm.ref1, glob, ov.pend)
        vu.fused_fold_overlap_hier2(p, glob.to(p.dtype), ov.pend,
                                    state.delta2, wscal,
                                    capture=comp2 is None,
                                    block=fspec.block)
        if comp2 is not None:
            pend = ov.pend[:, 0]
            if not km.any():
                # pend is dead once the fold has read it: dec goes there
                # and pend' = x̂_stale + dec is finished in place
                _ef2(state, glob, pend)
                pend.add_(glob)
            else:
                _park(pend, state.comm.resid2[:, 0] if ef2_on else None,
                      _ef2(state, glob, _pod_rows(out)), glob, km)
            state = state._replace(comm=state.comm._replace(ref2=glob))
        _stretch(ov.pend_k, km, k_eff)
        return state._replace(last_sync2=state.step)

    def round_fold(state: HierFlatState, glob: Optional[torch.Tensor],
                   out: Optional[torch.Tensor] = None) -> HierFlatState:
        """The overlapped round's END: the blocking sync1, then, when this
        step lands on the k2 cadence, the stale level-2 fold of
        ``round_begin``'s mean.  ``out``: a dead (P, D, R, C) fp32 buffer
        for the compressed payloads."""
        _check_round()
        state = sync1(state, out)
        if not level2_due(state):
            return state
        if glob is None:
            raise ValueError(
                "round_fold: the k2 cadence is due but round_begin took no "
                "cross-pod mean (it was given another round length)")
        return _fold2(state, coll.resolve(glob), out)

    def round_step(state: HierFlatState, grads_k: Any) -> HierFlatState:
        """One k1 round over a (k1, P, D, R, C) grads buffer or a grads tree
        with (k1, P, D, ...) leaves: k1 local steps, then sync1 (+ sync2
        when the k2 cadence is due); under overlap opened by
        ``round_begin`` and closed by ``round_fold``."""
        _check_round()
        steps = _round_grads(grads_k)
        glob = round_begin(state, len(steps)) if cfg.overlap else None
        for g in steps:
            state = local_step(state, g)
        return round_fold(state, glob) if cfg.overlap else round_end(state)

    def gather_params(state: HierFlatState,
                      kind: str = "forward") -> torch.Tensor:
        """The (P, D, R, C) parameter buffer of this rank's workers (on a
        row-sharded mesh gathered over the shard group, counted
        ``kind``)."""
        return shards.gather(state.params, kind)

    def params_tree(state: HierFlatState) -> Any:
        """Grid-stacked parameter tree ((P, D, ...) leaves), views (on a
        row-sharded mesh into the gathered copy)."""
        return flat.unflatten_grid(fspec, gather_params(state))

    def avg_model(state: HierFlatState) -> Any:
        """x̂ over all P·D workers — the evaluation model; with a
        ``MemberState`` over the active ones."""
        member = state.member
        if all_active(member):
            xbar = coll.worker_mean(mesh, state.params, (0, 1), coll.AXES,
                                    kind="eval")
        else:
            xbar = coll.worker_mean(
                mesh, state.params, (0, 1), coll.AXES, kind="eval",
                keep=host_mask(member).keep.reshape(p_loc, d_loc),
                count=_active_workers(member).clamp(min=1.0))
        return flat.unflatten_tree(fspec, shards.gather(xbar, "eval"))

    def _active_workers(member: MemberState) -> torch.Tensor:
        """The active workers of the whole grid, a 0-d fp32 tensor (on a
        mesh the pods' counts summed over the pod axis, counted "eval")."""
        n = member.n_pod.sum()
        if mesh is not None:
            n = n.to(coll.wire_device(mesh))
            mesh.all_reduce(n, ("pod",), kind="eval")
        return n.to(member.n_pod.device)

    # this rank's block of the (P, D) grid
    p0 = 0 if mesh is None else mesh.index(("pod",))[0] * p_loc
    d0 = 0 if mesh is None else mesh.index(("data",))[0] * d_loc
    mine = np.arange(p_total * d_total).reshape(p_total, d_total)[
        p0:p0 + p_loc, d0:d0 + d_loc].reshape(-1)

    @torch.no_grad()
    def set_membership(state: HierFlatState, active) -> HierFlatState:
        """Change the active set to ``active`` ((W,) pod-major or (P, D)
        over the whole grid), repairing the two-level invariants in place:
        Δ1 recentred within each pod over its continuing members (Σ_d Δ1 =
        0 in every pod with survivors), Δ2 over the pods that stay alive
        (Σ_p Δ2 = 0 over them); dropped and rejoining workers re-seeded
        from the continuing consensus x̂ (their Δ1, moments and EF residual
        zeroed), and a pod none of whose members continue re-anchored
        there (its Δ2 and resid2 zeroed, ref1 and overlap pend x̂, pend_k
        1).  On a mesh each global sum is one all-reduce counted
        "membership" over its axes."""
        p = state.params
        dev = p.device
        new = _new_mask(active, (p_total, d_total))
        cont_g = (global_mask(mesh, state.member.active, mine,
                              p_total * d_total) * new).reshape(
                                   p_total, d_total)
        new_g = new.reshape(p_total, d_total)
        cont = cont_g[p0:p0 + p_loc, d0:d0 + d_loc]
        keep = cont.reshape(-1) > 0
        live, dead = np.flatnonzero(keep), np.flatnonzero(~keep)
        rows = p.view(-1, *p.shape[2:])

        def scalar(x):
            return torch.tensor(float(x), dtype=torch.float32, device=dev)
        n_cont = scalar(max(cont_g.sum(), 1.0))
        xhat = _rows_sum(rows, live, mesh).div_(n_cont)
        for i in dead:
            rows[i].copy_(xhat)
        # Δ1 within each pod over its continuing members
        n_cont_pod = cont_g.sum(axis=1)[p0:p0 + p_loc]
        d1 = state.delta1
        for pi in range(p_loc):
            alive_d = np.flatnonzero(cont[pi] > 0)
            s1 = _rows_sum(d1[pi], alive_d, mesh, ("data",)).div_(
                scalar(max(n_cont_pod[pi], 1.0))).to(d1.dtype)
            for di in range(d_loc):
                if cont[pi, di] > 0:
                    d1[pi, di].sub_(s1)
                else:
                    d1[pi, di].zero_()
        # Δ2 over the pods that keep a continuing member
        pod_keep_g = cont_g.sum(axis=1) > 0
        pod_keep = pod_keep_g[p0:p0 + p_loc]
        alive_p, gone_p = np.flatnonzero(pod_keep), np.flatnonzero(~pod_keep)
        d2 = state.delta2[:, 0]
        s2 = _rows_sum(d2, alive_p, mesh, ("pod",)).div_(
            scalar(max(pod_keep_g.sum(), 1.0))).to(d2.dtype)
        for pi in alive_p:
            d2[pi].sub_(s2)
        for pi in gone_p:
            d2[pi].zero_()
        _zero_rows(state.inner, dead, 4)
        cm = state.comm
        if isinstance(cm, HierCommState):
            if ef1_on:
                _zero_rows(cm.resid1, dead, 4)
            for pi in gone_p:
                if comp1 is not None:
                    cm.ref1[pi, 0].copy_(xhat)
                if ef2_on:
                    cm.resid2[pi, 0].zero_()
        if cfg.overlap:
            for pi in gone_p:
                state.overlap.pend[pi, 0].copy_(xhat)
                state.overlap.pend_k[pi].fill_(1.0)
        n_new_pod = new_g.sum(axis=1)
        return state._replace(member=MemberState(
            active=torch.from_numpy(
                new_g[p0:p0 + p_loc, d0:d0 + d_loc].copy()).to(dev).view(
                    p_loc, d_loc, 1, 1),
            n_active=scalar((n_new_pod > 0).sum()),
            n_pod=torch.from_numpy(n_new_pod[p0:p0 + p_loc].astype(
                np.float32)).to(dev).view(p_loc, 1, 1, 1)))

    diag_keys = ["params_rms", "drift_sq_mean", "drift_max",
                 "nonfinite_workers", "delta1_residual", "delta2_residual",
                 "zeta_sq_proxy"]
    if ef1_on:
        diag_keys += ["ef_resid_rms"]
    if kind != "sgd":
        diag_keys += ["mu_rms"]
    if kind == "adam":
        diag_keys += ["nu_rms"]

    @torch.no_grad()
    def diagnostics(state: HierFlatState) -> dict:
        """The two-level twin of the flat pass (the reference's
        ``_core_diag_hier``): ``delta1_residual`` is the worst pod's
        ‖mean_d Δ1[p]‖∞ (Σ_d Δ1[p] = 0 within every pod),
        ``delta2_residual`` ‖mean_p Δ2‖∞ (Σ_p Δ2 = 0); the ζ² proxy is
        the dispersion of each worker's TOTAL correction Δ1 + Δ2.  With a
        ``MemberState``: over the active workers (a dead row is never
        read), the pods' means over their active members and the
        cross-pod mean over alive pods."""
        member = state.member
        p, d1, d2 = state.params, state.delta1, state.delta2
        dev = p.device
        rows = p.reshape(-1, *p.shape[2:])
        d1r = d1.reshape(-1, *d1.shape[2:])
        # the rows read: every worker and pod (None), or the active ones
        live = pods = None
        pod_rows = [None] * p_loc
        n, n_alive = float(p_total * d_total), float(p_total)
        n_pod = np.full(p_loc, float(d_total))
        if _masked(member):
            hm = host_mask(member)
            live, pods = hm.live, np.flatnonzero(hm.n_pod > 0)
            pod_rows = [np.flatnonzero(k) for k in
                        hm.keep.reshape(p_loc, d_loc)]
            n = max(float(_active_workers(member)), 1.0)
            n_alive, n_pod = hm.n, np.maximum(hm.n_pod, 1.0)
        each = range(rows.shape[0]) if live is None else live
        elems = float(fspec.rows * fspec.lanes)
        zero = torch.zeros((), dtype=torch.float32, device=dev)

        def wsum(buf, axes, idx):
            """Σ over ``buf``'s leading dim (its rows ``idx`` when given)
            and the ranks of ``axes``, in fp32 ("eval")."""
            if idx is None:
                return coll.worker_sum(mesh, buf.to(torch.float32), 0, axes)
            return _rows_sum(buf, idx, mesh, axes, kind="eval")
        sums = {"params": _sq_rows(p, live)}
        xhat = wsum(rows, coll.AXES, live).mul_(1.0 / n)
        per = _per_worker(p, xhat, each, mesh, mine, p_total * d_total)
        del xhat
        maxes = {}
        maxes["delta1"] = torch.stack([zero] + [
            _amax(wsum(d1[pi], ("data",), pod_rows[pi]).mul_(
                1.0 / float(n_pod[pi]))) for pi in range(p_loc)]).max()
        maxes["delta2"] = _amax(wsum(d2[:, 0], ("pod",), pods).mul_(
            1.0 / n_alive))

        def corr(i):                    # worker i's total correction
            return (d1r[i].to(torch.float32)
                    + d2[i // d_loc, 0].to(torch.float32))
        cmean = sum((corr(i) for i in each),
                    torch.zeros(d1.shape[2:], dtype=torch.float32,
                                device=dev))
        if mesh is not None:
            mesh.all_reduce(cmean, kind="eval")
        cmean.mul_(1.0 / n)
        sums["zeta"] = sum((_sq(corr(i) - cmean) for i in each), zero)
        del cmean
        if ef1_on:
            sums["ef"] = _sq_rows(state.comm.resid1, live)
        _moment_sums(kind, sm3, state.inner, sums, live)
        sums, maxes = _global_scalars(mesh, sums, maxes)
        out = {"params_rms": torch.sqrt(sums["params"] / (n * elems)),
               "drift_sq_mean": per[0].sum() * (1.0 / n),
               "drift_max": torch.sqrt(per[0].max()),
               "nonfinite_workers": (per[1] > 0).sum().to(torch.float32),
               "delta1_residual": maxes["delta1"],
               "delta2_residual": maxes["delta2"],
               "zeta_sq_proxy": sums["zeta"] * (1.0 / n)}
        if ef1_on:
            out["ef_resid_rms"] = torch.sqrt(sums["ef"] / (n * elems))
        _moment_rms(kind, sm3, fspec, n, sums, out)
        return {k: out[k] for k in diag_keys}

    return Engine(algorithm=cfg.algorithm, spec=fspec, algo=algo, init=init,
                  train_step=train_step, local_step=local_step, sync=sync,
                  average_model=avg_model, params_tree=params_tree,
                  round_step=round_step, round_end=round_end,
                  round_step_flat=round_step, sync_due=sync_due,
                  step_sync=step_sync,
                  round_begin=round_begin if cfg.overlap else None,
                  round_fold=round_fold if cfg.overlap else None,
                  compressors=(comp1, comp2),
                  misses=misses if cfg.overlap else None,
                  sync1=sync1, sync2=sync2, grid=(p_total, d_total),
                  diagnostics=diagnostics,
                  set_membership=set_membership if cfg.membership else None,
                  all_active=all_active, gather_params=gather_params,
                  own_rows=None if shards.axis is None else
                  functools.partial(shards.own, rows=fspec.rows))
