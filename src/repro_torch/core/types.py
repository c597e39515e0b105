"""State containers of the algorithms (``repro.core.types`` and
``repro.core.engine``): the flat-buffer engine's ``FlatWorkerState``,
``CommState``, ``OverlapState``, ``MemberState``, ``HierFlatState`` and
``HierCommState``, and the per-leaf reference executor's ``WorkerState``
and ``HierState``.

The flat engine's buffers are updated IN PLACE by its kernels; an engine
call returns a new tuple (``_replace``) that holds the same buffers with
the step counters advanced.  The per-leaf executor is functional, as the
reference's is: each call returns new trees (nested dicts of tensors with
the worker axes leading) and leaves its input state as it was.  The step
counters are host integers in both: the driver decides on the host when a
round ends, so they never need a device read.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree as tree_mod


class WorkerState(NamedTuple):
    """The per-leaf executor's state (``repro.core.types.WorkerState``):
    trees whose leaves carry a leading worker axis W.  ``center`` (EASGD's
    x̃, single-model fp32) and ``bias`` (BVR-L-SGD's B) are None where the
    algorithm has none; ``comm`` a ``CommState`` of trees under compressed
    sync (ref single-model), () otherwise."""

    params: Any              # (W, ...) worker-stacked model parameters
    delta: Any               # (W, ...) VRL correction Δ_i (zeros if unused)
    inner: Any               # inner-optimizer state (momentum buffers, ...)
    center: Any              # EASGD center variable x̃ (None elsewhere)
    step: int                # iterations completed
    last_sync: int           # step index of the last sync
    bias: Any = None         # (W, ...) BVR-L-SGD bias variate B_i (else None)
    comm: Any = ()           # compressed-sync state (CommState) — () when
                             # the sync payload is uncompressed


class HierState(NamedTuple):
    """Two-level hierarchical VRL-SGD state of the per-leaf executor
    (``repro.core.types.HierState``): leaves carry a pod-major (P, D, ...)
    worker grid, Δ2 one (P, 1, ...) correction per pod; ``comm`` a
    ``HierCommState`` of trees when a level compresses."""

    params: Any              # (P, D, ...) pod-major worker grid
    delta1: Any              # (P, D, ...) intra-pod corrections
    delta2: Any              # (P, 1, ...) cross-pod corrections (per pod)
    inner: Any
    step: int
    last_sync1: int          # step of the last level-1 (intra-pod) sync
    last_sync2: int          # step of the last level-2 (cross-pod) sync
    comm: Any = ()           # per-level compressed-sync state


def swap_dims(tree, a: int = 0, b: int = 1):
    """Every leaf with dims ``a`` and ``b`` swapped (views)."""
    return tree_mod.tree_map(lambda x: x.transpose(a, b), tree)


class CommState(NamedTuple):
    """Compressed-sync state (``comm.compressors``).

    ``resid``: the per-worker error-feedback residual, (W, R, C) fp32; ()
    when error feedback is off.  ``ref``: the shared drift reference, the
    (R, C) fp32 value every worker holds after the last sync, against
    which the next payload is compressed; () for S-SGD's gradient
    compression (ref ≡ 0).  The per-leaf executor holds trees in both:
    resid worker-stacked, ref single-model.
    """

    resid: Any = ()
    ref: Any = ()


class HierCommState(NamedTuple):
    """The hierarchy's per-level compressed-sync state.

    Level 1 (intra-pod): ``resid1`` the per-worker residual, (P, D, R, C)
    fp32; ``ref1`` the per-pod reference, (P, 1, R, C) fp32, shared by the
    pod's workers.  Level 2 (cross-pod): ``resid2`` the per-pod residual,
    (P, 1, R, C) fp32; ``ref2`` the global reference, (R, C) fp32.  Each
    half is () when its level is uncompressed, each residual () when its
    compressor has no error feedback.  The per-leaf executor holds trees
    of the same leading shapes (ref2 single-model).
    """

    resid1: Any = ()
    ref1: Any = ()
    resid2: Any = ()
    ref2: Any = ()


class OverlapState(NamedTuple):
    """Double buffer of the overlapped round.

    The round issues its worker mean at round START over the positions
    every worker transmitted at the previous round boundary, and folds
    the result in one round stale.  ``pend``: each worker's last
    transmitted absolute position, (W, R, C) fp32.  ``pend_k``: the local
    steps each ``pend`` covers, a (W, 1, 1) fp32 DEVICE tensor, so that
    the fold's 1/(pend_k·γ) is formed on the device without a host round
    trip.  Under the hierarchy only the cross-pod level overlaps: pend is
    each pod's position, (P, 1, R, C), and pend_k (P, 1, 1, 1).
    """

    pend: Any
    pend_k: Any


class MemberState(NamedTuple):
    """Elastic membership of fault-tolerant rounds
    (``repro.core.types.MemberState``), device tensors.

    ``active``: the {0, 1} fp32 mask over workers, shaped to broadcast
    against the flat buffers: (W, 1, 1), the hierarchy's (P, D, 1, 1); on a
    mesh this rank's block of it.  Dead workers keep their rows (nothing is
    re-laid out); every sync mean adds up only the active workers' slices,
    never a multiply by the mask (a dead worker's NaN · 0 is NaN).

    ``n_active``: 0-d fp32, the divisor of the top-level masked mean,
    carried in the state so that the masked sync stays ONE all-reduce:
    the active workers (the hierarchy: the ALIVE pods, those with at least
    one active member — the cross-pod mean is uniform over them, the
    weighting that keeps Σ_p Δ2 = 0 through pod churn); global on a mesh.

    ``n_pod``: the hierarchy only, each pod's active members, (P, 1, 1, 1)
    fp32 (the intra-pod means' divisors); () on the flat engine.

    Only ``Engine.set_membership`` (the repair between rounds) changes
    them.
    """

    active: Any
    n_active: Any
    n_pod: Any = ()


class FlatWorkerState(NamedTuple):
    """Worker-stacked algorithm state as contiguous flat buffers.

    ``params``/``delta``/moments: (W, R, C) (layout: ``core.flat``);
    ``center``: (R, C) fp32 (EASGD only); ``inner``: () for sgd, the (W, R,
    C) momentum buffer, or an ``optim.AdamState`` of a (W, R, C) mu and a
    nu that is dense (W, R, C) or an ``optim.SM3Pair`` of fp32 stats, row
    (W, R, 1) and lane (W, S, C) with S = ``FlatSpec.shards``;
    ``bias``: BVR-L-SGD's (W, R, C) variate B; ``comm``: a ``CommState``
    under compression; ``overlap``: an ``OverlapState`` under overlapped
    rounds; ``member``: a ``MemberState`` under ``cfg.membership``.  Each
    is () where the configuration does not use it.
    """

    params: torch.Tensor
    delta: Any
    step: int                   # iterations completed
    last_sync: int              # step index of the last sync
    inner: Any = ()
    center: Any = ()
    bias: Any = ()
    comm: Any = ()
    overlap: Any = ()
    member: Any = ()


class HierFlatState(NamedTuple):
    """Two-level algorithm state as pod-major contiguous flat buffers.

    ``params``/``delta1``: (P, D, R, C); ``delta2``: (P, 1, R, C), one
    cross-pod correction per pod, broadcast over the intra-pod axis by the
    kernels rather than materialised; ``inner``: () for sgd, the (P, D, R,
    C) momentum buffer, or an ``optim.AdamState`` of a (P, D, R, C) mu and
    a dense nu or an ``SM3Pair`` of row (P, D, R, 1) and lane (P, D, S, C)
    stats.  Invariants: Σ_d Δ1[p, d] = 0 within every
    pod after a level-1 sync, Σ_p Δ2[p] = 0 after a level-2 sync.
    ``overlap``: an ``OverlapState`` over pods under overlapped rounds, ()
    otherwise; ``comm``: a ``HierCommState`` when either level compresses,
    () otherwise; ``member``: a ``MemberState`` (active (P, D, 1, 1), n_pod
    (P, 1, 1, 1), n_active the alive pods) under ``cfg.membership``.
    """

    params: torch.Tensor
    delta1: torch.Tensor
    delta2: torch.Tensor
    inner: Any
    step: int                   # iterations completed
    last_sync1: int             # step index of the last level-1 sync
    last_sync2: int             # step index of the last level-2 sync (or
                                # fold)
    comm: Any = ()
    overlap: Any = ()
    member: Any = ()
