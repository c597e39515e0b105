"""State container of the flat-buffer engine (``repro.core.engine``
``FlatWorkerState``, ``CommState``, ``OverlapState``, ``HierFlatState``,
``HierCommState``), for the slice the port runs: the flat algorithms with
the sgd, momentum and adam inner optimizers (Adam dense or SM3-factored),
compressed sync and overlapped rounds, and the two-level hierarchy with
the same inner optimizers, blocking or overlapped, compressed per level.

The buffers are updated IN PLACE by the engine's kernels; an engine call
returns a new tuple (``_replace``) that holds the same buffers with the
step counters advanced.  The counters are host integers: the round driver
decides on the host when a round ends, so they never need a device read.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch


class CommState(NamedTuple):
    """Compressed-sync state (``comm.compressors``).

    ``resid``: the per-worker error-feedback residual, (W, R, C) fp32; ()
    when error feedback is off.  ``ref``: the shared drift reference, the
    (R, C) fp32 value every worker holds after the last sync, against
    which the next payload is compressed; () for S-SGD's gradient
    compression (ref ≡ 0).
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
    compressor has no error feedback.
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


class FlatWorkerState(NamedTuple):
    """Worker-stacked algorithm state as contiguous flat buffers.

    ``params``/``delta``/moments: (W, R, C) (layout: ``core.flat``);
    ``center``: (R, C) fp32 (EASGD only); ``inner``: () for sgd, the (W, R,
    C) momentum buffer, or an ``optim.AdamState`` of a (W, R, C) mu and a
    nu that is dense (W, R, C) or an ``optim.SM3Pair`` of fp32 stats, row
    (W, R, 1) and lane (W, S, C) with S = ``FlatSpec.shards``;
    ``bias``: BVR-L-SGD's (W, R, C) variate B; ``comm``: a ``CommState``
    under compression; ``overlap``: an ``OverlapState`` under overlapped
    rounds.  Each is () where the configuration does not use it.
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
    () otherwise.
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
