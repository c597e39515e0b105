"""State container of the flat-buffer engine (``repro.core.engine``
``FlatWorkerState``), for the slice the port runs: the flat algorithms
with the sgd, momentum and adam inner optimizers.

The buffers are updated IN PLACE by the engine's kernels; an engine call
returns a new tuple (``_replace``) that holds the same buffers with the
step counters advanced.  The counters are host integers: the round driver
decides on the host when a round ends, so they never need a device read.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch


class FlatWorkerState(NamedTuple):
    """Worker-stacked algorithm state as contiguous flat buffers.

    ``params``/``delta``/moments: (W, R, C) (layout: ``core.flat``);
    ``center``: (R, C) fp32 (EASGD only); ``inner``: () for sgd, the (W, R,
    C) momentum buffer, or an ``optim.AdamState`` of (W, R, C) mu and nu;
    ``bias``: BVR-L-SGD's (W, R, C) variate B.  Δ, center and bias are ()
    for algorithms that never use them.
    """

    params: torch.Tensor
    delta: Any
    step: int                   # iterations completed
    last_sync: int              # step index of the last sync
    inner: Any = ()
    center: Any = ()
    bias: Any = ()
