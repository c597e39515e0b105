"""State container of the flat-buffer engine (``repro.core.engine``
``FlatWorkerState``), for the slice the port runs: vrl_sgd with the sgd
inner optimizer.

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

    ``params``/``delta``: (W, R, C) (layout: ``core.flat``); Δ is () for
    algorithms that never use it.
    """

    params: torch.Tensor
    delta: Any
    step: int                   # iterations completed
    last_sync: int              # step index of the last sync
