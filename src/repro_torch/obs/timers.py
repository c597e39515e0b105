"""Wall-clock phase timers with p50/p95 accumulation
(``repro.obs.timers``, copied).

The phases the driver times are the host-visible boundaries, the
reference's (its round is ONE jitted dispatch): data staging, the round
dispatch+block, eval, diagnostics, gather/scatter, membership updates,
checkpointing.  The summary reports per-phase sample count, total seconds and nearest-rank
p50/p95 milliseconds.

Self-contained on purpose: ``src/repro_torch`` imports no ``benchmarks``
(the percentile helper there is the same nearest-rank convention).
"""
from __future__ import annotations

import math
import time
from contextlib import contextmanager
from typing import Dict, List


def percentile(samples: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of a non-empty list."""
    s = sorted(samples)
    rank = max(1, math.ceil(q / 100.0 * len(s)))
    return s[rank - 1]


class PhaseTimers:
    """Accumulate named wall-clock phase samples."""

    def __init__(self):
        self._samples: Dict[str, List[float]] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self._samples.setdefault(name, []).append(float(seconds))

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-phase {n, total_s, mean_ms, p50_ms, p95_ms}, insertion
        order (which is first-seen order — roughly pipeline order)."""
        out: Dict[str, Dict[str, float]] = {}
        for name, s in self._samples.items():
            out[name] = {
                "n": len(s),
                "total_s": round(sum(s), 6),
                "mean_ms": round(1e3 * sum(s) / len(s), 3),
                "p50_ms": round(1e3 * percentile(s, 50), 3),
                "p95_ms": round(1e3 * percentile(s, 95), 3),
            }
        return out
