"""Structured telemetry for the training driver (``repro.obs``).

  ``metrics``      schema-versioned JSONL event stream (``MetricsWriter``)
  ``diagnostics``  host-side helpers around ``Engine.diagnostics`` — the
                   one read-only pass over the flat state (drift
                   dispersion, the Δ-dispersion ζ² proxy, Σ Δ / Σ B
                   residuals, EF/moment norms, non-finite worker count)
  ``timers``       wall-clock phase timers with p50/p95 accumulation
  ``report``       summarize / diff metrics streams (``python -m
                   repro_torch.obs.report``)
  ``convert``      legacy ``results/*.json`` ↔ obs JSONL converters

``metrics``, ``timers``, ``report`` and ``convert`` are framework-free
copies of the reference's (``SCHEMA_VERSION`` 1): a stream written by
either package reads in both.  The diagnostics pass runs between rounds,
never inside one, so a round keeps its one model-state all-reduce.
"""
from repro_torch.obs.metrics import (SCHEMA_VERSION, MetricsWriter,
                                     NullWriter, read_metrics, run_meta)

__all__ = [
    "SCHEMA_VERSION",
    "MetricsWriter",
    "NullWriter",
    "read_metrics",
    "run_meta",
]
