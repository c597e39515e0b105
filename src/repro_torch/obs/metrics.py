"""Schema-versioned JSONL metrics stream (``repro.obs.metrics``, copied:
the two packages write and read the same streams).

One record per line; every record carries ``schema`` (an integer, bumped
on breaking layout changes), ``event`` (the record type) and ``wall_s``
(seconds since the stream opened).  The FIRST record of a stream is
always ``run_start`` with a ``meta`` dict describing the run (arch,
algorithm, workers, k, resolved backend, wire bytes per sync, ...), so a
metrics file is self-describing — ``python -m repro_torch.obs.report``
needs nothing else.

Event vocabulary the training driver emits (consumers must tolerate
unknown events — the set grows):

  run_start    stream header: ``meta`` run-description dict
  round        a compiled round committed: t, r, k, loss, wire_bytes
  sync         the round's sync collective: wire_bytes, participants
  diag         algorithm-health diagnostics (``Engine.diagnostics``):
               drift_sq_mean/drift_max/drift_per_worker, zeta_sq_proxy,
               delta_residual (+bias_residual), ef_resid_rms, mu/nu_rms,
               nonfinite_workers, alarms
  eval         averaged-model eval at a log boundary
  membership   the worker-slot mask changed: active list, n_active
  rollback     divergence guard (or invariant alarm) rolled back
  cohort       client sampling drew a cohort: client ids
  checkpoint   atomic save (killed=True when a simulated kill hit)
  restore      resume loaded a checkpoint
  fault        injected faults scheduled inside the upcoming round
  tail         per-step tail (steps not divisible by k)
  bench        benchmark row (see ``repro_torch.obs.convert``)
  run_end      final record: steps, final/avg-model loss, phase timers

Writers flush after every record, so a crashed run leaves a valid
prefix — exactly what the chaos pipeline reads back.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

SCHEMA_VERSION = 1


def _json_safe(x: Any) -> Any:
    """Recursively coerce numpy/torch scalars and small arrays to plain
    python so ``json.dump`` accepts them."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, dict):
        return {str(k): _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    item = getattr(x, "item", None)
    if item is not None and getattr(x, "ndim", 1) == 0:
        return _json_safe(item())
    tolist = getattr(x, "tolist", None)
    if tolist is not None:
        return _json_safe(tolist())
    return str(x)


class MetricsWriter:
    """Append-only JSONL event stream (see module docstring).

    Opens ``path`` eagerly (creating parent dirs) and writes the
    ``run_start`` header immediately; ``emit`` stamps ``schema`` /
    ``event`` / ``wall_s`` onto every record and flushes, so partial
    streams from crashed runs stay readable.  ``close`` is optional —
    nothing is buffered — but emits a final flush point for symmetry.
    """

    active = True

    def __init__(self, path: str, *, run_meta: Optional[Dict[str, Any]] = None,
                 source: str = "train"):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._t0 = time.time()
        self._f = open(path, "w")
        self._write({"schema": SCHEMA_VERSION, "event": "run_start",
                     "wall_s": 0.0, "source": source,
                     "meta": _json_safe(dict(run_meta or {}))})

    def _write(self, rec: Dict[str, Any]) -> None:
        json.dump(rec, self._f)
        self._f.write("\n")
        self._f.flush()

    def emit(self, event: str, **fields: Any) -> None:
        if self._f is None:
            return
        rec = {"schema": SCHEMA_VERSION, "event": str(event),
               "wall_s": round(time.time() - self._t0, 6)}
        rec.update(_json_safe(fields))
        self._write(rec)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "MetricsWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class NullWriter:
    """Inactive stand-in so driver code can emit unconditionally."""

    active = False
    path = None

    def emit(self, event: str, **fields: Any) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self) -> "NullWriter":
        return self

    def __exit__(self, *exc) -> None:
        pass


def read_metrics(path: str) -> List[Dict[str, Any]]:
    """Parse and validate a metrics JSONL file.

    Every line must be a JSON object with ``schema`` and ``event``;
    records from a NEWER schema than this reader are rejected loudly
    rather than misread.  Unknown event types pass through (the
    vocabulary grows; see module docstring).
    """
    records: List[Dict[str, Any]] = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                raise ValueError(f"{path}:{i + 1}: invalid JSON: {e}") from e
            if not isinstance(rec, dict) or "event" not in rec \
                    or "schema" not in rec:
                raise ValueError(
                    f"{path}:{i + 1}: metrics records must be objects with "
                    "'schema' and 'event' fields")
            if int(rec["schema"]) > SCHEMA_VERSION:
                raise ValueError(
                    f"{path}:{i + 1}: schema {rec['schema']} is newer than "
                    f"this reader (supports <= {SCHEMA_VERSION})")
            records.append(rec)
    return records


def run_meta(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The ``run_start`` header's ``meta`` dict ({} when absent)."""
    for rec in records:
        if rec.get("event") == "run_start":
            meta = rec.get("meta")
            return dict(meta) if isinstance(meta, dict) else {}
    return {}
