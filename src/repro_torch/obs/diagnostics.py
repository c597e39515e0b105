"""Host-side helpers around ``Engine.diagnostics``
(``repro.obs.diagnostics``).

``Engine.diagnostics`` (built in ``core/engine.py``) is ONE read-only
pass over the flat state returning a dict of 0-d tensors (plus a
per-worker drift vector on flat engines).  The helpers here turn that
into JSON-safe records, one-line console summaries, and alarm decisions:

  ``to_record``           tensor dict -> plain-float dict for the metrics
                          stream
  ``check_alarms``        the invariant monitor: Σ Δ / Σ B residuals over
                          a configurable threshold, plus any non-finite
                          worker row -> list of human-readable reasons
  ``describe``            one-line console summary of a record
  ``wire_bytes_per_sync`` measured sync payload bytes from the engine's
                          flat spec + resolved compressors — by
                          construction identical to
                          ``comm.rep_nbytes(compress(...))``

What the paper grounds each field in:

  zeta_sq_proxy    (1/n) Σᵢ ‖Δᵢ − Δ̄‖² — the across-worker dispersion of
                   the VRL control variates.  In the paper's analysis Δᵢ
                   tracks ∇Fᵢ(x) − ∇F(x), so this dispersion is the
                   runtime proxy for ζ², the inter-worker gradient
                   variance whose dependency VRL-SGD eliminates.  (The
                   naive between-round drift dispersion is ~0 for
                   broadcast syncs — post-sync params are identical — so
                   it would measure nothing.)
  drift_*          ‖xᵢ − x̂‖ against the worker mean: bounded drift is the
                   analysis' other pillar, and is the meaningful
                   dispersion under overlap / EASGD where params do NOT
                   re-coincide each round.
  delta_residual   ‖(1/n) Σᵢ Δᵢ‖∞ — the paper's Σᵢ Δᵢ = 0 invariant
                   (bias_residual is the BVR Σᵢ Bᵢ = 0 twin).  Nonzero
                   means the control variates have leaked a systematic
                   bias into every sync.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from repro_torch.comm import compressors as comm_mod
from repro_torch.core import flat

# alarm-relevant invariant residuals (flat + hierarchical spellings)
_RESIDUAL_KEYS = (
    ("delta_residual", "sum-delta"),
    ("bias_residual", "sum-bias"),
    ("delta1_residual", "pod sum-delta1"),
    ("delta2_residual", "cross-pod sum-delta2"),
)


def to_record(diag: Dict[str, Any]) -> Dict[str, Any]:
    """Fetch a diagnostics dict of tensors into plain JSON-safe floats."""
    out: Dict[str, Any] = {}
    for k, v in diag.items():
        if getattr(v, "ndim", 0) == 0:
            out[k] = float(v)
        else:
            out[k] = [float(x) for x in v.reshape(-1).tolist()]
    return out


def check_alarms(rec: Dict[str, Any], *,
                 invariant_threshold: float = 0.0) -> List[str]:
    """The invariant monitor: reasons this record should alarm.

    A non-finite worker row always alarms (it is unconditionally wrong);
    the Σ Δ / Σ B residual checks only run with a positive threshold —
    the residual is never exactly 0.0 in finite arithmetic, so the
    driver owns the tolerance (``--invariant-alarm``).  NaN residuals do
    NOT re-alarm here: the non-finite count already covers that state.

    Threshold guidance: uncompressed syncs hold the residual at float
    noise (~1e-6 of the Δ scale).  A LOSSY sync compressor keeps it
    genuinely nonzero — x̂' is rebuilt from decoded payloads, not the
    true mean, so Σ Δ picks up an error-feedback-bounded bias — pick a
    threshold above that floor (watch ``ef_resid_rms``) or leave the
    alarm off under compression.
    """
    reasons: List[str] = []
    nf = rec.get("nonfinite_workers")
    if nf is not None and nf > 0:
        reasons.append(f"{int(nf)} worker row(s) hold non-finite params")
    if invariant_threshold > 0.0:
        for key, label in _RESIDUAL_KEYS:
            v = rec.get(key)
            if v is not None and math.isfinite(v) \
                    and v > invariant_threshold:
                reasons.append(f"{label} residual {v:.3g} exceeds "
                               f"{invariant_threshold:g}")
    return reasons


def describe(rec: Dict[str, Any]) -> str:
    """One console line: the headline health figures of a record."""
    parts = []
    if "drift_sq_mean" in rec:
        parts.append(f"drift2 {rec['drift_sq_mean']:.3e}")
    if "zeta_sq_proxy" in rec:
        parts.append(f"zeta2~ {rec['zeta_sq_proxy']:.3e}")
    for key, _ in _RESIDUAL_KEYS:
        if key in rec:
            parts.append(f"{key.replace('_residual', '')}-res "
                         f"{rec[key]:.2e}")
    if "ef_resid_rms" in rec:
        parts.append(f"ef-rms {rec['ef_resid_rms']:.2e}")
    nf = rec.get("nonfinite_workers")
    if nf:
        parts.append(f"NONFINITE x{int(nf)}")
    return "  ".join(parts) if parts else "(empty)"


def wire_bytes_per_sync(engine) -> Optional[Dict[str, Any]]:
    """Measured per-participant sync payload for an engine, from the
    flat spec and the resolved compressor pair.

    ``comm.wire_bytes`` equals ``rep_nbytes(compress(...))`` exactly,
    padding elision included, so this is the measured figure without
    running a compressor.  ``wire_bytes2`` is the level-2 (cross-pod)
    payload on hierarchical engines, None otherwise.
    """
    if engine is None:
        return None
    es = engine.spec
    item = flat.dtype_of(es.dtype).itemsize
    raw = comm_mod.raw_bytes(es.rows, es.lanes, item)
    wires = [comm_mod.wire_bytes(c, rows=es.rows, lanes=es.lanes,
                                 size=es.size, itemsize=item)
             for c in engine.compressors]
    hier = getattr(engine, "grid", None) is not None
    return {
        "raw_bytes": int(raw),
        "wire_bytes": int(wires[0]),
        "wire_bytes2": int(wires[1]) if hier and len(wires) > 1 else None,
    }
