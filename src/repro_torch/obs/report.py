"""Render metrics streams: summarize one run, or diff two
(``repro.obs.report``, copied, with the CLI of ``scripts/report.py``).

The input is the schema-versioned JSONL stream ``MetricsWriter`` emits
(``read_metrics`` validates it).  ``summarize`` turns one stream into a
human-readable report: the run header, a sampled loss trajectory, the
algorithm-health diagnostics (max/last invariant residuals, drift, the
ζ² proxy), measured communication volume, the wall-clock phase table,
and the fault/rollback/membership timeline.  ``diff`` lines two runs up
metric-by-metric — the chaos pipeline uses it to show a faulted run
against its clean twin.

Everything here is pure formatting over parsed records so tests can call
it in-process; ``main`` is the command line:

  python -m repro_torch.obs.report run.jsonl              # one-run report
  python -m repro_torch.obs.report clean.jsonl chaos.jsonl  # A-vs-B diff
                                                  # (+ both summaries, -v)

A stream written by either package's ``--metrics`` reads here.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.metrics import read_metrics, run_meta

# events rendered in the timeline section, in stream order
_TIMELINE_EVENTS = ("membership", "rollback", "fault", "checkpoint",
                    "restore", "tail")
_MAX_TIMELINE = 40
_MAX_TRAJECTORY = 12


def load(path: str) -> List[Dict[str, Any]]:
    """Alias for :func:`repro_torch.obs.metrics.read_metrics`."""
    return read_metrics(path)


def _by_event(records: Sequence[Dict[str, Any]], event: str) -> List[dict]:
    return [r for r in records if r.get("event") == event]


def _fmt(v: Any) -> str:
    if v is None:
        return "-"
    if isinstance(v, bool):
        return str(v)
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _sample(rows: List[Any], cap: int = _MAX_TRAJECTORY) -> List[Any]:
    """First, last, and an even stride in between — a glanceable curve."""
    if len(rows) <= cap:
        return rows
    stride = (len(rows) - 1) / (cap - 1)
    idx = sorted({round(i * stride) for i in range(cap)})
    return [rows[i] for i in idx]


def _table(headers: Sequence[str], rows: List[Sequence[Any]]) -> List[str]:
    cells = [[_fmt(c) for c in row] for row in rows]
    widths = [max(len(h), *(len(r[i]) for r in cells)) if cells else len(h)
              for i, h in enumerate(headers)]
    lines = ["  ".join(h.ljust(w) for h, w in zip(headers, widths))]
    lines.append("  ".join("-" * w for w in widths))
    for row in cells:
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
    return lines


def _diag_extrema(records: Sequence[dict]) -> Dict[str, Tuple[float, float]]:
    """{key: (max, last)} over the numeric diag fields present."""
    out: Dict[str, Tuple[float, float]] = {}
    for rec in _by_event(records, "diag"):
        for k, v in rec.items():
            if k in ("schema", "event", "wall_s", "t", "r", "alarms",
                     "rolled_back") or not isinstance(v, (int, float)) \
                    or isinstance(v, bool):
                continue
            prev = out.get(k)
            out[k] = (v if prev is None else max(prev[0], v), v)
    return out


def _comm_totals(records: Sequence[dict]) -> Dict[str, Any]:
    """Total measured sync traffic: Σ wire_bytes * participants."""
    syncs = _by_event(records, "sync")
    total = 0
    known = True
    for s in syncs:
        w = s.get("wire_bytes")
        if w is None:
            known = False
            continue
        n = s.get("participants") or 1
        total += int(w) * int(n)
        w2 = s.get("wire_bytes2")
        if w2 is not None:
            total += int(w2)
    return {"syncs": len(syncs), "bytes": total if syncs and known else None}


def summarize(records: Sequence[Dict[str, Any]],
              label: Optional[str] = None) -> str:
    """One run -> a multi-section plain-text report."""
    meta = run_meta(records)
    lines: List[str] = []
    title = f"run report{f' — {label}' if label else ''}"
    lines += [title, "=" * len(title)]
    if meta:
        head = [f"{k}={_fmt(meta.get(k))}"
                for k in ("arch", "algorithm", "workers", "clients",
                          "steps", "k", "backend", "resolved_backend",
                          "compress", "faults", "guard", "membership")
                if meta.get(k) not in (None, False)]
        lines.append("  ".join(head))
        wire = meta.get("wire") or {}
        if wire.get("wire_bytes"):
            note = (f"  sync wire {wire['wire_bytes'] / 2**20:.2f} MiB"
                    f"/participant (raw {wire['raw_bytes'] / 2**20:.2f}"
                    f" MiB)")
            if wire.get("wire_bytes2"):
                note += f", sync2 {wire['wire_bytes2'] / 2**20:.2f} MiB"
            lines.append(note)

    rounds = _by_event(records, "round")
    evals = _by_event(records, "eval") + _by_event(records, "tail")
    if rounds or evals:
        lines += ["", "loss trajectory"]
        by_t = {e.get("t"): e for e in evals}
        rows = [(rec.get("t"), rec.get("r"), rec.get("loss"),
                 (by_t.get(rec.get("t")) or {}).get("avg_model_loss"))
                for rec in rounds]
        if not rows:                       # per-step runs have only evals
            rows = [(e.get("t"), None, e.get("local_loss"),
                     e.get("avg_model_loss")) for e in evals]
        lines += ["  " + ln for ln in _table(
            ("step", "round", "local_loss", "avg_model_loss"),
            _sample(rows))]

    diag = _diag_extrema(records)
    if diag:
        lines += ["", "algorithm health (diag records: "
                  f"{len(_by_event(records, 'diag'))})"]
        rows = [(k, mx, last) for k, (mx, last) in sorted(diag.items())
                if k != "drift_per_worker"]
        lines += ["  " + ln for ln in _table(("metric", "max", "last"),
                                             rows)]
        alarms = [(r.get("t"), a) for r in _by_event(records, "diag")
                  for a in (r.get("alarms") or [])]
        for t, a in alarms[:10]:
            lines.append(f"  ALARM @step {t}: {a}")
        if len(alarms) > 10:
            lines.append(f"  ... {len(alarms) - 10} more alarms")

    comm = _comm_totals(records)
    if comm["syncs"]:
        vol = ("unknown" if comm["bytes"] is None
               else f"{comm['bytes'] / 2**20:.1f} MiB")
        lines += ["", f"communication: {comm['syncs']} syncs, total "
                  f"measured wire volume {vol}"]

    ends = _by_event(records, "run_end")
    phases = (ends[-1].get("phases") or {}) if ends else {}
    if phases:
        lines += ["", "wall-clock phases"]
        rows = [(name, p.get("n"), p.get("total_s"), p.get("p50_ms"),
                 p.get("p95_ms")) for name, p in phases.items()]
        lines += ["  " + ln for ln in _table(
            ("phase", "n", "total_s", "p50_ms", "p95_ms"), rows)]

    timeline = [r for r in records if r.get("event") in _TIMELINE_EVENTS]
    if timeline:
        lines += ["", "event timeline"]
        for rec in timeline[:_MAX_TIMELINE]:
            body = "  ".join(f"{k}={_fmt(v)}" for k, v in rec.items()
                             if k not in ("schema", "event", "wall_s"))
            lines.append(f"  [{rec.get('wall_s', 0):8.2f}s] "
                         f"{rec['event']:<10s} {body}")
        if len(timeline) > _MAX_TIMELINE:
            lines.append(f"  ... {len(timeline) - _MAX_TIMELINE} more")

    if ends:
        e = ends[-1]
        lines += ["", f"final: steps={_fmt(e.get('steps'))}  "
                  f"avg_model_loss={_fmt(e.get('avg_model_loss'))}  "
                  f"rounds={_fmt(e.get('rounds'))}  "
                  f"wall={_fmt(e.get('wall_s'))}s"]
    else:
        lines += ["", "final: (no run_end record — stream is a partial "
                  "prefix from a crashed or killed run)"]
    return "\n".join(lines)


def _run_metrics(records: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """The comparable scalars of one run, for ``diff``."""
    ends = _by_event(records, "run_end")
    end = ends[-1] if ends else {}
    diag = _diag_extrema(records)
    comm = _comm_totals(records)
    out: Dict[str, Any] = {
        "steps": end.get("steps"),
        "rounds": end.get("rounds", len(_by_event(records, "round"))),
        "avg_model_loss": end.get("avg_model_loss"),
        "wall_s": end.get("wall_s"),
        "syncs": comm["syncs"],
        "wire_MiB_total": (None if comm["bytes"] is None
                           else round(comm["bytes"] / 2**20, 2)),
        "rollbacks": len(_by_event(records, "rollback")),
        "membership_changes": len(_by_event(records, "membership")),
        "checkpoints": len(_by_event(records, "checkpoint")),
    }
    for k in ("delta_residual", "bias_residual", "delta1_residual",
              "delta2_residual", "zeta_sq_proxy", "drift_sq_mean",
              "nonfinite_workers"):
        if k in diag:
            out[f"max_{k}"] = diag[k][0]
    phases = end.get("phases") or {}
    for name, p in phases.items():
        out[f"phase_{name}_s"] = p.get("total_s")
    return out


def diff(a: Sequence[Dict[str, Any]], b: Sequence[Dict[str, Any]],
         labels: Tuple[str, str] = ("A", "B")) -> str:
    """Two runs -> a metric | A | B | delta table."""
    ma, mb = _run_metrics(a), _run_metrics(b)
    keys = list(dict.fromkeys(list(ma) + list(mb)))
    rows = []
    for k in keys:
        va, vb = ma.get(k), mb.get(k)
        delta = (vb - va if isinstance(va, (int, float))
                 and isinstance(vb, (int, float))
                 and not isinstance(va, bool) else None)
        rows.append((k, va, vb, delta))
    title = f"run diff: {labels[0]} vs {labels[1]}"
    lines = [title, "=" * len(title)]
    lines += _table(("metric", labels[0], labels[1], "delta"), rows)
    return "\n".join(lines)


def main(argv=None) -> int:
    """Summarize one metrics stream, or diff two (``scripts/report.py``'s
    command line)."""
    import argparse
    import os

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize one metrics stream, or diff two.")
    ap.add_argument("metrics", help="metrics JSONL file")
    ap.add_argument("other", nargs="?", default=None,
                    help="second metrics file: print a diff instead")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="with two files, also print both summaries")
    args = ap.parse_args(argv)

    a = load(args.metrics)
    if args.other is None:
        print(summarize(a, label=os.path.basename(args.metrics)))
        return 0
    b = load(args.other)
    labels = (os.path.basename(args.metrics), os.path.basename(args.other))
    if args.verbose:
        print(summarize(a, label=labels[0]))
        print()
        print(summarize(b, label=labels[1]))
        print()
    print(diff(a, b, labels=labels))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
