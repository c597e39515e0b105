"""Converter shim between legacy benchmark results and the obs stream
(``repro.obs.convert``, copied).

``results/`` grew three ad-hoc formats before the telemetry subsystem
existed: ``comm_bench.jsonl`` (raw dry-run rows, one JSON object per
line, no schema), ``comm_compress.json`` and ``comm_cohort.json``
(nested dicts with a ``table`` of either one or two key levels).  The
canonical form is now the schema-versioned obs JSONL stream: a
``run_start`` header whose meta carries every non-table field, then one
``bench`` record per table cell:

    {"schema": 1, "event": "bench", "bench": "<kind>",
     "key": ["ssgd/every_step/none", "117187"], "data": {...}}

``key`` is the cell's path inside the legacy ``table`` (one entry per
nesting level; row files use the line index), so ``legacy_view`` can
rebuild the exact legacy object and existing artifact consumers keep
working — the benchmark writes the canonical ``.jsonl`` AND the legacy
``.json`` through this shim.

Round-trip contract (tested): ``legacy_view(records_from_legacy(x))``
equals ``x`` up to JSON's own key stringification (ints used as dict
keys become strings, exactly as ``json.dump`` would emit them).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.obs.metrics import SCHEMA_VERSION, _json_safe, read_metrics


def _is_row(node: Any) -> bool:
    """A table node is a row (emit it) when no value nests further."""
    return isinstance(node, dict) and \
        not any(isinstance(v, dict) for v in node.values())


def _walk(node: Dict[str, Any], key: List[str], out: List[dict],
          kind: str) -> None:
    if _is_row(node):
        out.append({"schema": SCHEMA_VERSION, "event": "bench",
                    "bench": kind, "key": list(key),
                    "data": _json_safe(node)})
        return
    for k, v in node.items():
        if not isinstance(v, dict):
            raise ValueError(
                f"mixed table node at {key + [str(k)]}: rows and "
                f"sub-tables cannot share a level")
        _walk(v, key + [str(k)], out, kind)


def records_from_legacy(obj: Any, kind: str) -> List[Dict[str, Any]]:
    """A legacy results object -> obs records (header + bench rows).

    ``obj`` is either the nested-dict shape (``table`` + scalar meta
    fields, e.g. comm_compress/comm_cohort) or a list of row dicts
    (e.g. the raw comm_bench JSONL lines).
    """
    header = {"schema": SCHEMA_VERSION, "event": "run_start",
              "wall_s": 0.0, "source": "bench", "bench": kind}
    out: List[Dict[str, Any]] = [header]
    if isinstance(obj, list):
        header["meta"] = {}
        for i, row in enumerate(obj):
            if not isinstance(row, dict):
                raise ValueError(f"row {i} of {kind} is not an object")
            out.append({"schema": SCHEMA_VERSION, "event": "bench",
                        "bench": kind, "key": [str(i)],
                        "data": _json_safe(row)})
        return out
    if not isinstance(obj, dict):
        raise ValueError(f"cannot convert {type(obj).__name__} to a "
                         f"bench stream")
    header["meta"] = _json_safe(
        {k: v for k, v in obj.items() if k != "table"})
    table = obj.get("table")
    if table is not None:
        _walk(table, [], out, kind)
    return out


def legacy_view(records: Sequence[Dict[str, Any]]) -> Any:
    """Rebuild the legacy object from an obs bench stream.

    Row streams (every key is a single line index) come back as a list;
    table streams come back as the meta fields + nested ``table``.
    """
    header = next((r for r in records if r.get("event") == "run_start"),
                  None)
    rows = [r for r in records if r.get("event") == "bench"]
    meta = dict((header or {}).get("meta") or {})
    if not meta and rows and all(len(r.get("key", [])) == 1
                                 and r["key"][0].isdigit() for r in rows):
        return [r["data"] for r in rows]
    table: Dict[str, Any] = {}
    for r in rows:
        node = table
        key = r.get("key", [])
        if not key:
            raise ValueError("bench record with an empty key cannot be "
                             "placed in a table")
        for k in key[:-1]:
            node = node.setdefault(k, {})
        node[key[-1]] = r["data"]
    out = dict(meta)
    if table or not rows:
        out["table"] = table
    return out


def write_jsonl(records: Sequence[Dict[str, Any]], path: str) -> str:
    """Write obs records as a canonical JSONL stream."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        for rec in records:
            json.dump(rec, f)
            f.write("\n")
    return path


def write_legacy_json(records: Sequence[Dict[str, Any]], path: str,
                      indent: int = 1) -> str:
    """Write the legacy .json view of an obs bench stream (the shim for
    pre-obs artifact consumers)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(legacy_view(records), f, indent=indent)
    return path


def convert_file(src: str, dst: str, kind: Optional[str] = None) -> str:
    """File-to-file conversion, direction inferred from extensions:
    legacy (.json / raw .jsonl rows) -> obs .jsonl, or obs .jsonl ->
    legacy .json."""
    kind = kind or os.path.splitext(os.path.basename(src))[0]
    if src.endswith(".jsonl"):
        with open(src) as f:
            lines = [json.loads(ln) for ln in f if ln.strip()]
        if lines and all(isinstance(r, dict) and "schema" in r
                         for r in lines):
            return write_legacy_json(read_metrics(src), dst)
        return write_jsonl(records_from_legacy(lines, kind), dst)
    with open(src) as f:
        obj = json.load(f)
    return write_jsonl(records_from_legacy(obj, kind), dst)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(
        description="convert legacy results files <-> obs bench streams")
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--kind", default=None,
                    help="bench kind tag (default: src basename)")
    a = ap.parse_args()
    print(convert_file(a.src, a.dst, kind=a.kind))
