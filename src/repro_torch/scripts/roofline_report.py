"""Roofline table from the port's dry-run rows (``benchmarks/
roofline_report.py``'s counterpart).

Reads the JSONL that ``python -m repro_torch.launch.dryrun --out PATH``
writes and prints one CSV row per (arch, shape, mesh): the local step's
(or prefill's, decode's) terms, with a train shape's sync collective
amortised over a period of K = 20 steps.  The dry run counts every layer
on meta tensors, so the reference's two-point calibration (XLA counts a
scanned body once) is not needed: the rows say ``calib=counted``.  The
terms are the card's (``launch.mesh``: NVIDIA H100 SXM5 80GB, 700 W, data
sheet).

  PYTHONPATH=src python -m repro_torch.scripts.roofline_report \\
      [results/dryrun_torch.jsonl ...]
"""
from __future__ import annotations

import json
import os
import sys
from collections import defaultdict

RESULTS = os.environ.get(
    "DRYRUN_RESULTS",
    "results/dryrun_torch.jsonl,results/dryrun_torch_multi.jsonl")
K = 20
KIND = {"train_4k": "local", "prefill_32k": "prefill",
        "decode_32k": "decode", "long_500k": "decode"}


def csv(name: str, us: float, derived: str) -> None:
    print(f"{name},{us:.1f},{derived}", flush=True)


def load(paths) -> dict:
    """{(arch, shape, mesh, fn): row}, the last row of each key winning."""
    dedup = {}
    for path in paths:
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    r = json.loads(line)
                    if "fn" in r:       # engine-mem lines have no fn
                        dedup[(r["arch"], r["shape"], r["mesh"], r["fn"])] = r
    return dedup


def terms(fns: dict, shape: str):
    """(t_compute, t_memory, t_collective, bottleneck, useful ratio, the
    row) of one (arch, shape, mesh), or None without an ok row."""
    row = fns.get(KIND.get(shape, "")) or fns.get("train")
    if row is None:
        return None
    tc, tm, tl = row["t_compute"], row["t_memory"], row["t_collective"]
    if shape == "train_4k" and "sync" in fns:
        tl += fns["sync"].get("t_collective", 0.0) / K
    bott = max((("compute", tc), ("memory", tm), ("collective", tl)),
               key=lambda kv: kv[1])[0]
    flops, chips = row["hlo_flops"], row.get("chips", 1)
    useful = row["model_flops"] / (flops * chips) if flops else 0.0
    return tc, tm, tl, bott, useful, row


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    rows = load(argv or RESULTS.split(","))
    if not rows:
        csv("roofline/missing", 0.0,
            "run python -m repro_torch.launch.dryrun --out PATH first")
        return {}
    by_combo = defaultdict(dict)
    for (arch, shape, mesh, fn), r in rows.items():
        if r.get("ok"):
            by_combo[(arch, shape, mesh)][fn] = r
    out = {}
    for (arch, shape, mesh), fns in sorted(by_combo.items()):
        t = terms(fns, shape)
        if t is None:
            continue
        tc, tm, tl, bott, useful, row = t
        out[(arch, shape, mesh)] = (tc, tm, tl, bott)
        csv(f"roofline/{arch}/{shape}/{mesh}",
            row.get("compile_s", 0) * 1e6,
            f"t_compute_ms={tc*1e3:.3f};t_memory_ms={tm*1e3:.3f};"
            f"t_collective_ms={tl*1e3:.3f};bottleneck={bott};"
            f"useful_ratio={useful:.3f};calib=counted;"
            f"mem_gib={row.get('per_device_bytes', 0)/2**30:.1f}")
    return out


if __name__ == "__main__":
    main()
