"""Markdown tables of the port's dry run (``scripts/gen_experiments_
tables.py``'s counterpart): the fit matrix (ok or refused, GiB a device)
and the single-grid roofline terms, from the JSONL that ``python -m
repro_torch.launch.dryrun --out PATH`` writes.  Every layer is counted on
meta tensors, so no calibration: the terms are the rows' own, a train
shape's sync collective amortised over K = 20 steps (the card's
constants: NVIDIA H100 SXM5 80GB, 700 W, data sheet).

  PYTHONPATH=src python -m repro_torch.scripts.gen_experiments_tables \\
      [results/dryrun_torch.jsonl ...]
"""
from __future__ import annotations

import sys
from collections import defaultdict

from repro_torch.configs import registry
from repro_torch.scripts.roofline_report import RESULTS, load, terms

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def fmt_gib(b):
    return "?" if (b is None or b < 0) else f"{b/2**30:.1f}"


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    rows = load(argv or RESULTS.split(","))
    by_combo = defaultdict(dict)
    for (arch, shape, mesh, fn), r in rows.items():
        by_combo[(arch, shape, mesh)][fn] = r
    archs = [a for a in registry.list_archs()
             if any(k[0] == a for k in by_combo)]

    print("### Dry run — fit matrix (per device, the port's grid)\n")
    print("| arch | shape | single | GiB/dev | multi | GiB/dev |")
    print("|---|---|---|---|---|---|")
    for arch in archs:
        for shape in SHAPES:
            cells = []
            for mesh in ["single", "multi"]:
                fns = by_combo.get((arch, shape, mesh), {})
                r = (fns.get("train") or fns.get("local")
                     or fns.get("prefill") or fns.get("decode"))
                if r is None:
                    cells += ["—", "—"]
                else:
                    cells += ["OK" if r.get("ok") else "FAIL",
                              fmt_gib(r.get("per_device_bytes"))]
            print(f"| {arch} | {shape} | " + " | ".join(cells) + " |")

    print("\n### Roofline — single-grid terms (per device, per step; "
          "calib=counted)\n")
    print("| arch | shape | compute ms | memory ms | collective ms | "
          "bottleneck | useful ratio | model TFLOPs |")
    print("|---|---|---|---|---|---|---|---|")
    for arch in archs:
        for shape in SHAPES:
            fns = {fn: r for fn, r in
                   by_combo.get((arch, shape, "single"), {}).items()
                   if r.get("ok")}
            t = terms(fns, shape)
            if t is None:
                continue
            tc, tm, tl, bott, useful, row = t
            print(f"| {arch} | {shape} | {tc*1e3:.2f} | {tm*1e3:.2f} | "
                  f"{tl*1e3:.2f} | **{bott}** | {useful:.3f} | "
                  f"{row['model_flops']/1e12:.1f} |")

    fails = [r for r in rows.values() if not r.get("ok")]
    if fails:
        print("\n### Refused or failed\n")
        for r in fails:
            print(f"- {r['arch']}/{r['shape']}/{r['mesh']}/{r['fn']}: "
                  f"{r['error'][:200]}")


if __name__ == "__main__":
    main()
