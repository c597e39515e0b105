"""Federated-style example on the port (``examples/federated_nonidentical.
py``): the paper's §6 protocol on the transfer-learning analog — 8
workers, disjoint class shards, an MLP on frozen features, k = 20 (the
paper's Table 2 hyper-parameters), with the warm-up ablation.

  PYTHONPATH=src python -m repro_torch.examples.federated_nonidentical
  PYTHONPATH=src python -m repro_torch.examples.federated_nonidentical \\
      --device cpu

The MLP's initial weights are ``paper.task.mlp_init``'s (torch's draws),
so the losses are the port's own; the ordering is the paper's.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.data import feature_classification, label_skew
from repro_torch.data.partition import class_shard_partition
from repro_torch.paper.task import resolve_device, run_mlp_task


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    data = feature_classification(n=4096, dim=256, num_classes=64, seed=0)
    parts = class_shard_partition(data.y, 8, seed=0)
    print(f"8 workers, class-sharded: label skew (TV) = "
          f"{label_skew(data.y, parts):.3f} (1.0 = fully disjoint)")
    results = {}
    for alg, warm in [("ssgd", False), ("vrl_sgd", False),
                      ("vrl_sgd", True), ("local_sgd", False),
                      ("easgd", False)]:
        tag = alg + ("-w" if warm else "")
        losses = run_mlp_task(alg, num_workers=8, batch=32, lr=0.5, k=20,
                              steps=args.steps, partition="class_shard",
                              data=data, warmup=warm, device=device)
        results[tag] = (losses[10], float(np.mean(losses[-20:])))
        print(f"  {tag:12s} loss@10 {results[tag][0]:.4f}  "
              f"final {results[tag][1]:.4f}")
    print("expected ordering (paper Fig. 1): "
          "ssgd ≈ vrl_sgd(-w) < local_sgd < easgd")
    return results


if __name__ == "__main__":
    main()
