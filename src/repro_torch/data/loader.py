"""Deterministic per-worker batch iterator over partitioned datasets — the
port's copy of ``repro.data.loader`` (numpy: bitwise the reference's
batches)."""
from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.data.partition import (
    class_shard_partition,
    dirichlet_partition,
    iid_partition,
)
from repro_torch.data.synthetic import ClassificationData


class WorkerLoader:
    """Yields worker-stacked batches (W, b, ...) forever, deterministically.

    Each worker cycles through its own shard with an independent shuffle
    stream, ``RandomState(seed + 1000 + w)`` — the paper's setup (per-GPU
    disjoint data).
    """

    def __init__(self, data: ClassificationData, num_workers: int,
                 batch: int, *, partition: str = "class_shard",
                 alpha: float = 0.1, seed: int = 0):
        self.data = data
        self.batch = batch
        self.num_workers = num_workers
        if partition == "class_shard":
            self.parts = class_shard_partition(data.y, num_workers, seed)
        elif partition == "dirichlet":
            self.parts = dirichlet_partition(data.y, num_workers, alpha,
                                             seed)
        elif partition == "iid":
            self.parts = iid_partition(len(data.y), num_workers, seed)
        else:
            raise ValueError(partition)
        self._rngs = [np.random.RandomState(seed + 1000 + w)
                      for w in range(num_workers)]
        self._cursors = [np.array([], dtype=np.int64)] * num_workers

    def _next_idx(self, w: int) -> np.ndarray:
        while len(self._cursors[w]) < self.batch:
            perm = self._rngs[w].permutation(self.parts[w])
            self._cursors[w] = np.concatenate([self._cursors[w], perm])
        idx, self._cursors[w] = (self._cursors[w][:self.batch],
                                 self._cursors[w][self.batch:])
        return idx

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        while True:
            idx = [self._next_idx(w) for w in range(self.num_workers)]
            xs = np.stack([self.data.x[i] for i in idx])   # (W, b, dim)
            ys = np.stack([self.data.y[i] for i in idx])   # (W, b)
            yield xs, ys
