"""Non-identical data partitioning — the port's copy of
``repro.data.partition`` (pure numpy, the same draws in the same order).

The paper's *non-identical case* gives each worker a disjoint subset of
classes; the Dirichlet(α) relaxation of the federated-learning literature
and an iid split sit beside it, with a skew metric for the extent of
non-iid, and the shard→unit assignments a resharded resume carries.
"""
from __future__ import annotations

import numpy as np


def class_shard_partition(labels: np.ndarray, num_workers: int,
                          seed: int = 0) -> list[np.ndarray]:
    """The paper's scheme: classes split disjointly across workers."""
    rng = np.random.RandomState(seed)
    classes = np.unique(labels)
    rng.shuffle(classes)
    chunks = np.array_split(classes, num_workers)
    out = []
    for ch in chunks:
        idx = np.flatnonzero(np.isin(labels, ch))
        rng.shuffle(idx)
        out.append(idx)
    return out


def dirichlet_partition(labels: np.ndarray, num_workers: int,
                        alpha: float = 0.1, seed: int = 0) -> list[np.ndarray]:
    """Dirichlet(α) label-skew partition; α→0 approaches class sharding,
    α→∞ approaches iid.  Every worker gets at least one index (a starved
    bucket takes one from the currently largest, ties to the lowest worker
    id), every array is int64; fewer samples than workers raises."""
    if len(labels) < num_workers:
        raise ValueError(
            f"cannot give every worker an index: {len(labels)} samples "
            f"< {num_workers} workers")
    rng = np.random.RandomState(seed)
    classes = np.unique(labels)
    buckets: list[list[int]] = [[] for _ in range(num_workers)]
    for c in classes:
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * num_workers)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for w, part in enumerate(np.split(idx, cuts)):
            buckets[w].extend(part.tolist())
    parts = [np.array(sorted(b), dtype=np.int64) for b in buckets]
    while any(len(p) == 0 for p in parts):
        empty = min(w for w in range(num_workers) if len(parts[w]) == 0)
        donor = max(range(num_workers), key=lambda w: (len(parts[w]), -w))
        parts[empty] = parts[donor][-1:]
        parts[donor] = parts[donor][:-1]
    return parts


def iid_partition(n: int, num_workers: int,
                  seed: int = 0) -> list[np.ndarray]:
    rng = np.random.RandomState(seed)
    idx = rng.permutation(n)
    return list(np.array_split(idx, num_workers))


def repartition(parts: list[np.ndarray],
                num_workers: int) -> list[np.ndarray]:
    """Re-split a partition over another worker count (a resharded
    resume): the old assignment concatenated in worker order and
    ``array_split``, so every index appears once and the old per-worker
    order survives as contiguous runs."""
    if num_workers < 1:
        raise ValueError(f"num_workers must be >= 1, got {num_workers}")
    allidx = np.concatenate(
        [np.asarray(p, dtype=np.int64) for p in parts] or
        [np.empty(0, np.int64)])
    if len(allidx) < num_workers:
        raise ValueError(
            f"cannot give every worker an index: {len(allidx)} indices "
            f"< {num_workers} workers")
    return [np.asarray(p, dtype=np.int64)
            for p in np.array_split(allidx, num_workers)]


def contiguous_assignment(n_shards: int,
                          num_units: int) -> list[np.ndarray]:
    """Fresh shard→unit assignment: ``n_shards`` data shards split
    contiguously over ``num_units`` units (the assignment a run starts
    from)."""
    if num_units < 1:
        raise ValueError(f"num_units must be >= 1, got {num_units}")
    if n_shards < num_units:
        raise ValueError(
            f"cannot give every unit a shard: {n_shards} shards "
            f"< {num_units} units")
    shards = np.arange(n_shards, dtype=np.int64)
    return [np.asarray(p, dtype=np.int64)
            for p in np.array_split(shards, num_units)]


def assignment_to_meta(parts: list[np.ndarray]) -> list[list[int]]:
    """JSON-safe form of an assignment (checkpoint metadata)."""
    return [[int(i) for i in np.asarray(p).ravel()] for p in parts]


def assignment_from_meta(meta: list[list[int]]) -> list[np.ndarray]:
    return [np.asarray(p, dtype=np.int64) for p in meta]


def label_skew(labels: np.ndarray, parts: list[np.ndarray]) -> float:
    """Mean total-variation distance between the workers' label
    distributions and the global one."""
    classes = np.unique(labels)
    global_p = np.array([(labels == c).mean() for c in classes])
    tvs = []
    for idx in parts:
        lp = np.array([(labels[idx] == c).mean() for c in classes])
        tvs.append(0.5 * np.abs(lp - global_p).sum())
    return float(np.mean(tvs))
