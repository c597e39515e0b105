"""Synthetic datasets — the port's copy of ``repro.data.synthetic``.

Pure numpy with the same draws in the same order, so the port trains on
bitwise the reference's data (``tests/test_torch_train.py``,
``tests/test_torch_paper_data.py``).  The generators mirror the paper's
tasks structurally:

  gaussian_classification — class-conditional Gaussian clusters (the
      paper's feature-extracted tasks).
  feature_classification — fixed random "pretrained extractor" features
      (the transfer-learning task: 2048-d features -> MLP, §6.1).
  lm_token_stream / assigned_token_stream — per-worker unigram-skewed
      token sequences for the transformer configs (non-iid language
      modeling).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ClassificationData:
    x: np.ndarray        # (n, dim) float32
    y: np.ndarray        # (n,) int32
    num_classes: int


def gaussian_classification(n: int = 4096, dim: int = 64,
                            num_classes: int = 10, sep: float = 3.0,
                            seed: int = 0) -> ClassificationData:
    rng = np.random.RandomState(seed)
    centers = (rng.randn(num_classes, dim).astype(np.float32) * sep
               / np.sqrt(dim))
    y = rng.randint(0, num_classes, size=n).astype(np.int32)
    x = centers[y] + rng.randn(n, dim).astype(np.float32)
    return ClassificationData(x=x, y=y, num_classes=num_classes)


def feature_classification(n: int = 8192, dim: int = 2048,
                           num_classes: int = 200,
                           seed: int = 0) -> ClassificationData:
    """Transfer-learning analog: well-separated features from a frozen
    extractor (paper §6.1 uses Inception-V3 2048-d features, 200
    classes)."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(num_classes, dim).astype(np.float32) * 0.15
    y = rng.randint(0, num_classes, size=n).astype(np.int32)
    x = centers[y] + 0.05 * rng.randn(n, dim).astype(np.float32)
    return ClassificationData(x=x, y=y, num_classes=num_classes)


def lm_token_stream(num_workers: int, seq_len: int, vocab: int,
                    steps: int, batch: int, *, alpha: float = 0.1,
                    identical: bool = False, seed: int = 0) -> np.ndarray:
    """(steps, W, batch, seq_len) int32 token batches: each worker samples
    from its own Dirichlet(α)-skewed unigram distribution over a shared
    vocabulary (uniform when ``identical``), each row sorted so the task
    has learnable monotone runs."""
    rng = np.random.RandomState(seed)
    if identical:
        probs = np.ones((num_workers, vocab)) / vocab
    else:
        probs = rng.dirichlet([alpha] * vocab, size=num_workers)
    out = np.empty((steps, num_workers, batch, seq_len), np.int32)
    for w in range(num_workers):
        draws = rng.choice(vocab, size=(steps, batch, seq_len), p=probs[w])
        out[:, w] = np.sort(draws, axis=-1)
    return out


def assigned_token_stream(assignment: list[np.ndarray], seq_len: int,
                          vocab: int, steps: int, batch: int, *,
                          alpha: float = 0.1, identical: bool = False,
                          seed: int = 0) -> np.ndarray:
    """(steps, U, batch, seq_len) int32 token batches for U units under a
    persistent shard→unit assignment.

    ``n_shards = Σ len(assignment[u])`` shard-level Dirichlet(α)-skewed
    unigram distributions are drawn from ``seed`` alone; unit ``u`` samples
    from the MEAN of its assigned shards' distributions, and each row is
    sorted so the task has learnable monotone runs.  With the trivial
    assignment (unit u ↔ shard u) the output is bitwise
    :func:`lm_token_stream`.
    """
    num_units = len(assignment)
    n_shards = int(sum(len(a) for a in assignment))
    rng = np.random.RandomState(seed)
    if identical:
        unit_probs = np.ones((num_units, vocab)) / vocab
    else:
        shard_probs = rng.dirichlet([alpha] * vocab, size=n_shards)
        unit_probs = np.stack(
            [shard_probs[np.asarray(a, dtype=np.int64)].mean(axis=0)
             for a in assignment])
    out = np.empty((steps, num_units, batch, seq_len), np.int32)
    for u in range(num_units):
        draws = rng.choice(vocab, size=(steps, batch, seq_len),
                           p=unit_probs[u])
        out[:, u] = np.sort(draws, axis=-1)
    return out
