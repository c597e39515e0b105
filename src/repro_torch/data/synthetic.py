"""Synthetic non-iid LM token stream — the port's copy of
``repro.data.synthetic.assigned_token_stream``.

Pure numpy with the same draws in the same order, so the port trains on
bitwise the reference's batches (held in ``tests/test_torch_train.py``).
"""
from __future__ import annotations

import numpy as np


def assigned_token_stream(assignment: list[np.ndarray], seq_len: int,
                          vocab: int, steps: int, batch: int, *,
                          alpha: float = 0.1, identical: bool = False,
                          seed: int = 0) -> np.ndarray:
    """(steps, U, batch, seq_len) int32 token batches for U units under a
    persistent shard→unit assignment.

    ``n_shards = Σ len(assignment[u])`` shard-level Dirichlet(α)-skewed
    unigram distributions are drawn from ``seed`` alone; unit ``u`` samples
    from the MEAN of its assigned shards' distributions, and each row is
    sorted so the task has learnable monotone runs.
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
