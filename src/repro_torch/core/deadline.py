"""Straggler deadlines of the overlapped round (``repro.core.engine``
``_miss_mask``, ``_miss_mask2``), drawn on the host with numpy.

Under ``VRLConfig.deadline`` each participant of an overlapped round
(a worker, or for the hierarchy's level-2 fold a pod) misses its capture
with probability ``deadline``: a per-round simulation, since one process
has no per-worker clock.  The reference draws the misses as

    u = jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(0), step),
                           (n, 1))
    miss = u < deadline

and so does this module, bit for bit: the Threefry-2x32 block cipher (20
rounds, Salmon et al. 2011, as JAX implements it), ``fold_in`` as one
cipher call on the counter (0, step), and ``random_bits`` in JAX's
partitionable layout (``jax_threefry_partitionable``, the default since
JAX 0.5): element i of the (n, 1) draw is the cipher of the 64-bit
counter i split into (hi, lo) words, its two output words XORed.  A
uniform fp32 in [0, 1) is then ``(bits >> 9) | 0x3f800000`` read as a
float, minus 1.  The compare is in fp32, as the reference's weak-typed
``deadline`` is.  On a mesh the reference folds each worker axis's index
into the key after the step (``fold_in(key, axis_index(a))``, in the
order of the worker axes; the hierarchy's level 2 folds the pod axis
only), so each rank draws for its own block: ``axis_index`` takes those
indices.  The mask is (n, 1) fp32 {0, 1}; it is made on the host
and copied to the device once per fold.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 cipher of the counter words (x0, x1) (uint32
    arrays of one shape) under ``key`` = (k0, k1); returns the two output
    words."""
    k0, k1 = (np.uint32(k) for k in key)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32).copy()
    x1 = np.asarray(x1, np.uint32).copy()
    with np.errstate(over="ignore"):
        x0 += ks[0]
        x1 += ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 += x1
                x1 = _rotl(x1, r)
                x1 ^= x0
            x0 += ks[(i + 1) % 3]
            x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def fold_in(key, data: int):
    """``jax.random.fold_in``: the cipher of (0, data) under ``key``, data
    taken as uint32."""
    a, b = threefry2x32(key, np.zeros(1, np.uint32),
                        np.array([data], np.uint64).astype(np.uint32))
    return int(a[0]), int(b[0])


def random_bits(key, n: int) -> np.ndarray:
    """``jax.random.bits(key, (n, 1))`` (uint32), partitionable layout:
    element i is the cipher of the 64-bit counter i, its words XORed."""
    i = np.arange(n, dtype=np.uint64)
    a, b = threefry2x32(key, (i >> np.uint64(32)).astype(np.uint32),
                        (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return (a ^ b).reshape(n, 1)


def uniform(step: int, n: int, axis_index: tuple = ()) -> np.ndarray:
    """The reference's per-round draw ``jax.random.uniform(fold_in(
    PRNGKey(0), step), (n, 1))``, fp32 in [0, 1), with each of
    ``axis_index`` folded into the key after the step."""
    key = fold_in((0, 0), step)
    for i in axis_index:
        key = fold_in(key, i)
    bits = random_bits(key, n)
    one = np.uint32(0x3F800000)
    return ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)


def miss_mask(step: int, n: int, deadline: float,
              axis_index: tuple = ()) -> np.ndarray:
    """(n, 1) fp32 miss mask of the round ending at ``step``: 1 where the
    participant missed its capture deadline (``axis_index``: as for
    ``uniform``).  ``deadline`` = 0 is all zeros without a draw (the
    reference's no-deadline program)."""
    if not deadline:
        return np.zeros((n, 1), np.float32)
    return (uniform(step, n, axis_index) < np.float32(deadline)
            ).astype(np.float32)
