"""Checkpointed resharding (``repro.checkpoint.reshard``): restore a
W-worker flat state onto W' workers.

An elastic restart rarely gets the same fleet back.  ``restore_resharded``
takes a flat-engine checkpoint saved at ``W`` workers (by either package)
and rebuilds a valid ``FlatWorkerState`` for an engine initialized at
``W' != W``, by host-side row surgery on the (W, R, C) buffers — the JAX
package's numpy surgery, operation for operation, so the two restore the
same file to the same bits:

  params / moments   new row j copies saved row ``j % W`` (tiling — every
                     new worker starts at a position the old run actually
                     held, and moments stay consistent with their params)
  delta / bias       tiled the same way, then RECENTRED to zero mean in
                     float64 — the paper's invariant Σ_i Δ_i = 0 (and
                     Σ_i B_i = 0 for BVR) is what makes the first post-
                     restart sync a correct VRL update, and tiling alone
                     breaks it whenever W' is not a multiple of W
  comm residuals     zeroed — error feedback accumulated by the old
                     membership has no meaningful owner in the new one
                     (the first post-restart sync simply compresses a
                     slightly larger payload)
  comm references    kept — the drift reference is membership-independent
  overlap pend       rebuilt from the resharded params (pend_k = 1): the
                     next overlapped collective averages real positions
  step counters      kept — the run resumes its global step
  member             a fresh full mask at W' (the template's own)

The unravel spec is W-independent (it describes one worker's (R, C)
layout), so the same compatibility gate as ``restore_flat_state`` applies
— layout, compressors, and moment storage must match, each failure naming
the field and both values.  Hierarchical (pod-grid) checkpoints are
refused: resharding a (P, D) grid is a topology decision, not row
surgery.  Data assignments are resharded separately with
``data.partition.repartition``.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np

from repro_torch import tree as tree_mod
from repro_torch.checkpoint.checkpoint import (SEP, ArrayFile, Block,
                                               _as_bf16_bits, _carries_comm,
                                               _from_file, _leaf_info, _place,
                                               load_meta, validate_flat_meta)

# rows of the (W, R, C) buffers recentred at a time: the float64 copies of
# a block stay in cache (the elementwise arithmetic, so the result, is the
# same as over the whole buffer at once)
_RECENTER_ROWS = 512


def saved_workers(path: str) -> int:
    """Leading worker-axis size of the checkpoint at ``path``."""
    shapes = load_meta(path).get("shapes", {})
    if "params" not in shapes:
        raise ValueError(
            f"checkpoint at {path!r} has no 'params' entry — not a "
            f"flat-engine state")
    return int(shapes["params"][0])


def _tile(arr: np.ndarray, w_new: int) -> np.ndarray:
    return arr[np.arange(w_new) % arr.shape[0]]


def _bf16_to_f64(bits: np.ndarray) -> np.ndarray:
    """bfloat16 patterns (V2) -> float64 (exact)."""
    u = bits.view(np.uint16).astype(np.uint32) << 16
    return u.view(np.float32).astype(np.float64)


def _f64_to_bf16(x: np.ndarray) -> np.ndarray:
    """float64 -> bfloat16 patterns (V2) as numpy's cast to ml_dtypes'
    bfloat16 makes them: to float32, then to bfloat16, each rounded to
    nearest even."""
    u = x.astype(np.float32).view(np.uint32)
    r = (u + np.uint32(0x7FFF) + ((u >> 16) & 1)) >> 16
    r = np.where(np.isnan(x), (u >> 16) | 0x40, r)
    return r.astype(np.uint16).view(np.dtype("V2"))


def _recenter(arr: np.ndarray, rec: Optional[str]) -> np.ndarray:
    """arr − its mean over the worker axis, in float64, cast back."""
    bf16 = _as_bf16_bits(arr, rec)
    out = np.empty_like(arr)
    rows = out.reshape(arr.shape[0], -1, *arr.shape[-1:]) if arr.ndim > 1 \
        else out[:, None, None]
    src = arr.reshape(rows.shape)
    for i in range(0, rows.shape[1], _RECENTER_ROWS):
        a = src[:, i:i + _RECENTER_ROWS]
        x = _bf16_to_f64(a) if bf16 else a.astype(np.float64)
        x -= x.mean(axis=0, keepdims=True)
        rows[:, i:i + _RECENTER_ROWS] = (_f64_to_bf16(x) if bf16
                                         else x.astype(arr.dtype))
    return out


def restore_resharded(path: str, state_like: Any, spec, *,
                      compressors: dict | None = None,
                      moments: dict | None = None,
                      block: Optional[Block] = None) -> Any:
    """Restore the checkpoint at ``path`` into ``state_like`` (a fresh
    ``engine.init`` state at the NEW worker count), resharding the
    worker axis per the module rules.  ``block``: on a mesh, this rank's
    part of every leaf (the surgery runs on the full arrays first)."""
    recorded = load_meta(path)["meta"]
    if recorded.get("worker_grid") is not None:
        raise ValueError(
            "resharding a hierarchical (pod-grid) checkpoint is not "
            f"supported — recorded grid {recorded['worker_grid']}; "
            "restore onto the same grid, or retrain the pod topology")
    if compressors is None and _carries_comm(state_like):
        raise ValueError(
            "restore target carries compressed-sync buffers (comm.resid/"
            "ref) but no compressor metadata was given — pass compressors="
            "repro_torch.comm.pair_meta(engine.compressors) so the "
            "recorded compressors can be validated")
    validate_flat_meta(recorded, spec, compressors=compressors,
                       moments=moments)
    dtypes = load_meta(path).get("dtypes", {})

    def full(key: str, leaf: Any) -> tuple:
        shape = _leaf_info(leaf)[0]
        return shape if block is None else tuple(block.full_shape(key,
                                                                  shape))

    with ArrayFile(os.path.join(path, "arrays.npz")) as data:
        if "params" not in data:
            raise ValueError(f"checkpoint at {path!r} has no 'params' "
                             f"entry — not a flat-engine state")

        def load(key):
            return _from_file(data[key], dtypes.get(key))

        saved_params = load("params")
        w_old = int(saved_params.shape[0])
        w_new = int(full("params", state_like.params)[0])
        new_params = _tile(saved_params, w_new)

        def one(key: str, leaf: Any) -> Any:
            top = key.split(SEP, 1)[0]
            if top == "member":
                return leaf                          # fresh full mask
            tshape = full(key, leaf)
            rec = dtypes.get(key)
            if top == "overlap":
                rec = "float32"
                if key.endswith("pend"):
                    arr = new_params.astype(np.float32)
                else:                                # pend_k
                    arr = np.ones(tshape, np.float32)
            else:
                if key not in data:
                    raise KeyError(f"checkpoint missing {key!r}")
                arr = load(key)
                if top == "params":
                    arr = new_params
                elif top in ("delta", "bias"):
                    arr = _recenter(_tile(arr, w_new), rec)
                elif top == "comm" and "resid" in key:
                    arr = np.zeros(tshape, np.float32)
                    rec = "float32"
                elif arr.ndim >= 1 and arr.shape[0] == w_old \
                        and tshape[:1] == (w_new,):
                    arr = _tile(arr, w_new)          # moments & friends
            if tshape != tuple(arr.shape):
                raise ValueError(
                    f"{key}: resharded shape {arr.shape} != template "
                    f"{tshape} (saved at W={w_old}, restoring at "
                    f"W={w_new})")
            if block is not None:
                arr = block.take(key, arr)
            return _place(key, arr, rec, leaf)

        return tree_mod.state_map(one, state_like)
