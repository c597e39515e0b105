"""Plain PyTorch versions of the engine's fused update kernels.

The port's counterpart of ``repro.kernels.xla_update``: the same
elementwise math over worker-stacked (W, R, C) buffers, written as tensor
ops.  Each function is the oracle its CUDA kernel (``kernels/vrl_update``)
is held against, and what the kernel wrappers run for CPU tensors.

The math is the reference's op for op: fp32 in-register values, the same
association order (``_corrected``: g − Δ − B, then + wd·p), the same
output casts, and true division by k_eff·γ in the sync.  Python-float
``lr``/``wd`` meet fp32 tensors as fp32 constants, as JAX's weak-typed
scalars do.  These functions return new tensors; the wrappers write the
result back in place.
"""
from __future__ import annotations

from typing import Optional

import torch


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _corrected(g: torch.Tensor, d: Optional[torch.Tensor],
               b: Optional[torch.Tensor]) -> torch.Tensor:
    """v = g − [Δ] − [B] (same association order as the kernels)."""
    v = _f32(g)
    if d is not None:
        v = v - _f32(d)
    if b is not None:
        v = v - _f32(b)
    return v


def fused_local_sgd(p, g, d=None, *, lr: float, wd: float = 0.0,
                    block: int = 0, b=None) -> torch.Tensor:
    """p' = p − γ((g − Δ − B) + wd·p) on (W, R, C) buffers.

    d=None ⇒ Δ ≡ 0; b (BVR-L-SGD's bias variate) =None ⇒ B ≡ 0."""
    del block
    v = _corrected(g, d, b)
    p32 = _f32(p)
    if wd:
        v = v + wd * p32
    return (p32 - lr * v).to(p.dtype)


def fused_sync_vrl(p, xbar, d, scal, *, block: int = 0):
    """Δ' = Δ + (x̂ − p)/(k_eff γ); p' = x̂ on (W, R, C) buffers.

    ``xbar``: (R, C); ``scal``: (1, 1) fp32 holding k_eff·γ.
    Returns (p', Δ').
    """
    del block
    xb = _f32(xbar)[None]
    kg = scal[0, 0]
    new_d = (_f32(d) + (xb - _f32(p)) / kg).to(d.dtype)
    new_p = xb.expand(p.shape).to(p.dtype, copy=True)
    return new_p, new_d
