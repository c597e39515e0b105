"""Plain PyTorch versions of the engine's fused update kernels.

The port's counterpart of ``repro.kernels.xla_update``: the same
elementwise math over worker-stacked (W, R, C) buffers (and the
hierarchy's pod-major (P, D, R, C) ones), written as tensor ops; and the
per-leaf updates of the tree-update API (``vrl_local_update``,
``vrl_sync_update``), whose oracles are ``repro.kernels.ref``'s.  Each function is the oracle its CUDA kernel (``kernels/vrl_update``)
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

from repro_torch.comm import compressors as cc


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """fp32 square root rounded to nearest, as XLA's and the CUDA
    kernels' ``sqrtf`` are.  PyTorch's vectorised CPU ``sqrt`` is not
    correctly rounded for ~0.6 % of fp32 inputs (its AVX-512 path; one ulp
    off), so on the CPU the root is taken in double and rounded to fp32
    once, which is exact rounding (53 >= 2·24 + 2 bits).  On the card
    ``torch.sqrt`` is IEEE already."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)


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


def fused_local_momentum(p, g, d, m, *, lr: float, beta: float,
                         wd: float = 0.0, nesterov: bool = False,
                         block: int = 0, b=None):
    """Momentum inner step fused with the corrections; returns (p', m').

      v = g − Δ − B + wd·p;  m' = βm + v;  p' = p − γ·(nesterov ? v + βm' : m')
    """
    del block
    v = _corrected(g, d, b)
    p32 = _f32(p)
    if wd:
        v = v + wd * p32
    m_new = beta * _f32(m) + v
    step_dir = v + beta * m_new if nesterov else m_new
    return (p32 - lr * step_dir).to(p.dtype), m_new.to(m.dtype)


def fused_local_adam(p, g, d, mu, nu, scal, *, lr: float, b1: float = 0.9,
                     b2: float = 0.999, eps: float = 1e-8, wd: float = 0.0,
                     block: int = 0, b=None):
    """Adam inner step fused with the corrections; returns (p', mu', nu').

    ``scal``: (1, 2) fp32 = [1 − b1^t, 1 − b2^t] (device-made bias
    corrections, ``optim.adam_scal``).
    """
    del block
    v = _corrected(g, d, b)
    p32 = _f32(p)
    c1 = scal[0, 0]
    c2 = scal[0, 1]
    mu_new = b1 * _f32(mu) + (1.0 - b1) * v
    nu_new = b2 * _f32(nu) + (1.0 - b2) * v * v
    step = lr * (mu_new / c1) / (sqrt_rn(nu_new / c2) + eps)
    if wd:
        step = step + lr * wd * p32
    return ((p32 - step).to(p.dtype), mu_new.to(mu.dtype),
            nu_new.to(nu.dtype))


def _sm3_second_moment(v, row, col, b2: float):
    """v̂ = min(row, col) rebuilt per element, EMA'd with the fresh v²,
    re-factored into the two stats.  ``row``: (..., R, 1); ``col``:
    (..., S, C), one lane-stat row per shard's row span of R/S rows.  fp32
    max is exact and order-free (NaN propagates through min and max), so a
    kernel that accumulates the span's max in any order matches bitwise.
    Returns (nu, row', col')."""
    shards = col.shape[-2]
    span = v.shape[-2] // shards
    col_b = torch.repeat_interleave(_f32(col), span, dim=-2)   # (..., R, C)
    vhat = torch.minimum(_f32(row), col_b)
    nu = b2 * vhat + (1.0 - b2) * v * v
    new_row = nu.amax(dim=-1, keepdim=True)
    spanned = nu.reshape(nu.shape[:-2] + (shards, span, nu.shape[-1]))
    return nu, new_row, spanned.amax(dim=-2)


def fused_local_adam_sm3(p, g, d, mu, row, col, scal, *, lr: float,
                         b1: float = 0.9, b2: float = 0.999,
                         eps: float = 1e-8, wd: float = 0.0,
                         block: int = 0, b=None):
    """SM3-factored Adam inner step fused with the corrections: ``row``
    (W, R, 1) and ``col`` (W, S, C) fp32 stats replace the dense nu.
    Returns (p', mu', row', col')."""
    del block
    v = _corrected(g, d, b)
    p32 = _f32(p)
    c1 = scal[0, 0]
    c2 = scal[0, 1]
    mu_new = b1 * _f32(mu) + (1.0 - b1) * v
    nu, new_row, new_col = _sm3_second_moment(v, row, col, b2)
    step = lr * (mu_new / c1) / (sqrt_rn(nu / c2) + eps)
    if wd:
        step = step + lr * wd * p32
    return ((p32 - step).to(p.dtype), mu_new.to(mu.dtype), new_row,
            new_col)


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


def fused_sync_bvr(p, xbar, d, b, scal, *, beta: float, block: int = 0):
    """BVR-L-SGD sync: the VRL Δ update plus the bias-variate EMA.

      u = (x̂ − p)/(k_eff γ);  Δ' = Δ + u;  B' = (1−β)·B + β·u;  p' = x̂

    Returns (p', Δ', B').
    """
    del block
    xb = _f32(xbar)[None]
    kg = scal[0, 0]
    u = (xb - _f32(p)) / kg
    new_d = (_f32(d) + u).to(d.dtype)
    new_b = ((1.0 - beta) * _f32(b) + beta * u).to(b.dtype)
    new_p = xb.expand(p.shape).to(p.dtype, copy=True)
    return new_p, new_d, new_b


def fused_sync_easgd(p, xbar, center, *, a: float, na: float,
                     block: int = 0):
    """Elastic sync (Zhang et al.); returns (p', x̃').

      p' = p − a·(p − x̃)            a  = easgd_alpha / N
      x̃' = (1 − N·a)·x̃ + N·a·x̂     na = N·a

    ``xbar``/``center``: (R, C); p' reads the OLD center.
    """
    del block
    p32 = _f32(p)
    c = _f32(center)[None]
    new_p = (p32 - a * (p32 - c)).to(p.dtype)
    new_c = ((1.0 - na) * _f32(center) + na * _f32(xbar)).to(center.dtype)
    return new_p, new_c


# ====================================================== overlapped-round fold
# Apply the round-START worker mean's one-round-stale result at round END:
#   c = x̂_stale − pend;  p' = p + c;  Δ' = Δ + c·s₀;  pend' = km·pend +
#   (1−km)·p'
# ``wscal``: the per-worker (W, 2) fp32 [s₀ = 1/(pend_k·γ), miss mask km].
# ``capture=False`` leaves the pend capture to the caller (compressed sync).

def fused_fold_overlap(p, xbar, pend, d, wscal, *, capture: bool = True,
                       block: int = 0):
    """Stale fold for the VRL algorithms; returns (p', Δ'[, pend'])."""
    del block
    pend32 = _f32(pend)
    c = _f32(xbar)[None] - pend32
    pnew = _f32(p) + c
    inv = wscal[:, 0][:, None, None]
    new_d = (_f32(d) + c * inv).to(d.dtype)
    if not capture:
        return pnew.to(p.dtype), new_d
    km = wscal[:, 1][:, None, None]
    new_pend = (km * pend32 + (1.0 - km) * pnew).to(pend.dtype)
    return pnew.to(p.dtype), new_d, new_pend


def fused_fold_overlap_bvr(p, xbar, pend, d, b, wscal, *, beta: float,
                           capture: bool = True, block: int = 0):
    """BVR-L-SGD stale fold: the VRL fold plus
    B' = (1−β)B + β·c·s₀.  Returns (p', Δ', B'[, pend'])."""
    del block
    pend32 = _f32(pend)
    c = _f32(xbar)[None] - pend32
    pnew = _f32(p) + c
    inv = wscal[:, 0][:, None, None]
    new_d = (_f32(d) + c * inv).to(d.dtype)
    new_b = ((1.0 - beta) * _f32(b) + beta * c * inv).to(b.dtype)
    if not capture:
        return pnew.to(p.dtype), new_d, new_b
    km = wscal[:, 1][:, None, None]
    new_pend = (km * pend32 + (1.0 - km) * pnew).to(pend.dtype)
    return pnew.to(p.dtype), new_d, new_b, new_pend


def fused_fold_overlap_avg(p, xbar, pend, wscal, *, capture: bool = True,
                           block: int = 0):
    """Average-sync stale fold (local_sgd, stl_sgd): p' = p + c only.
    Returns (p'[, pend'])."""
    del block
    pend32 = _f32(pend)
    c = _f32(xbar)[None] - pend32
    pnew = _f32(p) + c
    if not capture:
        return (pnew.to(p.dtype),)
    km = wscal[:, 1][:, None, None]
    new_pend = (km * pend32 + (1.0 - km) * pnew).to(pend.dtype)
    return pnew.to(p.dtype), new_pend


def fused_fold_overlap_hier2(p, glob, pend2, d2, wscal, *,
                             capture: bool = True, block: int = 0):
    """Level-2 stale fold on (P, D, R, C) buffers; assumes a level-1 sync
    at the same step (worker params equal their pod average, read off
    worker 0 like ``fused_sync_hier2``).  ``glob``: (R, C); ``pend2``/
    ``d2``: (P, 1, R, C); ``wscal``: (P, 2) [s₀, km] per pod.  Returns
    (p', Δ2'[, pend2'])."""
    del block
    pend32 = _f32(pend2)
    c = _f32(glob)[None, None] - pend32          # (P, 1, R, C) per pod
    pnew = _f32(p) + c                           # broadcast over D
    inv = wscal[:, 0][:, None, None, None]
    new_d2 = (_f32(d2) + c * inv).to(d2.dtype)
    if not capture:
        return pnew.to(p.dtype), new_d2
    km = wscal[:, 1][:, None, None, None]
    pod_new = _f32(p[:, :1]) + c                 # per-pod folded position
    new_pend = (km * pend32 + (1.0 - km) * pod_new).to(pend2.dtype)
    return pnew.to(p.dtype), new_d2, new_pend


# ==================================================== compressed-sync round trip
# The EF round trip of the sync payload's drift: payload = (p − ref) + e,
# then ``comm.compressors.ef_int8`` / ``ef_topk``; resid' = payload − dec,
# so resid' + dec == payload bitwise.  ``ref`` (R, C, broadcast over the
# workers; the grid forms: (P, 1, R, C), broadcast over each pod's D
# workers) and ``e`` may be None (S-SGD's gradient compression has no ref;
# error feedback off has no residual); resid' is then None too.

def _ef_payload(p, ref, e):
    x = _f32(p)
    if ref is not None:
        x = x - _f32(ref)
    if e is not None:
        x = x + _f32(e)
    return x


def fused_ef_int8(p, ref, e, *, block: int = 0):
    """Per-row-scaled int8 EF round trip on (W, R, C); returns (dec fp32,
    resid' or None)."""
    del block
    dec, res = cc.ef_int8(_ef_payload(p, ref, e))
    return dec, (res if e is not None else None)


def fused_ef_topk(p, ref, e, *, k: int, block: int = 0):
    """Top-k (k lanes kept per row) EF round trip on (W, R, C); the
    operand contract of ``fused_ef_int8``."""
    del block
    dec, res = cc.ef_topk(_ef_payload(p, ref, e), k)
    return dec, (res if e is not None else None)


def fused_ef_int8_grid(p, ref, e, *, block: int = 0):
    """Pod-major int8 EF round trip: p, e (P, D, R, C), ref the (P, 1, R,
    C) per-pod reference; returns (dec fp32, resid' or None)."""
    return fused_ef_int8(p, ref, e, block=block)


def fused_ef_topk_grid(p, ref, e, *, k: int, block: int = 0):
    """Pod-major top-k EF round trip; the contract of
    ``fused_ef_int8_grid``."""
    return fused_ef_topk(p, ref, e, k=k, block=block)


# ========================================== hierarchical (P, D, R, C) versions
def fused_hier_local_sgd(p, g, d1, d2, *, lr: float, wd: float = 0.0,
                         block: int = 0) -> torch.Tensor:
    """p' = p − γ((g − Δ1 − Δ2) + wd·p); Δ2 (P, 1, R, C) broadcasts over
    the D workers of its pod."""
    del block
    v = _f32(g) - _f32(d1) - _f32(d2)
    p32 = _f32(p)
    if wd:
        v = v + wd * p32
    return (p32 - lr * v).to(p.dtype)


def fused_sync_hier1(p, xbar_pod, d1, scal, *, block: int = 0):
    """Level-1 sync: Δ1' = Δ1 + (x̂_pod − p)/(k1γ); p' = x̂_pod.
    ``xbar_pod``: (P, 1, R, C); ``scal``: (1, 1) k1_eff·γ.  Returns
    (p', Δ1')."""
    del block
    xb = _f32(xbar_pod)
    kg = scal[0, 0]
    new_d1 = (_f32(d1) + (xb - _f32(p)) / kg).to(d1.dtype)
    new_p = xb.expand(p.shape).to(p.dtype, copy=True)
    return new_p, new_d1


def fused_sync_hier2(p, glob, d2, scal, *, block: int = 0):
    """Level-2 sync: Δ2' = Δ2 + (x̂ − x̂_pod)/(k2γ); p' = x̂.

    Assumes a level-1 sync at the same step, so every worker's params ARE
    its pod average: the (P, 1, R, C) pod average is read off worker 0 of
    each pod.  ``glob``: (R, C); ``scal``: (1, 1) k2_eff·γ.  Returns
    (p', Δ2').
    """
    del block
    glob32 = _f32(glob)[None, None]
    pod = _f32(p[:, :1])
    kg = scal[0, 0]
    new_d2 = (_f32(d2) + (glob32 - pod) / kg).to(d2.dtype)
    new_p = glob32.expand(p.shape).to(p.dtype, copy=True)
    return new_p, new_d2


def fused_hier_local_momentum(p, g, d1, d2, m, *, lr: float, beta: float,
                              wd: float = 0.0, nesterov: bool = False,
                              block: int = 0):
    """Momentum inner step with both Δ corrections: v = g − Δ1 − Δ2
    (+ wd·p); returns (p', m')."""
    del block
    v = _f32(g) - _f32(d1) - _f32(d2)
    p32 = _f32(p)
    if wd:
        v = v + wd * p32
    m_new = beta * _f32(m) + v
    step_dir = v + beta * m_new if nesterov else m_new
    return (p32 - lr * step_dir).to(p.dtype), m_new.to(m.dtype)


def fused_hier_local_adam(p, g, d1, d2, mu, nu, scal, *, lr: float,
                          b1: float = 0.9, b2: float = 0.999,
                          eps: float = 1e-8, wd: float = 0.0,
                          block: int = 0):
    """Adam inner step on v = g − Δ1 − Δ2, dense nu; returns (p', mu',
    nu')."""
    del block
    v = _f32(g) - _f32(d1) - _f32(d2)
    p32 = _f32(p)
    c1 = scal[0, 0]
    c2 = scal[0, 1]
    mu_new = b1 * _f32(mu) + (1.0 - b1) * v
    nu_new = b2 * _f32(nu) + (1.0 - b2) * v * v
    step = lr * (mu_new / c1) / (sqrt_rn(nu_new / c2) + eps)
    if wd:
        step = step + lr * wd * p32
    return ((p32 - step).to(p.dtype), mu_new.to(mu.dtype),
            nu_new.to(nu.dtype))


def fused_hier_local_adam_sm3(p, g, d1, d2, mu, row, col, scal, *,
                              lr: float, b1: float = 0.9, b2: float = 0.999,
                              eps: float = 1e-8, wd: float = 0.0,
                              block: int = 0):
    """Pod-major SM3 Adam on v = g − Δ1 − Δ2: ``row`` (P, D, R, 1),
    ``col`` (P, D, S, C).  Returns (p', mu', row', col')."""
    del block
    v = _f32(g) - _f32(d1) - _f32(d2)
    p32 = _f32(p)
    c1 = scal[0, 0]
    c2 = scal[0, 1]
    mu_new = b1 * _f32(mu) + (1.0 - b1) * v
    nu, new_row, new_col = _sm3_second_moment(v, row, col, b2)
    step = lr * (mu_new / c1) / (sqrt_rn(nu / c2) + eps)
    if wd:
        step = step + lr * wd * p32
    return ((p32 - step).to(p.dtype), mu_new.to(mu.dtype), new_row,
            new_col)


# ============================================== per-leaf (tree-update API)
def vrl_local_update(p, g, d, *, lr: float, block: int = 0) -> torch.Tensor:
    """One leaf's local step, p' = p − γ(g − Δ) in fp32, in p's dtype; Δ is
    first cast to p's dtype, as the tree wrapper casts it.  Bitwise the
    eager oracle ``repro.kernels.ref.vrl_update_ref`` applied to that Δ."""
    del block
    d32 = _f32(d.to(p.dtype))
    return (_f32(p) - lr * (_f32(g) - d32)).to(p.dtype)


def vrl_sync_update(p, xbar, d, *, inv_kg: float, block: int = 0):
    """One leaf's sync: Δ' = Δ + (x̂ − p)·inv_kg (a product by the fp32
    inv_kg, not a division by k·γ) in Δ's dtype, p' = x̂ in p's; x̂
    broadcasts against p.  Returns new (p', Δ'), bitwise the eager oracle
    ``repro.kernels.ref.vrl_sync_ref``."""
    del block
    xb = _f32(xbar)
    new_d = (_f32(d) + (xb - _f32(p)) * inv_kg).to(d.dtype)
    new_p = torch.broadcast_to(xb, p.shape).to(
        p.dtype, memory_format=torch.contiguous_format, copy=True)
    return new_p, new_d
