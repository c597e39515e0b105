"""Fused VRL-SGD update kernels for Hopper — the engine's hot path.

The port's counterpart of ``repro.kernels.vrl_update``: the flat
algorithms' local steps and syncs as single passes over worker-stacked
(W, R, C) buffers, written in place.  Operands take the reference's
dtypes: the parameters (and the mean x̂ given with them) fp32 or bf16, Δ
and B fp32 or bf16 (``VRLConfig.delta_dtype``), the gradient either, the
moments fp32 or bf16; the EASGD center, the overlap pend, the EF
reference, residual and payload and the SM3 stats fp32.  The math is
fp32 in registers and each result is rounded once to its buffer's
dtype.

  local sgd:       p' = p − γ((g − Δ − B) + wd·p)
  local momentum:  m' = βm + v;  p' = p − γ·m'  (v = g − Δ − B + wd·p)
  local adam:      mu, nu EMAs of v;  p' = p − γ(mu/c1)/(√(nu/c2)+eps) − γwd·p
  local adam sm3:  the same with nu rebuilt as b2·min(row, col) + (1−b2)v²;
                   row' = its max over each row, col' = over each shard's
                   row span
  sync vrl:        Δ' = Δ + (x̂ − p)/(k_eff γ);  p' = x̂
  sync bvr:        the vrl sync plus B' = (1−β)B + β(x̂ − p)/(k_eff γ)
  sync easgd:      p' = p − a(p − x̃), then x̃' = (1 − na)x̃ + na·x̂
  EF round trip:   x = (p − ref) + e;  dec = int8 or top-k round trip of x;
                   e' = x − dec (grid form: ref (P, 1, R, C), one per pod)
  overlap fold:    c = x̂_stale − pend;  p' = p + c;  Δ' = Δ + c·s₀;
                   B' = (1−β)B + β·c·s₀;  pend' = km·pend + (1−km)·p'

and the two-level hierarchy's over pod-major (P, D, R, C) buffers, with
Δ2, x̂_pod and pend2 (P, 1, R, C) per pod:

  hier local sgd:  p' = p − γ((g − Δ1 − Δ2) + wd·p)
  hier local momentum, adam, adam sm3: the flat steps on v = g − Δ1 − Δ2
  sync hier1:      Δ1' = Δ1 + (x̂_pod − p)/(k1_eff γ);  p' = x̂_pod
  sync hier2:      Δ2' = Δ2 + (x̂ − p_pod)/(k2_eff γ);  p' = x̂
  fold hier2:      c = x̂_stale − pend2;  p' = p + c;  Δ2' = Δ2 + c·s₀;
                   pend2' = km·pend2 + (1−km)·p'_pod

and the per-leaf updates of the tree-update API (``kernels/ops``), over
one parameter leaf of any shape, fp32 or bf16, into new tensors:

  leaf local:      p' = p − γ(g − Δ)    (Δ rounded to p's dtype first)
  leaf sync:       Δ' = Δ + (x̂ − p)·inv_kg;  p' = x̂

Each wrapper takes its kernel for CUDA tensors (``csrc/vrl_update.cu`` for
the local steps, the syncs and the hierarchy, ``csrc/comm_update.cu`` for
the EF round trip and the flat fold, ``csrc/leaf_update.cu`` for the
per-leaf pair, built at first use by ``kernels/build``) and the plain PyTorch version (``kernels/torch_update``)
for CPU tensors; a CUDA tensor never falls back to the plain version.  ``LAUNCHES`` counts kernel launches per wrapper (a
CPU call is not a launch), so a run can show that its main path went
through the kernels.  Meta tensors (the dry run, ``launch.dryrun``) are
checked as any others, then charged to ``kernels.costs.CHARGES`` (the
kernel's name, shape and work; not a launch) and returned as they came,
a new output as a new meta tensor: nothing reaches ``ctypes``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import costs
from repro_torch.kernels import torch_update as tu

LAUNCHES = {"fused_local_sgd": 0, "fused_local_momentum": 0,
            "fused_local_adam": 0, "fused_sync_vrl": 0, "fused_sync_bvr": 0,
            "fused_sync_easgd": 0, "fused_ef_int8": 0, "fused_ef_topk": 0,
            "fused_fold_overlap": 0, "fused_fold_overlap_bvr": 0,
            "fused_fold_overlap_avg": 0, "fused_hier_local_sgd": 0,
            "fused_sync_hier1": 0, "fused_sync_hier2": 0,
            "fused_fold_overlap_hier2": 0, "fused_local_adam_sm3": 0,
            "fused_hier_local_momentum": 0, "fused_hier_local_adam": 0,
            "fused_hier_local_adam_sm3": 0, "fused_ef_int8_grid": 0,
            "fused_ef_topk_grid": 0, "vrl_local_update": 0,
            "vrl_sync_update": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_PTR = ctypes.c_void_p


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as void*, sizes as int64, so nothing is cut to 32 bits)."""
    lib = build.load("vrl_update")
    f32, i64, cint = ctypes.c_float, ctypes.c_int64, ctypes.c_int
    lib.vrl_fused_local_sgd.argtypes = [_PTR, _PTR, _PTR, _PTR, cint, f32,
                                        f32, i64, _PTR]
    lib.vrl_fused_local_sgd.restype = ctypes.c_int
    lib.vrl_fused_sync_vrl.argtypes = [_PTR, _PTR, _PTR, _PTR, cint, i64,
                                       i64, _PTR]
    lib.vrl_fused_sync_vrl.restype = ctypes.c_int
    lib.vrl_fused_local_momentum.argtypes = [
        _PTR, _PTR, _PTR, _PTR, _PTR, ctypes.c_int, f32, f32, f32,
        ctypes.c_int, i64, _PTR]
    lib.vrl_fused_local_momentum.restype = ctypes.c_int
    lib.vrl_fused_local_adam.argtypes = [
        _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, ctypes.c_int, _PTR,
        f32, f32, f32, f32, f32, f32, f32, f32, i64, _PTR]
    lib.vrl_fused_local_adam.restype = ctypes.c_int
    lib.vrl_fused_sync_bvr.argtypes = [_PTR, _PTR, _PTR, _PTR, _PTR, cint,
                                       f32, f32, i64, i64, _PTR]
    lib.vrl_fused_sync_bvr.restype = ctypes.c_int
    lib.vrl_fused_sync_easgd.argtypes = [_PTR, _PTR, _PTR, cint, f32, f32,
                                         f32, i64, i64, _PTR]
    lib.vrl_fused_sync_easgd.restype = ctypes.c_int
    lib.vrl_fused_hier_local_sgd.argtypes = [_PTR, _PTR, _PTR, _PTR, cint,
                                             f32, f32, i64, i64, i64, _PTR]
    lib.vrl_fused_hier_local_sgd.restype = ctypes.c_int
    for fn in (lib.vrl_fused_sync_hier1, lib.vrl_fused_sync_hier2):
        fn.argtypes = [_PTR, _PTR, _PTR, _PTR, cint, i64, i64, i64, _PTR]
        fn.restype = ctypes.c_int
    lib.vrl_fused_fold_hier2.argtypes = [_PTR, _PTR, _PTR, _PTR, _PTR,
                                         cint, cint, i64, i64, i64, _PTR]
    lib.vrl_fused_fold_hier2.restype = ctypes.c_int
    lib.vrl_fused_hier_local_momentum.argtypes = [
        _PTR, _PTR, _PTR, _PTR, _PTR, ctypes.c_int, f32, f32, f32,
        ctypes.c_int, i64, i64, i64, _PTR]
    lib.vrl_fused_hier_local_momentum.restype = ctypes.c_int
    lib.vrl_fused_hier_local_adam.argtypes = [
        _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, ctypes.c_int, _PTR,
        f32, f32, f32, f32, f32, f32, f32, f32, i64, i64, i64, _PTR]
    lib.vrl_fused_hier_local_adam.restype = ctypes.c_int
    lib.vrl_fused_local_adam_sm3.argtypes = [
        _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, ctypes.c_int, _PTR,
        f32, f32, f32, f32, f32, f32, f32, f32, i64, i64, i64, i64, i64,
        _PTR]
    lib.vrl_fused_local_adam_sm3.restype = ctypes.c_int
    return lib


@functools.cache
def _comm_lib() -> ctypes.CDLL:
    """The compressed/overlapped-sync library with its C signatures."""
    lib = build.load("comm_update")
    f32, i64, cint = ctypes.c_float, ctypes.c_int64, ctypes.c_int
    lib.vrl_fused_ef.argtypes = [_PTR, _PTR, _PTR, _PTR, cint, cint, cint,
                                 i64, i64, i64, i64, i64, _PTR]
    lib.vrl_fused_ef.restype = cint
    lib.vrl_fused_fold.argtypes = [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, cint,
                                   f32, f32, cint, i64, i64, _PTR]
    lib.vrl_fused_fold.restype = cint
    return lib


_MOMENT_DTYPES = (torch.float32, torch.bfloat16)
_FLOATS = _MOMENT_DTYPES
# operands by role (the reference's kernels read each through _f32 and cast
# each result to its buffer's dtype): the parameters and the mean x̂ come
# in one dtype, the drift buffers (Δ, B; the hierarchy's Δ1, Δ2) in one,
# the gradient in either; every other operand is fp32
_PARAMS = ("p", "xbar", "xbar_pod", "glob")
_DRIFT = ("d", "b", "d1", "d2")
# the C functions' dtype mask (csrc/vrl_update.cu, comm_update.cu)
_DT_P, _DT_G, _DT_D, _DT_M = 1, 2, 4, 8


def _check(name: str, lead: torch.Tensor, *, moments=(), fp32=(),
           grid=False, strided=(), **tensors) -> None:
    """Raise on what the kernels do not take: p not (W, R, C) (with
    ``grid``: not (P, D, R, C)); dtypes off their roles — p and x̂ (and
    the hierarchy's x̂_pod, glob) fp32 or bf16, all in p's dtype; Δ and B
    (Δ1, Δ2) fp32 or bf16, of one dtype; g fp32 or bf16; the moments named
    in ``moments`` fp32 or bf16, of one dtype; every other operand, and
    those named in ``fp32``, fp32; mixed devices, non-contiguous or
    misaligned buffers (those named in ``strided`` may hold their
    contiguous (R, C) worker slices a stride apart, see
    ``_worker_stride``), lanes not a multiple of 4."""
    if lead.dim() != (4 if grid else 3):
        raise ValueError(f"{name}: p must be "
                         f"{'(P, D, R, C)' if grid else '(W, R, C)'}, got "
                         f"{tuple(lead.shape)}")
    if lead.shape[-1] % 4:
        raise ValueError(f"{name}: lanes {lead.shape[-1]} not a multiple of 4")
    roles = {"parameters": [], "drift": [], "moments": []}
    for key, t in tensors.items():
        if t is None:
            continue
        role = (None if key in fp32 else "parameters" if key in _PARAMS
                else "drift" if key in _DRIFT else "moments"
                if key in moments else "g" if key == "g" else None)
        allowed = (torch.float32,) if role is None else _FLOATS
        if t.dtype not in allowed:
            raise TypeError(f"{name}: {key} is {t.dtype}; the kernels take "
                            f"{' or '.join(map(str, allowed))} there")
        if role in roles:
            roles[role].append((key, t.dtype))
        if t.device != lead.device:
            raise ValueError(f"{name}: {key} on {t.device}, p on "
                             f"{lead.device}")
        if not (t.is_contiguous() or key in strided):
            raise ValueError(f"{name}: {key} is not contiguous")
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} is not 16-byte aligned")
    for role, seen in roles.items():
        if len({dt for _, dt in seen}) > 1:
            raise TypeError(f"{name}: the {role} {dict(seen)} differ in "
                            f"dtype; the kernels take one dtype there")
    if lead.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name}: unsupported device {lead.device}")


def _bf(t: Optional[torch.Tensor]) -> bool:
    return t is not None and t.dtype == torch.bfloat16


def _dtypes(p: torch.Tensor, g=None, d=None, m=None) -> int:
    """The C functions' dtype mask: which of p (and x̂), g, the drift
    buffers and the moments are bf16."""
    return (_DT_P * _bf(p) | _DT_G * _bf(g) | _DT_D * _bf(d)
            | _DT_M * _bf(m))


def _items(p: torch.Tensor, g=None, d=None) -> dict:
    """The operands' element sizes for ``kernels.costs``: pb (p, x̂), gb
    (g), db (Δ, B)."""
    out = {"pb": p.element_size()}
    if g is not None:
        out["gb"] = g.element_size()
    if d is not None:
        out["db"] = d.element_size()
    return out


def _dry(name: str, p: torch.Tensor, out, **opts):
    """A call on meta tensors: charged to the dry run (``kernels.costs``)
    with the options of its work, then ``out`` as the kernel would return
    it; nothing is launched."""
    costs.charge(name, tuple(p.shape), **opts)
    return out


def _worker_stride(name: str, p: torch.Tensor) -> int:
    """Elements between consecutive workers of a (W, R, C) ``p`` whose
    (R, C) slices are contiguous but may lie a stride apart: the pod rows
    ``params[:, 0]`` of a (P, D, R, C) buffer, which the hierarchy's
    level 2 compresses in place rather than copy."""
    w, r, c = p.shape
    stride = p.stride(0) if w > 1 else r * c
    if p.stride()[1:] != (c, 1) or stride < r * c or stride % 4:
        raise ValueError(f"{name}: p's (R, C) worker slices are not "
                         f"contiguous, or lie closer than R·C or off a "
                         f"multiple of 4 apart (strides {p.stride()})")
    return stride


def _drift(d: Optional[torch.Tensor], b: Optional[torch.Tensor]):
    """The drift operand whose dtype stands for both Δ and B."""
    return d if d is not None else b


def _raise_on(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error "
                           f"{err}") from torch.cuda.CudaError(err)


def _same_shape(name: str, p: torch.Tensor, **tensors) -> None:
    for key, t in tensors.items():
        if t is not None and t.shape != p.shape:
            raise ValueError(f"{name}: {key} {tuple(t.shape)} != p "
                             f"{tuple(p.shape)}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _adam_consts(lr, b1, b2, eps, wd):
    """Adam's scalar arguments, each derived constant rounded from double
    once (as JAX's weak-typed Python scalars are)."""
    return (float(lr), float(b1), float(1.0 - b1), float(b2),
            float(1.0 - b2), float(eps), float(wd), float(lr * wd))


# Replaces repro/kernels/vrl_update.py:152 fused_local_sgd (Pallas, TPU).
# Bound: device-memory bandwidth — reads p, g, Δ [, B] and writes p once
# (16 B per element with Δ); a handful of flops per element.  Design: one
# float4 grid-stride pass in place over p (the Pallas kernel aliases p).
def fused_local_sgd(p: torch.Tensor, g: torch.Tensor,
                    d: Optional[torch.Tensor] = None, *, lr: float,
                    wd: float = 0.0, block: int = 0,
                    b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """p ← p − γ((g − Δ − B) + wd·p) in place on (W, R, C); returns p.

    d=None ⇒ Δ ≡ 0; b=None ⇒ B ≡ 0.  ``block`` is accepted and ignored.
    """
    del block
    _check("fused_local_sgd", p, p=p, g=g, d=d, b=b)
    _same_shape("fused_local_sgd", p, g=g, d=d, b=b)
    if p.device.type == "cpu":
        return p.copy_(tu.fused_local_sgd(p, g, d, lr=lr, wd=wd, b=b))
    if p.device.type == "meta":
        return _dry("fused_local_sgd", p, p, use_d=d is not None, wd=wd,
                    use_b=b is not None, **_items(p, g, _drift(d, b)))
    lib = _lib()
    with torch.cuda.device(p.device):
        err = lib.vrl_fused_local_sgd(
            p.data_ptr(), g.data_ptr(), _ptr(d), _ptr(b),
            _dtypes(p, g, _drift(d, b)), float(lr), float(wd), p.numel(),
            _stream(p))
    _raise_on("fused_local_sgd", err)
    LAUNCHES["fused_local_sgd"] += 1
    return p


# Replaces repro/kernels/vrl_update.py:351 fused_sync_vrl (Pallas, TPU).
# Bound: device-memory bandwidth — reads p, Δ (W·R·C each) and x̂ (R·C)
# once, writes p and Δ.  Design: each thread loads one float4 of x̂ and
# walks the W workers with it from a register, so x̂ is read once and never
# expanded; k_eff·γ is read from the device tensor ``scal`` (no host sync).
def fused_sync_vrl(p: torch.Tensor, xbar: torch.Tensor, d: torch.Tensor,
                   scal: torch.Tensor, *, block: int = 0):
    """Δ ← Δ + (x̂ − p)/(k_eff γ); p ← x̂, in place; returns (p, Δ).

    ``xbar``: (R, C); ``scal``: (1, 1) fp32 holding k_eff·γ.
    """
    del block
    _check("fused_sync_vrl", p, p=p, xbar=xbar, d=d, scal=scal)
    if d.shape != p.shape or tuple(xbar.shape) != tuple(p.shape[1:]):
        raise ValueError(f"fused_sync_vrl: shapes p {tuple(p.shape)}, "
                         f"xbar {tuple(xbar.shape)}, d {tuple(d.shape)}")
    if scal.numel() != 1:
        raise ValueError(f"fused_sync_vrl: scal must hold one value, got "
                         f"{tuple(scal.shape)}")
    if p.device.type == "cpu":
        new_p, new_d = tu.fused_sync_vrl(p, xbar, d, scal.reshape(1, 1))
        return p.copy_(new_p), d.copy_(new_d)
    if p.device.type == "meta":
        return _dry("fused_sync_vrl", p, (p, d), **_items(p, d=d))
    lib = _lib()
    w = p.shape[0]
    with torch.cuda.device(p.device):
        err = lib.vrl_fused_sync_vrl(
            p.data_ptr(), d.data_ptr(), xbar.data_ptr(), scal.data_ptr(),
            _dtypes(p, d=d), w, p.numel() // max(w, 1), _stream(p))
    _raise_on("fused_sync_vrl", err)
    LAUNCHES["fused_sync_vrl"] += 1
    return p, d


# Replaces repro/kernels/vrl_update.py:188 fused_local_momentum (Pallas,
# TPU).  Bound: device-memory bandwidth — reads p, g [, Δ, B], m and writes
# p, m once (20 B per fp32 element without Δ); ~6 flops per element.
# Design: as fused_local_sgd, one float4 pass in place over p and m (the
# Pallas kernel aliases both), m loaded and stored as fp32 or bf16.
def fused_local_momentum(p: torch.Tensor, g: torch.Tensor,
                         d: Optional[torch.Tensor], m: torch.Tensor, *,
                         lr: float, beta: float, wd: float = 0.0,
                         nesterov: bool = False, block: int = 0,
                         b: Optional[torch.Tensor] = None):
    """m ← βm + v; p ← p − γ·(nesterov ? v + βm : m), v = g − Δ − B + wd·p,
    in place on (W, R, C); returns (p, m).  d/b None ⇒ Δ/B ≡ 0; ``block``
    is accepted and ignored."""
    del block
    name = "fused_local_momentum"
    _check(name, p, moments=("m",), p=p, g=g, d=d, b=b, m=m)
    _same_shape(name, p, g=g, d=d, b=b, m=m)
    if p.device.type == "cpu":
        new_p, new_m = tu.fused_local_momentum(p, g, d, m, lr=lr, beta=beta,
                                               wd=wd, nesterov=nesterov, b=b)
        return p.copy_(new_p), m.copy_(new_m)
    if p.device.type == "meta":
        return _dry(name, p, (p, m), wd=wd, use_d=d is not None,
                    use_b=b is not None, m_bytes=m.element_size(),
                    **_items(p, g, _drift(d, b)))
    lib = _lib()
    with torch.cuda.device(p.device):
        err = lib.vrl_fused_local_momentum(
            p.data_ptr(), g.data_ptr(), _ptr(d), _ptr(b), m.data_ptr(),
            _dtypes(p, g, _drift(d, b), m), float(lr), float(beta),
            float(wd), int(bool(nesterov)), p.numel(), _stream(p))
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return p, m


# Replaces repro/kernels/vrl_update.py:230 fused_local_adam (Pallas, TPU).
# Bound: device-memory bandwidth — reads p, g [, Δ, B], mu, nu and writes
# p, mu, nu once (36 B per fp32 element with Δ and B); ~20 flops, one
# sqrt and two divisions per element.  Design: one float4 pass in place
# over p, mu and nu; the bias corrections [c1, c2] are read from the (1, 2)
# device tensor ``scal`` (no host sync); every constant derived from the
# hyper-parameters (1 − b1, 1 − b2, γ·wd) is rounded from double once, here.
def fused_local_adam(p: torch.Tensor, g: torch.Tensor,
                     d: Optional[torch.Tensor], mu: torch.Tensor,
                     nu: torch.Tensor, scal: torch.Tensor, *, lr: float,
                     b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                     wd: float = 0.0, block: int = 0,
                     b: Optional[torch.Tensor] = None):
    """Adam inner step fused with the corrections, in place on (W, R, C);
    returns (p, mu, nu).  ``scal``: (1, 2) fp32 [1 − b1^t, 1 − b2^t]."""
    del block
    name = "fused_local_adam"
    _check(name, p, moments=("mu", "nu"), p=p, g=g, d=d, b=b, mu=mu, nu=nu,
           scal=scal)
    _same_shape(name, p, g=g, d=d, b=b, mu=mu, nu=nu)
    if scal.numel() != 2:
        raise ValueError(f"{name}: scal must hold [c1, c2], got "
                         f"{tuple(scal.shape)}")
    if p.device.type == "cpu":
        outs = tu.fused_local_adam(p, g, d, mu, nu, scal.reshape(1, 2),
                                   lr=lr, b1=b1, b2=b2, eps=eps, wd=wd, b=b)
        return tuple(t.copy_(o) for t, o in zip((p, mu, nu), outs))
    if p.device.type == "meta":
        return _dry(name, p, (p, mu, nu), wd=wd, use_d=d is not None,
                    use_b=b is not None, m_bytes=mu.element_size(),
                    **_items(p, g, _drift(d, b)))
    lib = _lib()
    with torch.cuda.device(p.device):
        err = lib.vrl_fused_local_adam(
            p.data_ptr(), g.data_ptr(), _ptr(d), _ptr(b), mu.data_ptr(),
            nu.data_ptr(), _dtypes(p, g, _drift(d, b), mu), scal.data_ptr(),
            *_adam_consts(lr, b1, b2, eps, wd), p.numel(), _stream(p))
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return p, mu, nu


# Replaces repro/kernels/vrl_update.py:302 fused_local_adam_sm3 (Pallas,
# TPU).  Bound: device-memory bandwidth — reads p, g [, Δ, B], mu and the
# row stat once, writes p, mu and the row stat (24 R·C-buffers plus the row
# stat at W = 4 with Δ and fp32 mu); the lane stat is 4 KiB.  ~22 flops,
# one sqrt and two divisions per element.  Design (csrc/vrl_update.cu,
# adam_sm3_kernel): one warp per (worker, 256-lane row) rebuilds
# v̂ = min(row, col) from the row stat and the OLD lane stat held in
# registers, takes the row max with a warp reduction and writes the row
# stat in place; each block of rows within one shard span folds its lanes'
# max into a new zeroed lane-stat buffer with one atomicMax per lane (the
# Pallas kernel does not donate col either: every row of a span reads the
# old one).  Max over bits of nu ≥ +0 is exact and order-free, so the
# result is bitwise the plain version's.
_SM3_MAX_LANES = 1024


def _check_sm3(name: str, p: torch.Tensor, row: torch.Tensor,
               col: torch.Tensor) -> None:
    """row (..., R, 1) and col (..., S, C) beside p (..., R, C), R % S ==
    0; on the card lanes a multiple of 128 up to 1,024 (a warp per row)."""
    lead, r, c = tuple(p.shape[:-2]), p.shape[-2], p.shape[-1]
    shards = col.shape[-2] if col.dim() == p.dim() else 0
    if (tuple(row.shape) != lead + (r, 1)
            or tuple(col.shape) != lead + (shards, c) or shards < 1):
        raise ValueError(f"{name}: row {tuple(row.shape)} / col "
                         f"{tuple(col.shape)} are not the stats of p "
                         f"{tuple(p.shape)}: want {lead + (r, 1)} and "
                         f"{lead + ('S', c)}")
    if r % shards:
        raise ValueError(f"{name}: {r} rows do not split into {shards} "
                         f"shard spans")
    if p.device.type == "cuda" and (c % 128 or c > _SM3_MAX_LANES):
        raise ValueError(f"{name}: the kernel takes rows of 128·n lanes up "
                         f"to {_SM3_MAX_LANES}, got {c}")



def _adam_sm3(name, p, g, d, b, mu, row, col, scal, b_div, consts):
    workers = p.numel() // max(p.shape[-2] * p.shape[-1], 1)
    col_out = torch.empty_like(col)
    lib = _lib()
    with torch.cuda.device(p.device):
        err = lib.vrl_fused_local_adam_sm3(
            p.data_ptr(), g.data_ptr(), _ptr(d), _ptr(b), mu.data_ptr(),
            row.data_ptr(), col.data_ptr(), col_out.data_ptr(),
            _dtypes(p, g, _drift(d, b), mu), scal.data_ptr(), *consts,
            workers, b_div, p.shape[-2], p.shape[-1], col.shape[-2],
            _stream(p))
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return p, mu, row, col_out


def fused_local_adam_sm3(p: torch.Tensor, g: torch.Tensor,
                         d: Optional[torch.Tensor], mu: torch.Tensor,
                         row: torch.Tensor, col: torch.Tensor,
                         scal: torch.Tensor, *, lr: float, b1: float = 0.9,
                         b2: float = 0.999, eps: float = 1e-8,
                         wd: float = 0.0, block: int = 0,
                         b: Optional[torch.Tensor] = None):
    """SM3-factored Adam inner step fused with the corrections on (W, R,
    C): ``row`` (W, R, 1) and ``col`` (W, S, C) fp32 stats (S shard spans
    of R/S rows) replace the dense nu.  p, mu and row are updated in place;
    the new lane stat is a new tensor (every row reads the old one).
    Returns (p, mu, row, col').  ``scal``: (1, 2) fp32 [c1, c2]."""
    del block
    name = "fused_local_adam_sm3"
    _check(name, p, moments=("mu",), p=p, g=g, d=d, b=b, mu=mu, row=row,
           col=col, scal=scal)
    _same_shape(name, p, g=g, d=d, b=b, mu=mu)
    _check_sm3(name, p, row, col)
    if scal.numel() != 2:
        raise ValueError(f"{name}: scal must hold [c1, c2], got "
                         f"{tuple(scal.shape)}")
    if p.device.type == "cpu":
        new_p, new_mu, new_row, new_col = tu.fused_local_adam_sm3(
            p, g, d, mu, row, col, scal.reshape(1, 2), lr=lr, b1=b1, b2=b2,
            eps=eps, wd=wd, b=b)
        return p.copy_(new_p), mu.copy_(new_mu), row.copy_(new_row), new_col
    if p.device.type == "meta":
        return _dry(name, p, (p, mu, row, torch.empty_like(col)),
                    use_d=d is not None, use_b=b is not None,
                    mu_bytes=mu.element_size(), wd=wd, shards=col.shape[-2],
                    **_items(p, g, _drift(d, b)))
    return _adam_sm3(name, p, g, d, b, mu, row, col, scal, 1,
                     _adam_consts(lr, b1, b2, eps, wd))


# Replaces repro/kernels/vrl_update.py:388 fused_sync_bvr (Pallas, TPU).
# Bound: device-memory bandwidth — reads p, Δ, B (W·R·C each) and x̂ (R·C)
# once, writes p, Δ, B.  Design: as fused_sync_vrl, one float4 of x̂ per
# thread walks the W workers from a register; k_eff·γ read from ``scal``.
def fused_sync_bvr(p: torch.Tensor, xbar: torch.Tensor, d: torch.Tensor,
                   b: torch.Tensor, scal: torch.Tensor, *, beta: float,
                   block: int = 0):
    """u = (x̂ − p)/(k_eff γ); Δ ← Δ + u; B ← (1−β)B + βu; p ← x̂, in place;
    returns (p, Δ, B).  ``xbar``: (R, C); ``scal``: (1, 1) k_eff·γ."""
    del block
    name = "fused_sync_bvr"
    _check(name, p, p=p, xbar=xbar, d=d, b=b, scal=scal)
    _same_shape(name, p, d=d, b=b)
    if tuple(xbar.shape) != tuple(p.shape[1:]):
        raise ValueError(f"{name}: xbar {tuple(xbar.shape)} is not one "
                         f"worker of p {tuple(p.shape)}")
    if scal.numel() != 1:
        raise ValueError(f"{name}: scal must hold one value, got "
                         f"{tuple(scal.shape)}")
    if p.device.type == "cpu":
        outs = tu.fused_sync_bvr(p, xbar, d, b, scal.reshape(1, 1),
                                 beta=beta)
        return tuple(t.copy_(o) for t, o in zip((p, d, b), outs))
    if p.device.type == "meta":
        return _dry(name, p, (p, d, b), **_items(p, d=d))
    lib = _lib()
    w = p.shape[0]
    with torch.cuda.device(p.device):
        err = lib.vrl_fused_sync_bvr(
            p.data_ptr(), d.data_ptr(), b.data_ptr(), xbar.data_ptr(),
            scal.data_ptr(), _dtypes(p, d=d), float(1.0 - beta),
            float(beta), w,
            p.numel() // max(w, 1), _stream(p))
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return p, d, b


# Replaces repro/kernels/vrl_update.py:618 fused_sync_easgd (Pallas, TPU:
# two pallas_calls, :636 and :646).  Bound: device-memory bandwidth — the
# worker pass reads p and x̃ and writes p, the center pass reads x̃, x̂ and
# writes x̃.  Design: two launches on the caller's stream, the worker pass
# first (it reads the OLD center; stream order gives the ordering that
# XLA's alias analysis gives the reference), each x̃ float4 walking the W
# workers from a register.  One call counts as one launch.
def fused_sync_easgd(p: torch.Tensor, xbar: torch.Tensor,
                     center: torch.Tensor, *, a: float, na: float,
                     block: int = 0):
    """p ← p − a(p − x̃), then x̃ ← (1 − na)x̃ + na·x̂, in place; returns
    (p, x̃).  ``xbar``/``center``: (R, C) fp32."""
    del block
    name = "fused_sync_easgd"
    _check(name, p, fp32=("xbar",), p=p, xbar=xbar, center=center)
    if not (tuple(xbar.shape) == tuple(center.shape) == tuple(p.shape[1:])):
        raise ValueError(f"{name}: shapes p {tuple(p.shape)}, xbar "
                         f"{tuple(xbar.shape)}, center "
                         f"{tuple(center.shape)}")
    if p.device.type == "cpu":
        new_p, new_c = tu.fused_sync_easgd(p, xbar, center, a=a, na=na)
        return p.copy_(new_p), center.copy_(new_c)
    if p.device.type == "meta":
        return _dry(name, p, (p, center), **_items(p))
    lib = _lib()
    w = p.shape[0]
    with torch.cuda.device(p.device):
        err = lib.vrl_fused_sync_easgd(
            p.data_ptr(), center.data_ptr(), xbar.data_ptr(), _dtypes(p),
            float(a),
            float(1.0 - na), float(na), w, p.numel() // max(w, 1),
            _stream(p))
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return p, center


# Replaces repro/kernels/vrl_update.py:698 _ef_call, flat form (Pallas, TPU):
# fused_ef_int8 (:743) and fused_ef_topk (:755).  Bound: device-memory
# bandwidth — reads p, e (W·R·C each) and ref (R·C) once, writes dec and e
# (16 B per element with EF); top-k's per-row select adds 31 rounds of 8
# compares and one warp sum per row and worker, below the byte time.
# Design (csrc/comm_update.cu): one warp per 256-lane row, ref loaded once
# per row and applied to the W workers from registers; the row's max (int8)
# or kth-largest magnitude (top-k, a bitwise search) never leaves the warp.
# p's workers may lie a stride apart (the hierarchy's level-2 pod rows).
_MAX_EF_LANES = 1024


def _ef(name: str, mode: int, k: int, p: torch.Tensor,
        ref: Optional[torch.Tensor], e: Optional[torch.Tensor],
        out: Optional[torch.Tensor], grid: bool = False):
    _check(name, p, grid=grid, strided=() if grid else ("p",), p=p, ref=ref,
           e=e, out=out)
    stride = p[0, 0].numel() if grid else _worker_stride(name, p)
    _same_shape(name, p, e=e, out=out)
    if grid and ref is not None:
        _pod_shape(name, p, ref=ref)
    elif ref is not None and tuple(ref.shape) != tuple(p.shape[1:]):
        raise ValueError(f"{name}: ref {tuple(ref.shape)} is not one worker "
                         f"of p {tuple(p.shape)}")
    if out is not None and e is not None and _one_buffer(out, e):
        raise ValueError(f"{name}: out and e are one buffer; dec and the "
                         f"residual are both outputs")
    if mode == 1 and k < 1:
        raise ValueError(f"{name}: k must be >= 1, got {k}")
    if p.device.type == "cpu":
        dec, res = getattr(tu, name)(p, ref, e,
                                     **({"k": k} if mode == 1 else {}))
        out = dec if out is None else out.copy_(dec)
        if e is not None:
            e.copy_(res)
        return out, e
    if p.shape[-1] > _MAX_EF_LANES:
        raise ValueError(f"{name}: the kernel takes rows of at most "
                         f"{_MAX_EF_LANES} lanes, got {p.shape[-1]}")
    if p.device.type == "meta":
        out = (torch.empty(p.shape, dtype=torch.float32, device=p.device)
               if out is None else out)
        return _dry(name, p, (out, e), use_ref=ref is not None,
                    use_e=e is not None, **_items(p))
    if out is None:
        out = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    lib = _comm_lib()
    pods, dper = p.shape[:2] if grid else (1, p.shape[0])
    r, c = p.shape[-2:]
    with torch.cuda.device(p.device):
        err = lib.vrl_fused_ef(p.data_ptr(), _ptr(ref), _ptr(e),
                               out.data_ptr(), _dtypes(p), mode, int(k),
                               pods, dper, r, c, stride, _stream(p))
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return out, e


def _one_buffer(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` start at one address (on meta tensors, which
    have none: one storage at one offset)."""
    if a.device.type == "meta":
        return (a.untyped_storage()._cdata == b.untyped_storage()._cdata
                and a.storage_offset() == b.storage_offset())
    return a.data_ptr() == b.data_ptr()


def fused_ef_int8(p: torch.Tensor, ref: Optional[torch.Tensor],
                  e: Optional[torch.Tensor], *, block: int = 0,
                  out: Optional[torch.Tensor] = None):
    """Per-row-scaled int8 EF round trip on (W, R, C) buffers: p fp32 or
    bf16 (the parameters), the rest fp32.

    ``ref``: the (R, C) shared drift reference, or None (S-SGD's gradient
    compression); ``e``: the (W, R, C) residual, or None (error feedback
    off), updated in place to resid' = payload − dec.  ``out``: the (W, R,
    C) fp32 buffer that receives dec (new when None; it may be an fp32
    ``p`` itself).  ``p``'s (R, C) worker slices may lie a stride apart (a view
    ``params[:, 0]`` of a (P, D, R, C) buffer); ``e`` and ``out`` are
    contiguous.  Returns (dec, e).  ``block`` is accepted and ignored.
    """
    del block
    return _ef("fused_ef_int8", 0, 0, p, ref, e, out)


def fused_ef_topk(p: torch.Tensor, ref: Optional[torch.Tensor],
                  e: Optional[torch.Tensor], *, k: int, block: int = 0,
                  out: Optional[torch.Tensor] = None):
    """Top-k EF round trip (the k largest-magnitude lanes of each row
    kept, every lane tied with the kth kept too); the operand contract of
    ``fused_ef_int8``."""
    del block
    return _ef("fused_ef_topk", 1, k, p, ref, e, out)


# Replaces repro/kernels/vrl_update.py:698 _ef_call, grid form (Pallas,
# TPU): fused_ef_int8_grid (:762) and fused_ef_topk_grid (:769).  Bound:
# device-memory bandwidth — reads p and e (P·D·R·C each) and ref (P·R·C)
# once, writes dec and e: at (P, D) = (2, 2) and the main path's rows, 18
# R·C buffers, 35.6 GB (the bytes of fused_sync_hier1).  Design
# (csrc/comm_update.cu, the flat form's kernel): one warp owns a (pod,
# row), loads that pod's ref row into registers once and walks the pod's D
# workers with it, so ref is read once per pod, never D times (what the
# Pallas index map (pi, 0, i, 0) buys on the TPU); the row statistics are
# the flat form's.
def fused_ef_int8_grid(p: torch.Tensor, ref: Optional[torch.Tensor],
                       e: Optional[torch.Tensor], *, block: int = 0,
                       out: Optional[torch.Tensor] = None):
    """Pod-major int8 EF round trip: p, e, out (P, D, R, C) (p fp32 or
    bf16, e and out fp32), ref the
    (P, 1, R, C) per-pod reference broadcast over each pod's D workers (or
    None); otherwise the contract of ``fused_ef_int8``.  Returns (dec,
    e)."""
    del block
    return _ef("fused_ef_int8_grid", 0, 0, p, ref, e, out, grid=True)


def fused_ef_topk_grid(p: torch.Tensor, ref: Optional[torch.Tensor],
                       e: Optional[torch.Tensor], *, k: int, block: int = 0,
                       out: Optional[torch.Tensor] = None):
    """Pod-major top-k EF round trip; the operand contract of
    ``fused_ef_int8_grid``."""
    del block
    return _ef("fused_ef_topk_grid", 1, k, p, ref, e, out, grid=True)


# Replaces repro/kernels/vrl_update.py:476 _fold_call (Pallas, TPU):
# fused_fold_overlap (:521), fused_fold_overlap_bvr (:537) and
# fused_fold_overlap_avg (:546).  Bound: device-memory bandwidth — reads p,
# pend [, Δ, B] and x̂ once, writes p [, Δ, B] [, pend].  Design: one float4
# of x̂ per thread walks the W workers from a register; s₀ = 1/(pend_k γ)
# and km are read per worker from the (W, 2) device tensor ``wscal``.
def _fold(name: str, p, xbar, pend, d, b, wscal, *, beta: float,
          capture: bool):
    _check(name, p, p=p, xbar=xbar, pend=pend, d=d, b=b, wscal=wscal)
    _same_shape(name, p, pend=pend, d=d, b=b)
    if tuple(xbar.shape) != tuple(p.shape[1:]):
        raise ValueError(f"{name}: xbar {tuple(xbar.shape)} is not one "
                         f"worker of p {tuple(p.shape)}")
    if tuple(wscal.shape) != (p.shape[0], 2):
        raise ValueError(f"{name}: wscal must be (W, 2) = ({p.shape[0]}, 2), "
                         f"got {tuple(wscal.shape)}")
    bufs = (p,) + ((d,) if d is not None else ()) \
        + ((b,) if b is not None else ()) + ((pend,) if capture else ())
    if p.device.type == "cpu":
        if b is not None:
            outs = tu.fused_fold_overlap_bvr(p, xbar, pend, d, b, wscal,
                                             beta=beta, capture=capture)
        elif d is not None:
            outs = tu.fused_fold_overlap(p, xbar, pend, d, wscal,
                                         capture=capture)
        else:
            outs = tu.fused_fold_overlap_avg(p, xbar, pend, wscal,
                                             capture=capture)
        return tuple(t.copy_(o) for t, o in zip(bufs, outs))
    if p.device.type == "meta":
        return _dry(name, p, bufs, capture=capture,
                    **_items(p, d=_drift(d, b)))
    lib = _comm_lib()
    w = p.shape[0]
    with torch.cuda.device(p.device):
        err = lib.vrl_fused_fold(
            p.data_ptr(), xbar.data_ptr(), pend.data_ptr(), _ptr(d), _ptr(b),
            wscal.data_ptr(), _dtypes(p, d=_drift(d, b)), float(1.0 - beta),
            float(beta), int(capture),
            w, p.numel() // max(w, 1), _stream(p))
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return bufs


def fused_fold_overlap(p: torch.Tensor, xbar: torch.Tensor,
                       pend: torch.Tensor, d: torch.Tensor,
                       wscal: torch.Tensor, *, capture: bool = True,
                       block: int = 0):
    """The overlapped round's stale fold for the VRL algorithms, in place:
    c = x̂ − pend; p ← p + c; Δ ← Δ + c·s₀; with ``capture``, pend ←
    km·pend + (1−km)·p'.  ``xbar``: (R, C); ``wscal``: (W, 2) fp32 [s₀ =
    1/(pend_k·γ), km].  Returns (p, Δ[, pend])."""
    del block
    return _fold("fused_fold_overlap", p, xbar, pend, d, None, wscal,
                 beta=0.0, capture=capture)


def fused_fold_overlap_bvr(p: torch.Tensor, xbar: torch.Tensor,
                           pend: torch.Tensor, d: torch.Tensor,
                           b: torch.Tensor, wscal: torch.Tensor, *,
                           beta: float, capture: bool = True,
                           block: int = 0):
    """BVR-L-SGD's stale fold: the VRL fold plus B ← (1−β)B + β·c·s₀.
    Returns (p, Δ, B[, pend])."""
    del block
    return _fold("fused_fold_overlap_bvr", p, xbar, pend, d, b, wscal,
                 beta=beta, capture=capture)


def fused_fold_overlap_avg(p: torch.Tensor, xbar: torch.Tensor,
                           pend: torch.Tensor, wscal: torch.Tensor, *,
                           capture: bool = True, block: int = 0):
    """The average-sync stale fold (local_sgd, stl_sgd): p ← p + c only.
    Returns (p[, pend])."""
    del block
    return _fold("fused_fold_overlap_avg", p, xbar, pend, None, None, wscal,
                 beta=0.0, capture=capture)


# ------------------------------------------------ hierarchy (P, D, R, C)
def _pod_shape(name: str, p: torch.Tensor, **tensors) -> None:
    """Each per-pod operand must be (P, 1, R, C) beside p (P, D, R, C)."""
    want = (p.shape[0], 1) + tuple(p.shape[2:])
    for key, t in tensors.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {key} {tuple(t.shape)} is not one "
                             f"value per pod of p {tuple(p.shape)}: want "
                             f"{want}")


def _scal1(name: str, scal: torch.Tensor) -> None:
    if scal.numel() != 1:
        raise ValueError(f"{name}: scal must hold one value, got "
                         f"{tuple(scal.shape)}")


def _grid_sizes(p: torch.Tensor):
    pods, dper = p.shape[:2]
    return pods, dper, p.numel() // max(pods * dper, 1)


# Replaces repro/kernels/vrl_update.py:803 fused_hier_local_sgd (Pallas,
# TPU).  Bound: device-memory bandwidth — reads p, g, Δ1 (P·D·R·C each)
# and Δ2 (P·R·C) once, writes p (18 R·C-buffers at P = D = 2); ~5 flops
# per element.  Design: one thread per (pod, float4 of R·C) walks the pod's
# D workers with Δ2 in a register (loaded once per pod, never expanded);
# the arithmetic is fused_local_sgd's device function with Δ1 as Δ and Δ2
# as the second correction.
def fused_hier_local_sgd(p: torch.Tensor, g: torch.Tensor, d1: torch.Tensor,
                         d2: torch.Tensor, *, lr: float, wd: float = 0.0,
                         block: int = 0) -> torch.Tensor:
    """p ← p − γ((g − Δ1 − Δ2) + wd·p) in place on (P, D, R, C); Δ2 is
    (P, 1, R, C).  Returns p.  ``block`` is accepted and ignored."""
    del block
    name = "fused_hier_local_sgd"
    _check(name, p, grid=True, p=p, g=g, d1=d1, d2=d2)
    _same_shape(name, p, g=g, d1=d1)
    _pod_shape(name, p, d2=d2)
    if p.device.type == "cpu":
        return p.copy_(tu.fused_hier_local_sgd(p, g, d1, d2, lr=lr, wd=wd))
    if p.device.type == "meta":
        return _dry(name, p, p, wd=wd, **_items(p, g, d1))
    lib = _lib()
    with torch.cuda.device(p.device):
        err = lib.vrl_fused_hier_local_sgd(
            p.data_ptr(), g.data_ptr(), d1.data_ptr(), d2.data_ptr(),
            _dtypes(p, g, d1), float(lr), float(wd), *_grid_sizes(p),
            _stream(p))
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return p


# Replaces repro/kernels/vrl_update.py:971 fused_sync_hier1 (Pallas, TPU).
# Bound: device-memory bandwidth — reads p, Δ1 and x̂_pod (P·R·C) once,
# writes p and Δ1 (18 R·C-buffers at P = D = 2).  Design: the VRL sync of
# each pod in ONE launch over the whole grid: a thread holds one float4 of
# its pod's x̂_pod in a register and walks the pod's D workers; k1_eff·γ is
# read from the device tensor ``scal``.
def fused_sync_hier1(p: torch.Tensor, xbar_pod: torch.Tensor,
                     d1: torch.Tensor, scal: torch.Tensor, *, block: int = 0):
    """Δ1 ← Δ1 + (x̂_pod − p)/(k1_eff γ); p ← x̂_pod, in place on (P, D, R,
    C); ``xbar_pod``: (P, 1, R, C); ``scal``: (1, 1) k1_eff·γ.  Returns
    (p, Δ1)."""
    del block
    name = "fused_sync_hier1"
    _check(name, p, grid=True, p=p, xbar_pod=xbar_pod, d1=d1, scal=scal)
    _same_shape(name, p, d1=d1)
    _pod_shape(name, p, xbar_pod=xbar_pod)
    _scal1(name, scal)
    if p.device.type == "cpu":
        new_p, new_d = tu.fused_sync_hier1(p, xbar_pod, d1,
                                           scal.reshape(1, 1))
        return p.copy_(new_p), d1.copy_(new_d)
    if p.device.type == "meta":
        return _dry(name, p, (p, d1), **_items(p, d=d1))
    lib = _lib()
    with torch.cuda.device(p.device):
        err = lib.vrl_fused_sync_hier1(
            p.data_ptr(), d1.data_ptr(), xbar_pod.data_ptr(),
            scal.data_ptr(), _dtypes(p, d=d1), *_grid_sizes(p), _stream(p))
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return p, d1


# Replaces repro/kernels/vrl_update.py:1003 fused_sync_hier2 (Pallas, TPU).
# Bound: device-memory bandwidth — reads the pod value (worker 0's p), Δ2
# and x̂ once, writes p and Δ2 (11 R·C-buffers at P = D = 2).  Design: a
# thread reads its pod's value off worker 0 (as the plain version does;
# after the level-1 sync every worker holds it), updates Δ2 once per pod in
# place, then writes x̂ to the pod's D workers.  The Pallas kernel revisits
# Δ2 D times and so cannot donate it; one thread per (pod, element) has no
# such hazard.
def fused_sync_hier2(p: torch.Tensor, glob: torch.Tensor, d2: torch.Tensor,
                     scal: torch.Tensor, *, block: int = 0):
    """Δ2 ← Δ2 + (x̂ − p_pod)/(k2_eff γ); p ← x̂, in place; p_pod is worker
    0 of each pod.  ``glob``: (R, C); ``d2``: (P, 1, R, C); ``scal``: (1, 1)
    k2_eff·γ.  Returns (p, Δ2)."""
    del block
    name = "fused_sync_hier2"
    _check(name, p, grid=True, p=p, glob=glob, d2=d2, scal=scal)
    _pod_shape(name, p, d2=d2)
    if tuple(glob.shape) != tuple(p.shape[2:]):
        raise ValueError(f"{name}: glob {tuple(glob.shape)} is not one "
                         f"worker of p {tuple(p.shape)}")
    _scal1(name, scal)
    if p.device.type == "cpu":
        new_p, new_d = tu.fused_sync_hier2(p, glob, d2, scal.reshape(1, 1))
        return p.copy_(new_p), d2.copy_(new_d)
    if p.device.type == "meta":
        return _dry(name, p, (p, d2), **_items(p, d=d2))
    lib = _lib()
    with torch.cuda.device(p.device):
        err = lib.vrl_fused_sync_hier2(
            p.data_ptr(), d2.data_ptr(), glob.data_ptr(), scal.data_ptr(),
            _dtypes(p, d=d2), *_grid_sizes(p), _stream(p))
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return p, d2


# Replaces repro/kernels/vrl_update.py:570 fused_fold_overlap_hier2 (Pallas,
# TPU).  Bound: device-memory bandwidth — reads p, x̂_stale, pend2 and Δ2
# once, writes p, Δ2 and (with capture) pend2 (17 R·C-buffers at P = D = 2).
# Design: a thread holds one float4 of x̂_stale and of its pod's pend2 and
# forms c once, adds it to the pod's D workers, updates Δ2 and captures
# pend2' from worker 0's folded value, both once per pod in place; s₀ and
# km are read per pod from the (P, 2) device tensor ``wscal``.
def fused_fold_overlap_hier2(p: torch.Tensor, glob: torch.Tensor,
                             pend2: torch.Tensor, d2: torch.Tensor,
                             wscal: torch.Tensor, *, capture: bool = True,
                             block: int = 0):
    """The level-2 stale fold, in place: c = x̂ − pend2 (per pod); p ← p +
    c; Δ2 ← Δ2 + c·s₀; with ``capture``, pend2 ← km·pend2 + (1−km)·p'_pod.
    ``glob``: (R, C); ``pend2``, ``d2``: (P, 1, R, C); ``wscal``: (P, 2) fp32
    [s₀ = 1/(pend_k·γ), km].  Assumes a level-1 sync at the same step (p_pod
    is worker 0).  Returns (p, Δ2[, pend2])."""
    del block
    name = "fused_fold_overlap_hier2"
    _check(name, p, grid=True, p=p, glob=glob, pend2=pend2, d2=d2,
           wscal=wscal)
    _pod_shape(name, p, pend2=pend2, d2=d2)
    if tuple(glob.shape) != tuple(p.shape[2:]):
        raise ValueError(f"{name}: glob {tuple(glob.shape)} is not one "
                         f"worker of p {tuple(p.shape)}")
    if tuple(wscal.shape) != (p.shape[0], 2):
        raise ValueError(f"{name}: wscal must be (P, 2) = ({p.shape[0]}, "
                         f"2), got {tuple(wscal.shape)}")
    bufs = (p, d2) + ((pend2,) if capture else ())
    if p.device.type == "cpu":
        outs = tu.fused_fold_overlap_hier2(p, glob, pend2, d2, wscal,
                                           capture=capture)
        return tuple(t.copy_(o) for t, o in zip(bufs, outs))
    if p.device.type == "meta":
        return _dry(name, p, bufs, capture=capture, **_items(p, d=d2))
    lib = _lib()
    with torch.cuda.device(p.device):
        err = lib.vrl_fused_fold_hier2(
            p.data_ptr(), glob.data_ptr(), pend2.data_ptr(), d2.data_ptr(),
            wscal.data_ptr(), int(capture), _dtypes(p, d=d2),
            *_grid_sizes(p), _stream(p))
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return bufs


# Replaces repro/kernels/vrl_update.py:833 fused_hier_local_momentum
# (Pallas, TPU).  Bound: device-memory bandwidth — reads p, g, Δ1, m (P·D·R·C
# each) and Δ2 (P·R·C) once, writes p and m (26 R·C-buffers at P = D = 2
# with fp32 m); ~8 flops per element.  Design: fused_hier_local_sgd's — one
# thread per (pod, float4 of R·C) walks the pod's D workers with Δ2 in a
# register — with fused_local_momentum's arithmetic, Δ1 as Δ and Δ2 as the
# second correction; m fp32 or bf16, in place.
def fused_hier_local_momentum(p: torch.Tensor, g: torch.Tensor,
                              d1: torch.Tensor, d2: torch.Tensor,
                              m: torch.Tensor, *, lr: float, beta: float,
                              wd: float = 0.0, nesterov: bool = False,
                              block: int = 0):
    """m ← βm + v; p ← p − γ·(nesterov ? v + βm : m), v = g − Δ1 − Δ2 +
    wd·p, in place on (P, D, R, C); Δ2 is (P, 1, R, C).  Returns (p, m)."""
    del block
    name = "fused_hier_local_momentum"
    _check(name, p, grid=True, moments=("m",), p=p, g=g, d1=d1, d2=d2, m=m)
    _same_shape(name, p, g=g, d1=d1, m=m)
    _pod_shape(name, p, d2=d2)
    if p.device.type == "cpu":
        new_p, new_m = tu.fused_hier_local_momentum(
            p, g, d1, d2, m, lr=lr, beta=beta, wd=wd, nesterov=nesterov)
        return p.copy_(new_p), m.copy_(new_m)
    if p.device.type == "meta":
        return _dry(name, p, (p, m), wd=wd, m_bytes=m.element_size(),
                    **_items(p, g, d1))
    lib = _lib()
    with torch.cuda.device(p.device):
        err = lib.vrl_fused_hier_local_momentum(
            p.data_ptr(), g.data_ptr(), d1.data_ptr(), d2.data_ptr(),
            m.data_ptr(), _dtypes(p, g, d1, m), float(lr),
            float(beta), float(wd), int(bool(nesterov)), *_grid_sizes(p),
            _stream(p))
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return p, m


# Replaces repro/kernels/vrl_update.py:871 fused_hier_local_adam (Pallas,
# TPU).  Bound: device-memory bandwidth — reads p, g, Δ1, mu, nu and Δ2 once
# per pod, writes p, mu, nu (34 R·C-buffers at P = D = 2 with fp32
# moments); ~20 flops, one sqrt and two divisions per element.  Design: the
# pod walk of fused_hier_local_sgd with fused_local_adam's arithmetic; [c1,
# c2] read from the (1, 2) device tensor ``scal``; in place over p, mu, nu.
def fused_hier_local_adam(p: torch.Tensor, g: torch.Tensor,
                          d1: torch.Tensor, d2: torch.Tensor,
                          mu: torch.Tensor, nu: torch.Tensor,
                          scal: torch.Tensor, *, lr: float, b1: float = 0.9,
                          b2: float = 0.999, eps: float = 1e-8,
                          wd: float = 0.0, block: int = 0):
    """Adam on v = g − Δ1 − Δ2 in place on (P, D, R, C); returns (p, mu,
    nu).  ``scal``: (1, 2) fp32 [1 − b1^t, 1 − b2^t]."""
    del block
    name = "fused_hier_local_adam"
    _check(name, p, grid=True, moments=("mu", "nu"), p=p, g=g, d1=d1, d2=d2,
           mu=mu, nu=nu, scal=scal)
    _same_shape(name, p, g=g, d1=d1, mu=mu, nu=nu)
    _pod_shape(name, p, d2=d2)
    if scal.numel() != 2:
        raise ValueError(f"{name}: scal must hold [c1, c2], got "
                         f"{tuple(scal.shape)}")
    if p.device.type == "cpu":
        outs = tu.fused_hier_local_adam(p, g, d1, d2, mu, nu,
                                        scal.reshape(1, 2), lr=lr, b1=b1,
                                        b2=b2, eps=eps, wd=wd)
        return tuple(t.copy_(o) for t, o in zip((p, mu, nu), outs))
    if p.device.type == "meta":
        return _dry(name, p, (p, mu, nu), wd=wd, m_bytes=mu.element_size(),
                    **_items(p, g, d1))
    lib = _lib()
    with torch.cuda.device(p.device):
        err = lib.vrl_fused_hier_local_adam(
            p.data_ptr(), g.data_ptr(), d1.data_ptr(), d2.data_ptr(),
            mu.data_ptr(), nu.data_ptr(), _dtypes(p, g, d1, mu),
            scal.data_ptr(), *_adam_consts(lr, b1, b2, eps, wd),
            *_grid_sizes(p), _stream(p))
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return p, mu, nu


# Replaces repro/kernels/vrl_update.py:927 fused_hier_local_adam_sm3
# (Pallas, TPU).  Bound: device-memory bandwidth — reads p, g, Δ1, mu, Δ2
# once per pod and the row stat, writes p, mu and the row stat (22
# R·C-buffers plus the row stat at P = D = 2 with bf16 mu).  Design:
# fused_local_adam_sm3's kernel over the P·D workers, with Δ1 as Δ and Δ2
# indexed by pod; a pod's workers take neighbouring blocks, so the second
# read of a Δ2 row finds it in L2.
def fused_hier_local_adam_sm3(p: torch.Tensor, g: torch.Tensor,
                              d1: torch.Tensor, d2: torch.Tensor,
                              mu: torch.Tensor, row: torch.Tensor,
                              col: torch.Tensor, scal: torch.Tensor, *,
                              lr: float, b1: float = 0.9, b2: float = 0.999,
                              eps: float = 1e-8, wd: float = 0.0,
                              block: int = 0):
    """SM3-factored Adam on v = g − Δ1 − Δ2 over (P, D, R, C): ``row`` (P,
    D, R, 1), ``col`` (P, D, S, C).  p, mu, row in place; returns (p, mu,
    row, col') with col' new."""
    del block
    name = "fused_hier_local_adam_sm3"
    _check(name, p, grid=True, moments=("mu",), p=p, g=g, d1=d1, d2=d2,
           mu=mu, row=row, col=col, scal=scal)
    _same_shape(name, p, g=g, d1=d1, mu=mu)
    _pod_shape(name, p, d2=d2)
    _check_sm3(name, p, row, col)
    if scal.numel() != 2:
        raise ValueError(f"{name}: scal must hold [c1, c2], got "
                         f"{tuple(scal.shape)}")
    if p.device.type == "cpu":
        new_p, new_mu, new_row, new_col = tu.fused_hier_local_adam_sm3(
            p, g, d1, d2, mu, row, col, scal.reshape(1, 2), lr=lr, b1=b1,
            b2=b2, eps=eps, wd=wd)
        return p.copy_(new_p), mu.copy_(new_mu), row.copy_(new_row), new_col
    if p.device.type == "meta":
        return _dry(name, p, (p, mu, row, torch.empty_like(col)),
                    mu_bytes=mu.element_size(), wd=wd, shards=col.shape[-2],
                    **_items(p, g, d1))
    return _adam_sm3(name, p, g, d1, d2, mu, row, col, scal, p.shape[1],
                     _adam_consts(lr, b1, b2, eps, wd))


# ============================================== per-leaf (tree-update API)
@functools.cache
def _leaf_lib() -> ctypes.CDLL:
    """The per-leaf update library with its C signatures."""
    lib = build.load("leaf_update")
    f32, i64, cint = ctypes.c_float, ctypes.c_int64, ctypes.c_int
    lib.leaf_local_update.argtypes = [_PTR, _PTR, _PTR, _PTR, cint, cint,
                                      cint, f32, i64, _PTR]
    lib.leaf_local_update.restype = cint
    lib.leaf_sync_update.argtypes = [_PTR, _PTR, _PTR, _PTR, _PTR, cint,
                                     cint, cint, f32, i64, i64, _PTR]
    lib.leaf_sync_update.restype = cint
    return lib


def _check_leaf(name: str, p: torch.Tensor, **tensors) -> None:
    """Raise on what the per-leaf kernels do not take: an operand not fp32
    or bf16, on another device than p, or not contiguous (any alignment
    and any element count are fine)."""
    if p.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name}: unsupported device {p.device}")
    for key, t in dict(p=p, **tensors).items():
        if t.dtype not in _MOMENT_DTYPES:
            raise TypeError(f"{name}: {key} is {t.dtype}; the kernel takes "
                            f"torch.float32 or torch.bfloat16")
        if t.device != p.device:
            raise ValueError(f"{name}: {key} on {t.device}, p on {p.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")


def _bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


# Replaces repro/kernels/vrl_update.py:73 vrl_local_update (Pallas, TPU).
# Bound: device-memory bandwidth — reads p, g, Δ and writes p' once (16 B
# per fp32 element, a few flops).  Design: one pass over the whole leaf,
# 8-element groups by 16-byte loads where aligned, the tail (and any
# misaligned view) element by element; Δ rounded to p's dtype in register.
def vrl_local_update(p: torch.Tensor, g: torch.Tensor, d: torch.Tensor, *,
                     lr: float, block: int = 0) -> torch.Tensor:
    """p' = p − γ(g − Δ) over one leaf of any shape, a new tensor in p's
    dtype; Δ is rounded to p's dtype first (the tree wrapper's cast).
    Operands fp32 or bf16, each in its own dtype.  ``block`` is accepted
    and ignored: the kernel takes the element count, no tile padding."""
    del block
    name = "vrl_local_update"
    _check_leaf(name, p, g=g, d=d)
    _same_shape(name, p, g=g, d=d)
    if p.device.type == "cpu":
        return tu.vrl_local_update(p, g, d, lr=lr)
    if p.device.type == "meta":
        return _dry(name, p, torch.empty_like(
            p, memory_format=torch.contiguous_format), n=p.numel(), m=0,
            local=True, item=(p.element_size(), g.element_size(),
                              d.element_size()))
    out = torch.empty_like(p, memory_format=torch.contiguous_format)
    lib = _leaf_lib()
    with torch.cuda.device(p.device):
        err = lib.leaf_local_update(
            out.data_ptr(), p.data_ptr(), g.data_ptr(), d.data_ptr(),
            _bf16(p), _bf16(g), _bf16(d), float(lr), p.numel(), _stream(p))
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return out


# Replaces repro/kernels/vrl_update.py:91 vrl_sync_update (Pallas, TPU).
# Bound: device-memory bandwidth — reads p, Δ and x̂ once, writes p' and
# Δ'.  Design: as vrl_local_update; an x̂ shaped like p without its leading
# axes is read with a stride of 0 over them (each thread loads its x̂
# elements once and walks the copies), so it is never expanded.
def vrl_sync_update(p: torch.Tensor, xbar: torch.Tensor, d: torch.Tensor,
                    *, inv_kg: float, block: int = 0):
    """Δ' = Δ + (x̂ − p)·inv_kg (inv_kg rounded to fp32 once, a product,
    not a division) and p' = x̂, over one leaf: returns new (p' in p's
    dtype, Δ' in Δ's).  ``xbar``: p's shape, or p's without leading axes
    (broadcast over them, not materialised)."""
    del block
    name = "vrl_sync_update"
    _check_leaf(name, p, xbar=xbar, d=d)
    _same_shape(name, p, d=d)
    if tuple(xbar.shape) != tuple(p.shape[p.dim() - xbar.dim():]) \
            or xbar.dim() > p.dim():
        raise ValueError(f"{name}: xbar {tuple(xbar.shape)} is not p's "
                         f"shape {tuple(p.shape)} or a trailing part of it")
    if p.device.type == "cpu":
        return tu.vrl_sync_update(p, xbar, d, inv_kg=inv_kg)
    if p.device.type == "meta":
        return _dry(name, p, (
            torch.empty_like(p, memory_format=torch.contiguous_format),
            torch.empty_like(d, memory_format=torch.contiguous_format)),
            n=p.numel(), m=xbar.numel(), local=False,
            item=(p.element_size(), xbar.element_size(), d.element_size()))
    new_p = torch.empty_like(p, memory_format=torch.contiguous_format)
    new_d = torch.empty_like(d, memory_format=torch.contiguous_format)
    lib = _leaf_lib()
    with torch.cuda.device(p.device):
        err = lib.leaf_sync_update(
            new_p.data_ptr(), new_d.data_ptr(), p.data_ptr(),
            xbar.data_ptr(), d.data_ptr(), _bf16(p), _bf16(xbar), _bf16(d),
            float(inv_kg), p.numel(), xbar.numel(), _stream(p))
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return new_p, new_d
