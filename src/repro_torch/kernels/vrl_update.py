"""Fused VRL-SGD update kernels for Hopper — the engine's hot path.

The port's counterpart of ``repro.kernels.vrl_update``: the paper's local
step and sync as single passes over worker-stacked (W, R, C) fp32 buffers,
written in place.

  local:  p' = p − γ((g − Δ − B) + wd·p)
  sync:   Δ' = Δ + (x̂ − p)/(k_eff γ);  p' = x̂

Each wrapper takes its kernel for CUDA tensors (``csrc/vrl_update.cu``,
built at first use by ``kernels/build``) and the plain PyTorch version
(``kernels/torch_update``) for CPU tensors; a CUDA tensor never falls back
to the plain version.  ``LAUNCHES`` counts kernel launches per wrapper (a
CPU call is not a launch), so a run can show that its main path went
through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import torch_update as tu

LAUNCHES = {"fused_local_sgd": 0, "fused_sync_vrl": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_PTR = ctypes.c_void_p


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as void*, sizes as int64, so nothing is cut to 32 bits)."""
    lib = build.load("vrl_update")
    lib.vrl_fused_local_sgd.argtypes = [_PTR, _PTR, _PTR, _PTR,
                                        ctypes.c_float, ctypes.c_float,
                                        ctypes.c_int64, _PTR]
    lib.vrl_fused_local_sgd.restype = ctypes.c_int
    lib.vrl_fused_sync_vrl.argtypes = [_PTR, _PTR, _PTR, _PTR,
                                       ctypes.c_int64, ctypes.c_int64, _PTR]
    lib.vrl_fused_sync_vrl.restype = ctypes.c_int
    return lib


def _check(name: str, ref: torch.Tensor, **tensors) -> None:
    """Raise on what the kernels do not take: non-fp32, mixed devices,
    non-contiguous or misaligned buffers, lanes not a multiple of 4."""
    if ref.dim() != 3:
        raise ValueError(f"{name}: p must be (W, R, C), got {tuple(ref.shape)}")
    if ref.shape[-1] % 4:
        raise ValueError(f"{name}: lanes {ref.shape[-1]} not a multiple of 4")
    for key, t in tensors.items():
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} is {t.dtype}; the kernels take "
                            f"float32 only")
        if t.device != ref.device:
            raise ValueError(f"{name}: {key} on {t.device}, p on {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} is not 16-byte aligned")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {ref.device}")


def _raise_on(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error "
                           f"{err}") from torch.cuda.CudaError(err)


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
    for key, t in (("g", g), ("d", d), ("b", b)):
        if t is not None and t.shape != p.shape:
            raise ValueError(f"fused_local_sgd: {key} {tuple(t.shape)} != p "
                             f"{tuple(p.shape)}")
    if p.device.type == "cpu":
        return p.copy_(tu.fused_local_sgd(p, g, d, lr=lr, wd=wd, b=b))
    lib = _lib()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.vrl_fused_local_sgd(
            p.data_ptr(), g.data_ptr(),
            d.data_ptr() if d is not None else None,
            b.data_ptr() if b is not None else None,
            float(lr), float(wd), p.numel(), stream)
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
    lib = _lib()
    w = p.shape[0]
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.vrl_fused_sync_vrl(
            p.data_ptr(), d.data_ptr(), xbar.data_ptr(), scal.data_ptr(),
            w, p.numel() // max(w, 1), stream)
    _raise_on("fused_sync_vrl", err)
    LAUNCHES["fused_sync_vrl"] += 1
    return p, d
