"""Inner optimizers (``repro.optim.optimizers``): SGD, momentum, Adam.

Per-leaf transforms over parameter trees (nested dicts of tensors) with
the reference's interface

    opt.init(params) -> state
    opt.update(params, grads, state) -> (new_params, new_state)

and its math op for op: fp32 in-register, decoupled (AdamW-style) weight
decay, moments stored in ``moment_dtype`` and read back up to fp32.  The
flat-buffer engine runs the same steps fused over (W, R, C) buffers
(``kernels/vrl_update``); these per-leaf versions are the port's oracle
for them in the tests.  Adam's step count is a host integer, as the
engine's step counters are; its bias corrections are made on the device
(``adam_scal``).

``sm3=True`` switches Adam's second moment to the SM3 factored form
(Anil et al. 2019): per matrix-like leaf, nu's full buffer is replaced by
a row-max and a lane-max statistic over the trailing 2D face, with
v̂ = min(row, lane) bounding nu from above; the engine applies the same
construction to its (R, C) flat buffers.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch import tree as tree_mod
from repro_torch.kernels.torch_update import sqrt_rn

ADAM_B1, ADAM_B2 = 0.9, 0.999


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]


class AdamState(NamedTuple):
    mu: Any
    nu: Any                     # dense, or an SM3Pair
    count: int                  # steps taken (host integer)


class SM3Pair(NamedTuple):
    """Factored second-moment statistics: ``row`` the max over the last
    (lane) dim, ``col`` the max over the second-to-last (row) dim (the
    engine's: over each shard's row span); ``min(row, col)`` bounds the
    dense nu from above.  Always fp32 (the stats are ~(R + C)/(R·C) of the
    dense buffer, so quantizing them buys nothing)."""

    row: Any
    col: Any


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _dtype(name: Any) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def adam_scal(count: int, device: Any = None, b1: float = ADAM_B1,
              b2: float = ADAM_B2) -> torch.Tensor:
    """(1, 2) fp32 [1 − b1^t, 1 − b2^t] at t = ``count``, made on
    ``device`` from a fill (no host-to-device copy, no host sync): the
    reference's ``1.0 - b ** t`` with t an fp32 scalar."""
    t = torch.full((), float(count), dtype=torch.float32, device=device)
    return torch.stack([1.0 - torch.pow(b1, t),
                        1.0 - torch.pow(b2, t)]).reshape(1, 2)


def sgd(lr: float, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return ()

    def update(params, grads, state):
        def upd(x, g):
            g = _f32(g)
            if weight_decay:
                g = g + weight_decay * _f32(x)
            return (_f32(x) - lr * g).to(x.dtype)
        return tree_mod.tree_map(upd, params, grads), state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9, weight_decay: float = 0.0,
             nesterov: bool = False,
             moment_dtype: Any = torch.float32) -> Optimizer:
    mdt = _dtype(moment_dtype)

    def init(params):
        return tree_mod.tree_map(lambda x: torch.zeros_like(x, dtype=mdt),
                                 params)

    def _g(x, g):
        g = _f32(g)
        return g + weight_decay * _f32(x) if weight_decay else g

    def update(params, grads, bufs):
        new_m = tree_mod.tree_map(
            lambda x, g, m: (beta * _f32(m) + _g(x, g)).to(mdt),
            params, grads, bufs)

        def upd(x, g, m):
            m = _f32(m)
            step_dir = _g(x, g) + beta * m if nesterov else m
            return (_f32(x) - lr * step_dir).to(x.dtype)
        return tree_mod.tree_map(upd, params, grads, new_m), new_m

    return Optimizer(init, update)


def adam(lr: float, b1: float = ADAM_B1, b2: float = ADAM_B2,
         eps: float = 1e-8, weight_decay: float = 0.0,
         moment_dtype: Any = torch.float32, sm3: bool = False) -> Optimizer:
    """Adam with decoupled weight decay.  ``sm3``: leaves with ndim >= 2
    keep an ``SM3Pair`` of fp32 stats instead of nu; the others a dense nu
    (fp32 zeros at init, stored in ``moment_dtype`` after a step, as in the
    reference)."""
    mdt = _dtype(moment_dtype)

    def stats(x):
        if x.dim() < 2:
            return torch.zeros_like(x, dtype=torch.float32)
        return SM3Pair(
            row=x.new_zeros(x.shape[:-1] + (1,), dtype=torch.float32),
            col=x.new_zeros(x.shape[:-2] + (1, x.shape[-1]),
                            dtype=torch.float32))

    def init(params):
        zeros = tree_mod.tree_map(
            lambda x: torch.zeros_like(x, dtype=mdt), params)
        nu = (tree_mod.tree_map(stats, params) if sm3
              else tree_mod.tree_map(torch.clone, zeros))
        return AdamState(zeros, nu, 0)

    def update(params, grads, state):
        count = state.count + 1
        leaves = tree_mod.leaves(params)
        scal = adam_scal(count, leaves[0].device if leaves else None, b1, b2)
        c1, c2 = scal[0, 0], scal[0, 1]

        def upd(x, g, m_old, nu_old):
            g = _f32(g)
            m = b1 * _f32(m_old) + (1 - b1) * g
            if isinstance(nu_old, SM3Pair):
                vhat = torch.minimum(nu_old.row, nu_old.col)
                v = b2 * vhat + (1 - b2) * torch.square(g)
                nu_new = SM3Pair(row=v.amax(dim=-1, keepdim=True),
                                 col=v.amax(dim=-2, keepdim=True))
            else:
                v = b2 * _f32(nu_old) + (1 - b2) * torch.square(g)
                nu_new = v.to(mdt)
            step = lr * (m / c1) / (sqrt_rn(v / c2) + eps)
            if weight_decay:
                step = step + lr * weight_decay * _f32(x)
            return (_f32(x) - step).to(x.dtype), m.to(mdt), nu_new

        out = tree_mod.tree_map(upd, params, grads, state.mu, state.nu)
        return (tree_mod.pick(out, 0),
                AdamState(tree_mod.pick(out, 1), tree_mod.pick(out, 2), count))

    return Optimizer(init, update)


def inner_kind(cfg) -> Tuple[str, float]:
    """(kind, β) of the inner optimizer a VRLConfig asks for: sgd with a
    nonzero ``momentum`` is momentum; momentum's β defaults to 0.9.  The
    per-leaf ``make_inner`` and the engine's fused kernels both follow
    it."""
    if cfg.inner_optimizer == "sgd":
        return ("momentum", cfg.momentum) if cfg.momentum else ("sgd", 0.0)
    if cfg.inner_optimizer == "momentum":
        return "momentum", cfg.momentum or 0.9
    if cfg.inner_optimizer == "adam":
        return "adam", 0.0
    raise ValueError(cfg.inner_optimizer)


def make_inner(cfg) -> Optimizer:
    """Build the inner optimizer from a VRLConfig."""
    mdt = getattr(cfg, "moment_dtype", "float32")
    kind, beta = inner_kind(cfg)
    if kind == "sgd":
        return sgd(cfg.learning_rate, cfg.weight_decay)
    if kind == "momentum":
        return momentum(cfg.learning_rate, beta, cfg.weight_decay,
                        moment_dtype=mdt)
    return adam(cfg.learning_rate, weight_decay=cfg.weight_decay,
                moment_dtype=mdt, sm3=getattr(cfg, "sm3", False))
