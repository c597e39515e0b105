"""Variance Reduced Local SGD (VRL-SGD) — Algorithm 1 of the paper
(``repro.core.vrl_sgd``).

Per worker i (leading axis of every leaf):

  local, k times:   v_i = ∇f_i(x_i, ξ) − Δ_i
                    x_i ← inner_opt(x_i, v_i)            (paper: plain SGD)
  sync (every k):   x̂   = (1/N) Σ_i x_i                  (one all-reduce)
                    Δ_i ← Δ_i + (x̂ − x_i) / (k_eff · γ)  (eq. 4)
                    x_i ← x̂

``k_eff`` is the actual number of local steps since the last sync, so the
warm-up variant (Remark 5.3: first period k=1) and any communication
schedule stay exact.  Invariants (tests/test_torch_ref_executor.py):
Σ_i Δ_i = 0 after every sync; k=1 is S-SGD; Δ ≡ 0 is Local SGD; x̂ follows
eq. (8), exact SGD on the averaged gradients.

A thin description over ``core/engine``: ``SPEC`` names the correction (Δ
in the local step) and the sync rule ("vrl"); these functions run the
per-leaf reference executor, and ``engine.make_engine`` the flat-buffer
one over the CUDA kernels.
"""
from __future__ import annotations

from typing import Any

from repro_torch.configs.base import VRLConfig
from repro_torch.core import engine
from repro_torch.core.engine import (  # noqa: F401
    _bcast, average_model, worker_mean)
from repro_torch.core.types import WorkerState

SPEC = engine.ALGO_SPECS["vrl_sgd"]


def init(cfg: VRLConfig, params: Any, num_workers: int) -> WorkerState:
    """params: single-model tree -> worker-stacked state."""
    return engine.ref_init(SPEC, cfg, params, num_workers)


def corrected_grads(state: WorkerState, grads: Any) -> Any:
    """v_i = g_i − Δ_i  (eq. 6)."""
    return engine.corrected_grads(state, grads)


def local_step(cfg: VRLConfig, state: WorkerState, grads: Any) -> WorkerState:
    """One local iteration on every worker (no cross-worker communication)."""
    return engine.ref_local_step(SPEC, cfg, state, grads)


def sync(cfg: VRLConfig, state: WorkerState) -> WorkerState:
    """Model averaging + Δ update (the only cross-worker communication)."""
    return engine.ref_sync(SPEC, cfg, state)


def should_sync(cfg: VRLConfig, step: int, last_sync: int) -> bool:
    """True when ``step`` (post-increment) completes a communication period."""
    return engine.should_sync(SPEC, cfg, step, last_sync)


def train_step(cfg: VRLConfig, state: WorkerState, grads: Any) -> WorkerState:
    """The local step, then the sync when the period ends."""
    return engine.ref_train_step(SPEC, cfg, state, grads)


def make_algorithm(cfg: VRLConfig):
    """Uniform (init, train_step, local_step, sync) tuple for this algorithm."""
    return init, train_step, local_step, sync
