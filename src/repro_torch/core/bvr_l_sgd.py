"""Bias-Variance Reduced Local SGD [Murata & Suzuki 2021], engine form
(``repro.core.bvr_l_sgd``).

  local:  v_i = g_i − Δ_i − B_i
  sync:   u_i = (x̂ − x_i)/(k_eff γ)      (realised drift this round)
          Δ_i ← Δ_i + u_i                (eq. 4, unchanged)
          B_i ← (1−β)·B_i + β·u_i        (bias-variate EMA, β = bvr_beta)
          x_i ← x̂

Σ_i B_i = 0 after every sync (the argument for Δ); β = 0 turns B off and
the trajectory is bitwise VRL-SGD.  ``SPEC`` over ``core/engine``'s
per-leaf reference executor.
"""
from __future__ import annotations

from typing import Any

from repro_torch.configs.base import VRLConfig
from repro_torch.core import engine
from repro_torch.core.types import WorkerState

SPEC = engine.ALGO_SPECS["bvr_l_sgd"]


def init(cfg: VRLConfig, params: Any, num_workers: int) -> WorkerState:
    return engine.ref_init(SPEC, cfg, params, num_workers)


def local_step(cfg: VRLConfig, state: WorkerState, grads: Any) -> WorkerState:
    return engine.ref_local_step(SPEC, cfg, state, grads)


def sync(cfg: VRLConfig, state: WorkerState) -> WorkerState:
    return engine.ref_sync(SPEC, cfg, state)


def should_sync(cfg: VRLConfig, step: int, last_sync: int) -> bool:
    return engine.should_sync(SPEC, cfg, step, last_sync)


def train_step(cfg: VRLConfig, state: WorkerState, grads: Any) -> WorkerState:
    return engine.ref_train_step(SPEC, cfg, state, grads)
