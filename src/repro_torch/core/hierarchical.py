"""Hierarchical (two-level) VRL-SGD — a thin spec over the shared engine
(``repro.core.hierarchical``).

The worker population is a pod-major (P, D) grid with one VRL correction
per link tier:

  level 1 (intra-pod):  every k1 steps within each pod
      x̂_pod = mean over the pod's workers
      Δ1_i  += (x̂_pod − x_i) / (k1 γ);  x_i = x̂_pod
  level 2 (cross-pod):  every k2 ≥ k1 steps globally
      x̂     = mean over everything
      Δ2_p  += (x̂ − x̂_pod) / (k2 γ)    (one Δ2 per pod, shared)
      x_i    = x̂

  local step:  x_i ← inner_opt(x_i, ∇f_i(x_i, ξ) − Δ1_i − Δ2_p)

This module re-exports the per-leaf reference executor over
``types.HierState`` ((P, D, ...) leaves; ``engine.ref_hier_*``) under the
historical names; ``engine.make_engine`` on ``VRLConfig(algorithm=
"hier_vrl_sgd", hier=HierConfig(k1, k2, grid))`` is the flat-buffer one.
Σ_d Δ1 = 0 within every pod and Σ_p Δ2 = 0 across pods; one pod at k1 =
k2 is the paper's Algorithm 1.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple, Union

from repro_torch.configs.base import VRLConfig
from repro_torch.core import engine
from repro_torch.core.types import HierState  # noqa: F401  (historical home)


def init(cfg: VRLConfig, params: Any,
         grid: Union[int, Tuple[int, int]]) -> HierState:
    """``grid``: the pod-major (P, D) worker grid; a plain worker count is
    accepted for the uniform Algorithm interface and validated against
    ``cfg.hier.grid``."""
    if isinstance(grid, int):
        hcfg = engine.hier_config(cfg)
        if hcfg.grid[0] * hcfg.grid[1] != grid:
            raise ValueError(f"hier grid {hcfg.grid} holds "
                             f"{hcfg.grid[0] * hcfg.grid[1]} workers, "
                             f"init asked for {grid}")
        grid = hcfg.grid
    return engine.ref_hier_init(cfg, params, grid)


def local_step(cfg: VRLConfig, state: HierState, grads: Any) -> HierState:
    return engine.ref_hier_local_step(cfg, state, grads)


def sync_level1(cfg: VRLConfig, state: HierState) -> HierState:
    """Intra-pod sync: mean over axis 1 (the pod-internal worker axis)."""
    return engine.ref_hier_sync1(cfg, state)


def sync_level2(cfg: VRLConfig, state: HierState) -> HierState:
    """Cross-pod sync.  Assumes a level-1 sync at the same step (so every
    worker already holds its pod average)."""
    return engine.ref_hier_sync2(cfg, state)


def sync(cfg: VRLConfig, state: HierState) -> HierState:
    """The full level-2 boundary event: intra-pod then cross-pod."""
    return sync_level2(cfg, sync_level1(cfg, state))


def train_step(cfg: VRLConfig, state: HierState, grads: Any, *,
               k1: Optional[int] = None, k2: Optional[int] = None
               ) -> HierState:
    """Local step + the per-level syncs that are due (periods from
    ``cfg.hier`` unless overridden)."""
    return engine.ref_hier_train_step(cfg, state, grads, k1=k1, k2=k2)


def average_model(state: HierState) -> Any:
    return engine.hier_average_model(state)
