"""Local SGD baseline [Stich 2019] (``repro.core.local_sgd``): k local
steps, periodic model averaging — exactly VRL-SGD with Δ_i ≡ 0 (paper
§4.1).  ``SPEC`` (no correction, "average" sync) over ``core/engine``'s
per-leaf reference executor here, the flat-buffer one via
``engine.make_engine``.
"""
from __future__ import annotations

from typing import Any

from repro_torch.configs.base import VRLConfig
from repro_torch.core import engine
from repro_torch.core.types import WorkerState

SPEC = engine.ALGO_SPECS["local_sgd"]


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
