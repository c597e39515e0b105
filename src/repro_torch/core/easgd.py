"""EASGD baseline [Zhang, Choromanska & LeCun 2015], periodic variant
(``repro.core.easgd``).

Each worker runs k local steps; at a communication round the workers and
the center variable x̃ pull toward each other elastically:

    x_i ← x_i − α (x_i − x̃)
    x̃  ← x̃ + α Σ_i (x_i − x̃)   =  (1 − Nα) x̃ + Nα · x̄

``SPEC`` (no correction, "elastic" sync, a center variable) over
``core/engine``'s per-leaf reference executor.
"""
from __future__ import annotations

from typing import Any

from repro_torch.configs.base import VRLConfig
from repro_torch.core import engine
from repro_torch.core.types import WorkerState

SPEC = engine.ALGO_SPECS["easgd"]


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
