"""Synchronous SGD baseline [Ghadimi & Lan 2013] (``repro.core.ssgd``):
gradient all-reduce every step — the reference point for linear iteration
speedup, communication complexity O(T).  ``SPEC`` (gradient all-reduce, no
periodic sync) over ``core/engine``'s per-leaf reference executor.
"""
from __future__ import annotations

from typing import Any

from repro_torch.configs.base import VRLConfig
from repro_torch.core import engine
from repro_torch.core.types import WorkerState

SPEC = engine.ALGO_SPECS["ssgd"]


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
