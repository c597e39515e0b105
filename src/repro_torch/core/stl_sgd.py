"""STL-SGD [Shen et al. 2020] (``repro.core.stl_sgd``): Local SGD with a
stagewise communication period.  The update structure IS Local SGD's; the
period grows stagewise (``core.schedule.CommSchedule``, by default the
doubling ramp 1 → ``comm_period``, ``engine.comm_schedule``), so on a
constant schedule the trajectory is bitwise Local SGD.  ``SPEC`` over
``core/engine``'s per-leaf reference executor.
"""
from __future__ import annotations

from typing import Any

from repro_torch.configs.base import VRLConfig
from repro_torch.core import engine
from repro_torch.core.types import WorkerState

SPEC = engine.ALGO_SPECS["stl_sgd"]


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
