"""Uniform algorithm interface (``repro.core.api``).

    alg = get_algorithm("vrl_sgd")
    state = alg.init(vrl_cfg, params, num_workers)
    state = alg.train_step(vrl_cfg, state, worker_grads)   # grads: (W, ...)
    model = alg.average_model(state)

Every algorithm is a thin ``engine.AlgoSpec`` description executed by
``core/engine``.  ``get_algorithm`` returns the per-leaf reference
executor (tree-structured state, easy to inspect; it launches no kernel);
the flat-buffer executor over the CUDA kernels is ``engine.make_engine``,
which the train loop picks by ``VRLConfig.update_backend``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.core import (
    bvr_l_sgd,
    easgd,
    engine,
    hierarchical,
    local_sgd,
    ssgd,
    stl_sgd,
    vrl_sgd,
)


class Algorithm(NamedTuple):
    name: str
    init: Callable
    train_step: Callable
    local_step: Callable
    sync: Callable
    average_model: Callable


_ALGS = {
    "vrl_sgd": vrl_sgd,
    "local_sgd": local_sgd,
    "ssgd": ssgd,
    "easgd": easgd,
    "hier_vrl_sgd": hierarchical,
    "stl_sgd": stl_sgd,
    "bvr_l_sgd": bvr_l_sgd,
}


def get_algorithm(name: str) -> Algorithm:
    if name not in _ALGS:
        raise KeyError(f"unknown algorithm {name!r}; known: {sorted(_ALGS)}")
    m = _ALGS[name]
    return Algorithm(
        name=name,
        init=m.init,
        train_step=m.train_step,
        local_step=m.local_step,
        sync=m.sync,
        average_model=getattr(m, "average_model", engine.average_model),
    )


def get_spec(name: str) -> engine.AlgoSpec:
    """The algorithm's engine description (correction term + sync rule)."""
    return engine.get_spec(name)


def list_algorithms() -> list[str]:
    return sorted(_ALGS)
