"""Parameter definition substrate (``repro.models.param``).

Models declare their parameters once as a tree of :class:`ParamDef`
(shape + logical axis names + initializer); from it come materialized
parameters (``materialize``) and shape-only templates (``abstract``, meta
tensors — nothing allocated).  Parameters are a nested dict of tensors in
the reference's tree layout, stacked layers on a leading "layers" axis, so
the flat engine lays them out exactly as the reference does.

``jax.random`` cannot be reproduced in torch: ``materialize`` draws from a
``torch.Generator`` under the reference's scale rules (normal with std
1/sqrt(fan-in), fan-in = ``shape[-2]``; an explicit ``scale``; zeros;
ones).  Parity tests carry the JAX parameters across with ``from_numpy``
instead of re-seeding.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_mod


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones
    scale: Optional[float] = None  # stddev; default fan-in

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def _init_one(d: ParamDef, gen: torch.Generator, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    scale = d.scale if d.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    # scaled in place: one fp32 copy of the leaf at a time, not two (the
    # values are those of ``x * scale``, bitwise)
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(dtype)


def materialize(defs: Any, seed: int, dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cpu") -> Any:
    """Draw every leaf, in tree order, from one generator seeded ``seed``
    on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return tree_mod.from_paths(
        [(path, _init_one(d, gen, dtype, device))
         for path, d in tree_mod.leaves_with_path(defs)])


def abstract(defs: Any, dtype: torch.dtype = torch.float32) -> Any:
    """Meta-tensor tree: shapes and dtypes, no storage."""
    return tree_mod.tree_map(
        lambda d: torch.empty(d.shape, dtype=dtype, device="meta"), defs)


def stack_defs(defs: Any, n: int, axis_name: str = "layers") -> Any:
    """Prepend a stacked leading axis (layers / worker) to every leaf."""
    return tree_mod.tree_map(
        lambda d: ParamDef((n, *d.shape), (axis_name, *d.axes), d.init,
                           d.scale), defs)


def from_numpy(tree: Any, device: torch.device | str = "cpu") -> Any:
    """Carry a parameter tree of numpy arrays (e.g. JAX parameters through
    ``np.asarray``) into the port: same keys, values copied exactly."""
    return tree_mod.tree_map(
        lambda x: torch.from_numpy(np.array(x, copy=True)).to(device), tree)
