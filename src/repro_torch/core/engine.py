"""Flat-buffer algorithm engine (``repro.core.engine``, flat branch).

Every algorithm of the reference is the same loop over worker-stacked,
model-sized state: a *local* elementwise update per step (eqs. 5-6: the
inner-optimizer step on the Δ-corrected gradient) and a periodic *sync*
(eq. 4: model averaging plus the Δ update).  ``AlgoSpec`` describes an
algorithm over that loop; ``make_engine`` binds the executor: parameters
and Δ are flattened ONCE at init into contiguous (W, R, C) buffers
(``core/flat``), every local step is one fused kernel pass
(``kernels/vrl_update.fused_local_sgd``) and every sync is one worker mean
plus one fused pass (``fused_sync_vrl``).  The kernels update the buffers
in place.

On one device the worker axis is the leading buffer dimension, and the
worker mean — on a cluster, the one all-reduce per round — is a
``torch.mean`` over it.

The port runs vrl_sgd with the sgd inner optimizer; the reference's other
algorithms (local_sgd, ssgd, easgd, hier_vrl_sgd, stl_sgd, bvr_l_sgd) and
inner optimizers are still to be ported (ROADMAP Queue 1), and asking for
one raises.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree as tree_mod
from repro_torch.configs.base import VRLConfig
from repro_torch.core import flat
from repro_torch.core.types import FlatWorkerState
from repro_torch.kernels import vrl_update as vu


# ===================================================================== specs
class AlgoSpec(NamedTuple):
    """An algorithm as a description over the shared engine."""

    name: str
    use_delta: bool        # local step applies v = g − Δ (eq. 6)
    grad_all_reduce: bool  # S-SGD: mean gradients over workers every step
    sync: str              # rule at period boundaries ("vrl" here)
    has_center: bool       # EASGD center variable x̃
    warmup_aware: bool     # honors VRLConfig.warmup (first period k=1)
    use_bias: bool = False  # BVR-L-SGD: local step also subtracts B
    stagewise: bool = False  # STL-SGD: default to a stagewise CommSchedule


ALGO_SPECS = {
    "vrl_sgd": AlgoSpec("vrl_sgd", use_delta=True, grad_all_reduce=False,
                        sync="vrl", has_center=False, warmup_aware=True),
}

# In the reference, not yet in the port.
NOT_PORTED = ("bvr_l_sgd", "easgd", "hier_vrl_sgd", "local_sgd", "ssgd",
              "stl_sgd")


def get_spec(name: str) -> AlgoSpec:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"algorithm {name!r} is not ported to PyTorch yet; see ROADMAP.md "
            f"Queue 1 (ported: {sorted(ALGO_SPECS)})")
    if name not in ALGO_SPECS:
        raise KeyError(f"unknown algorithm {name!r}; known: "
                       f"{sorted(ALGO_SPECS)}")
    return ALGO_SPECS[name]


def should_sync(spec: AlgoSpec, cfg: VRLConfig, step: int,
                last_sync: int) -> bool:
    """True when ``step`` (post-increment) completes a communication period.

    VRL-SGD-W (Remark 5.3): with ``warmup`` the first period runs k=1.
    """
    if spec.warmup_aware and cfg.warmup and last_sync == 0 and step <= 1:
        k = 1
    else:
        k = cfg.comm_period
    return (step - last_sync) >= k


def delta_invariant(state: FlatWorkerState) -> Tuple[float, float]:
    """(max|Σ_i Δ_i|, max|Δ|): the paper's invariant Σ_i Δ_i = 0 after
    every sync, and the scale its fp32 rounding residue is relative to.
    Reads the state once per value (host sync)."""
    return (state.delta.sum(dim=0).abs().max().item(),
            state.delta.abs().max().item())


# ============================================================ fused executor
class Engine(NamedTuple):
    """Bound flat-buffer-executor closures for one (algorithm, model) pair.

    Every callable taking ``grads`` accepts either a worker-stacked
    gradient tree or an already-flat (W, R, C) gradient buffer.
    """

    algorithm: str
    spec: flat.FlatSpec
    algo: AlgoSpec
    init: Callable              # (params_tree, num_workers) -> state
    train_step: Callable        # (state, grads) -> state
    local_step: Callable        # (state, grads) -> state
    sync: Callable              # (state,) -> state
    average_model: Callable     # (state,) -> single-model tree
    params_tree: Callable       # (state,) -> worker-stacked params tree (views)
    round_step: Callable        # (state, grads_k) -> state: k local steps + sync
    round_end: Callable         # (state,) -> state: the round-closing sync
    round_step_flat: Callable   # (state, gk) -> state over (k, W, R, C) grads


def make_engine(cfg: VRLConfig, template: Any, *,
                device: Optional[torch.device] = None) -> Engine:
    """Build the flat-buffer engine for ``cfg.algorithm`` over ``template``
    (a single-model tree of meta tensors, tensors or ``(shape, dtype)``
    pairs).  ``device`` places the state; default: where ``init``'s
    parameters lie."""
    algo = get_spec(cfg.algorithm)
    ecfg = cfg.engine
    fspec = flat.make_spec(template, lanes=ecfg.lanes, block=ecfg.block,
                           max_waste=ecfg.max_pad_waste)
    lr, wd = cfg.learning_rate, cfg.weight_decay
    delta_dt = flat.dtype_of(cfg.delta_dtype)

    def _wmean(buf: torch.Tensor) -> torch.Tensor:
        """Worker mean of a (W, R, C) buffer -> (R, C): on one device a
        reduction over dim 0 (on a cluster, the round's one all-reduce)."""
        return buf.mean(dim=0)

    def _gbuf(grads: Any) -> torch.Tensor:
        if isinstance(grads, torch.Tensor):
            return grads
        return flat.flatten_stacked(fspec, grads,
                                    dtype=flat.dtype_of(fspec.dtype))

    def init(params: Any, num_workers: int) -> FlatWorkerState:
        flat1 = flat.flatten_tree(fspec, params)
        if device is not None:
            flat1 = flat1.to(device)
        stacked = flat1.unsqueeze(0).repeat(num_workers, 1, 1)
        delta = (torch.zeros(stacked.shape, dtype=delta_dt,
                             device=stacked.device)
                 if algo.use_delta else ())
        return FlatWorkerState(params=stacked, delta=delta, step=0,
                               last_sync=0)

    def local_step(state: FlatWorkerState, grads: Any) -> FlatWorkerState:
        g = _gbuf(grads)
        d = state.delta if algo.use_delta else None
        vu.fused_local_sgd(state.params, g, d, lr=lr, wd=wd,
                           block=fspec.block)
        return state._replace(step=state.step + 1)

    def sync(state: FlatWorkerState) -> FlatWorkerState:
        xbar = _wmean(state.params)
        # k_eff·γ as an fp32 product made on the device: no host round trip
        k_eff = max(state.step - state.last_sync, 1)
        scal = torch.full((1, 1), float(k_eff), dtype=torch.float32,
                          device=state.params.device) * lr
        vu.fused_sync_vrl(state.params, xbar.to(state.params.dtype),
                          state.delta, scal, block=fspec.block)
        return state._replace(last_sync=state.step)

    def train_step(state: FlatWorkerState, grads: Any) -> FlatWorkerState:
        state = local_step(state, grads)
        if should_sync(algo, cfg, state.step, state.last_sync):
            state = sync(state)
        return state

    def round_step_flat(state: FlatWorkerState,
                        gk: torch.Tensor) -> FlatWorkerState:
        """k local steps over a (k, W, R, C) grads buffer, then the
        round-closing sync.  The round IS the communication period — the
        caller sizes gk (warmup's first k=1 period is a 1-step round)."""
        for g in gk:
            state = local_step(state, g)
        return sync(state)

    def round_step(state: FlatWorkerState, grads_k: Any) -> FlatWorkerState:
        """``round_step_flat`` over a grads tree with (k, W, ...) leaves."""
        k = tree_mod.leaves(grads_k)[0].shape[0]
        for i in range(k):
            state = local_step(state, tree_mod.tree_map(
                lambda x: x[i], grads_k))
        return sync(state)

    def params_tree(state: FlatWorkerState) -> Any:
        """Worker-stacked parameter tree of views into ``state.params``."""
        return flat.unflatten_stacked(fspec, state.params)

    def avg_model(state: FlatWorkerState) -> Any:
        """x̂ — the evaluation model (the paper reports metrics on it)."""
        return flat.unflatten_tree(fspec, _wmean(state.params))

    return Engine(algorithm=cfg.algorithm, spec=fspec, algo=algo, init=init,
                  train_step=train_step, local_step=local_step, sync=sync,
                  average_model=avg_model, params_tree=params_tree,
                  round_step=round_step, round_end=sync,
                  round_step_flat=round_step_flat)
