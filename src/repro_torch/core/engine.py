"""Flat-buffer algorithm engine (``repro.core.engine``, flat branch).

Every algorithm of the reference is the same loop over worker-stacked,
model-sized state: a *local* elementwise update per step (eqs. 5-6: the
inner-optimizer step on the Δ-corrected gradient) and a periodic *sync*
(eq. 4: model averaging plus the Δ update).  ``AlgoSpec`` describes an
algorithm over that loop; ``make_engine`` binds the executor: parameters,
Δ, B and the inner-optimizer moments are flattened ONCE at init into
contiguous (W, R, C) buffers (``core/flat``), every local step is one
fused kernel pass (``kernels/vrl_update.fused_local_{sgd,momentum,adam}``)
and every sync is one worker mean plus at most one fused pass
(``fused_sync_{vrl,bvr,easgd}``; local_sgd's average is a broadcast copy).
The kernels update the buffers in place.

On one device the worker axis is the leading buffer dimension, and the
worker mean — on a cluster, the one all-reduce per round — is a
``torch.mean`` over it.

The port runs every flat algorithm (vrl_sgd, local_sgd, ssgd, easgd,
stl_sgd, bvr_l_sgd) with the sgd, momentum and adam inner optimizers;
hier_vrl_sgd and SM3-factored Adam are still to be ported (ROADMAP
Queue 1), and asking for either raises.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree as tree_mod
from repro_torch.configs.base import VRLConfig
from repro_torch.core import flat
from repro_torch.core import schedule as schedule_mod
from repro_torch.core.types import FlatWorkerState
from repro_torch.kernels import vrl_update as vu
from repro_torch.optim import optimizers as opt_mod


# ===================================================================== specs
class AlgoSpec(NamedTuple):
    """An algorithm as a description over the shared engine.

    ``sync`` names the rule that runs at period boundaries; "bvr" is the
    VRL rule plus BVR-L-SGD's bias-variate EMA.
    """

    name: str
    use_delta: bool        # local step applies v = g − Δ (eq. 6)
    grad_all_reduce: bool  # S-SGD: mean gradients over workers every step
    sync: str              # "vrl" | "average" | "elastic" | "none" | "bvr"
    has_center: bool       # EASGD center variable x̃
    warmup_aware: bool     # honors VRLConfig.warmup (first period k=1)
    use_bias: bool = False  # BVR-L-SGD: local step also subtracts B
    stagewise: bool = False  # STL-SGD: default to a stagewise CommSchedule


ALGO_SPECS = {
    "vrl_sgd": AlgoSpec("vrl_sgd", use_delta=True, grad_all_reduce=False,
                        sync="vrl", has_center=False, warmup_aware=True),
    "local_sgd": AlgoSpec("local_sgd", use_delta=False, grad_all_reduce=False,
                          sync="average", has_center=False,
                          warmup_aware=False),
    "ssgd": AlgoSpec("ssgd", use_delta=False, grad_all_reduce=True,
                     sync="none", has_center=False, warmup_aware=False),
    "easgd": AlgoSpec("easgd", use_delta=False, grad_all_reduce=False,
                      sync="elastic", has_center=True, warmup_aware=False),
    # STL-SGD (Shen et al., 2020): Local SGD whose period grows stagewise;
    # the cadence comes from the CommSchedule (comm_schedule() below), so
    # with a constant schedule the trajectory is bitwise local_sgd.
    "stl_sgd": AlgoSpec("stl_sgd", use_delta=False, grad_all_reduce=False,
                        sync="average", has_center=False,
                        warmup_aware=False, stagewise=True),
    # BVR-L-SGD (Murata & Suzuki, 2021): VRL-SGD plus a bias variate B_i,
    # an EMA (rate cfg.bvr_beta) of the per-round drift (x̂ − x_i)/(k_eff γ),
    # subtracted in every local step alongside Δ_i.  Σ_i B_i = 0 after every
    # sync; bvr_beta=0 disables it — the trajectory is then bitwise vrl_sgd.
    "bvr_l_sgd": AlgoSpec("bvr_l_sgd", use_delta=True,
                          grad_all_reduce=False, sync="bvr",
                          has_center=False, warmup_aware=True,
                          use_bias=True),
}

# In the reference, not yet in the port.
NOT_PORTED = ("hier_vrl_sgd",)


def get_spec(name: str) -> AlgoSpec:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"algorithm {name!r} is not ported to PyTorch yet; see ROADMAP.md "
            f"Queue 1 (ported: {sorted(ALGO_SPECS)})")
    if name not in ALGO_SPECS:
        raise KeyError(f"unknown algorithm {name!r}; known: "
                       f"{sorted(ALGO_SPECS)}")
    return ALGO_SPECS[name]


def flat_algorithms() -> Tuple[str, ...]:
    """Names of the flat (non-hierarchical) algorithms, sorted."""
    return tuple(sorted(ALGO_SPECS))


def comm_schedule(cfg: VRLConfig):
    """The round schedule driving this config's sync cadence.

    ``cfg.comm_schedule`` when set; stl_sgd defaults to the STL-SGD
    stagewise-doubling ramp 1 → ``comm_period``; None otherwise (the
    constant ``comm_period`` cadence).  A schedule supersedes ``warmup``.
    """
    if cfg.comm_schedule is not None:
        return cfg.comm_schedule
    if get_spec(cfg.algorithm).stagewise:
        return schedule_mod.stagewise_doubling(k0=1, k_max=cfg.comm_period)
    return None


def use_bias(spec: AlgoSpec, cfg: VRLConfig) -> bool:
    """True when the BVR bias variate is active (``bvr_beta == 0`` turns
    B off, so the run is bitwise the underlying VRL-SGD)."""
    return spec.use_bias and bool(cfg.bvr_beta)


def should_sync(spec: AlgoSpec, cfg: VRLConfig, step: int,
                last_sync: int) -> bool:
    """True when ``step`` (post-increment) completes a communication period.

    With a ``CommSchedule`` the period is the schedule's for the round
    starting at ``last_sync``; otherwise the constant ``comm_period``.
    VRL-SGD-W (Remark 5.3): with ``warmup`` the first period runs k=1.
    """
    sched = comm_schedule(cfg)
    if sched is not None:
        k = sched.period_starting_at(last_sync)
    elif spec.warmup_aware and cfg.warmup and last_sync == 0 and step <= 1:
        k = 1
    else:
        k = cfg.comm_period
    return (step - last_sync) >= k


def sum_invariant(buf: torch.Tensor) -> Tuple[float, float]:
    """(max|Σ_i buf_i|, max|buf|) over the worker axis: the paper's
    invariant Σ_i Δ_i = 0 after every sync (and BVR's Σ_i B_i = 0), and
    the scale its fp32 rounding residue is relative to.  Reads the state
    once per value (host sync)."""
    return (buf.sum(dim=0).abs().max().item(), buf.abs().max().item())


_ADAM_B1, _ADAM_B2 = opt_mod.ADAM_B1, opt_mod.ADAM_B2
_MOMENT_DTYPES = ("float32", "bfloat16")


def _moment_opts(cfg: VRLConfig, kind: str) -> torch.dtype:
    """The moment storage dtype.  The kernels compute fp32 in-register;
    ``moment_dtype`` only picks what persists between steps.  SM3 factors
    Adam's second moment only, so it is inert for sgd/momentum, as in the
    reference; for adam it is not ported and raises."""
    name = cfg.moment_dtype
    if name not in _MOMENT_DTYPES:
        raise ValueError(f"unknown moment_dtype {name!r}; known: "
                         f"{_MOMENT_DTYPES}")
    if cfg.sm3 and kind == "adam":
        raise NotImplementedError(
            "SM3-factored Adam (sm3=True) is not ported to PyTorch yet; see "
            "ROADMAP.md Queue 1")
    return flat.dtype_of(name)


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
    kind, beta = opt_mod.inner_kind(cfg)
    mdt = _moment_opts(cfg, kind)
    lr, wd = cfg.learning_rate, cfg.weight_decay
    delta_dt = flat.dtype_of(cfg.delta_dtype)
    bias_on = use_bias(algo, cfg)

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

        def zeros(dtype):
            return torch.zeros(stacked.shape, dtype=dtype,
                               device=stacked.device)
        if kind == "sgd":
            inner = ()
        elif kind == "momentum":
            inner = zeros(mdt)
        else:
            inner = opt_mod.AdamState(zeros(mdt), zeros(mdt), 0)
        return FlatWorkerState(
            params=stacked, delta=zeros(delta_dt) if algo.use_delta else (),
            step=0, last_sync=0, inner=inner,
            center=(flat1.to(torch.float32, copy=True) if algo.has_center
                    else ()),
            bias=zeros(delta_dt) if bias_on else ())

    def local_step(state: FlatWorkerState, grads: Any) -> FlatWorkerState:
        """One local step.  S-SGD first overwrites the (W, R, C) gradient
        buffer with its worker mean, in place (no second W× buffer)."""
        g = _gbuf(grads)
        if algo.grad_all_reduce:
            g.copy_(_wmean(g).unsqueeze(0).expand_as(g))
        p = state.params
        d = state.delta if algo.use_delta else None
        b = state.bias if bias_on else None
        inner = state.inner
        if kind == "sgd":
            vu.fused_local_sgd(p, g, d, b=b, lr=lr, wd=wd, block=fspec.block)
        elif kind == "momentum":
            vu.fused_local_momentum(p, g, d, inner, b=b, lr=lr, beta=beta,
                                    wd=wd, block=fspec.block)
        else:
            count = inner.count + 1
            scal = opt_mod.adam_scal(count, p.device, _ADAM_B1, _ADAM_B2)
            vu.fused_local_adam(p, g, d, inner.mu, inner.nu, scal, b=b,
                                lr=lr, b1=_ADAM_B1, b2=_ADAM_B2, wd=wd,
                                block=fspec.block)
            inner = inner._replace(count=count)
        out = state._replace(inner=inner, step=state.step + 1)
        if algo.grad_all_reduce:
            out = out._replace(last_sync=state.step + 1)
        return out

    def sync(state: FlatWorkerState) -> FlatWorkerState:
        p = state.params
        if algo.sync == "none":
            return state._replace(last_sync=state.step)
        if algo.sync == "elastic":
            n = p.shape[0]
            a = cfg.easgd_alpha / n
            # x̂ of the PRE-sync parameters, before the worker pass
            xbar = _wmean(p.to(torch.float32))
            vu.fused_sync_easgd(p, xbar, state.center, a=a, na=n * a,
                                block=fspec.block)
            return state._replace(last_sync=state.step)
        xbar = _wmean(p)
        if algo.sync == "average":
            p.copy_(xbar.unsqueeze(0).expand_as(p))
            return state._replace(last_sync=state.step)
        # "vrl"/"bvr": k_eff·γ as an fp32 product made on the device — no
        # host round trip
        k_eff = max(state.step - state.last_sync, 1)
        scal = torch.full((1, 1), float(k_eff), dtype=torch.float32,
                          device=p.device) * lr
        if algo.sync == "bvr" and bias_on:
            vu.fused_sync_bvr(p, xbar.to(p.dtype), state.delta, state.bias,
                              scal, beta=cfg.bvr_beta, block=fspec.block)
        else:
            vu.fused_sync_vrl(p, xbar.to(p.dtype), state.delta, scal,
                              block=fspec.block)
        return state._replace(last_sync=state.step)

    def train_step(state: FlatWorkerState, grads: Any) -> FlatWorkerState:
        state = local_step(state, grads)
        if algo.sync != "none" and should_sync(algo, cfg, state.step,
                                               state.last_sync):
            state = sync(state)
        return state

    def round_step_flat(state: FlatWorkerState,
                        gk: torch.Tensor) -> FlatWorkerState:
        """k local steps over a (k, W, R, C) grads buffer, then the
        round-closing sync.  The round IS the communication period — the
        caller sizes gk (warmup's first k=1 period is a 1-step round, a
        CommSchedule sizes each round from its stage)."""
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
