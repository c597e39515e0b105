"""PyTorch port, flat-buffer engine (vrl_sgd, sgd inner) vs the JAX
package's ``make_engine(update_backend="xla")``.

Both engines start from the same parameters and consume the same
(k, W, R, C) gradient stacks (numpy, pad lanes zero) through
``round_step_flat``, with VRL-SGD-W warmup on and off.  The update math is
bitwise equal op for op (``tests/test_torch_update.py``); the worker mean
may sum in another order, so trajectories are held to the reference's own
engine standard (``tests/test_engine_parity.py``): params atol 1e-5, and Δ
— the param residual divided by k·γ — atol 1e-5/(k·γ).  Paper §4.1:
Σ_i Δ_i = 0 after every sync, to 1e-4 · max|Δ| (fp32 rounding of x̂).
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import VRLConfig as JVRL  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import flat as jflat  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import tree as tm  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import VRLConfig as TVRL  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import flat as tflat  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.param import abstract, from_numpy  # noqa: E402

W, K, LR = 4, 3, 0.05


@pytest.fixture(scope="module")
def setup():
    cfg_j = jreg.smoke_arch("qwen2-0.5b")
    template_j = jax.eval_shape(functools.partial(JT.init_params, cfg_j),
                                jax.random.PRNGKey(0))
    template_t = abstract(TT.model_defs(treg.smoke_arch("qwen2-0.5b")))
    params_j = JT.init_params(cfg_j, jax.random.PRNGKey(3))
    return template_j, template_t, params_j


def _grad_stack(spec_j, k, seed):
    """(k, W, R, C) fp32 gradients with zero pad lanes."""
    rng = np.random.RandomState(seed)
    out = np.zeros((k, W, spec_j.rows, spec_j.lanes), np.float32)
    flat_view = out.reshape(k, W, -1)
    flat_view[:, :, :spec_j.size] = rng.randn(k, W, spec_j.size)
    return out


def _engines(setup, warmup):
    template_j, template_t, params_j = setup
    ej = jeng.make_engine(JVRL(comm_period=K, learning_rate=LR,
                               warmup=warmup, update_backend="xla"),
                          template_j)
    et = teng.make_engine(TVRL(comm_period=K, learning_rate=LR,
                               warmup=warmup), template_t)
    sj = ej.init(params_j, W)
    st = et.init(from_numpy(jax.tree.map(np.asarray, params_j)), W)
    return ej, et, sj, st


@pytest.mark.parametrize("warmup", [False, True])
def test_round_trajectory_matches_reference(setup, warmup):
    ej, et, sj, st = _engines(setup, warmup)
    assert et.spec.meta() == ej.spec.meta()
    np.testing.assert_array_equal(st.params.numpy(), np.asarray(sj.params))
    round_j = jax.jit(ej.round_step_flat)
    ks = ([1] if warmup else []) + [K, K, K]
    for r, k in enumerate(ks):
        gk = _grad_stack(ej.spec, k, seed=10 + r)
        sj = round_j(sj, jnp.asarray(gk))
        st = et.round_step_flat(st, torch.from_numpy(gk))
        assert (st.step, st.last_sync) == (int(sj.step), int(sj.last_sync))
        np.testing.assert_allclose(st.params.numpy(), np.asarray(sj.params),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(st.delta.numpy(), np.asarray(sj.delta),
                                   rtol=0, atol=1e-5 / (k * LR))
        # paper §4.1: Σ_i Δ_i = 0 after every sync, to fp32 rounding: the
        # mean x̂ is rounded, and Σ_i (x̂ − p_i)/(kγ) keeps that rounding
        # (≈ W·ulp(max|p|)/(kγ)); the reference's engine carries the same
        sum_d = st.delta.sum(dim=0).abs().max().item()
        assert sum_d <= 1e-4 * st.delta.abs().max().item()
        assert sum_d <= 4 * np.abs(np.asarray(sj.delta).sum(axis=0)).max()
        # every worker holds x̂ after the sync
        assert torch.equal(st.params[0], st.params[-1])
    for a, b in zip(jax.tree.leaves(ej.average_model(sj)),
                    tm.leaves(et.average_model(st))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("warmup", [False, True])
def test_per_step_train_step_matches_reference(setup, warmup):
    """The per-step driver (local step + sync on the should_sync cadence)
    against the reference's ``train_step`` over the same gradients."""
    ej, et, sj, st = _engines(setup, warmup)
    step_j = jax.jit(ej.train_step)
    for t in range(2 * K + 2):
        g = _grad_stack(ej.spec, 1, seed=40 + t)[0]
        gtree = jflat.unflatten_stacked(ej.spec, jnp.asarray(g))
        sj = step_j(sj, gtree)
        st = et.train_step(st, torch.from_numpy(g))
        assert (st.step, st.last_sync) == (int(sj.step), int(sj.last_sync))
    np.testing.assert_allclose(st.params.numpy(), np.asarray(sj.params),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(st.delta.numpy(), np.asarray(sj.delta),
                               rtol=0, atol=1e-5 / (K * LR))


@pytest.mark.parametrize("warmup", [False, True])
def test_should_sync_matches_reference(warmup):
    spec_j, spec_t = jeng.get_spec("vrl_sgd"), teng.get_spec("vrl_sgd")
    cj = JVRL(comm_period=K, warmup=warmup)
    ct = TVRL(comm_period=K, warmup=warmup)
    for last in (0, 1, 4):
        for step in range(last, last + K + 2):
            want = bool(jeng.should_sync(spec_j, cj, jnp.int32(step),
                                         jnp.int32(last)))
            assert teng.should_sync(spec_t, ct, step, last) == want


def test_specs_and_unported_algorithms():
    assert teng.get_spec("vrl_sgd") == jeng.get_spec("vrl_sgd")
    assert set(teng.NOT_PORTED) | set(teng.ALGO_SPECS) == set(jeng.ALGO_SPECS)
    for name in teng.NOT_PORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            teng.get_spec(name)


def test_tree_grads_equal_flat_grads(setup):
    """``local_step`` and ``round_step`` take worker-stacked gradient trees,
    ``local_step``/``round_step_flat`` the flat buffers: same results."""
    _, et, _, st = _engines(setup, False)
    _, _, _, st2 = _engines(setup, False)
    g = torch.from_numpy(_grad_stack(et.spec, 1, seed=7)[0])
    st = et.local_step(st, g)
    st2 = et.local_step(st2, tflat.unflatten_stacked(et.spec, g))
    assert torch.equal(st.params, st2.params)
    gk = torch.from_numpy(_grad_stack(et.spec, K, seed=8))
    gk_tree = tm.tree_map(
        lambda *xs: torch.stack(xs),
        *[tflat.unflatten_stacked(et.spec, g) for g in gk])
    st = et.round_step_flat(st, gk)
    st2 = et.round_step(st2, gk_tree)
    assert (st.step, st.last_sync) == (st2.step, st2.last_sync) == (1 + K,
                                                                   1 + K)
    assert torch.equal(st.params, st2.params)
    assert torch.equal(st.delta, st2.delta)
