"""PyTorch port, flat-buffer engine vs the JAX package's
``make_engine(update_backend="xla")``.

vrl_sgd with sgd: both engines start from the same parameters and consume
the same (k, W, R, C) gradient stacks (numpy, pad lanes zero) through
``round_step_flat`` and ``train_step``, with VRL-SGD-W warmup on and off.
Every flat algorithm × sgd, momentum, adam: 13 per-step ``train_step``s at
k = 4, W = 4 (the reference's ``tests/test_engine_parity.py`` matrix).
The update math is bitwise equal op for op (``tests/test_torch_update.py``);
the worker mean may sum in another order, so trajectories are held to the
reference's own engine standard: params atol 1e-5, and Δ — the param
residual divided by k·γ — atol 1e-5/(k·γ).  Paper §4.1: Σ_i Δ_i = 0 (and
BVR's Σ_i B_i = 0) after every sync, to 1e-4 · max|Δ| (fp32 rounding of
x̂).  The spec identities are bitwise in the port: stl_sgd on a constant
schedule is local_sgd; bvr_l_sgd with β = 0 is vrl_sgd.
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


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    """Every algorithm of the reference is ported, the hierarchy with every
    inner optimizer and with its compressed syncs: nothing raises
    NotImplementedError."""
    for name in teng.ALGO_SPECS:
        assert tuple(teng.get_spec(name)) == tuple(jeng.get_spec(name)), name
    assert set(teng.ALGO_SPECS) == set(jeng.ALGO_SPECS)
    assert not getattr(teng, "NOT_PORTED", ())
    assert teng.flat_algorithms() == jeng.flat_algorithms()
    template_t = abstract(TT.model_defs(treg.smoke_arch("qwen2-0.5b")))
    from repro_torch.comm import compressors as tcc
    for inner in ("momentum", "adam"):
        assert teng.make_engine(TVRL(algorithm="hier_vrl_sgd",
                                     inner_optimizer=inner),
                                template_t).grid == (2, 4)
        eng = teng.make_engine(TVRL(algorithm="hier_vrl_sgd",
                                    inner_optimizer=inner,
                                    compress=tcc.parse_compressor("int8")),
                               template_t)
        assert eng.compressors == (tcc.parse_compressor("int8"),) * 2


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


# ------------------------------------------ every flat algorithm x inner
INNER = ["sgd", "momentum", "adam"]
MK, MSTEPS = 4, 13              # 13 steps at k=4: 3 completed sync periods


def _mcfg(mod, alg, inner, k=MK, **over):
    kw = dict(algorithm=alg, comm_period=k, learning_rate=LR,
              weight_decay=1e-3, inner_optimizer=inner,
              momentum=0.9 if inner == "momentum" else 0.0, warmup=False)
    kw.update(over)
    if mod is JVRL:
        kw["update_backend"] = "xla"
    return mod(**kw)


def _matrix_run(setup, alg, inner, steps=MSTEPS, k=MK, **over):
    """Per-step ``train_step`` of both engines over the same numpy
    gradient stacks (a fresh buffer each step: S-SGD overwrites it)."""
    template_j, template_t, params_j = setup
    ej = jeng.make_engine(_mcfg(JVRL, alg, inner, k, **over), template_j)
    et = teng.make_engine(_mcfg(TVRL, alg, inner, k, **over), template_t)
    sj = ej.init(params_j, W)
    st = et.init(from_numpy(jax.tree.map(np.asarray, params_j)), W)
    step_j = jax.jit(ej.train_step)
    for t in range(steps):
        g = _grad_stack(ej.spec, 1, seed=100 + t)[0]
        sj = step_j(sj, jflat.unflatten_stacked(ej.spec, jnp.asarray(g)))
        st = et.train_step(st, torch.from_numpy(g.copy()))
        assert (st.step, st.last_sync) == (int(sj.step), int(sj.last_sync))
    return ej, et, sj, st


def _inner_bufs(inner_state):
    if isinstance(inner_state, tuple) and not inner_state:
        return []
    if isinstance(inner_state, torch.Tensor) or hasattr(inner_state, "shape"):
        return [inner_state]
    return [inner_state.mu, inner_state.nu]


@pytest.mark.parametrize("inner", INNER)
@pytest.mark.parametrize("alg", list(jeng.flat_algorithms()))
def test_engine_matrix_matches_reference(setup, alg, inner):
    """Params atol 1e-5 (the reference's engine standard); Δ, B and the
    first moments are param residuals over k·γ, so atol 1e-5/(k·γ); Adam's
    nu (a square of those) rtol 1e-4; EASGD's center atol 1e-5."""
    ej, et, sj, st = _matrix_run(setup, alg, inner)
    np.testing.assert_allclose(st.params.numpy(), np.asarray(sj.params),
                               rtol=0, atol=1e-5)
    scaled = 1e-5 / (MK * LR)
    for name in ("delta", "bias"):
        a, b = getattr(st, name), getattr(sj, name)
        assert isinstance(a, torch.Tensor) == hasattr(b, "shape"), name
        if isinstance(a, torch.Tensor):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=scaled, err_msg=name)
    ti, ji = _inner_bufs(st.inner), _inner_bufs(sj.inner)
    assert len(ti) == len(ji) == {"sgd": 0, "momentum": 1, "adam": 2}[inner]
    for i, (a, b) in enumerate(zip(ti, ji)):
        if i == 1:      # Adam's nu
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-12)
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=scaled)
    if inner == "adam":
        assert st.inner.count == int(sj.inner.count) == MSTEPS
    assert isinstance(st.center, torch.Tensor) == (alg == "easgd")
    if alg == "easgd":
        np.testing.assert_allclose(st.center.numpy(), np.asarray(sj.center),
                                   rtol=0, atol=1e-5)
    for a, b in zip(jax.tree.leaves(ej.average_model(sj)),
                    tm.leaves(et.average_model(st))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("inner", INNER)
def test_stl_const_schedule_is_local_sgd_bitwise(setup, inner):
    """STL-SGD on a constant schedule IS Local SGD: same kernels, same
    sync rule, same round boundaries — bitwise, in the port."""
    from repro_torch.core.schedule import const_comm
    *_, s1 = _matrix_run(setup, "stl_sgd", inner,
                         comm_schedule=const_comm(MK))
    *_, s2 = _matrix_run(setup, "local_sgd", inner)
    assert torch.equal(s1.params, s2.params)
    assert s1.last_sync == s2.last_sync == 12


@pytest.mark.parametrize("inner", INNER)
@pytest.mark.parametrize("warmup", [False, True])
def test_bvr_zero_beta_is_vrl_sgd_bitwise(setup, inner, warmup):
    """bvr_beta=0 turns B off: the state carries no B and the trajectory
    is bitwise vrl_sgd (params and Δ), in the port."""
    *_, s1 = _matrix_run(setup, "bvr_l_sgd", inner, bvr_beta=0.0,
                         warmup=warmup)
    *_, s2 = _matrix_run(setup, "vrl_sgd", inner, warmup=warmup)
    assert s1.bias == ()
    assert torch.equal(s1.params, s2.params)
    assert torch.equal(s1.delta, s2.delta)


def test_vrl_k1_matches_ssgd(setup):
    """Paper §4.1: VRL-SGD with k=1 is S-SGD (the Δ-corrected local steps
    of one step average to the mean-gradient step), to rounding."""
    *_, s1 = _matrix_run(setup, "vrl_sgd", "sgd", steps=8, k=1)
    *_, s2 = _matrix_run(setup, "ssgd", "sgd", steps=8, k=1)
    np.testing.assert_allclose(s1.params.numpy(), s2.params.numpy(),
                               rtol=1e-4, atol=1e-5)
    assert s2.last_sync == s2.step == 8


@pytest.mark.parametrize("alg", ["vrl_sgd", "bvr_l_sgd"])
@pytest.mark.parametrize("inner", INNER)
def test_delta_and_bias_sum_to_zero_after_sync(setup, alg, inner):
    """Σ_i Δ_i = 0 and Σ_i B_i = 0 after every sync, to fp32 rounding of
    x̂ relative to the largest value the buffer holds."""
    *_, st = _matrix_run(setup, alg, inner, steps=12)
    assert st.last_sync == 12
    for buf in (st.delta, st.bias):
        if isinstance(buf, torch.Tensor):
            sum_b, max_b = teng.sum_invariant(buf)
            assert max_b > 0 and sum_b <= 1e-4 * max_b


def test_schedule_and_moment_options(setup):
    """stl_sgd defaults to doubling 1 → k; a schedule supersedes warmup;
    should_sync follows the reference on every (algorithm, step); bf16
    moments are stored bf16; SM3 raises."""
    from repro_torch.core.schedule import stagewise_doubling
    ct = _mcfg(TVRL, "stl_sgd", "sgd")
    assert teng.comm_schedule(ct) == stagewise_doubling(1, MK)
    assert teng.comm_schedule(_mcfg(TVRL, "vrl_sgd", "sgd")) is None
    for alg in teng.flat_algorithms():
        for warmup in (False, True):
            cj = _mcfg(JVRL, alg, "sgd", warmup=warmup)
            ct = _mcfg(TVRL, alg, "sgd", warmup=warmup)
            for last in (0, 1, 4, 12):
                for step in range(last, last + MK + 2):
                    want = bool(jeng.should_sync(
                        jeng.get_spec(alg), cj, jnp.int32(step),
                        jnp.int32(last)))
                    assert teng.should_sync(teng.get_spec(alg), ct, step,
                                            last) == want
    template_t = setup[1]
    et = teng.make_engine(_mcfg(TVRL, "vrl_sgd", "adam",
                                moment_dtype="bfloat16"), template_t)
    st = et.init(from_numpy(jax.tree.map(np.asarray, setup[2])), 2)
    assert st.inner.mu.dtype == st.inner.nu.dtype == torch.bfloat16
    # SM3 factors Adam's nu into the reference's stats (runs:
    # tests/test_torch_sm3.py)
    ej = jeng.make_engine(_mcfg(JVRL, "vrl_sgd", "adam", sm3=True),
                          setup[0])
    et = teng.make_engine(_mcfg(TVRL, "vrl_sgd", "adam", sm3=True),
                          template_t)
    sj = ej.init(setup[2], 2)
    st = et.init(from_numpy(jax.tree.map(np.asarray, setup[2])), 2)
    for a, b in ((st.inner.nu.row, sj.inner.nu.row),
                 (st.inner.nu.col, sj.inner.nu.col)):
        assert a.shape == b.shape and a.dtype == torch.float32
    # SM3 factors Adam's nu only: inert for momentum, as in the reference
    st = teng.make_engine(_mcfg(TVRL, "vrl_sgd", "momentum", sm3=True),
                          template_t).init(
        from_numpy(jax.tree.map(np.asarray, setup[2])), 2)
    assert isinstance(st.inner, torch.Tensor)


# ------------------------------------------ compressed and overlapped rounds
ROUND_CASES = [("vrl_sgd", "int8", False), ("vrl_sgd", None, True),
               ("bvr_l_sgd", "topk:32", True), ("vrl_sgd", "int8", True),
               ("local_sgd", "topk:4", True), ("easgd", "int8:noef", False)]


@pytest.mark.parametrize("alg,compress,overlap", ROUND_CASES)
def test_round_trajectory_compressed_overlapped(setup, alg, compress,
                                                overlap):
    """The smoke qwen2 layout (2,560 rows), VRL-SGD-W rounds of 1, K, K, K
    through the port's ``round_step_flat``, compressed and/or overlapped,
    against the reference's local steps and sync (or round_begin/
    round_fold) on the same gradients: params atol 1e-5, Δ and B atol
    1e-5/γ (the fold scales by 1/(pend_k γ), the sync by 1/(k γ)), except
    where an int8 level flipped between the packages' roundings: at most a
    few such elements, each within twice the summed step of its row over
    the run's communications; top-k is held to atol
    (``tests/test_torch_compress.py``)."""
    from repro.comm import compressors as jcc
    from repro_torch.comm import compressors as tcc
    from test_torch_compress import close_or_flipped, step_bound
    template_j, template_t, params_j = setup
    kw = dict(algorithm=alg, comm_period=K, learning_rate=LR, warmup=True,
              overlap=overlap)
    ej = jeng.make_engine(JVRL(update_backend="xla", compress=None if
                               compress is None else
                               jcc.parse_compressor(compress), **kw),
                          template_j)
    et = teng.make_engine(TVRL(compress=None if compress is None else
                               tcc.parse_compressor(compress), **kw),
                          template_t)
    sj = ej.init(params_j, W)
    st = et.init(from_numpy(jax.tree.map(np.asarray, params_j)), W)
    assert (et.round_begin is None) == (not overlap)
    local_j = jax.jit(ej.local_step)
    ks = ([1] if teng.get_spec(alg).warmup_aware else []) + [K, K, K]
    bound = 0.0
    for r, k in enumerate(ks):
        gk = _grad_stack(ej.spec, k, seed=60 + r)
        xbar = ej.round_begin(sj, k) if overlap else None
        for g in gk:
            sj = local_j(sj, jflat.unflatten_stacked(ej.spec,
                                                     jnp.asarray(g)))
        if compress is not None and not overlap:
            x = np.asarray(sj.params) - np.asarray(sj.comm.ref)[None]
            if not isinstance(sj.comm.resid, tuple):
                x = x + np.asarray(sj.comm.resid)
            bound += step_bound(compress, x)
        sj = ej.round_fold(sj, xbar) if overlap else ej.sync(sj)
        if compress is not None and overlap:
            bound += step_bound(compress, np.asarray(sj.overlap.pend)
                                - np.asarray(xbar)[None]
                                + np.asarray(sj.comm.resid))
        st = et.round_step_flat(st, torch.from_numpy(gk))
        assert (st.step, st.last_sync) == (int(sj.step), int(sj.last_sync))
    pairs = [("params", st.params, sj.params, 1)]
    for name in ("delta", "bias"):
        a, b = getattr(st, name), getattr(sj, name)
        assert isinstance(a, torch.Tensor) == hasattr(b, "shape")
        if isinstance(a, torch.Tensor):
            pairs.append((name, a, b, 1 / LR))
    if overlap:
        pairs.append(("pend", st.overlap.pend, sj.overlap.pend, 1))
        np.testing.assert_array_equal(st.overlap.pend_k.numpy(),
                                      np.asarray(sj.overlap.pend_k))
    if compress is not None:
        pairs.append(("ref", st.comm.ref, sj.comm.ref, 1))
        if compress != "int8:noef":
            pairs.append(("resid", st.comm.resid, sj.comm.resid, 1))
    flips = {name: close_or_flipped(a.numpy(), b, 1e-5 * scale,
                                    2 * bound * scale, name, compress)
             for name, a, b, scale in pairs}
    print(f"{alg}+{compress}, overlap={overlap}: flipped elements {flips}")
