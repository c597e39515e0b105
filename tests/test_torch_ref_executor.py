"""PyTorch port, the per-leaf reference executor (``repro_torch.core
.get_algorithm``, ``update_backend="reference"``) vs the JAX package.

* The algorithm claims the reference's own tests hold
  (``tests/test_vrl_core.py``, ``test_vrl_properties.py``,
  ``test_schedule.py``), run on the port: VRL-SGD converges on the
  non-identical quadratic where Local SGD stalls; k = 1 is S-SGD; Δ ≡ 0
  is Local SGD; Σ_i Δ_i = 0 after every sync; x̂ follows eq. (8); the
  warm-up; the Δ update's closed form; EASGD's pull; every flat algorithm
  converges on identical objectives; the sqrt schedule.
* Per-leaf parity with ``repro.core.get_algorithm`` from transferred
  parameters, both fed the same gradients each step (the JAX state's
  pseudo-gradients, as numpy): all seven algorithms × sgd, momentum and
  adam, 13 steps at k = 4 (the hierarchy on a (2, 2) grid at k1 = 2,
  k2 = 4), params atol 1e-5 and Δ, B atol 1e-5/(k·γ) (the hierarchy's Δ
  at the reference's ``datol``); Adam under the rule of the port's other
  parity tests: all but 1 % of the elements within those, every element
  within 2γ per step.  Compressed syncs (int8, topk:4) for vrl_sgd, ssgd,
  easgd and the hierarchy under the flip rule of
  ``tests/test_torch_compress.py``: at most 16 + 1 per 1e3 elements of a
  buffer beyond atol, each within twice the summed largest row step of
  the run's payloads (one int8 level or top-k pick flipped).
* The port's per-leaf executor against the port's flat engine at the
  tolerances of ``tests/test_engine_parity.py`` (each from its own
  params' gradients): params and the average model atol 1e-5.
* ``make_train_step`` with ``update_backend="reference"`` against the
  JAX package's, on a tiny LM, and the refusals of both packages
  (overlap and membership with the reference backend; "xla" on the card).
* ``launch.train --backend reference --device cpu`` for vrl_sgd and the
  hierarchy with int8: finite losses, the Σ Δ (and EF-term) checks in the
  log, no kernel launched.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.comm import compressors as jcc  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import HierConfig as JHier  # noqa: E402
from repro.configs.base import VRLConfig as JVRL  # noqa: E402
from repro.core import get_algorithm as j_get  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train.train_loop import make_train_step as j_make  # noqa: E402
from repro_torch import tree as tm  # noqa: E402
from repro_torch.comm import compressors as tcc  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import HierConfig as THier  # noqa: E402
from repro_torch.configs.base import VRLConfig as TVRL  # noqa: E402
from repro_torch.core import (engine as teng, flat_algorithms,  # noqa: E402
                              get_algorithm, hierarchical as TH, list_algorithms,
                              make_engine)
from repro_torch.core.schedule import (const_schedule,  # noqa: E402
                                       sqrt_schedule, total_syncs)
from repro_torch.kernels import vrl_update as tvu  # noqa: E402
from repro_torch.launch import train as t_launch  # noqa: E402
from repro_torch.models.param import from_numpy  # noqa: E402
from repro_torch.train.train_loop import make_train_step as t_make  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------- the algorithm claims
def quad_grads(b):
    """Appendix E: f1=(x+2b)^2, f2=2(x-b)^2 (zero within-worker noise)."""
    def grads(params):
        x = params["x"]
        return {"x": torch.stack([2 * (x[0] + 2 * b), 4 * (x[1] - b)])}
    return grads


def run(alg_name, k, steps, lr=0.05, b=5.0, warmup=False):
    cfg = TVRL(algorithm=alg_name, comm_period=k, learning_rate=lr,
               weight_decay=0.0, warmup=warmup)
    alg = get_algorithm(alg_name)
    state = alg.init(cfg, {"x": torch.tensor([1.0])}, 2)
    g = quad_grads(b)
    for _ in range(steps):
        state = alg.train_step(cfg, state, g(state.params))
    return alg, cfg, state


@pytest.mark.parametrize("alg_name,far", [("vrl_sgd", False),
                                          ("local_sgd", True)])
def test_nonidentical_quadratic_vrl_converges_local_sgd_stalls(alg_name,
                                                               far):
    alg, _, state = run(alg_name, k=16, steps=1500)
    xhat = float(alg.average_model(state)["x"][0])
    # Local SGD's biased fixed point grows with k (paper App. E)
    assert abs(xhat) > 0.5 if far else abs(xhat) < 1e-4


def test_vrl_k1_equals_ssgd():
    _, _, s_vrl = run("vrl_sgd", k=1, steps=50)
    _, _, s_ssgd = run("ssgd", k=1, steps=50)
    np.testing.assert_allclose(s_vrl.params["x"].numpy(),
                               s_ssgd.params["x"].numpy(), rtol=1e-4,
                               atol=1e-5)


def test_vrl_zero_delta_equals_local_sgd():
    cfg = TVRL(algorithm="vrl_sgd", comm_period=8, learning_rate=0.05,
               weight_decay=0.0, warmup=False)
    alg_v, alg_l = get_algorithm("vrl_sgd"), get_algorithm("local_sgd")
    sv = alg_v.init(cfg, {"x": torch.tensor([1.0])}, 2)
    sl = alg_l.init(cfg, {"x": torch.tensor([1.0])}, 2)
    g = quad_grads(3.0)
    for _ in range(40):
        sv = alg_v.train_step(cfg, sv, g(sv.params))
        sv = sv._replace(delta=tm.tree_map(torch.zeros_like, sv.delta))
        sl = alg_l.train_step(cfg, sl, g(sl.params))
    np.testing.assert_allclose(sv.params["x"].numpy(),
                               sl.params["x"].numpy(), rtol=1e-6)


def test_delta_sums_to_zero_and_easgd_pulls_to_center():
    _, _, state = run("vrl_sgd", k=8, steps=64)
    assert abs(float(state.delta["x"].sum())) < 1e-5
    _, _, state = run("easgd", k=4, steps=40, b=0.0)
    assert abs(float(state.center["x"][0])) < 1.0


def test_average_model_follows_eq8():
    cfg = TVRL(algorithm="vrl_sgd", comm_period=4, learning_rate=0.1,
               weight_decay=0.0, warmup=False)
    alg = get_algorithm("vrl_sgd")
    state = alg.init(cfg, {"x": torch.tensor([2.0])}, 2)
    g = quad_grads(1.0)
    xhat_manual = 2.0
    for _ in range(20):
        grads = g(state.params)
        xhat_manual = xhat_manual - 0.1 * float(grads["x"].mean())
        state = alg.train_step(cfg, state, grads)
        assert abs(float(alg.average_model(state)["x"][0])
                   - xhat_manual) < 1e-5


def test_warmup_syncs_after_first_step():
    cfg = TVRL(algorithm="vrl_sgd", comm_period=10, learning_rate=0.05,
               weight_decay=0.0, warmup=True)
    alg = get_algorithm("vrl_sgd")
    state = alg.init(cfg, {"x": torch.tensor([1.0])}, 2)
    state = alg.train_step(cfg, state, quad_grads(5.0)(state.params))
    assert state.last_sync == 1
    d = state.delta["x"].numpy()
    assert abs(d.sum()) < 1e-5 and abs(d[0]) > 1.0


def test_delta_matches_eq4_closed_form():
    lr, k = 0.05, 5
    cfg = TVRL(algorithm="vrl_sgd", comm_period=k, learning_rate=lr,
               weight_decay=0.0, warmup=False)
    alg = get_algorithm("vrl_sgd")
    state = alg.init(cfg, {"x": torch.tensor([1.0])}, 2)
    g = quad_grads(2.0)
    prev_delta = state.delta["x"].numpy().copy()
    for _ in range(k):
        pre = state
        state = alg.train_step(cfg, state, g(state.params))
    # the functional executor left ``pre`` as it was: replay its last step
    x = alg.local_step(cfg, pre, g(pre.params)).params["x"].numpy()
    expect = prev_delta + (x.mean(axis=0, keepdims=True) - x) / (k * lr)
    np.testing.assert_allclose(state.delta["x"].numpy(), expect, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("alg_name", flat_algorithms())
def test_identical_case_all_converge(alg_name):
    alg, _, state = run(alg_name, k=8, steps=800, b=0.0)
    assert abs(float(alg.average_model(state)["x"][0])) < 1e-3


def _run_random(seed, n_workers, k, lr, steps, dim=3):
    rng = np.random.RandomState(seed)
    cfg = TVRL(algorithm="vrl_sgd", comm_period=k, learning_rate=lr,
               weight_decay=0.0, warmup=False)
    alg = get_algorithm("vrl_sgd")
    state = alg.init(cfg, {"w": torch.zeros((dim,))}, n_workers)
    xhat_manual = np.zeros(dim, np.float64)
    for _ in range(steps):
        g = rng.randn(n_workers, dim).astype(np.float32)
        xhat_manual -= lr * g.mean(axis=0)
        state = alg.train_step(cfg, state, {"w": torch.from_numpy(g)})
    return alg, state, xhat_manual


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000), n_workers=st.integers(2, 6),
       k=st.integers(1, 7), lr=st.floats(1e-3, 0.5))
def test_delta_sum_zero_invariant(seed, n_workers, k, lr):
    _, state, _ = _run_random(seed, n_workers, k, lr, k * 3)
    np.testing.assert_allclose(state.delta["w"].sum(dim=0).numpy(), 0.0,
                               atol=1e-4)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000), n_workers=st.integers(2, 5),
       k=st.integers(1, 6), lr=st.floats(1e-3, 0.3),
       steps=st.integers(1, 20))
def test_average_model_is_exact_sgd(seed, n_workers, k, lr, steps):
    alg, state, xhat_manual = _run_random(seed, n_workers, k, lr, steps)
    np.testing.assert_allclose(alg.average_model(state)["w"].numpy(),
                               xhat_manual, rtol=2e-4, atol=1e-5)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 10_000), k=st.integers(2, 6))
def test_params_equal_after_sync(seed, k):
    _, state, _ = _run_random(seed, 4, k, 0.05, k * 2)
    w = state.params["w"].numpy()
    np.testing.assert_allclose(w, np.broadcast_to(w[:1], w.shape), atol=1e-6)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_k1_trajectory_matches_ssgd(seed):
    rng = np.random.RandomState(seed)
    cfg = TVRL(algorithm="vrl_sgd", comm_period=1, learning_rate=0.1,
               weight_decay=0.0, warmup=False)
    a1, a2 = get_algorithm("vrl_sgd"), get_algorithm("ssgd")
    s1 = a1.init(cfg, {"w": torch.zeros((2,))}, 3)
    s2 = a2.init(cfg, {"w": torch.zeros((2,))}, 3)
    for _ in range(10):
        g = torch.from_numpy(rng.randn(3, 2).astype(np.float32))
        s1 = a1.train_step(cfg, s1, {"w": g})
        s2 = a2.train_step(cfg, s2, {"w": g})
    np.testing.assert_allclose(s1.params["w"].numpy(),
                               s2.params["w"].numpy(), rtol=1e-4, atol=1e-5)


def run_scheduled(sched, steps=4000, lr=0.02, b=5.0):
    cfg = TVRL(algorithm="vrl_sgd", comm_period=1, learning_rate=lr,
               weight_decay=0.0, warmup=False)
    alg = get_algorithm("vrl_sgd")
    state = alg.init(cfg, {"x": torch.tensor([1.0])}, 2)
    grads, syncs = quad_grads(b), 0
    for _ in range(steps):
        state = alg.local_step(cfg, state, grads(state.params))
        if sched.should_sync(state.step, state.last_sync):
            state = alg.sync(cfg, state)
            syncs += 1
    return abs(float(alg.average_model(state)["x"][0])), syncs


def test_sqrt_schedule_converges_with_fewer_syncs():
    dist_c, syncs_c = run_scheduled(const_schedule(8, warmup=False))
    dist_s, syncs_s = run_scheduled(sqrt_schedule(c=0.5, k_max=64))
    assert dist_s < 1e-3
    assert syncs_s < 0.6 * syncs_c


def test_sqrt_period_grows_and_total_syncs_shape():
    s = sqrt_schedule(c=1.0, k_max=50, warmup=True)
    assert (s.period_at(1), s.period_at(100), s.period_at(10_000)) == \
        (1, 10, 50)
    s = sqrt_schedule(c=1.0, k_max=10**9, warmup=False)
    r1, r2 = total_syncs(s, 1_000), total_syncs(s, 4_000)
    assert 1.6 < r2 / r1 < 2.4, (r1, r2)


def test_api_lists_every_algorithm_and_hier_init_checks_grid():
    assert list_algorithms() == sorted(teng.ALGO_SPECS)
    cfg = TVRL(algorithm="hier_vrl_sgd",
               hier=THier(k1=2, k2=4, grid=(2, 2)))
    state = get_algorithm("hier_vrl_sgd").init(cfg, {"w": torch.ones(3)}, 4)
    assert state.params["w"].shape == (2, 2, 3)
    assert state.delta2["w"].shape == (2, 1, 3)
    with pytest.raises(ValueError, match="holds 4 workers"):
        TH.init(cfg, {"w": torch.ones(3)}, 6)


# ------------------------------------------------ parity with the JAX package
W, K, STEPS, LR = 4, 4, 13, 0.05
GRID, K1, K2 = (2, 2), 2, 4
SHAPES = {"w": (8, 3), "b": (5,), "deep": {"u": (2, 2, 4)}}


def _params0():
    ks = jax.random.split(jax.random.PRNGKey(7), 3)
    return {"w": jax.random.normal(ks[0], (8, 3)),
            "b": jax.random.normal(ks[1], (5,)),
            "deep": {"u": jax.random.normal(ks[2], (2, 2, 4))}}


def _pseudo_grads(params, t, lead=1):
    """Non-identical pseudo-gradients from a numpy params tree: the sin
    phase differs per worker (``lead`` leading worker axes)."""
    def one(x):
        n = int(np.prod(x.shape[:lead]))
        phase = np.arange(n, dtype=np.float32).reshape(
            x.shape[:lead] + (1,) * (x.ndim - lead))
        return (np.sin(3.0 * x + 0.7 * t + phase) + 0.1 * x).astype(
            np.float32)
    return jax.tree.map(one, params)


def _cfgs(alg, inner, compress=None, k=K):
    kw = dict(algorithm=alg, comm_period=k, learning_rate=LR,
              weight_decay=1e-3, inner_optimizer=inner,
              momentum=0.9 if inner == "momentum" else 0.0, warmup=False)
    hier = alg == "hier_vrl_sgd"
    cj = JVRL(update_backend="reference",
              compress=None if compress is None else
              jcc.parse_compressor(compress),
              hier=JHier(k1=K1, k2=K2, grid=GRID) if hier else None, **kw)
    ct = TVRL(update_backend="reference",
              compress=None if compress is None else
              tcc.parse_compressor(compress),
              hier=THier(k1=K1, k2=K2, grid=GRID) if hier else None, **kw)
    return cj, ct


def _row_step(compress, payload_leaves):
    """The largest one-flip move of any row of the payloads: one int8
    level (max|row|/127) or one top-k pick (the row's kth |x|), over
    256-lane rows of each leaf as ``ef_leaf`` lays them out."""
    spec = tcc.parse_compressor(compress)
    out = 0.0
    for x in payload_leaves:
        a = np.abs(np.asarray(x, np.float64)).reshape(-1)
        a = np.pad(a, (0, (-a.size) % 256)).reshape(-1, 256)
        if spec.name == "int8":
            step = a.max(axis=-1) / 127.0
        else:
            k = tcc.topk_k(spec, 256)
            step = -np.partition(-a, k - 1, axis=-1)[:, k - 1]
        out = max(out, float(step.max()))
    return out


def _payloads(cj, sj, hier):
    """The JAX state's next sync payloads (x − ref + resid), as numpy."""
    cm = sj.comm
    if cm == ():
        return []
    if hier:
        ref, resid, x = cm.ref1, cm.resid1, sj.params
    else:
        ref, resid, x = cm.ref, cm.resid, sj.params
    out = []
    for i, leaf in enumerate(jax.tree.leaves(x)):
        p = np.asarray(leaf, np.float64)
        if not isinstance(ref, tuple):
            p = p - np.asarray(jax.tree.leaves(ref)[i])
        if not isinstance(resid, tuple):
            p = p + np.asarray(jax.tree.leaves(resid)[i])
        out.append(p)
    return out


def run_pair(alg, inner, compress=None):
    """Both per-leaf executors, per step, on the same numpy gradients (the
    JAX state's); returns (JAX state, port state, summed flip bound)."""
    cj, ct = _cfgs(alg, inner, compress)
    hier = alg == "hier_vrl_sgd"
    ja, ta = j_get(alg), get_algorithm(alg)
    p0 = _params0()
    arg = GRID if hier else W
    sj = ja.init(cj, p0, arg)
    st = ta.init(ct, from_numpy(jax.tree.map(np.asarray, p0)), arg)
    step_j = jax.jit(lambda s, g: ja.train_step(cj, s, g))
    bound = 0.0
    for t in range(STEPS):
        g = _pseudo_grads(jax.tree.map(np.asarray, sj.params), t,
                          2 if hier else 1)
        if compress is not None:
            if teng.get_spec(alg).grad_all_reduce:
                e = sj.comm.resid
                bound += _row_step(compress, [
                    a + (0 if isinstance(e, tuple) else np.asarray(b))
                    for a, b in zip(jax.tree.leaves(g),
                                    jax.tree.leaves(e) if not isinstance(
                                        e, tuple) else jax.tree.leaves(g))])
            else:
                bound += _row_step(compress, _payloads(cj, sj, hier))
        sj = step_j(sj, jax.tree.map(jnp.asarray, g))
        st = ta.train_step(ct, st, from_numpy(g))
    return sj, st, bound


def _adam_rule(name, diff, atol, lr, k):
    bound = 2 * lr * STEPS / (1 if k == 1 else k * lr)
    share = float((diff > atol).mean())
    assert share <= 0.01 and diff.max() <= bound, (name, share, diff.max())


def _close(name, got, want, atol, inner, k, flip=0.0, compress=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    diff = np.abs(got - want)
    if inner == "adam":
        return _adam_rule(name, diff, atol, LR, k)
    flipped = diff > atol
    cap = 0 if compress is None else 16 + diff.size // 1000
    assert int(flipped.sum()) <= cap, (name, int(flipped.sum()), diff.max())
    assert np.all(diff[flipped] <= flip), (name, diff.max(), flip)


def _compare_trees(name, tj, tt, atol, inner, k=1, flip=0.0, compress=None):
    lj, lt = jax.tree.leaves(tj), tm.leaves(tt)
    assert len(lj) == len(lt), name
    for a, b in zip(lj, lt):
        _close(name, b.float().numpy(), a, atol, inner, k, flip, compress)


PAIR_CASES = [(alg, inner) for alg in sorted(teng.ALGO_SPECS)
              for inner in ("sgd", "momentum", "adam")]


@pytest.mark.parametrize("alg,inner", PAIR_CASES)
def test_per_leaf_matches_reference_executor(alg, inner):
    sj, st, _ = run_pair(alg, inner)
    hier = alg == "hier_vrl_sgd"
    _compare_trees("params", sj.params, st.params, 1e-5, inner)
    if hier:
        assert (st.step, st.last_sync1, st.last_sync2) == (
            int(sj.step), int(sj.last_sync1), int(sj.last_sync2))
        datol = 1e-6 + 2.5e-6 / (K1 * LR)
        for name in ("delta1", "delta2"):
            _compare_trees(name, getattr(sj, name), getattr(st, name),
                           datol, inner, K1)
    else:
        assert (st.step, st.last_sync) == (int(sj.step), int(sj.last_sync))
        _compare_trees("delta", sj.delta, st.delta, 1e-5 / (K * LR), inner,
                       K)
        assert (sj.bias is None) == (st.bias is None)
        if st.bias is not None:
            _compare_trees("bias", sj.bias, st.bias, 1e-5 / (K * LR), inner,
                           K)
        assert (sj.center is None) == (st.center is None)
        if st.center is not None:
            _compare_trees("center", sj.center, st.center, 1e-5, inner)
    avg_j = j_get(alg).average_model(sj)
    _compare_trees("average_model", avg_j,
                   get_algorithm(alg).average_model(st), 1e-5, inner)


@pytest.mark.parametrize("compress", ["int8", "topk:4"])
@pytest.mark.parametrize("alg", ["vrl_sgd", "ssgd", "easgd",
                                 "hier_vrl_sgd"])
def test_per_leaf_compressed_matches_reference(alg, compress):
    sj, st, bound = run_pair(alg, "sgd", compress)
    assert bound > 0
    hier = alg == "hier_vrl_sgd"
    flip = 2 * bound
    _compare_trees("params", sj.params, st.params, 1e-5, "sgd", flip=flip,
                   compress=compress)
    k = K1 if hier else K
    for name in (("delta1", "delta2") if hier else ("delta",)):
        _compare_trees(name, getattr(sj, name), getattr(st, name),
                       1e-5 / (k * LR), "sgd", flip=flip / (k * LR),
                       compress=compress)
    assert type(st.comm).__name__ == type(sj.comm).__name__
    for name, cj in sj.comm._asdict().items():
        ct = getattr(st.comm, name)
        assert isinstance(ct, tuple) == isinstance(cj, tuple), name
        if not isinstance(cj, tuple):
            _compare_trees(name, cj, ct, 1e-5, "sgd", flip=flip,
                           compress=compress)


# ------------------------------------- the port's own two executors agree
def _own_grads(tree, t, lead=1):
    return from_numpy(_pseudo_grads(tm.tree_map(lambda x: x.numpy(), tree),
                                    t, lead))


@pytest.mark.parametrize("alg,inner", PAIR_CASES)
def test_per_leaf_matches_flat_engine(alg, inner):
    """Each from its own params' gradients, as the reference's
    ``tests/test_engine_parity.py`` runs its executors: params and the
    evaluation model atol 1e-5 (Adam: the rule above)."""
    _, ct = _cfgs(alg, inner)
    ct = dataclasses.replace(ct, update_backend="auto")
    hier = alg == "hier_vrl_sgd"
    p0 = from_numpy(jax.tree.map(np.asarray, _params0()))
    eng = make_engine(ct, tm.tree_map(lambda x: x, p0))
    alg_t = get_algorithm(alg)
    sr = alg_t.init(ct, p0, GRID if hier else W)
    sf = eng.init(p0, W)
    lead = 2 if hier else 1
    for t in range(STEPS):
        sr = alg_t.train_step(ct, sr, _own_grads(sr.params, t, lead))
        sf = eng.train_step(sf, _own_grads(eng.params_tree(sf), t, lead))
    for name, a, b in (("params", sr.params, eng.params_tree(sf)),
                       ("average_model", alg_t.average_model(sr),
                        eng.average_model(sf))):
        for x, y in zip(tm.leaves(a), tm.leaves(b)):
            _close(name, x.numpy(), y.numpy(), 1e-5, inner, 1)
    assert sf.step == sr.step == STEPS


# ------------------------------------------------------------- train loop
TINY = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=64, num_heads=4,
            num_kv_heads=2, head_dim=16)


@pytest.mark.parametrize("alg", ["vrl_sgd", "hier_vrl_sgd"])
def test_train_loop_reference_backend_matches_jax(alg):
    """make_train_step's reference branch, both packages, the same
    parameters and tokens: per-step losses rtol 1e-5, final params and Δ
    at the executor tolerances; no kernel launched.  The parameters are
    the init with wq and wk scaled by 0.1, as in the port's other train
    parity tests (tests/test_torch_train.py: at face value the init's
    attention is near one-hot and two fp32 implementations part within a
    round)."""
    cfg_j = jreg.smoke_arch("qwen2-0.5b", **TINY)
    cfg_t = treg.smoke_arch("qwen2-0.5b", **TINY)
    hier = alg == "hier_vrl_sgd"
    kw = dict(algorithm=alg, comm_period=3, learning_rate=0.05,
              weight_decay=0.0, warmup=False, update_backend="reference")
    vj = JVRL(hier=JHier(k1=2, k2=4, grid=GRID) if hier else None, **kw)
    vt = TVRL(hier=THier(k1=2, k2=4, grid=GRID) if hier else None, **kw)
    w, b, s = (4 if hier else 2), 2, 16
    jb = j_make(cfg_j, vj, remat=False)
    tb = t_make(cfg_t, vt, device="cpu")
    assert tb.engine is None
    params = JT.init_params(cfg_j, jax.random.PRNGKey(0))
    attn = params["layers"]["attn"]
    attn["wq"], attn["wk"] = attn["wq"] * 0.1, attn["wk"] * 0.1
    sj = j_get(alg).init(vj, params, GRID if hier else w)
    st = get_algorithm(alg).init(vt, from_numpy(jax.tree.map(
        np.asarray, params)), GRID if hier else w)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(3), (w, b, s),
                                       0, 64))
    labels = np.roll(toks, -1, -1)
    step_j = jax.jit(jb.train_step)
    tvu.reset_launches()
    for _ in range(7):
        sj, lj = step_j(sj, jnp.asarray(toks), jnp.asarray(labels))
        st, lt = tb.train_step(st, torch.from_numpy(toks).long(),
                               torch.from_numpy(labels).long())
        np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    assert not any(tvu.LAUNCHES.values())
    _compare_trees("params", sj.params, st.params, 1e-5, "sgd")
    for name in (("delta1", "delta2") if hier else ("delta",)):
        _compare_trees(name, getattr(sj, name), getattr(st, name),
                       1e-5 / (2 * 0.05), "sgd")
    # the round driver: one more round of k (k1) steps, closed by the sync
    k = 2 if hier else 3
    tk = torch.from_numpy(np.broadcast_to(toks, (k,) + toks.shape).copy())
    st2, losses = tb.round_step(st, tk.long(), torch.roll(tk, -1, -1).long())
    assert losses.shape == (k,)
    assert (st2.last_sync1 if hier else st2.last_sync) == st.step + k


@pytest.mark.parametrize("field", ["overlap", "membership"])
def test_reference_backend_refusals_in_both_packages(field):
    cfg_j = jreg.smoke_arch("qwen2-0.5b", **TINY)
    cfg_t = treg.smoke_arch("qwen2-0.5b", **TINY)
    with pytest.raises(ValueError, match=field):
        j_make(cfg_j, JVRL(update_backend="reference", **{field: True}),
               remat=False)
    with pytest.raises(ValueError, match=field):
        t_make(cfg_t, TVRL(update_backend="reference", **{field: True}),
               device="cpu")


def test_resolve_backend():
    assert teng.resolve_backend("auto", "cuda") == "fused"
    assert teng.resolve_backend("auto", "cpu") == "xla"
    assert teng.resolve_backend(TVRL(update_backend="xla"), "cpu") == "xla"
    assert teng.resolve_backend("reference", "cuda") == "reference"
    with pytest.raises(ValueError, match="oracles"):
        teng.resolve_backend("xla", "cuda")
    with pytest.raises(ValueError, match="oracles"):
        t_make(treg.smoke_arch("qwen2-0.5b", **TINY),
               TVRL(update_backend="xla"), device="cuda")
    with pytest.raises(ValueError, match="unknown update_backend"):
        teng.resolve_backend("pallas", "cpu")
    # membership runs on the flat engine; easgd refuses it, as the
    # reference's does
    assert make_engine(TVRL(membership=True),
                       {"w": torch.zeros(3)}).set_membership is not None
    with pytest.raises(ValueError, match="easgd"):
        make_engine(TVRL(algorithm="easgd", membership=True),
                    {"w": torch.zeros(3)})


CLI = ["--smoke", "--device", "cpu", "--steps", "8", "--batch", "2",
       "--seq", "16", "--lr", "0.05", "--log-every", "1",
       "--backend", "reference"]


@pytest.mark.parametrize("extra", [
    ["--workers", "2", "--k", "2", "--warmup"],
    ["--workers", "4", "--algorithm", "hier_vrl_sgd", "--pods", "2",
     "--k1", "2", "--k2", "4", "--compress", "int8"]])
def test_launch_train_reference_backend_on_cpu(capsys, extra):
    res = t_launch.run(CLI + extra)
    out = capsys.readouterr().out
    assert "backend=reference, device=cpu" in out
    assert "engine: per-leaf reference executor over" in out
    assert res.engine is None and len(res.losses) == 8
    assert np.all(np.isfinite(res.losses + res.avg_model_losses))
    assert not any(tvu.LAUNCHES.values())
    if "hier_vrl_sgd" in extra:
        assert {r["level"] for r in res.level_terms} == {"delta1", "delta2"}
        assert all(r["off"] <= r["limit"] for r in res.level_terms)
        assert (res.state.last_sync1, res.state.last_sync2) == (8, 8)
    else:
        assert all(s <= 1e-4 * m for _, s, m in res.invariant)
    with pytest.raises(SystemExit, match="overlap"):
        t_launch.run(CLI + extra + ["--overlap"])
