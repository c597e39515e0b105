"""PyTorch port, inner optimizers and communication schedules vs the JAX
package.

* ``repro_torch.optim.optimizers`` (sgd, momentum, adam with fp32 or bf16
  moments, ``make_inner``) against ``repro.optim.optimizers`` per leaf,
  over several steps from the same numpy parameters and gradients:
  bitwise — both are the same fp32 elementwise ops in the same order.
* Adam's bias corrections [1 − b1^t, 1 − b2^t]: the port makes them on the
  device from a fill (``adam_scal``), the reference as ``1.0 - b ** t``
  with t an fp32 scalar.  On the CPU torch's fp32 ``pow`` and XLA's agree
  bitwise for t = 1…200 (checked here); so the engine's Adam trajectory
  differs from the reference's only where the worker mean sums in another
  order.
* ``core.schedule``: ``CommSchedule`` and its builders and parser against
  ``repro.core.schedule`` — the same stages, periods and round sizes.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import VRLConfig as JVRL  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.configs.base import VRLConfig as TVRL  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {"w": scale * rng.randn(8, 3).astype(np.float32),
            "b": scale * rng.randn(5).astype(np.float32),
            "deep": {"u": scale * rng.randn(2, 2, 4).astype(np.float32)}}


def _to_t(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _leaves_np(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_np(tree[k])]
    if isinstance(tree, torch.Tensor):
        return [tree.float().numpy()]
    return [np.asarray(jnp.asarray(tree).astype(jnp.float32))]


def _run(jo, to, steps=4):
    pj, pt = _tree(0), _to_t(_tree(0))
    sj, st = jo.init(pj), to.init(pt)
    for s in range(steps):
        g = _tree(10 + s, scale=0.5)
        pj, sj = jo.update(pj, g, sj)
        pt, st = to.update(pt, _to_t(g), st)
    return (pj, sj), (pt, st)


OPT_CASES = [
    ("sgd", dict(lr=0.05, weight_decay=0.0)),
    ("sgd", dict(lr=0.05, weight_decay=1e-3)),
    ("momentum", dict(lr=0.05, beta=0.9, weight_decay=1e-3)),
    ("momentum", dict(lr=0.05, beta=0.9, weight_decay=1e-3, nesterov=True)),
    ("momentum", dict(lr=0.05, beta=0.9, moment_dtype="bfloat16")),
    ("adam", dict(lr=1e-3)),
    ("adam", dict(lr=1e-3, weight_decay=1e-3)),
    ("adam", dict(lr=1e-3, weight_decay=1e-3, moment_dtype="bfloat16")),
]


@pytest.mark.parametrize("name,kw", OPT_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(OPT_CASES)])
def test_optimizer_bitwise_reference(name, kw):
    (pj, sj), (pt, st) = _run(getattr(jopt, name)(**kw),
                              getattr(topt, name)(**kw))
    for a, b in zip(_leaves_np(pt), _leaves_np(pj)):
        np.testing.assert_array_equal(a, b)
    if name == "momentum":
        for a, b in zip(_leaves_np(st), _leaves_np(sj)):
            np.testing.assert_array_equal(a, b)
    if name == "adam":
        assert st.count == int(sj.count) == 4
        for a, b in zip(_leaves_np(st.mu) + _leaves_np(st.nu),
                        _leaves_np(sj.mu) + _leaves_np(sj.nu)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("inner,momentum,moment_dtype", [
    ("sgd", 0.0, "float32"), ("sgd", 0.5, "float32"),
    ("momentum", 0.0, "float32"), ("adam", 0.0, "bfloat16")])
def test_make_inner_matches_reference(inner, momentum, moment_dtype):
    kw = dict(inner_optimizer=inner, momentum=momentum, learning_rate=0.05,
              moment_dtype=moment_dtype)
    (pj, _), (pt, _) = _run(jopt.make_inner(JVRL(**kw)),
                            topt.make_inner(TVRL(**kw)), steps=3)
    for a, b in zip(_leaves_np(pt), _leaves_np(pj)):
        np.testing.assert_array_equal(a, b)


def test_sm3_and_unknown_inner_raise():
    """SM3 Adam is ported: ``make_inner`` builds it as the reference does
    (its steps: tests/test_torch_sm3.py); an unknown inner optimizer still
    raises."""
    kw = dict(inner_optimizer="adam", sm3=True, learning_rate=0.05)
    (pj, sj), (pt, st) = _run(jopt.make_inner(JVRL(**kw)),
                              topt.make_inner(TVRL(**kw)), steps=2)
    assert isinstance(st.nu["w"], topt.SM3Pair)
    for a, b in zip(_leaves_np(pt), _leaves_np(pj)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        topt.make_inner(TVRL(inner_optimizer="lamb"))


def test_adam_scal_bitwise_reference_t1_to_200():
    """The engine's device-made [1 − b1^t, 1 − b2^t] against the
    reference's fp32 ``1.0 - b ** t`` (engine.py:1220-1223)."""
    t = jnp.arange(1, 201, dtype=jnp.float32)
    want = np.stack([np.asarray(1.0 - jopt_b ** t)
                     for jopt_b in (0.9, 0.999)], axis=1)
    got = np.concatenate([topt.adam_scal(i).numpy() for i in range(1, 201)])
    assert got.dtype == np.float32 and got.shape == (200, 2)
    np.testing.assert_array_equal(got, want)


SCHEDULES = ["const", "const:3", "stagewise", "stagewise:2", "stagewise:1:2",
             "stagewise:2:3:16", "custom:1x4,2x4,8x2", "custom:3"]


@pytest.mark.parametrize("text", SCHEDULES)
def test_parse_schedule_matches_reference(text):
    sj, st = jsched.parse_schedule(text, 8), tsched.parse_schedule(text, 8)
    assert st.stages == sj.stages
    assert st.stage_ends == sj.stage_ends
    assert st.total_steps() == sj.total_steps()
    for t_total in (0, 1, 7, 40, 101):
        assert st.round_sizes(t_total) == sj.round_sizes(t_total)
        assert st.sync_steps(t_total) == sj.sync_steps(t_total)
        assert (st.distinct_periods(t_total)
                == sj.distinct_periods(t_total))
    for last in range(0, 60, 3):
        assert st.period_starting_at(last) == sj.period_starting_at(last)


def test_schedule_builders_match_reference():
    for k in (1, 4):
        assert tsched.const_comm(k).stages == jsched.const_comm(k).stages
    for k0, k_max, r in ((1, 8, 4), (2, 16, 3), (3, 3, 1), (1, 6, 2)):
        assert (tsched.stagewise_doubling(k0, k_max, r).stages
                == jsched.stagewise_doubling(k0, k_max, r).stages)
    for args in ((1, 4, 3), (2, 2, 5)):
        assert (tsched.stagewise_total_steps(*args)
                == jsched.stagewise_total_steps(*args))
    assert (tsched.custom_stages([(1, 2), ("4", "1")]).stages
            == jsched.custom_stages([(1, 2), ("4", "1")]).stages)
    for bad in (lambda m: m.stagewise_doubling(4, 2),
                lambda m: m.CommSchedule(stages=()),
                lambda m: m.CommSchedule(stages=((0, 1),)),
                lambda m: m.parse_schedule("sqrt")):
        for mod in (jsched, tsched):
            with pytest.raises(ValueError):
                bad(mod)
