"""The paper's workload on the port against the JAX package's, on the CPU.

The gate: ``repro_torch.paper.run_mlp_task(update_backend="reference",
device="cpu")`` from the reference's initial parameters (``mlp_init``'s
``jax.random`` draws carried across as numpy) stays within atol 1e-5 of
every one of the 300 per-step losses of ``benchmarks.common.run_mlp_task``
(the average model's loss on the global batch), for S-SGD, VRL-SGD, Local
SGD and EASGD under class-sharded and iid data, and VRL-SGD with the
warm-up.  The flat engine (``update_backend="auto"``: the kernels' plain
versions on the CPU) matches the per-leaf executor within atol 1e-5, the
standard of ``tests/test_engine_parity.py``.  The port's figures reproduce
the reference's conclusions, and Fig. 1's final losses lie within 1e-4 of
the reference's.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from benchmarks import common  # noqa: E402
from repro.data import feature_classification  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.kernels import vrl_update as tvu  # noqa: E402
from repro_torch.paper import figures, task  # noqa: E402

ALGS = ["ssgd", "vrl_sgd", "local_sgd", "easgd"]
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The MLP's products are small: one intra-op thread runs them fastest
    when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _data(seed=0):
    return feature_classification(n=4096, dim=256, num_classes=64, seed=seed)


@functools.cache
def _jax_params(seed=0):
    p = common.mlp_init(jax.random.PRNGKey(seed), in_dim=256, hidden=128,
                        classes=64)
    return {k: np.array(v) for k, v in p.items()}


@functools.cache
def _reference(alg, partition="class_shard", warmup=False):
    """``benchmarks.common.run_mlp_task`` at its defaults (300 steps), once
    per module."""
    return tuple(common.run_mlp_task(alg, partition=partition,
                                     data=_data(), warmup=warmup))


@functools.cache
def _port(alg, partition="class_shard", warmup=False, backend="reference"):
    return tuple(task.run_mlp_task(alg, partition=partition, data=_data(),
                                   warmup=warmup, device="cpu",
                                   params=_jax_params(),
                                   update_backend=backend))


@pytest.mark.parametrize("partition", ["class_shard", "iid"])
@pytest.mark.parametrize("alg", ALGS)
def test_run_mlp_task_matches_the_reference_every_step(alg, partition):
    want = np.array(_reference(alg, partition))
    got = np.array(_port(alg, partition))
    assert got.shape == want.shape == (300,)
    assert np.isfinite(got).all()
    err = np.abs(got - want)
    assert err.max() <= ATOL, (int(err.argmax()), err.max())


def test_run_mlp_task_with_warmup_matches_the_reference():
    want = np.array(_reference("vrl_sgd", warmup=True))
    got = np.array(_port("vrl_sgd", warmup=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the warm-up changes the trajectory (the first period is one step)
    assert np.abs(got - np.array(_port("vrl_sgd"))).max() > 1e-3


@pytest.mark.parametrize("alg", ALGS)
def test_flat_engine_matches_the_per_leaf_executor(alg):
    """update_backend "auto" on the CPU is the flat engine over the
    kernels' plain versions; it launches no kernel there."""
    n0 = dict(tvu.LAUNCHES)
    got = np.array(_port(alg, backend="auto"))
    assert dict(tvu.LAUNCHES) == n0
    np.testing.assert_allclose(got, np.array(_port(alg)), rtol=0,
                               atol=ATOL)


def test_backends_resolve_as_documented():
    run = task.mlp_task("vrl_sgd", steps=2, device="cpu",
                        data=_data(), update_backend="auto")
    assert run.backend == "xla" and isinstance(run.executor, tengine.Engine)
    run = task.mlp_task("vrl_sgd", steps=2, device="cpu",
                        data=_data(), update_backend="reference")
    assert run.backend == "reference" and run.executor.name == "vrl_sgd"


def test_on_step_sees_sigma_delta_zero_after_each_sync():
    """Σ_i Δ_i ≈ 0 after every sync of the flat engine's VRL-SGD; the
    hook runs after every step with the post-step state."""
    seen = []

    def on_step(step, state):
        if state.last_sync == step:
            s, m = tengine.sum_invariant(state.delta)
            seen.append((step, s, m))

    task.mlp_task("vrl_sgd", steps=60, k=20, device="cpu", data=_data(),
                  params=_jax_params(), update_backend="auto",
                  on_step=on_step)
    assert [s for s, _, _ in seen] == [20, 40, 60]
    for _, s, m in seen:
        assert m > 0 and s <= 1e-4 * m


def test_run_mlp_task_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        task.run_mlp_task("vrl_sgd", steps=1, data=_data())
    with pytest.raises(SystemExit):
        figures.main(["fig1"])


def test_mlp_task_default_params_come_from_mlp_init():
    a = task.mlp_task("ssgd", steps=3, device="cpu", data=_data())
    b = task.mlp_task("ssgd", steps=3, device="cpu", data=_data(),
                      params=task.mlp_init(0, 256, 128, 64))
    assert a.losses == b.losses


# -------------------------------------------------------------- figures
def test_fig1_reproduces_the_reference(capsys):
    """Fig. 1 on the port from the reference's parameters: its final
    losses within 1e-4 of the reference's (the same runs as the gate's),
    VRL-SGD ahead of Local SGD, and the reference's csv lines."""
    out = figures.fig1(device="cpu", backend="reference",
                       params=_jax_params())
    for alg in ALGS:
        want = np.mean(_reference(alg)[-20:])
        assert abs(out[alg] - want) <= 1e-4, (alg, out[alg], want)
    assert out["vrl_sgd"] < out["local_sgd"]
    assert out["vrl_sgd"] - out["ssgd"] < out["local_sgd"] - out["ssgd"]
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(",")[0] for ln in lines] == [
        f"fig1_nonidentical/{a}" for a in ALGS] + [
        "fig1_nonidentical/summary"]
    assert "vrl_beats_local=True" in lines[-1]


def test_appendix_e_reproduces_the_reference(capsys):
    """The exact quadratic: VRL-SGD within 1e-3 of x* = 0 at every (b, k),
    Local SGD's bias growing with b and k; the flat engine's sweep agrees
    with the per-leaf executor's."""
    out = figures.appendix_e(device="cpu", backend="reference")
    assert all(out[("vrl_sgd", b, k)] < 1e-3 for b in (1.0, 5.0, 25.0)
               for k in (4, 16, 64))
    assert out[("local_sgd", 25.0, 64)] > out[("local_sgd", 1.0, 4)]
    assert "vrl_always_converges=True;local_bias_grows=True" in \
        capsys.readouterr().out.splitlines()[-1]
    for alg, b, k in (("vrl_sgd", 25.0, 64), ("local_sgd", 5.0, 16)):
        flat = figures.quadratic(alg, b, k, device="cpu", backend="auto")
        assert abs(flat - out[(alg, b, k)]) <= 1e-5 + 1e-4 * out[
            (alg, b, k)]


def test_figures_cli_runs_one_figure(capsys, monkeypatch):
    """``python -m repro_torch.paper.figures warmup --device cpu``, its
    steps cut for the test: the reference's two runs and summary line."""
    monkeypatch.setattr(figures, "warmup", functools.partial(
        figures.warmup, steps=30))
    monkeypatch.setitem(figures.FIGURES, "warmup", figures.warmup)
    out = figures.main(["warmup", "--device", "cpu"])
    assert set(out["warmup"]) == {"vrl_sgd", "vrl_sgd_w"}
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(",")[0] for ln in lines] == [
        "warmup/vrl_sgd", "warmup/vrl_sgd_w", "warmup/summary"]
