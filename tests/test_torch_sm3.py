"""PyTorch port, SM3-factored Adam and layout-only shards vs the JAX
package (the port's ``tests/test_sharded_moments.py``).

* Plain kernel (``kernels/torch_update.fused_local_adam_sm3``): BITWISE
  the reference's ``xla_update`` twin over Δ and B on and off, wd 0 and
  non-zero, fp32 and bf16 mu, S ∈ {1, 2, 4} lane-stat spans, and with a
  planted NaN (compared NaN for NaN).  Against the Pallas kernel in
  interpret mode at block 8 with several tiles per span (so the lane stat
  is accumulated tile by tile there): each output within the ulps of the
  products interpret mode contracts into FMAs (b1·mu, b2·v̂, γwd·p, p −
  step; ``tests/test_torch_update.py``), the stats within the largest such
  bound of nu over their row or span — the per-span max equals the tiled
  one.
* Engine: vrl_sgd and bvr_l_sgd + adam + sm3 at fp32 (13 per-step
  ``train_step``s, k = 4, W = 4, the smoke qwen2 layout) against the
  reference's xla executor at its engine standard: params atol 1e-5, Δ,
  B and mu atol 1e-5/(k·γ), the stats rtol 1e-4.  bf16 mu + sm3 to 1e-3
  (the reference's bf16 bound).  Layout-only ``shards``: rows pad to a
  multiple of block·shards and the lane stat gets one row per span; the
  unflattened trees at shards = 4 are BITWISE those at shards = 1 (pad rows
  are inert), and ``spec.meta()`` equals the reference's for shards ∈ {1,
  2, 4}.  The state holds 4·(W·R + W·S·C) bytes of stats.
* Composition: sm3 under top-k:8 compressed sync and under overlapped
  rounds, against the xla executor from the same parameters on the same
  numpy gradients (top-k flips nothing there: atol, as
  ``tests/test_torch_compress.py`` holds it).
* Per leaf: ``optim.optimizers.adam(sm3=True)`` (factored stats for
  leaves of ndim >= 2, dense fp32 below) is bitwise the reference's.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.comm import compressors as jcc  # noqa: E402
from repro.configs.base import EngineConfig as JEng  # noqa: E402
from repro.configs.base import VRLConfig as JVRL  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import flat as jflat  # noqa: E402
from repro.kernels import vrl_update as jvu  # noqa: E402
from repro.kernels import xla_update as jxu  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import tree as tm  # noqa: E402
from repro_torch.comm import compressors as tcc  # noqa: E402
from repro_torch.configs.base import EngineConfig as TEng  # noqa: E402
from repro_torch.configs.base import VRLConfig as TVRL  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import flat as tflat  # noqa: E402
from repro_torch.kernels import torch_update as tu  # noqa: E402
from repro_torch.kernels import vrl_update as tvu  # noqa: E402
from repro_torch.models.param import from_numpy  # noqa: E402
from repro_torch.optim import SM3Pair  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

from test_torch_engine import MK, MSTEPS, _matrix_run, setup  # noqa: E402,F401

W, R, C, BLOCK, LR = 4, 32, 256, 8, 0.05


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _ulp(*xs):
    """Σ ulp(|x|) over fp32 arrays: the roundings an FMA can skip."""
    return sum(np.spacing(np.abs(np.asarray(x, np.float32))) for x in xs)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x).astype(jnp.float32))


# ----------------------------------------------------------- plain kernel
def sm3_inputs(seed, shards, lead=(W,), r=R, mdt="f32", nan=False):
    """p, g, Δ, B (lead + (r, C)); mu as torch and jax arrays of the same
    values in ``mdt``; row (lead + (r, 1)) and col (lead + (S, C)) stats
    ≥ 0, as the engine keeps them; scal [c1, c2] at t = 3.  ``nan``: one
    NaN planted in g."""
    rng = np.random.RandomState(seed)
    p, g, d, b = (rng.randn(*lead, r, C).astype(np.float32)
                  for _ in range(4))
    if nan:
        g[(0,) * len(lead) + (3, 17)] = np.nan
    mu = torch.from_numpy(0.1 * rng.randn(*lead, r, C).astype(np.float32))
    if mdt == "bf16":
        mu = mu.bfloat16()
    mu_j = jnp.asarray(mu.float().numpy()).astype(
        jnp.bfloat16 if mdt == "bf16" else jnp.float32)
    row = 0.01 * np.square(rng.randn(*lead, r, 1)).astype(np.float32)
    col = 0.01 * np.square(rng.randn(*lead, shards, C)).astype(np.float32)
    scal = np.array([[1 - 0.9 ** 3, 1 - 0.999 ** 3]], np.float32)
    return p, g, d, b, (mu, mu_j), row, col, scal


def _equal(got, want):
    """Bitwise, NaN for NaN."""
    for a, w in zip(got, want):
        np.testing.assert_array_equal(_np(a), _np(w))


SM3_CASES = [(corr, wd, mdt, shards) for corr in ("none", "d", "db")
             for wd in (0.0, 1e-3) for mdt in ("f32", "bf16")
             for shards in (1, 2, 4)]


@pytest.mark.parametrize("corr,wd,mdt,shards", SM3_CASES)
def test_plain_adam_sm3_bitwise_xla(corr, wd, mdt, shards):
    p, g, d, b, (mu, mu_j), row, col, scal = sm3_inputs(20 + shards, shards,
                                                        mdt=mdt)
    b = b if "b" in corr else None
    d = d if "d" in corr else None
    kw = dict(lr=1e-3, wd=wd)
    want = jxu.fused_local_adam_sm3(_j(p), _j(g), _j(d), mu_j, _j(row),
                                    _j(col), _j(scal), b=_j(b), **kw)
    got = tu.fused_local_adam_sm3(_t(p), _t(g), _t(d), mu, _t(row),
                                  _t(col), _t(scal), b=_t(b), **kw)
    assert got[1].dtype == mu.dtype
    assert got[2].shape == (W, R, 1) and got[3].shape == (W, shards, C)
    _equal(got, want)


@pytest.mark.parametrize("shards", [1, 2])
def test_plain_adam_sm3_nan_propagates_like_xla(shards):
    """A NaN gradient element makes its p, mu, row stat and its span's lane
    stat NaN in both packages (max and min propagate NaN), nothing else."""
    p, g, d, b, (mu, mu_j), row, col, scal = sm3_inputs(
        30, shards, nan=True)
    want = jxu.fused_local_adam_sm3(_j(p), _j(g), _j(d), mu_j, _j(row),
                                    _j(col), _j(scal), lr=1e-3, b=_j(b))
    got = tu.fused_local_adam_sm3(_t(p), _t(g), _t(d), mu, _t(row),
                                  _t(col), _t(scal), lr=1e-3, b=_t(b))
    _equal(got, want)
    assert torch.isnan(got[2][0, 3, 0]) and torch.isnan(got[3][0, 0, 17])
    assert int(torch.isnan(got[2]).sum()) == 1
    assert int(torch.isnan(got[3]).sum()) == 1


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("wd", [0.0, 1e-3])
def test_plain_adam_sm3_vs_pallas_interpret(shards, wd):
    """Block 8 over R = 32 rows: 4 tiles per span at S = 1, 2 at S = 2, so
    the Pallas kernel accumulates the lane stat over revisits."""
    p, g, d, b, (mu_t, mu_j), row, col, scal = sm3_inputs(40, shards)
    lr, b1, b2 = 1e-3, 0.9, 0.999
    want = [np.asarray(x) for x in jvu.fused_local_adam_sm3(
        _j(p), _j(g), _j(d), mu_j, _j(row), _j(col), _j(scal), b=_j(b),
        lr=lr, wd=wd, block=BLOCK, interpret=True)]
    got = [x.numpy() for x in tu.fused_local_adam_sm3(
        _t(p), _t(g), _t(d), mu_t, _t(row), _t(col), _t(scal), b=_t(b),
        lr=lr, wd=wd)]
    f = np.float32
    v = (g - d) - b
    mu = mu_t.numpy()
    vhat = np.minimum(row, np.repeat(col, R // shards, axis=-2))
    mu_new = f(b1) * mu + f(1 - b1) * v
    nu = f(b2) * vhat + f(1 - b2) * v * v
    tol_mu = _ulp(f(b1) * mu, f(1 - b1) * v, mu_new)
    tol_nu = _ulp(f(b2) * vhat, f(1 - b2) * v * v, nu)
    step = f(lr) * (mu_new / scal[0, 0]) / (np.sqrt(nu / scal[0, 1])
                                            + f(1e-8))
    tol_p = (np.abs(step) * (tol_mu / np.abs(mu_new) + tol_nu / (2 * nu))
             + 4 * _ulp(step) + _ulp(f(lr * wd) * p, want[0]))
    assert np.all(np.abs(got[0] - want[0]) <= tol_p)
    assert np.all(np.abs(got[1] - want[1]) <= tol_mu)
    tol_row = tol_nu.max(axis=-1, keepdims=True)
    tol_col = tol_nu.reshape(W, shards, R // shards, C).max(axis=-2)
    assert np.all(np.abs(got[2] - want[2]) <= tol_row)
    assert np.all(np.abs(got[3] - want[3]) <= tol_col)


def test_sm3_wrapper_on_cpu_writes_in_place_and_rejects():
    p, g, d, b, (mu, _), row, col, scal = sm3_inputs(50, 2)
    p, g, d, b, row, col, scal = map(_t, (p, g, d, b, row, col, scal))
    want = tu.fused_local_adam_sm3(p, g, d, mu, row, col, scal, lr=1e-3,
                                   b=b)
    bufs = [x.clone() for x in (p, mu, row, col)]
    tvu.reset_launches()
    out = tvu.fused_local_adam_sm3(bufs[0], g, d, bufs[1], bufs[2],
                                   bufs[3], scal, lr=1e-3, b=b)
    assert [o is x for o, x in zip(out, bufs)] == [True, True, True, False]
    assert torch.equal(bufs[3], col)          # the old lane stat is read only
    _equal(out, want)
    assert not any(tvu.LAUNCHES.values()), tvu.LAUNCHES
    with pytest.raises(ValueError, match="stats"):
        tvu.fused_local_adam_sm3(p, g, d, mu, row[:, :-1].contiguous(), col,
                                 scal, lr=1e-3)
    with pytest.raises(ValueError, match="shard spans"):
        tvu.fused_local_adam_sm3(p, g, d, mu, row,
                                 torch.zeros(W, 3, C), scal, lr=1e-3)
    with pytest.raises(TypeError):
        tvu.fused_local_adam_sm3(p, g, d, mu, row.bfloat16(), col, scal,
                                 lr=1e-3)
    with pytest.raises(ValueError, match="scal"):
        tvu.fused_local_adam_sm3(p, g, d, mu, row, col, torch.ones(1),
                                 lr=1e-3)


# ---------------------------------------------------------------- engine
def compare_sm3_states(sj, st, k, lr=LR, atol=1e-5):
    """The reference's engine standard: params atol ``atol``; Δ, B and mu
    (param residuals over k·γ) atol/(k·γ); the stats rtol 1e-4."""
    np.testing.assert_allclose(st.params.numpy(), np.asarray(sj.params),
                               rtol=0, atol=atol)
    scaled = atol / (k * lr)
    for name in ("delta", "bias"):
        a, b = getattr(st, name, ()), getattr(sj, name, ())
        assert isinstance(a, torch.Tensor) == hasattr(b, "shape"), name
        if isinstance(a, torch.Tensor):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=scaled, err_msg=name)
    np.testing.assert_allclose(_np(st.inner.mu), _np(sj.inner.mu), rtol=0,
                               atol=scaled, err_msg="mu")
    nu_t, nu_j = st.inner.nu, sj.inner.nu
    assert isinstance(nu_t, SM3Pair) and hasattr(nu_j, "row")
    for name in ("row", "col"):
        a, b = getattr(nu_t, name), getattr(nu_j, name)
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-12, err_msg=name)
    assert st.inner.count == int(sj.inner.count)


@pytest.mark.parametrize("alg", ["vrl_sgd", "bvr_l_sgd"])
def test_engine_sm3_fp32_matches_reference(setup, alg):  # noqa: F811
    ej, et, sj, st = _matrix_run(setup, alg, "adam", sm3=True)
    assert st.inner.count == MSTEPS
    compare_sm3_states(sj, st, MK)
    for a, b in zip(jax.tree.leaves(ej.average_model(sj)),
                    tm.leaves(et.average_model(st))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5)


def test_engine_sm3_bf16_matches_reference_to_bf16_bound(setup):  # noqa: F811
    """bf16 mu may land on the neighbouring bf16 value of the reference's
    where the two fp32 values straddle a rounding boundary: 1e-3, the
    reference's bound for bf16 moments."""
    ej, et, sj, st = _matrix_run(setup, "vrl_sgd", "adam", sm3=True,
                                 moment_dtype="bfloat16")
    assert st.inner.mu.dtype == torch.bfloat16
    np.testing.assert_allclose(st.params.numpy(), np.asarray(sj.params),
                               rtol=0, atol=1e-3)
    for a, b in zip(jax.tree.leaves(ej.average_model(sj)),
                    tm.leaves(et.average_model(st))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-3)


# the reference's template: 977 elements, 4 rows of 256 lanes
TEMPLATE = {"w": (40, 24), "b": (17,)}


def templates():
    tj = jax.tree.map(lambda s: jnp.zeros(s, jnp.float32), TEMPLATE,
                      is_leaf=lambda x: isinstance(x, tuple))
    tt = jax.tree.map(lambda s: torch.empty(s, device="meta"), TEMPLATE,
                      is_leaf=lambda x: isinstance(x, tuple))
    return tj, tt


def params0():
    rng = np.random.RandomState(0)
    return {"w": 0.3 * rng.randn(40, 24).astype(np.float32),
            "b": 0.3 * rng.randn(17).astype(np.float32)}


def cfgs(shards=1, compress=None, **over):
    kw = dict(algorithm="vrl_sgd", comm_period=2, learning_rate=LR,
              weight_decay=1e-3, warmup=False, inner_optimizer="adam",
              sm3=True)
    kw.update(over)
    cj = JVRL(update_backend="xla", engine=JEng(block=BLOCK, shards=shards),
              compress=None if compress is None else
              jcc.parse_compressor(compress), **kw)
    ct = TVRL(engine=TEng(block=BLOCK, shards=shards),
              compress=None if compress is None else
              tcc.parse_compressor(compress), **kw)
    return cj, ct


def engines(shards=1, compress=None, **over):
    tj, tt = templates()
    cj, ct = cfgs(shards, compress, **over)
    ej, et = jeng.make_engine(cj, tj), teng.make_engine(ct, tt)
    p0 = params0()
    return ej, et, ej.init(jax.tree.map(jnp.asarray, p0), W), \
        et.init(from_numpy(p0), W)


def grad_buf(spec, seed):
    """(W, R, C) fp32 gradients with zero pad lanes, from numpy."""
    rng = np.random.RandomState(seed)
    out = np.zeros((W, spec.rows, spec.lanes), np.float32)
    out.reshape(W, -1)[:, :spec.size] = rng.randn(W, spec.size)
    return out


def run_steps(ej, et, sj, st, steps=7):
    """Per-step ``train_step`` of both engines over the same numpy
    gradients."""
    step_j = jax.jit(ej.train_step)
    for t in range(steps):
        g = grad_buf(ej.spec, 600 + t)
        sj = step_j(sj, jflat.unflatten_stacked(ej.spec, jnp.asarray(g)))
        st = et.train_step(st, torch.from_numpy(g))
        assert (st.step, st.last_sync) == (int(sj.step), int(sj.last_sync))
    return sj, st


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_spec_meta_and_layout_match_reference(shards):
    tj, tt = templates()
    spec_j = jflat.make_spec(tj, block=BLOCK, shards=shards)
    spec_t = tflat.make_spec(tt, block=BLOCK, shards=shards)
    assert spec_t.meta() == spec_j.meta()
    assert spec_t.rows % (BLOCK * shards) == 0 and spec_t.shards == shards
    for mod, tree in ((jflat, tj), (tflat, tt)):
        with pytest.raises(ValueError, match="shards"):
            mod.make_spec(tree, block=BLOCK, shards=0)


@pytest.mark.parametrize("shards", [2, 4])
def test_engine_sm3_sharded_layout_matches_reference(shards):
    ej, et, sj, st = engines(shards)
    assert et.spec.meta() == ej.spec.meta()
    sj, st = run_steps(ej, et, sj, st)
    assert st.inner.nu.col.shape == (W, shards, C)
    compare_sm3_states(sj, st, 2)


def test_sharded_layout_is_bitwise():
    """shards = 4 only grows the inert row padding: the unflattened trees
    are BITWISE those of shards = 1 (dense Adam, as the reference's test:
    under sm3 the lane stat covers smaller spans there, a finer but still
    valid upper bound, so the trajectory is another one)."""
    outs = {}
    for shards in (1, 4):
        _, et, _, st = engines(shards, sm3=False)
        for t in range(7):
            # the same real elements in both layouts (grad_buf draws
            # (W, size) values whatever the padding)
            st = et.train_step(st, torch.from_numpy(grad_buf(et.spec,
                                                             600 + t)))
        assert st.params.shape[-2] % (BLOCK * shards) == 0
        outs[shards] = (st.params.shape[-2], et.average_model(st))
    assert outs[4][0] > outs[1][0]
    for a, b in zip(tm.leaves(outs[1][1]), tm.leaves(outs[4][1])):
        assert torch.equal(a, b)


def test_sm3_state_bytes():
    """bf16 halves mu; SM3 replaces nu's (W, R, C) with a row stat plus
    one lane row per shard: exactly 4·(W·R + W·S·C) bytes."""
    _, et, _, st = engines(4, moment_dtype="bfloat16")
    w, r, c = st.params.shape
    assert st.inner.mu.dtype == torch.bfloat16
    assert st.inner.nu.row.shape == (w, r, 1)
    assert st.inner.nu.col.shape == (w, 4, c)
    stat_bytes = sum(x.numel() * x.element_size() for x in st.inner.nu)
    assert stat_bytes == 4 * (w * r + w * 4 * c)
    assert stat_bytes < w * r * c * 4 / 4
    st = et.train_step(st, torch.from_numpy(grad_buf(et.spec, 1)))
    assert st.inner.nu.row.dtype == st.inner.nu.col.dtype == torch.float32


# ----------------------------------------------------------- composition
def test_compose_with_compressed_sync():
    """sm3 + top-k:8 compressed sync, shards = 4: the JAX engine by its own
    local_step and sync on the host's cadence, the port by train_step."""
    ej, et, sj, st = engines(4, "topk:8")
    ct = cfgs(4, "topk:8")[1]
    local_j, sync_j = jax.jit(ej.local_step), jax.jit(ej.sync)
    algo = teng.get_spec("vrl_sgd")
    for t in range(7):
        g = grad_buf(ej.spec, 700 + t)
        sj = local_j(sj, jflat.unflatten_stacked(ej.spec, jnp.asarray(g)))
        st = et.train_step(st, torch.from_numpy(g))
        if teng.should_sync(algo, ct, int(sj.step), int(sj.last_sync)):
            sj = sync_j(sj)
        assert (st.step, st.last_sync) == (int(sj.step), int(sj.last_sync))
    assert float(st.comm.resid.abs().max()) > 0.0
    compare_sm3_states(sj, st, 2)
    for name in ("resid", "ref"):
        np.testing.assert_allclose(getattr(st.comm, name).numpy(),
                                   np.asarray(getattr(sj.comm, name)),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_compose_with_overlapped_rounds():
    """sm3 under overlapped rounds, shards = 4: four rounds of
    ``round_step_flat`` (round_begin, 2 local steps, the stale fold)."""
    ej, et, sj, st = engines(4, overlap=True)
    round_j = jax.jit(ej.round_step_flat)
    for r in range(4):
        gk = np.stack([grad_buf(ej.spec, 800 + 2 * r + i) for i in range(2)])
        sj = round_j(sj, jnp.asarray(gk))
        st = et.round_step_flat(st, torch.from_numpy(gk))
        assert (st.step, st.last_sync) == (int(sj.step), int(sj.last_sync))
    compare_sm3_states(sj, st, 2)
    np.testing.assert_allclose(st.overlap.pend.numpy(),
                               np.asarray(sj.overlap.pend), rtol=0,
                               atol=1e-5)


# --------------------------------------------------------------- per leaf
def _tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {"w": scale * rng.randn(8, 3).astype(np.float32),
            "b": scale * rng.randn(5).astype(np.float32),
            "deep": {"u": scale * rng.randn(2, 2, 4).astype(np.float32)}}


@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
def test_per_leaf_adam_sm3_bitwise_reference(mdt):
    jo = jopt.adam(0.05, weight_decay=1e-3, moment_dtype=mdt, sm3=True)
    to = topt.adam(0.05, weight_decay=1e-3, moment_dtype=mdt, sm3=True)
    pj = _tree(0)
    pt = tm.tree_map(torch.from_numpy, _tree(0))
    sj, st = jo.init(pj), to.init(pt)
    assert isinstance(st.nu["w"], SM3Pair) and isinstance(st.nu["b"],
                                                          torch.Tensor)
    assert st.nu["deep"]["u"].row.shape == (2, 2, 1)
    assert st.nu["deep"]["u"].col.shape == (2, 1, 4)
    for s in range(4):
        g = _tree(10 + s, scale=0.5)
        pj, sj = jo.update(pj, g, sj)
        pt, st = to.update(pt, tm.tree_map(torch.from_numpy, g), st)
    for name in ("w", "b"):
        np.testing.assert_array_equal(_np(pt[name]), _np(pj[name]))
        np.testing.assert_array_equal(_np(st.mu[name]), _np(sj.mu[name]))
    np.testing.assert_array_equal(_np(pt["deep"]["u"]),
                                  _np(pj["deep"]["u"]))
    for name in ("w",):
        for f in ("row", "col"):
            np.testing.assert_array_equal(
                _np(getattr(st.nu[name], f)), _np(getattr(sj.nu[name], f)))
    np.testing.assert_array_equal(_np(st.nu["b"]), _np(sj.nu["b"]))
    assert st.count == int(sj.count) == 4
