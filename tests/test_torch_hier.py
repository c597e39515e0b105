"""PyTorch port, two-level hier_vrl_sgd vs the JAX package.

* Grid layout: ``flatten_grid``/``unflatten_grid`` lay a grid-stacked tree
  out bitwise as the reference does; ``unflatten_grid`` returns views.
* Plain kernels (``kernels/torch_update``): the four hierarchy versions
  are bitwise the reference's ``xla_update`` twins.  Against the Pallas
  kernels in interpret mode: ``fused_sync_hier1`` and ``fused_sync_hier2``
  bitwise; ``fused_hier_local_sgd`` within ulp(γ·v) + ulp(p') (interpret
  mode contracts p − γ·v into an FMA, as ``tests/test_torch_update.py``
  explains); ``fused_fold_overlap_hier2``: p' and pend2' bitwise (their
  products are by km ∈ {0, 1}, exact), Δ2' within ulp(c·s₀) + ulp(Δ2')
  (the FMA of Δ2 + c·s₀).  The level-2 kernels assume a level-1 sync
  (pod-uniform params), so their inputs are.
* Engine: ``hier_vrl_sgd`` + sgd on a (2, 3) grid at (k1, k2) ∈ {(2, 4),
  (3, 9), (4, 8)}, 13 per-step ``train_step``s on pseudo-gradients of each
  engine's own parameters (the reference's ``_hier_grads``, in numpy),
  against the JAX engine's ``update_backend="xla"`` executor: params and
  the average model atol 1e-5; Δ1 and Δ2 atol 1e-6 + 2.5e-6/(k1·0.05)
  (the reference's own engine standard: Δ scales param-level rounding by
  1/(k·γ)); equal sync counters.  The pod mean may sum in another order
  than XLA's (which folds the 1/D into a multiply), hence not bitwise.
* Invariants: Σ_d Δ1 = 0 within every pod and Σ_p Δ2 = 0, below 5e-5
  (``tests/test_hierarchical.py``); one pod at k1 = k2 = k is BITWISE the
  port's flat vrl_sgd (same reductions, same arithmetic, Δ2 stays 0).
* Overlap: four rounds at (2, 4) against the JAX xla executor (params,
  pend atol 1e-5, Δ atol as above, pend_k bitwise, Σ invariants).
* Inner optimizers: momentum (nesterov on and off), Adam and SM3-factored
  Adam (fp32 and bf16 moments, S ∈ {1, 2}) kernels bitwise their xla
  twins and within the FMA-contraction ulps of Pallas interpret mode;
  the engine with each, (2, 3) grid at (2, 4), against the xla executor
  (moments at the Δ standard, nu and the stats rtol 1e-4, bf16 to 1e-3),
  overlapped Adam rounds, and the reference's composition case (bf16 +
  SM3, shards = 2) to 1e-3.
* Refusals: what the reference refuses — a deadline without overlap,
  k2 % k1 for rounds, wrong worker count (ValueError); compress,
  compress2 and deadlines build (their runs: ``tests/test_torch_hier_
  compress.py``, ``tests/test_torch_deadline.py``).
* Train loop: rounds from the same parameters (wq, wk × 0.1, see
  ``tests/test_torch_train.py``) on the reference's token stream, blocking
  and overlapped, against the JAX ``make_train_step``: losses rtol 1e-5,
  params atol 1e-5, Δ atol 1e-5/(k1·γ).
* CLI: ``launch.train --smoke --device cpu --algorithm hier_vrl_sgd``,
  blocking and overlapped.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import EngineConfig as JEng  # noqa: E402
from repro.configs.base import HierConfig as JHier  # noqa: E402
from repro.configs.base import VRLConfig as JVRL  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import flat as jflat  # noqa: E402
from repro.data import assigned_token_stream as j_stream  # noqa: E402
from repro.data import contiguous_assignment as j_assign  # noqa: E402
from repro.kernels import vrl_update as jvu  # noqa: E402
from repro.kernels import xla_update as jxu  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train.train_loop import make_train_step as j_make  # noqa: E402
from repro_torch.comm import compressors as tcc  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import EngineConfig as TEng  # noqa: E402
from repro_torch.configs.base import HierConfig as THier  # noqa: E402
from repro_torch.configs.base import VRLConfig as TVRL  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import flat as tflat  # noqa: E402
from repro_torch.core.types import HierFlatState  # noqa: E402
from repro_torch.kernels import torch_update as tu  # noqa: E402
from repro_torch.kernels import vrl_update as tvu  # noqa: E402
from repro_torch.launch import train as t_launch  # noqa: E402
from repro_torch.models.param import from_numpy  # noqa: E402
from repro_torch.train.train_loop import make_train_step as t_make  # noqa: E402

from test_torch_compress import params0, templates  # noqa: E402

GRID, LR, WD, STEPS = (2, 3), 0.05, 1e-3, 13
P, D, R, C, BLOCK = 2, 3, 16, 256, 8


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


# ---------------------------------------------------------------- layout
def test_grid_layout_matches_reference_and_unflatten_views():
    tj, tt = templates()
    spec_j = jflat.make_spec(tj)
    spec_t = tflat.make_spec(tt)
    assert spec_t.meta() == spec_j.meta()
    rng = np.random.RandomState(0)
    tree = jax.tree.map(
        lambda x: rng.randn(P, D, *x.shape).astype(np.float32), tj)
    want = np.asarray(jflat.flatten_grid(spec_j, tree))
    got = tflat.flatten_grid(spec_t, jax.tree.map(torch.from_numpy, tree))
    assert got.shape == (P, D, spec_t.rows, spec_t.lanes)
    np.testing.assert_array_equal(got.numpy(), want)
    back_j = jflat.unflatten_grid(spec_j, jnp.asarray(want))
    back_t = teng.tree_mod.leaves_with_path(tflat.unflatten_grid(spec_t, got))
    flat_j = jax.tree_util.tree_flatten_with_path(back_j)[0]
    assert len(back_t) == len(flat_j)
    for (_, a), (_, b) in zip(back_t, flat_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # views: writing the buffer shows in every leaf, with no copy
    got.add_(1.0)
    for _, a in back_t:
        assert a.untyped_storage().data_ptr() == \
            got.untyped_storage().data_ptr()
    for (_, a), (_, b) in zip(back_t, flat_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b) + 1.0)


# -------------------------------------------------------- plain kernels
def _grid_inputs(seed, uniform=False):
    """p, g, d1 (P, D, R, C); d2, x̂_pod, pend2 (P, 1, R, C); glob (R, C).
    ``uniform``: every worker of a pod holds the pod's params (the state
    after a level-1 sync)."""
    rng = np.random.RandomState(seed)
    p, g, d1 = (rng.randn(P, D, R, C).astype(np.float32) for _ in range(3))
    if uniform:
        p = np.repeat(p[:, :1], D, axis=1)
    d2, xpod, pend = (rng.randn(P, 1, R, C).astype(np.float32)
                      for _ in range(3))
    glob = rng.randn(R, C).astype(np.float32)
    return p, g, d1, d2, xpod, pend, glob


def _wscal(km):
    pend_k = np.array([1.0, 3.0], np.float32)
    inv = np.float32(1.0) / (pend_k * np.float32(LR))
    return np.stack([inv, np.full(P, km, np.float32)], axis=1)


HIER_CASES = ([("local", wd) for wd in (0.0, WD)]
              + [("sync1", kg) for kg in (0.05, 0.15, 0.7)]
              + [("sync2", kg) for kg in (0.05, 0.2)]
              + [("fold", (capture, km)) for capture in (False, True)
                 for km in (0.0, 1.0)]
              # the inner optimizers: (moment dtype, nesterov or S, wd)
              + [("momentum", (mdt, nesterov, WD)) for mdt in ("f32", "bf16")
                 for nesterov in (False, True)]
              + [("momentum", ("f32", False, 0.0))]
              + [("adam", (mdt, 1, wd)) for mdt in ("f32", "bf16")
                 for wd in (0.0, WD)]
              + [("adam_sm3", (mdt, shards, WD)) for mdt in ("f32", "bf16")
                 for shards in (1, 2)])
INNER_KINDS = ("momentum", "adam", "adam_sm3")
ADAM_SCAL = np.array([[1 - 0.9 ** 3, 1 - 0.999 ** 3]], np.float32)


def _case_inputs(kind, arg, seed):
    """(torch inputs, jax inputs) of one case: the grid buffers (level-2
    kernels: pod-uniform params), then for the inner optimizers m (or mu
    and nu) in the case's dtype — the same values in both packages — and
    the SM3 stats (P, D, R, 1), (P, D, S, C), ≥ 0 as the engine keeps
    them."""
    ins = _grid_inputs(seed, uniform=kind in ("sync2", "fold"))
    ins_t, ins_j = [_t(x) for x in ins], [_j(x) for x in ins]
    if kind in INNER_KINDS:
        mdt, shards = arg[0], arg[1] if kind == "adam_sm3" else 1
        rng = np.random.RandomState(seed + 1)
        moms = [0.1 * rng.randn(P, D, R, C).astype(np.float32),
                0.01 * np.square(rng.randn(P, D, R, C)).astype(np.float32)]
        if kind == "adam_sm3":
            moms[1:] = [
                0.01 * np.square(rng.randn(P, D, R, 1)).astype(np.float32),
                0.01 * np.square(rng.randn(P, D, shards, C)).astype(
                    np.float32)]
        n_mom = {"momentum": 1, "adam": 2, "adam_sm3": 1}[kind]
        for i, x in enumerate(moms):
            t = torch.from_numpy(x)
            if i < n_mom and mdt == "bf16":
                t = t.bfloat16()
            ins_t.append(t)
            ins_j.append(jnp.asarray(t.float().numpy()).astype(
                jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32))
    return ins_t, ins_j


def _hier_call(mod, kind, arg, ins, **kw):
    """One of the hierarchy's kernels of ``mod`` (the port's plain
    versions, or the reference's twins or Pallas kernels) on ``ins``."""
    p, g, d1, d2, xpod, pend, glob = ins[:7]
    conv = _t if mod is tu else _j
    if kind == "local":
        return (mod.fused_hier_local_sgd(p, g, d1, d2, lr=LR, wd=arg, **kw),)
    if kind == "sync1":
        return mod.fused_sync_hier1(p, xpod, d1,
                                    conv(np.array([[arg]], np.float32)), **kw)
    if kind == "sync2":
        return mod.fused_sync_hier2(p, glob, d2,
                                    conv(np.array([[arg]], np.float32)), **kw)
    if kind == "momentum":
        return mod.fused_hier_local_momentum(p, g, d1, d2, ins[7], lr=LR,
                                             beta=0.9, wd=arg[2],
                                             nesterov=arg[1], **kw)
    if kind == "adam":
        return mod.fused_hier_local_adam(p, g, d1, d2, ins[7], ins[8],
                                         conv(ADAM_SCAL), lr=1e-3,
                                         wd=arg[2], **kw)
    if kind == "adam_sm3":
        return mod.fused_hier_local_adam_sm3(p, g, d1, d2, *ins[7:10],
                                             conv(ADAM_SCAL), lr=1e-3,
                                             wd=arg[2], **kw)
    capture, km = arg
    return mod.fused_fold_overlap_hier2(p, glob, pend, d2, conv(_wscal(km)),
                                        capture=capture, **kw)


def _f32np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("kind,arg", HIER_CASES)
def test_plain_hier_kernels_bitwise_xla(kind, arg):
    ins_t, ins_j = _case_inputs(kind, arg, 30)
    got = _hier_call(tu, kind, arg, ins_t)
    want = _hier_call(jxu, kind, arg, ins_j)
    assert len(got) == len(want)
    for a, w in zip(got, want):
        assert a.dtype == (torch.bfloat16 if w.dtype == jnp.bfloat16
                           else torch.float32)
        np.testing.assert_array_equal(_f32np(a), _f32np(w))


def _bf16_ulp(x):
    """One bf16 step at |x| (fp32 spacing × 2^16): where an FMA-apart fp32
    value may round to the neighbouring bf16 value."""
    return np.spacing(np.abs(np.asarray(x, np.float32))) * 2.0 ** 16


def _inner_tols(kind, arg, ins_t, want):
    """Per output, the bound of the plain version's distance from
    interpret-mode Pallas, which contracts every product that feeds an add
    into an FMA (wd·p, β·m, γ·dir; b1·mu, b2·nu, γwd·p, p − step): the
    ulps of those products, each output's own rounding, what an input's
    difference carries through, and one bf16 step for a bf16 moment."""
    f = np.float32
    p, g, d1, d2 = (x.numpy() for x in ins_t[:4])
    v = (g - d1) - d2
    mdt, wd = arg[0], f(arg[2])
    bf = (lambda x: _bf16_ulp(x)) if mdt == "bf16" else (lambda x: 0.0)
    if kind == "momentum":
        lr, beta = f(LR), f(0.9)
        m = ins_t[7].float().numpy()
        # each contracted sum may round to the neighbouring fp32 value
        tol_v = _ulp(wd * p, v + wd * p) if wd else 0.0
        v = v + wd * p
        m_new = beta * m + v
        tol_m = tol_v + _ulp(beta * m, m_new)
        dir_ = v + beta * m_new if arg[1] else m_new
        tol_dir = (tol_v + beta * tol_m + _ulp(beta * m_new, dir_)
                   if arg[1] else tol_m)
        tol_p = lr * tol_dir + _ulp(lr * dir_, want[0])
        return [tol_p, tol_m + bf(want[1])]
    lr, b1, b2 = f(1e-3), f(0.9), f(0.999)
    mu = ins_t[7].float().numpy()
    if kind == "adam":
        nu_old = ins_t[8].float().numpy()
    else:
        row, col = (x.numpy() for x in ins_t[8:10])
        nu_old = np.minimum(row, np.repeat(col, R // col.shape[-2], axis=-2))
    mu_new = b1 * mu + f(1 - 0.9) * v
    nu = b2 * nu_old + f(1 - 0.999) * v * v
    tol_mu = _ulp(b1 * mu, f(1 - 0.9) * v, mu_new)
    tol_nu = _ulp(b2 * nu_old, f(1 - 0.999) * v * v, nu)
    step = lr * (mu_new / ADAM_SCAL[0, 0]) / (np.sqrt(nu / ADAM_SCAL[0, 1])
                                              + f(1e-8))
    tol_p = (np.abs(step) * (tol_mu / np.abs(mu_new) + tol_nu / (2 * nu))
             + 4 * _ulp(step) + _ulp(f(1e-3 * arg[2]) * p, want[0]))
    if kind == "adam":
        return [tol_p, tol_mu + bf(want[1]), tol_nu + bf(want[2])]
    shards = ins_t[9].shape[-2]
    return [tol_p, tol_mu + bf(want[1]), tol_nu.max(axis=-1, keepdims=True),
            tol_nu.reshape(P, D, shards, R // shards, C).max(axis=-2)]


@pytest.mark.parametrize("kind,arg", HIER_CASES)
def test_plain_hier_kernels_vs_pallas_interpret(kind, arg):
    ins_t, ins_j = _case_inputs(kind, arg, 31)
    got = [_f32np(x) for x in _hier_call(tu, kind, arg, ins_t)]
    want = [_f32np(x) for x in _hier_call(
        jvu, kind, arg, ins_j, block=BLOCK, interpret=True)]
    assert len(got) == len(want)
    p, g, d1, d2, _, pend, glob = (x.numpy() for x in ins_t[:7])
    if kind in INNER_KINDS:
        for i, (a, w, tol) in enumerate(zip(got, want, _inner_tols(
                kind, arg, ins_t, want))):
            assert np.all(np.abs(a - w) <= tol), (i, np.abs(a - w).max())
    elif kind == "local":
        # one rounding of γ·v apart (interpret mode's FMA contraction)
        v = g - d1 - d2
        if arg:
            v = v + np.float32(arg) * p
        tol = _ulp(np.float32(LR) * v, want[0])
        assert np.all(np.abs(got[0] - want[0]) <= tol)
    elif kind == "fold":
        np.testing.assert_array_equal(got[0], want[0])
        if arg[0]:
            np.testing.assert_array_equal(got[2], want[2])
        c = glob[None, None] - pend
        inv = _wscal(arg[1])[:, 0][:, None, None, None]
        np.testing.assert_array_less(np.abs(got[1] - want[1]),
                                     _ulp(c * inv, want[1]) + 1e-30)
    else:
        for a, w in zip(got, want):
            np.testing.assert_array_equal(a, w)


def test_hier_wrappers_on_cpu_write_in_place_and_reject():
    p, g, d1, d2, xpod, pend, glob = (_t(x) for x in _grid_inputs(
        32, uniform=True))
    scal = torch.tensor([[0.1]])
    ws = _t(_wscal(0.0))
    tvu.reset_launches()
    bufs = [x.clone() for x in (p, d1, d2, pend)]
    assert tvu.fused_hier_local_sgd(bufs[0], g, bufs[1], bufs[2],
                                    lr=LR) is bufs[0]
    assert torch.equal(bufs[0], tu.fused_hier_local_sgd(p, g, d1, d2, lr=LR))
    out = tvu.fused_sync_hier1(bufs[0], xpod, bufs[1], scal)
    assert out[0] is bufs[0] and out[1] is bufs[1]
    out = tvu.fused_sync_hier2(bufs[0], glob, bufs[2], scal)
    assert out[0] is bufs[0] and out[1] is bufs[2]
    want = tu.fused_fold_overlap_hier2(bufs[0], glob, bufs[3], bufs[2], ws)
    out = tvu.fused_fold_overlap_hier2(bufs[0], glob, bufs[3], bufs[2], ws)
    assert [o is b for o, b in zip(out, (bufs[0], bufs[2], bufs[3]))] == \
        [True] * 3
    assert all(torch.equal(a, w) for a, w in zip(out, want))
    out = tvu.fused_fold_overlap_hier2(p.clone(), glob, pend.clone(),
                                       d2.clone(), ws, capture=False)
    assert len(out) == 2
    # a CPU call runs the plain version: it is not a kernel launch
    assert not any(tvu.LAUNCHES.values()), tvu.LAUNCHES
    with pytest.raises(ValueError, match="P, D, R, C"):
        tvu.fused_hier_local_sgd(p[0], g[0], d1[0], d2[0], lr=LR)
    with pytest.raises(ValueError, match="per pod"):
        tvu.fused_hier_local_sgd(p, g, d1, d1, lr=LR)
    with pytest.raises(ValueError, match="per pod"):
        tvu.fused_sync_hier1(p, xpod[:, :, :-1].contiguous(), d1, scal)
    with pytest.raises(ValueError, match="glob"):
        tvu.fused_sync_hier2(p, glob[:-1], d2, scal)
    with pytest.raises(ValueError, match="scal"):
        tvu.fused_sync_hier2(p, glob, d2, torch.ones(2))
    with pytest.raises(ValueError, match="wscal"):
        tvu.fused_fold_overlap_hier2(p, glob, pend, d2, ws[:1].contiguous())
    with pytest.raises(TypeError):
        tvu.fused_sync_hier1(p, xpod.double(), d1, scal)


# ---------------------------------------------------------------- engine
def _hier_grads(params, t):
    """The reference's ``_hier_grads`` in numpy fp32: non-identical
    pseudo-gradients over a (P, D, ...) grid, the phase differing per
    worker so pods AND workers drift apart between syncs."""
    def one(x):
        x = np.asarray(x, np.float32)
        p, d = x.shape[:2]
        phase = np.arange(p * d, dtype=np.float32).reshape(
            (p, d) + (1,) * (x.ndim - 2))
        return (np.sin(np.float32(3.0) * x + np.float32(0.7 * t) + phase)
                + np.float32(0.1) * x).astype(np.float32)
    return jax.tree.map(one, params)


def _cfgs(k1, k2, grid=GRID, shards=0, **over):
    """``shards``: an EngineConfig at block 8 with that many row shards in
    both packages (0: the default engine config)."""
    kw = dict(algorithm="hier_vrl_sgd", learning_rate=LR, weight_decay=WD,
              warmup=False)
    kw.update(over)
    eng = {}
    if shards:
        eng = {"engine": (JEng(block=BLOCK, shards=shards),
                          TEng(block=BLOCK, shards=shards))}
    cj = JVRL(update_backend="xla", hier=JHier(k1=k1, k2=k2, grid=grid),
              **{k: v[0] for k, v in eng.items()}, **kw)
    ct = TVRL(hier=THier(k1=k1, k2=k2, grid=grid),
              **{k: v[1] for k, v in eng.items()}, **kw)
    return cj, ct


def _engines(k1, k2, grid=GRID, **over):
    tj, tt = templates()
    cj, ct = _cfgs(k1, k2, grid, **over)
    ej, et = jeng.make_engine(cj, tj), teng.make_engine(ct, tt)
    p0 = params0()
    w = grid[0] * grid[1]
    return ej, et, ej.init(p0, w), et.init(
        from_numpy(jax.tree.map(np.asarray, p0)), w)


def _port_grads(et, st, t):
    tree = jax.tree.map(lambda x: x.numpy(), et.params_tree(st))
    return jax.tree.map(torch.from_numpy, _hier_grads(tree, t))


def _delta_atol(k1):
    return 1e-6 + 2.5e-6 / (k1 * 0.05)


@pytest.mark.parametrize("k1,k2", [(2, 4), (3, 9), (4, 8)])
def test_engine_matches_reference(k1, k2):
    ej, et, sj, st = _engines(k1, k2)
    assert isinstance(st, HierFlatState) and et.grid == GRID
    assert et.spec.meta() == ej.spec.meta()
    for t in range(STEPS):
        sj = ej.train_step(sj, jax.tree.map(
            jnp.asarray, _hier_grads(jax.tree.map(np.asarray,
                                                  ej.params_tree(sj)), t)))
        st = et.train_step(st, _port_grads(et, st, t))
    assert st.step == STEPS
    assert (st.last_sync1, st.last_sync2) == (int(sj.last_sync1),
                                              int(sj.last_sync2))
    np.testing.assert_allclose(st.params.numpy(), np.asarray(sj.params),
                               rtol=0, atol=1e-5)
    for a, b in zip(jax.tree.leaves(ej.average_model(sj)),
                    teng.tree_mod.leaves(et.average_model(st))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5)
    for name in ("delta1", "delta2"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(sj, name)), rtol=0,
                                   atol=_delta_atol(k1), err_msg=name)


def test_delta_invariants_and_sync_counters():
    _, et, _, st = _engines(2, 6)
    for t in range(12):          # boundaries of both levels
        st = et.train_step(st, _port_grads(et, st, t))
    assert (st.last_sync1, st.last_sync2) == (12, 12)
    assert st.delta1.sum(dim=1).abs().max().item() < 5e-5
    assert st.delta2.sum(dim=0).abs().max().item() < 5e-5
    assert st.delta1.abs().max().item() > 0.0
    assert st.delta2.abs().max().item() > 0.0
    s1, _ = teng.sum_invariant(st.delta1, dim=1)
    assert s1 == st.delta1.sum(dim=1).abs().max().item()


@pytest.mark.parametrize("entry", ["train_step", "round_step"])
def test_one_pod_is_bitwise_flat_vrl_sgd(entry):
    """One pod at k1 = k2 = k IS the paper's Algorithm 1: bitwise the
    port's flat vrl_sgd (same worker mean, same arithmetic: Δ2 stays 0 and
    g − Δ1 − 0 is g − Δ1).  train_step: the pseudo-gradients of each
    engine's own parameters; round_step: numpy gradient buffers."""
    w, k = 4, 4
    _, tt = templates()
    ef = teng.make_engine(TVRL(algorithm="vrl_sgd", comm_period=k,
                               learning_rate=LR, weight_decay=WD,
                               warmup=False), tt)
    eh = teng.make_engine(_cfgs(k, k, grid=(1, w))[1], tt)
    p0 = from_numpy(jax.tree.map(np.asarray, params0()))
    sf, sh = ef.init(p0, w), eh.init(p0, w)
    for r in range(3):
        if entry == "round_step":
            gk = np.stack([_grid_buf(eh.spec, 70 + 10 * r + i, grid=(1, w))
                           for i in range(k)])
            sf = ef.round_step(sf, torch.from_numpy(gk[:, 0]))
            sh = eh.round_step(sh, torch.from_numpy(gk))
            continue
        for t in range(r * k, (r + 1) * k):
            flat_tree = jax.tree.map(lambda x: x.numpy()[None],
                                     ef.params_tree(sf))
            sf = ef.train_step(sf, jax.tree.map(
                lambda x: torch.from_numpy(x[0]),
                _hier_grads(flat_tree, t)))
            sh = eh.train_step(sh, _port_grads(eh, sh, t))
    assert torch.equal(sf.params, sh.params[0])
    assert torch.equal(sf.delta, sh.delta1[0])
    assert sh.delta2.abs().max().item() == 0.0
    assert (sf.step, sf.last_sync) == (sh.step, sh.last_sync1)
    assert sh.last_sync2 == sh.last_sync1 == 3 * k


# --------------------------------------------------------------- overlap
def _grid_buf(spec, seed, grid=GRID):
    """(P, D, R, C) fp32 gradients with zero pad lanes, from numpy."""
    rng = np.random.RandomState(seed)
    out = np.zeros(grid + (spec.rows, spec.lanes), np.float32)
    out.reshape(grid[0] * grid[1], -1)[:, :spec.size] = rng.randn(
        grid[0] * grid[1], spec.size)
    return out


def test_overlap_rounds_match_reference():
    """Four rounds of (k1, k2) = (2, 4) cross two k2 boundaries: level 2
    folds one round stale, level 1 stays blocking."""
    k1, k2 = 2, 4
    ej, et, sj, st = _engines(k1, k2, overlap=True)
    assert st.overlap.pend.shape == (GRID[0], 1, et.spec.rows, et.spec.lanes)
    round_j = jax.jit(ej.round_step_flat)
    for r in range(4):
        gk = np.stack([_grid_buf(ej.spec, 900 + 10 * r + i)
                       for i in range(k1)])
        due = st.step + k1 - st.last_sync2 >= k2
        glob = et.round_begin(st, k1)
        assert (glob is None) == (not due)
        sj = round_j(sj, jnp.asarray(gk))
        st = et.round_step_flat(st, torch.from_numpy(gk))
        assert (st.step, st.last_sync1, st.last_sync2) == (
            int(sj.step), int(sj.last_sync1), int(sj.last_sync2))
        np.testing.assert_allclose(st.params.numpy(), np.asarray(sj.params),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(st.overlap.pend.numpy(),
                                   np.asarray(sj.overlap.pend), rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(st.overlap.pend_k.numpy(),
                                      np.asarray(sj.overlap.pend_k))
        for name in ("delta1", "delta2"):
            np.testing.assert_allclose(getattr(st, name).numpy(),
                                       np.asarray(getattr(sj, name)),
                                       rtol=0, atol=_delta_atol(k1),
                                       err_msg=f"round {r} {name}")
        assert st.delta1.sum(dim=1).abs().max().item() < 5e-5
        assert st.delta2.sum(dim=0).abs().max().item() < 5e-5
    assert st.last_sync2 == 8 and st.delta2.abs().max().item() > 0.0


def test_overlap_round_fold_needs_the_begin_mean():
    _, et, _, st = _engines(2, 4, overlap=True)
    g = torch.from_numpy(_grid_buf(et.spec, 3))
    st = et.round_step_flat(st, torch.stack([g, g]))
    assert et.round_begin(st, 2) is not None
    for _ in range(2):
        st = et.local_step(st, g)
    with pytest.raises(ValueError, match="round_begin"):
        et.round_fold(st, None)


def test_blocking_round_is_the_per_step_cadence():
    """round_step (k1 local steps, sync1, sync2 when due) equals the
    per-step train_step on the same gradients, bitwise."""
    _, et, _, sa = _engines(2, 4)
    _, _, _, sb = _engines(2, 4)
    for r in range(3):
        gk = [torch.from_numpy(_grid_buf(et.spec, 50 + 2 * r + i))
              for i in range(2)]
        sa = et.round_step(sa, torch.stack(gk))
        for g in gk:
            sb = et.train_step(sb, g)
        assert (sa.last_sync1, sa.last_sync2) == (sb.last_sync1,
                                                  sb.last_sync2)
    for name in ("params", "delta1", "delta2"):
        assert torch.equal(getattr(sa, name), getattr(sb, name)), name


# ------------------------------------------------- inner optimizers
INNER_ENGINE = [("momentum", {}), ("adam", {}),
                ("adam", {"moment_dtype": "bfloat16"}),
                ("adam", {"sm3": True}),
                ("adam", {"sm3": True, "moment_dtype": "bfloat16"})]


def _inner_over(inner, over):
    return dict(inner_optimizer=inner,
                momentum=0.9 if inner == "momentum" else 0.0, **over)


@pytest.mark.parametrize("inner,over", INNER_ENGINE)
def test_engine_inner_optimizers_match_reference(inner, over):
    """(2, 3) grid at (k1, k2) = (2, 4), 13 per-step ``train_step``s on the
    same numpy gradients (the reference's run eagerly, as
    ``test_engine_matches_reference`` does, so that only the means' summing
    order differs): params atol 1e-5 and Δ1, Δ2 and mu at the Δ standard
    (param residuals over k1·γ), nu and the SM3 stats rtol 1e-4.  Under
    momentum the syncs' rounding residue, which enters v through Δ every
    step, is summed by m over ~1/(1 − β) steps: params atol 1e-5/(1 − β),
    m ten times the Δ standard.  bf16 moments to 1e-3 on params (the
    reference's bf16 bound: a moment may round to the neighbouring bf16
    value)."""
    k1, k2 = 2, 4
    ej, et, sj, st = _engines(k1, k2, **_inner_over(inner, over))
    for t in range(STEPS):
        g = _grid_buf(ej.spec, 400 + t)
        sj = ej.train_step(sj, jflat.unflatten_grid(ej.spec,
                                                    jnp.asarray(g)))
        st = et.train_step(st, torch.from_numpy(g))
        assert (st.step, st.last_sync1, st.last_sync2) == (
            int(sj.step), int(sj.last_sync1), int(sj.last_sync2))
    bf16 = over.get("moment_dtype") == "bfloat16"
    atol = 1e-3 if bf16 else 1e-5 / (1 - 0.9) if inner == "momentum" \
        else 1e-5
    np.testing.assert_allclose(st.params.numpy(), np.asarray(sj.params),
                               rtol=0, atol=atol)
    if bf16:
        assert _f32np(st.inner.mu).dtype == np.float32
        assert st.inner.mu.dtype == torch.bfloat16
        return
    for name in ("delta1", "delta2"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(sj, name)), rtol=0,
                                   atol=_delta_atol(k1), err_msg=name)
    if inner == "momentum":
        np.testing.assert_allclose(st.inner.numpy(), np.asarray(sj.inner),
                                   rtol=0, atol=10 * _delta_atol(k1))
        return
    assert st.inner.count == int(sj.inner.count) == STEPS
    np.testing.assert_allclose(st.inner.mu.numpy(), np.asarray(sj.inner.mu),
                               rtol=0, atol=_delta_atol(k1))
    nus = ([(st.inner.nu.row, sj.inner.nu.row),
            (st.inner.nu.col, sj.inner.nu.col)] if over.get("sm3")
           else [(st.inner.nu, sj.inner.nu)])
    for a, b in nus:
        assert a.shape == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-12)
    assert st.delta1.sum(dim=1).abs().max().item() < 5e-5
    assert st.delta2.sum(dim=0).abs().max().item() < 5e-5


def test_overlap_rounds_adam_match_reference():
    """Four overlapped rounds of (k1, k2) = (2, 4) with Adam: the level-2
    fold one round stale, the moments carried through it."""
    k1, k2 = 2, 4
    ej, et, sj, st = _engines(k1, k2, overlap=True, inner_optimizer="adam")
    round_j = jax.jit(ej.round_step_flat)
    for r in range(4):
        gk = np.stack([_grid_buf(ej.spec, 950 + 10 * r + i)
                       for i in range(k1)])
        sj = round_j(sj, jnp.asarray(gk))
        st = et.round_step_flat(st, torch.from_numpy(gk))
        assert (st.step, st.last_sync1, st.last_sync2) == (
            int(sj.step), int(sj.last_sync1), int(sj.last_sync2))
    for name, a, b in (("params", st.params, sj.params),
                       ("pend", st.overlap.pend, sj.overlap.pend)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5, err_msg=name)
    for name in ("delta1", "delta2"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(sj, name)), rtol=0,
                                   atol=_delta_atol(k1), err_msg=name)
    np.testing.assert_allclose(st.inner.mu.numpy(), np.asarray(sj.inner.mu),
                               rtol=0, atol=_delta_atol(k1))
    np.testing.assert_allclose(st.inner.nu.numpy(), np.asarray(sj.inner.nu),
                               rtol=1e-4, atol=1e-12)
    assert st.inner.count == 8 and st.last_sync2 == 8


def test_compose_with_hierarchical_engine():
    """The reference's composition case on the port: (2, 2) grid, shards =
    2, bf16 mu + SM3, 9 per-step ``train_step``s (both sync levels) on the
    pseudo-gradients of each engine's own parameters, to the bf16 bound
    1e-3."""
    ej, et, sj, st = _engines(2, 4, grid=(2, 2), shards=2,
                              inner_optimizer="adam",
                              moment_dtype="bfloat16", sm3=True)
    assert et.spec.meta() == ej.spec.meta() and et.spec.shards == 2
    assert st.inner.nu.col.shape == (2, 2, 2, et.spec.lanes)
    step_j = jax.jit(ej.train_step)
    for t in range(9):
        sj = step_j(sj, jax.tree.map(jnp.asarray, _hier_grads(
            jax.tree.map(np.asarray, ej.params_tree(sj)), t)))
        st = et.train_step(st, _port_grads(et, st, t))
    assert st.inner.mu.dtype == torch.bfloat16
    for a, b in zip(jax.tree.leaves(ej.average_model(sj)),
                    teng.tree_mod.leaves(et.average_model(st))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-3)


def test_inner_wrappers_on_cpu_write_in_place_and_reject():
    ins_t, _ = _case_inputs("adam_sm3", ("f32", 2, WD), 33)
    p, g, d1, d2 = ins_t[:4]
    mu, row, col = ins_t[7:10]
    scal = torch.from_numpy(ADAM_SCAL)
    tvu.reset_launches()
    bufs = [x.clone() for x in (p, mu, row, col)]
    want = tu.fused_hier_local_adam_sm3(p, g, d1, d2, mu, row, col, scal,
                                        lr=1e-3)
    out = tvu.fused_hier_local_adam_sm3(bufs[0], g, d1, d2, *bufs[1:], scal,
                                        lr=1e-3)
    assert [o is b for o, b in zip(out, bufs)] == [True, True, True, False]
    assert torch.equal(bufs[3], col)
    assert all(torch.equal(a, w) for a, w in zip(out, want))
    m = mu.clone()
    out = tvu.fused_hier_local_momentum(p.clone(), g, d1, d2, m, lr=LR,
                                        beta=0.9)
    assert out[1] is m
    nu = mu.square()
    out = tvu.fused_hier_local_adam(p.clone(), g, d1, d2, mu.clone(), nu,
                                    scal, lr=1e-3)
    assert out[2] is nu
    assert not any(tvu.LAUNCHES.values()), tvu.LAUNCHES
    with pytest.raises(ValueError, match="per pod"):
        tvu.fused_hier_local_momentum(p, g, d1, d1, m, lr=LR, beta=0.9)
    with pytest.raises(TypeError):
        tvu.fused_hier_local_adam(p, g, d1, d2, mu, nu.bfloat16(), scal,
                                  lr=1e-3)
    with pytest.raises(ValueError, match="stats"):
        tvu.fused_hier_local_adam_sm3(p, g, d1, d2, mu, row[:1].contiguous(),
                                      col, scal, lr=1e-3)


# -------------------------------------------------------------- refusals
def test_refusals():
    tj, tt = templates()

    def build(k1=2, k2=4, **over):
        return teng.make_engine(_cfgs(k1, k2, **over)[1], tt)
    # the inner optimizers, the compressed syncs and deadlines build (their
    # runs: test_engine_inner_*, test_torch_hier_compress.py,
    # test_torch_deadline.py); what stays refused is the reference's
    for inner in ("momentum", "adam"):
        assert build(inner_optimizer=inner).grid == GRID
    topk, int8 = tcc.parse_compressor("topk:4"), tcc.parse_compressor("int8")
    assert build(inner_optimizer="adam", sm3=True,
                 compress=topk).compressors == (topk, topk)
    assert build(compress=int8).compressors == (int8, int8)
    assert build(compress2=topk).compressors == (None, topk)
    assert build(overlap=True, deadline=0.5).misses(4, 2).shape == (2, 1)
    with pytest.raises(ValueError, match="deadline"):
        build(deadline=0.5)
    with pytest.raises(ValueError, match="error.feedback|residual"):
        build(overlap=True, deadline=0.5,
              compress2=tcc.parse_compressor("int8:noef"))
    eng = build(k1=2, k2=5)
    st = eng.init(from_numpy(jax.tree.map(np.asarray, params0())), 6)
    g = torch.from_numpy(_grid_buf(eng.spec, 1))
    with pytest.raises(ValueError, match="k2 % k1"):
        eng.round_step(st, torch.stack([g, g]))
    with pytest.raises(ValueError, match="k2 % k1"):
        eng.round_end(st)
    st = eng.train_step(st, g)          # the per-step cadence takes any k2
    assert st.step == 1
    with pytest.raises(ValueError, match=r"\(2, 3\) holds 6 workers"):
        eng.init(from_numpy(jax.tree.map(np.asarray, params0())), 4)


# ------------------------------------------------------------ train loop
W, B, S, K1, K2 = 4, 2, 16, 2, 4
CFG_J, CFG_T = jreg.smoke_arch("qwen2-0.5b"), treg.smoke_arch("qwen2-0.5b")


@pytest.fixture(scope="module")
def soft_params():
    params = JT.init_params(CFG_J, jax.random.PRNGKey(0))
    attn = params["layers"]["attn"]
    attn["wq"], attn["wk"] = attn["wq"] * 0.1, attn["wk"] * 0.1
    return params


@pytest.mark.parametrize("overlap", [False, True])
def test_train_loop_matches_reference(soft_params, overlap):
    """Two rounds of k1 = 2 at k2 = 4 (level 1 at each, level 2 or the
    stale fold at the second) from the same parameters on the reference's
    token stream."""
    kw = dict(algorithm="hier_vrl_sgd", learning_rate=LR, warmup=False,
              overlap=overlap)
    jb = j_make(CFG_J, JVRL(update_backend="xla",
                            hier=JHier(k1=K1, k2=K2, grid=(2, 2)), **kw),
                remat=False)
    tb = t_make(CFG_T, TVRL(hier=THier(k1=K1, k2=K2, grid=(2, 2)), **kw),
                device="cpu")
    js = jb.engine.init(soft_params, W)
    ts = tb.engine.init(from_numpy(jax.tree.map(np.asarray, soft_params)),
                        W)
    data = j_stream(j_assign(W, W), S, CFG_J.vocab_size, steps=2 * K1,
                    batch=B, alpha=0.05, seed=0)
    round_j = jax.jit(jb.round_step)
    for r in range(2):
        toks = data[r * K1:(r + 1) * K1]
        labels = np.roll(toks, -1, axis=-1)
        js, lj = round_j(js, jnp.asarray(toks), jnp.asarray(labels))
        ts, lt = tb.round_step(ts, torch.from_numpy(toks).long(),
                               torch.from_numpy(labels).long())
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5)
        assert (ts.step, ts.last_sync1, ts.last_sync2) == (
            int(js.step), int(js.last_sync1), int(js.last_sync2))
    assert ts.last_sync2 == 2 * K1
    np.testing.assert_allclose(ts.params.numpy(), np.asarray(js.params),
                               rtol=0, atol=1e-5)
    for name in ("delta1", "delta2"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), rtol=0,
                                   atol=1e-5 / (K1 * LR), err_msg=name)
    # the gradient buffer the engine saw is the loop's (W, R, C) buffer
    assert tb.sync1_step is tb.engine.sync1
    assert tb.sync2_step is tb.engine.sync2


def test_train_loop_grads_buffer_is_a_grid_view(soft_params):
    tb = t_make(CFG_T, TVRL(algorithm="hier_vrl_sgd", learning_rate=LR,
                            hier=THier(k1=K1, k2=K2, grid=(2, 2))),
                device="cpu")
    ts = tb.engine.init(from_numpy(jax.tree.map(np.asarray, soft_params)),
                        W)
    toks = torch.from_numpy(j_stream(j_assign(W, W), S, CFG_J.vocab_size,
                                     steps=1, batch=B, alpha=0.05,
                                     seed=1)[0]).long()
    g1, _ = tb.grads_fn(ts, toks, torch.roll(toks, -1, dims=-1))
    g2, _ = tb.grads_fn(ts, toks, torch.roll(toks, -1, dims=-1))
    assert g1.shape == ts.params.shape and g2 is g1     # reused, no copy
    g1 = g1.clone()
    # worker i of the loop is pod i // D, member i % D
    ws = tb.engine.init(from_numpy(jax.tree.map(np.asarray, soft_params)),
                        W)
    ws.params[1, 0].mul_(1.01)
    g3, _ = tb.grads_fn(ws, toks, torch.roll(toks, -1, dims=-1))
    assert torch.equal(g3[0], g1[0]) and not torch.equal(g3[1, 0], g1[1, 0])


# ------------------------------------------------------------------- CLI
@pytest.mark.parametrize("overlap", [False, True])
def test_launch_train_hier_on_cpu(capsys, overlap):
    argv = ["--smoke", "--device", "cpu", "--algorithm", "hier_vrl_sgd",
            "--workers", "4", "--pods", "2", "--k1", "2", "--k2", "4",
            "--steps", "9", "--batch", "2", "--seq", "16", "--lr", "0.05",
            "--log-every", "1"] + (["--overlap"] if overlap else [])
    res = t_launch.run(argv)
    out = capsys.readouterr().out.splitlines()
    assert "hier: 2 pods x 2 workers, k1=2 (intra-pod), k2=4 (cross-pod)" \
        in out
    # four rounds of k1, then a one-step tail on the two-level cadence
    assert [l.split(")")[0] for l in out if l.startswith("step")] == [
        f"step {t:5d} (round {r}" for r, t in ((1, 2), (2, 4), (3, 6),
                                               (4, 8))] + ["step     9 (tail"]
    assert out[-1].startswith("kernels: ")
    assert len(res.losses) == 9 and np.all(np.isfinite(res.losses))
    st = res.state
    assert isinstance(st, HierFlatState) and st.params.shape[:2] == (2, 2)
    # blocking: the tail's step 9 syncs nothing (k1 = 2); overlap: the tail
    # takes local steps only
    assert (st.step, st.last_sync1, st.last_sync2) == (9, 8, 8)
    assert len(res.invariant) == len(res.bias_invariant) == 5
    for log in (res.invariant, res.bias_invariant):
        for _, sum_b, max_b in log:
            assert sum_b <= 1e-4 * max(max_b, 1.0)
    assert res.invariant[-1][2] > 0 and res.bias_invariant[-1][2] > 0
