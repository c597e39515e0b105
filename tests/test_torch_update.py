"""PyTorch port, engine update kernels: plain versions vs the JAX package.

``repro_torch.kernels.torch_update`` (the plain PyTorch versions, which
CPU tensors take and the CUDA kernels are held against) must reproduce
``repro.kernels.xla_update`` BITWISE on the same numpy inputs.  Against the
Pallas kernels of ``repro.kernels.vrl_update`` run in interpret mode:

* ``fused_sync_vrl``, ``fused_sync_bvr``: bitwise.
* ``fused_local_sgd``: within one rounding of γ·v.  Interpret-mode Pallas
  on the CPU contracts the last op, p − γ·v, into one FMA (γ·v is never
  rounded); the plain version, ``xla_update`` and the CUDA kernel (built
  with -fmad=false) round γ·v first.  So |plain − pallas| ≤ ulp(γ·v) +
  ulp(p'), elementwise.
* ``fused_local_momentum``, ``fused_local_adam``, ``fused_sync_easgd``:
  the same contraction, at every product that feeds an add (wd·p, β·m,
  γ·dir, b1·mu, b2·nu, γwd·p, a·(p − x̃), (1−na)·x̃): each output within the
  ulps of those products, the ulp of its own rounding, and what an input's
  difference carries through (``_ulp`` sums below).

The CUDA kernels themselves run only on a card: ``tests/test_torch_cuda.py``
(marked ``cuda``) compares them with the plain versions bitwise there and
skips elsewhere.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import vrl_update as jvu  # noqa: E402
from repro.kernels import xla_update as jxu  # noqa: E402
from repro_torch.kernels import torch_update as tu  # noqa: E402
from repro_torch.kernels import vrl_update as tvu  # noqa: E402

W, R, C, BLOCK = 3, 16, 256, 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed=0, w=W, r=R, c=C):
    rng = np.random.RandomState(seed)
    p, g, d = (rng.randn(w, r, c).astype(np.float32) for _ in range(3))
    xbar = rng.randn(r, c).astype(np.float32)
    return p, g, d, xbar


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


LOCAL_CASES = [(use_d, lr, wd) for use_d in (False, True)
               for lr, wd in ((0.05, 0.0), (0.05, 1e-4), (0.2, 1e-4))]


@pytest.mark.parametrize("use_d,lr,wd", LOCAL_CASES)
def test_plain_local_sgd_bitwise_xla(use_d, lr, wd):
    p, g, d, _ = _inputs()
    d = d if use_d else None
    want = np.asarray(jxu.fused_local_sgd(_j(p), _j(g), _j(d), lr=lr, wd=wd))
    got = tu.fused_local_sgd(_t(p), _t(g), _t(d), lr=lr, wd=wd).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("use_d,lr,wd", LOCAL_CASES)
def test_plain_local_sgd_vs_pallas_interpret(use_d, lr, wd):
    p, g, d, _ = _inputs(seed=1)
    d = d if use_d else None
    want = np.asarray(jvu.fused_local_sgd(_j(p), _j(g), _j(d), lr=lr, wd=wd,
                                          block=BLOCK, interpret=True))
    got = tu.fused_local_sgd(_t(p), _t(g), _t(d), lr=lr, wd=wd).numpy()
    # one rounding of γ·v apart (the FMA contraction named above)
    v = g - d if use_d else g
    if wd:
        v = v + np.float32(wd) * p
    lv = np.float32(lr) * v
    tol = np.spacing(np.abs(lv)) + np.spacing(np.abs(want))
    assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("kg", [0.05, 3 * 0.05, 0.7])
def test_plain_sync_vrl_bitwise(kg):
    p, _, d, xbar = _inputs(seed=2)
    scal = np.array([[kg]], np.float32)
    got_p, got_d = tu.fused_sync_vrl(_t(p), _t(xbar), _t(d), _t(scal))
    for ref in (jxu.fused_sync_vrl(_j(p), _j(xbar), _j(d), _j(scal)),
                jvu.fused_sync_vrl(_j(p), _j(xbar), _j(d), _j(scal),
                                   block=BLOCK, interpret=True)):
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got_d.numpy(), np.asarray(ref[1]))


def test_wrappers_on_cpu_write_in_place_and_count_no_launch():
    p, g, d, xbar = _inputs(seed=3)
    tp, tg, td = _t(p), _t(g), _t(d)
    tvu.reset_launches()
    out = tvu.fused_local_sgd(tp, tg, td, lr=0.1, wd=1e-4)
    assert out is tp
    want = tu.fused_local_sgd(_t(p), tg, td, lr=0.1, wd=1e-4)
    assert torch.equal(tp, want)
    scal = torch.tensor([[0.3]], dtype=torch.float32)
    p0 = tp.clone()
    op, od = tvu.fused_sync_vrl(tp, _t(xbar), td, scal)
    assert op is tp and od is td
    wp, wd_ = tu.fused_sync_vrl(p0, _t(xbar), _t(d), scal)
    assert torch.equal(tp, wp) and torch.equal(td, wd_)
    # a CPU call runs the plain version: it is not a kernel launch
    assert set(tvu.LAUNCHES) >= {"fused_local_sgd", "fused_sync_vrl"}
    assert not any(tvu.LAUNCHES.values()), tvu.LAUNCHES


def test_wrappers_reject_what_the_kernels_do_not_take():
    p, g, d, xbar = (_t(x) for x in _inputs(seed=4))
    scal = torch.ones(1, 1)
    with pytest.raises(TypeError):
        tvu.fused_local_sgd(p.double(), g.double(), lr=0.1)
    with pytest.raises(ValueError):
        tvu.fused_local_sgd(p, g[:, :-1], lr=0.1)
    with pytest.raises(ValueError):
        tvu.fused_local_sgd(p, g.transpose(1, 2).contiguous()
                            .transpose(1, 2), lr=0.1)
    with pytest.raises(ValueError):
        tvu.fused_local_sgd(p[..., :6].contiguous(),
                            g[..., :6].contiguous(), lr=0.1)
    with pytest.raises(ValueError):
        tvu.fused_sync_vrl(p, xbar[:-1], d, scal)
    with pytest.raises(ValueError):
        tvu.fused_sync_vrl(p, xbar, d, torch.ones(2))


def _ulp(*xs):
    """Σ ulp(|x|) over fp32 arrays: the roundings an FMA can skip."""
    return sum(np.spacing(np.abs(np.asarray(x, np.float32))) for x in xs)


MOMENT = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _moments(seed, mdt, n=2):
    """n (W, R, C) moment buffers in ``mdt``: m-like and nu-like (≥ 0),
    as torch and jax arrays holding the same values."""
    rng = np.random.RandomState(seed)
    m = 0.1 * rng.randn(W, R, C).astype(np.float32)
    nu = 0.01 * np.square(rng.randn(W, R, C)).astype(np.float32)
    out = []
    for x in (m, nu)[:n]:
        t = torch.from_numpy(x).to(MOMENT[mdt][0])
        out.append((t, jnp.asarray(t.float().numpy()).astype(MOMENT[mdt][1])))
    return out


MOM_CASES = [(corr, wd, nesterov, mdt) for corr in ("none", "d", "db")
             for wd, nesterov in ((0.0, False), (1e-3, False), (1e-3, True))
             for mdt in ("f32", "bf16")]


@pytest.mark.parametrize("corr,wd,nesterov,mdt", MOM_CASES)
def test_plain_local_momentum_bitwise_xla(corr, wd, nesterov, mdt):
    p, g, d, xb = _inputs(seed=5)
    b = xb[None] * 0.5 + d if "b" in corr else None
    d = d if "d" in corr else None
    [(tm, jm)] = _moments(6, mdt, n=1)
    kw = dict(lr=0.05, beta=0.9, wd=wd, nesterov=nesterov)
    want = jxu.fused_local_momentum(_j(p), _j(g), _j(d), jm, b=_j(b), **kw)
    got = tu.fused_local_momentum(_t(p), _t(g), _t(d), tm, b=_t(b), **kw)
    assert got[1].dtype == MOMENT[mdt][0]
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(w.astype(jnp.float32)))


@pytest.mark.parametrize("nesterov", [False, True])
def test_plain_local_momentum_vs_pallas_interpret(nesterov):
    p, g, d, _ = _inputs(seed=7)
    [(tm, jm)] = _moments(8, "f32", n=1)
    m = tm.numpy()
    lr, beta, wd = 0.05, 0.9, 1e-3
    kw = dict(lr=lr, beta=beta, wd=wd, nesterov=nesterov)
    want_p, want_m = (np.asarray(x) for x in jvu.fused_local_momentum(
        _j(p), _j(g), _j(d), jm, block=BLOCK, interpret=True, **kw))
    got_p, got_m = (x.numpy() for x in tu.fused_local_momentum(
        _t(p), _t(g), _t(d), tm, **kw))
    f = np.float32
    v = (g - d) + f(wd) * p
    m_new = f(beta) * m + v
    tol_m = _ulp(f(wd) * p, f(beta) * m, m_new)
    dir_ = v + f(beta) * m_new if nesterov else m_new
    tol_dir = tol_m + (_ulp(f(beta) * m_new, dir_) if nesterov else 0)
    tol_p = _ulp(f(lr) * dir_, want_p) + f(lr) * (1 + beta) * tol_dir
    assert np.all(np.abs(got_m - want_m) <= tol_m)
    assert np.all(np.abs(got_p - want_p) <= tol_p)


ADAM_CASES = [(corr, wd, mdt) for corr in ("none", "d", "db")
              for wd in (0.0, 1e-3) for mdt in ("f32", "bf16")]


@pytest.mark.parametrize("corr,wd,mdt", ADAM_CASES)
def test_plain_local_adam_bitwise_xla(corr, wd, mdt):
    p, g, d, xb = _inputs(seed=9)
    b = xb[None] * 0.5 + d if "b" in corr else None
    d = d if "d" in corr else None
    (tmu, jmu), (tnu, jnu) = _moments(10, mdt)
    scal = np.array([[1 - 0.9 ** 3, 1 - 0.999 ** 3]], np.float32)
    kw = dict(lr=1e-3, wd=wd)
    want = jxu.fused_local_adam(_j(p), _j(g), _j(d), jmu, jnu, _j(scal),
                                b=_j(b), **kw)
    got = tu.fused_local_adam(_t(p), _t(g), _t(d), tmu, tnu, _t(scal),
                              b=_t(b), **kw)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(w.astype(jnp.float32)))


def test_plain_local_adam_vs_pallas_interpret():
    p, g, d, _ = _inputs(seed=11)
    (tmu, jmu), (tnu, jnu) = _moments(12, "f32")
    lr, wd, b1, b2 = 1e-3, 1e-3, 0.9, 0.999
    scal = np.array([[1 - b1 ** 3, 1 - b2 ** 3]], np.float32)
    want = [np.asarray(x) for x in jvu.fused_local_adam(
        _j(p), _j(g), _j(d), jmu, jnu, _j(scal), lr=lr, wd=wd, block=BLOCK,
        interpret=True)]
    got = [x.numpy() for x in tu.fused_local_adam(
        _t(p), _t(g), _t(d), tmu, tnu, _t(scal), lr=lr, wd=wd)]
    f = np.float32
    v = g - d
    mu, nu = tmu.numpy(), tnu.numpy()
    mu_new = f(b1) * mu + f(1 - b1) * v
    nu_new = f(b2) * nu + f(1 - b2) * v * v
    tol_mu = _ulp(f(b1) * mu, f(1 - b1) * v, mu_new)
    tol_nu = _ulp(f(b2) * nu, f(1 - b2) * v * v, nu_new)
    step = f(lr) * (mu_new / scal[0, 0]) / (np.sqrt(nu_new / scal[0, 1])
                                            + f(1e-8))
    # the step's relative error from mu' and nu' (√ halves nu's), four
    # roundings of its own, and the contracted γ·wd·p and p − step
    tol_p = (np.abs(step) * (tol_mu / np.abs(mu_new)
                             + tol_nu / (2 * nu_new))
             + 4 * _ulp(step) + _ulp(f(lr * wd) * p, want[0]))
    assert np.all(np.abs(got[1] - want[1]) <= tol_mu)
    assert np.all(np.abs(got[2] - want[2]) <= tol_nu)
    assert np.all(np.abs(got[0] - want[0]) <= tol_p)


@pytest.mark.parametrize("beta", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("kg", [0.05, 3 * 0.05])
def test_plain_sync_bvr_bitwise(beta, kg):
    p, g, d, xbar = _inputs(seed=13)
    b = 0.5 * g
    scal = np.array([[kg]], np.float32)
    got = tu.fused_sync_bvr(_t(p), _t(xbar), _t(d), _t(b), _t(scal),
                            beta=beta)
    for ref in (jxu.fused_sync_bvr(_j(p), _j(xbar), _j(d), _j(b), _j(scal),
                                   beta=beta),
                jvu.fused_sync_bvr(_j(p), _j(xbar), _j(d), _j(b), _j(scal),
                                   beta=beta, block=BLOCK, interpret=True)):
        for a, w in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(w))


@pytest.mark.parametrize("alpha,n", [(0.3, W), (0.9, W), (0.3, 4)])
def test_plain_sync_easgd_bitwise_xla_and_vs_pallas(alpha, n):
    p, _, _, xbar = _inputs(seed=14)
    center = p.mean(axis=0) + np.float32(0.25)
    a = alpha / n
    kw = dict(a=a, na=n * a)
    got_p, got_c = (x.numpy() for x in tu.fused_sync_easgd(
        _t(p), _t(xbar), _t(center), **kw))
    want = jxu.fused_sync_easgd(_j(p), _j(xbar), _j(center), **kw)
    np.testing.assert_array_equal(got_p, np.asarray(want[0]))
    np.testing.assert_array_equal(got_c, np.asarray(want[1]))
    pal_p, pal_c = (np.asarray(x) for x in jvu.fused_sync_easgd(
        _j(p), _j(xbar), _j(center), block=BLOCK, interpret=True, **kw))
    f = np.float32
    assert np.all(np.abs(got_p - pal_p)
                  <= _ulp(f(a) * (p - center[None]), pal_p))
    assert np.all(np.abs(got_c - pal_c)
                  <= _ulp(f(1 - n * a) * center, f(n * a) * xbar, pal_c))


def test_new_wrappers_on_cpu_write_in_place():
    p, g, d, xbar = (_t(x) for x in _inputs(seed=15))
    (m, _), (nu, _) = _moments(16, "bf16")
    tvu.reset_launches()
    p0, m0 = p.clone(), m.clone()
    out = tvu.fused_local_momentum(p, g, d, m, lr=0.05, beta=0.9, wd=1e-4)
    assert out[0] is p and out[1] is m
    want = tu.fused_local_momentum(p0, g, d, m0, lr=0.05, beta=0.9, wd=1e-4)
    assert torch.equal(p, want[0]) and torch.equal(m, want[1])
    mu = m.clone()
    from repro_torch.optim import adam_scal
    scal = adam_scal(2)
    p0, mu0, nu0 = p.clone(), mu.clone(), nu.clone()
    out = tvu.fused_local_adam(p, g, None, mu, nu, scal, lr=1e-3, b=d)
    assert out[0] is p and out[1] is mu and out[2] is nu
    want = tu.fused_local_adam(p0, g, None, mu0, nu0, scal, lr=1e-3, b=d)
    assert all(torch.equal(a, w) for a, w in zip(out, want))
    b = g.clone()
    kg = torch.tensor([[0.1]])
    p0, d0, b0 = p.clone(), d.clone(), b.clone()
    out = tvu.fused_sync_bvr(p, xbar, d, b, kg, beta=0.5)
    assert out[0] is p and out[1] is d and out[2] is b
    want = tu.fused_sync_bvr(p0, xbar, d0, b0, kg, beta=0.5)
    assert all(torch.equal(a, w) for a, w in zip(out, want))
    center = xbar + 1.0
    p0, c0 = p.clone(), center.clone()
    out = tvu.fused_sync_easgd(p, xbar, center, a=0.1, na=0.3)
    assert out[0] is p and out[1] is center
    want = tu.fused_sync_easgd(p0, xbar, c0, a=0.1, na=0.3)
    assert all(torch.equal(a, w) for a, w in zip(out, want))
    assert not any(tvu.LAUNCHES.values()), tvu.LAUNCHES


def test_new_wrappers_reject_what_the_kernels_do_not_take():
    p, g, d, xbar = (_t(x) for x in _inputs(seed=17))
    m = torch.zeros_like(p)
    with pytest.raises(TypeError):      # fp16 moments
        tvu.fused_local_momentum(p, g, d, m.half(), lr=0.1, beta=0.9)
    with pytest.raises(TypeError):      # mu and nu of two dtypes
        tvu.fused_local_adam(p, g, d, m, m.bfloat16(), torch.ones(1, 2),
                             lr=0.1)
    with pytest.raises(ValueError):
        tvu.fused_local_adam(p, g, d, m, m.clone(), torch.ones(1, 1), lr=0.1)
    with pytest.raises(ValueError):
        tvu.fused_local_momentum(p, g, d, m[:, :-1], lr=0.1, beta=0.9)
    with pytest.raises(ValueError):
        tvu.fused_sync_bvr(p, xbar[:-1], d, g, torch.ones(1, 1), beta=0.5)
    with pytest.raises(ValueError):
        tvu.fused_sync_easgd(p, xbar, xbar[:-1], a=0.1, na=0.3)
    with pytest.raises(TypeError):
        tvu.fused_sync_easgd(p, xbar, xbar.double(), a=0.1, na=0.3)


# ------------------------------------------------ overlapped-round fold
def _wscal(w=W):
    """(W, 2) [1/(pend_k γ), km] with pend_k ∈ {1, 2, 3} and km mixed."""
    pend_k = np.array([1.0, 2.0, 3.0, 2.0][:w], np.float32)
    inv = np.float32(1.0) / (pend_k * np.float32(0.05))
    km = np.array([0.0, 1.0, 0.0, 1.0][:w], np.float32)
    return np.stack([inv, km], axis=1)


FOLD_CASES = [(kind, capture) for kind in ("vrl", "bvr0.5", "bvr1", "avg")
              for capture in (False, True)]


def _fold_call(mod, kind, p, xbar, pend, d, b, wscal, capture, **kw):
    if kind == "avg":
        return mod.fused_fold_overlap_avg(p, xbar, pend, wscal,
                                          capture=capture, **kw)
    if kind == "vrl":
        return mod.fused_fold_overlap(p, xbar, pend, d, wscal,
                                      capture=capture, **kw)
    return mod.fused_fold_overlap_bvr(p, xbar, pend, d, b, wscal,
                                      beta=float(kind[3:]), capture=capture,
                                      **kw)


@pytest.mark.parametrize("kind,capture", FOLD_CASES)
def test_plain_fold_overlap_bitwise_xla(kind, capture):
    p, g, d, xbar = _inputs(seed=18)
    pend, b = p + 0.1 * g, 0.5 * g
    ws = _wscal()
    got = _fold_call(tu, kind, _t(p), _t(xbar), _t(pend), _t(d), _t(b),
                     _t(ws), capture)
    want = _fold_call(jxu, kind, _j(p), _j(xbar), _j(pend), _j(d), _j(b),
                      _j(ws), capture)
    assert len(got) == len(want)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind,capture", FOLD_CASES)
def test_plain_fold_overlap_vs_pallas_interpret(kind, capture):
    """p' and pend' bitwise (their products are by km ∈ {0, 1}: exact);
    Δ' and B' within the ulps of the products interpret-mode Pallas may
    contract into an FMA (c·s₀, (1−β)B, β·c·s₀) and of the result."""
    p, g, d, xbar = _inputs(seed=19)
    pend, b = p + 0.1 * g, 0.5 * g
    ws = _wscal()
    got = [x.numpy() for x in _fold_call(
        tu, kind, _t(p), _t(xbar), _t(pend), _t(d), _t(b), _t(ws), capture)]
    want = [np.asarray(x) for x in _fold_call(
        jvu, kind, _j(p), _j(xbar), _j(pend), _j(d), _j(b), _j(ws), capture,
        block=BLOCK, interpret=True)]
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[0], want[0])
    if capture:
        np.testing.assert_array_equal(got[-1], want[-1])
    f = np.float32
    c = xbar[None] - pend
    inv = ws[:, 0][:, None, None]
    if kind != "avg":
        np.testing.assert_array_less(np.abs(got[1] - want[1]),
                                     _ulp(c * inv, want[1]) + 1e-30)
    if kind.startswith("bvr"):
        beta = f(kind[3:])
        tol = _ulp(f(1 - beta) * b, beta * c * inv, want[2]) + 1e-30
        np.testing.assert_array_less(np.abs(got[2] - want[2]), tol)


def test_fold_wrappers_on_cpu_write_in_place_and_reject():
    p, g, d, xbar = (_t(x) for x in _inputs(seed=20))
    pend, b, ws = p + 0.1 * g, 0.5 * g, _t(_wscal())
    tvu.reset_launches()
    want = tu.fused_fold_overlap_bvr(p, xbar, pend, d, b, ws, beta=0.5)
    bufs = [x.clone() for x in (p, pend, d, b)]
    out = tvu.fused_fold_overlap_bvr(bufs[0], xbar, bufs[1], bufs[2],
                                     bufs[3], ws, beta=0.5)
    assert [o is x for o, x in zip(out, (bufs[0], bufs[2], bufs[3],
                                         bufs[1]))] == [True] * 4
    assert all(torch.equal(a, w) for a, w in zip(out, want))
    pend2 = pend.clone()
    out = tvu.fused_fold_overlap(p.clone(), xbar, pend2, d.clone(), ws,
                                 capture=False)
    assert len(out) == 2 and torch.equal(pend2, pend)
    out = tvu.fused_fold_overlap_avg(p.clone(), xbar, pend.clone(), ws)
    assert len(out) == 2
    assert not any(tvu.LAUNCHES.values()), tvu.LAUNCHES
    with pytest.raises(ValueError, match="wscal"):
        tvu.fused_fold_overlap(p, xbar, pend, d, ws[:, :1].contiguous())
    with pytest.raises(ValueError, match="xbar"):
        tvu.fused_fold_overlap(p, xbar[:-1], pend, d, ws)
    with pytest.raises(ValueError):
        tvu.fused_fold_overlap(p, xbar, pend[:, :-1], d, ws)
