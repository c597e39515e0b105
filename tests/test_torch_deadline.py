"""PyTorch port, straggler deadlines of the overlapped round vs the JAX
package.

* ``core/deadline``'s numpy draw is BITWISE ``jax.random.uniform(
  jax.random.fold_in(jax.random.PRNGKey(0), step), (n, 1))`` (Threefry-2x32
  in JAX's partitionable layout) for steps 0-300 and n ∈ {1, 2, 3, 4, 8},
  and so is the fp32 miss mask ``u < deadline``.
* Flat trajectories: vrl_sgd and bvr_l_sgd, uncompressed and int8, at
  deadline ∈ {0.25, 1.0}, four overlapped rounds of ``round_step_flat``
  against the reference's ``update_backend="xla"`` engine on the same
  numpy gradients (``tests/test_torch_overlap.py``'s standard: params and
  pend atol 1e-5, Δ and B 1e-5/γ, the residual and ref 1e-5, pend_k
  bitwise; int8 under ``close_or_flipped``'s flip rules, each capture's
  payload read off the reference's state: a missed worker's residual
  holds its whole payload).  The hierarchy (2, 3) at (k1, k2) = (2, 4): uncompressed, int8
  and int8 / topk:4, at the same deadlines (``tests/test_torch_hier_
  compress.py``'s ``run_hier`` and rules).
* deadline = 1.0 is bitwise pure-local training in the port: no worker
  ever transmits, pend stays x0, every fold's correction is exactly zero.
* deadline = 0.0 is bitwise the no-deadline program: a deadline that
  misses nothing over the run takes the same path to the same bits.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro_torch.core import deadline as tdl  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.models.param import from_numpy  # noqa: E402

from test_torch_compress import (close_or_flipped, grad_buf,  # noqa: E402
                                 params0, step_bound, templates)
from test_torch_hier_compress import compare_hier, run_hier  # noqa: E402
from test_torch_overlap import cfgs  # noqa: E402

W, K, LR, ROUNDS = 4, 4, 0.05, 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ draw
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_draw_is_bitwise_jax_random_uniform(n):
    draw = jax.jit(lambda s: jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(0), s), (n, 1)))
    for step in range(301):
        want = np.asarray(draw(jnp.int32(step)))
        got = tdl.uniform(step, n)
        assert got.dtype == np.float32 and got.shape == (n, 1)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32), err_msg=step)
        for d in (0.25, 0.5):
            np.testing.assert_array_equal(
                tdl.miss_mask(step, n, d),
                np.asarray(want < jnp.float32(d), np.float32))
    assert not tdl.miss_mask(7, n, 0.0).any()


def test_known_draws():
    """The key and the draw of step 4 (jax 0.9.0), and the per-pod masks
    at deadline 0.25 of the hierarchy's folds at steps 4, 8 and 12."""
    assert tdl.fold_in((0, 0), 4) == (2285895361, 433833334)
    np.testing.assert_array_equal(
        tdl.uniform(4, 4).ravel(),
        np.array([0.15365434, 0.72900534, 0.09780347, 0.45166838],
                 np.float32))
    assert [tdl.miss_mask(s, 2, 0.25).ravel().tolist()
            for s in (4, 8, 12)] == [[1, 0], [0, 1], [0, 0]]


# ------------------------------------------------------------------ flat
def run_flat(alg, compress, deadline, seed=700):
    tj, tt = templates()
    cj, ct = cfgs(alg, compress, deadline=deadline)
    ej, et = jeng.make_engine(cj, tj), teng.make_engine(ct, tt)
    p0 = params0()
    sj = ej.init(p0, W)
    st = et.init(from_numpy(jax.tree.map(np.asarray, p0)), W)
    round_j = jax.jit(ej.round_step_flat)
    bound = 0.0
    for r in range(ROUNDS):
        gk = np.stack([grad_buf(ej.spec, seed + 10 * r + i)
                       for i in range(K)])
        xbar = np.asarray(sj.overlap.pend).mean(axis=0)
        sj = round_j(sj, jnp.asarray(gk))
        st = et.round_step_flat(st, torch.from_numpy(gk))
        assert (st.step, st.last_sync) == (int(sj.step), int(sj.last_sync))
        if compress is not None:
            # the capture's payload: dec + e' = pend' − x̂_stale + e' for a
            # worker that transmitted; a missed one keeps it all in e'
            km = tdl.miss_mask(st.step, W, deadline)[:, :, None]
            resid = np.asarray(sj.comm.resid)
            x = (1 - km) * (np.asarray(sj.overlap.pend) - xbar[None]) + resid
            bound += step_bound(compress, x)
    return sj, st, bound


@pytest.mark.parametrize("deadline", [0.25, 1.0])
@pytest.mark.parametrize("compress", [None, "int8"])
@pytest.mark.parametrize("alg", ["vrl_sgd", "bvr_l_sgd"])
def test_flat_deadline_matches_reference(alg, compress, deadline):
    sj, st, bound = run_flat(alg, compress, deadline)
    pairs = [("params", st.params, sj.params, 1.0),
             ("pend", st.overlap.pend, sj.overlap.pend, 1.0),
             ("delta", st.delta, sj.delta, 1 / LR)]
    if isinstance(st.bias, torch.Tensor):
        pairs.append(("bias", st.bias, sj.bias, 1 / LR))
    if compress is not None:
        pairs += [("resid", st.comm.resid, sj.comm.resid, 1.0),
                  ("ref", st.comm.ref, sj.comm.ref, 1.0)]
    flips = {name: close_or_flipped(a.numpy(), b, 1e-5 * scale,
                                    2 * bound * scale, name, compress)
             for name, a, b, scale in pairs}
    np.testing.assert_array_equal(st.overlap.pend_k.numpy(),
                                  np.asarray(sj.overlap.pend_k))
    print(f"{alg}+{compress}, deadline={deadline}: flipped {flips}, pend_k "
          f"{st.overlap.pend_k.ravel().tolist()}")
    missed = [tdl.miss_mask(K * (r + 1), W, deadline).any()
              for r in range(ROUNDS)]
    assert any(missed)


# ------------------------------------------------------------- hierarchy
@pytest.mark.parametrize("deadline", [0.25, 1.0])
@pytest.mark.parametrize("compress,compress2", [(None, None),
                                                ("int8", None),
                                                ("int8", "topk:4")])
def test_hier_deadline_matches_reference(compress, compress2, deadline):
    ej, et, sj, st, bound = run_hier(compress, compress2, overlap=True,
                                     deadline=deadline)
    flips = compare_hier(sj, st, et, bound)
    print(f"hier {compress}/{compress2}, deadline={deadline}: flipped "
          f"{flips}, pend_k {st.overlap.pend_k.ravel().tolist()}")
    if deadline == 1.0:
        # no pod ever transmits: pend stays x0, pend_k stretches each fold
        assert st.overlap.pend_k.ravel().tolist() == [9.0, 9.0]


# ------------------------------------------------------- the two limits
def _state_bufs(st):
    bufs = {"params": st.params, "delta": st.delta, "pend": st.overlap.pend,
            "pend_k": st.overlap.pend_k}
    if st.comm != ():
        bufs.update(resid=st.comm.resid, ref=st.comm.ref)
    return bufs


@pytest.mark.parametrize("compress", [None, "int8"])
def test_deadline_one_is_pure_local_training(compress):
    """Nobody ever transmits: every fold folds c = x0 − x0 = 0, so the
    parameters are bitwise those of local steps alone, Δ stays 0, pend x0."""
    tj, tt = templates()
    _, ct = cfgs("vrl_sgd", compress, deadline=1.0)
    et = teng.make_engine(ct, tt)
    _, c_local = cfgs("vrl_sgd", None, overlap=False)
    el = teng.make_engine(c_local, tt)
    p0 = from_numpy(jax.tree.map(np.asarray, params0()))
    st, sl = et.init(p0, W), el.init(p0, W)
    pend0 = st.overlap.pend.clone()
    for r in range(ROUNDS):
        gk = np.stack([grad_buf(et.spec, 40 + 10 * r + i) for i in range(K)])
        st = et.round_step_flat(st, torch.from_numpy(gk))
        for g in gk:
            sl = el.local_step(sl, torch.from_numpy(g))
    assert torch.equal(st.params, sl.params)
    assert not st.delta.any()
    assert torch.equal(st.overlap.pend, pend0)
    assert st.overlap.pend_k.ravel().tolist() == [1.0 + K * ROUNDS] * W


@pytest.mark.parametrize("alg,compress", [("vrl_sgd", None),
                                          ("vrl_sgd", "int8"),
                                          ("bvr_l_sgd", "topk:4")])
def test_deadline_zero_is_the_no_deadline_program(alg, compress):
    """deadline = 0 draws nothing; a deadline that draws but misses nothing
    over the run (1e-9) is bitwise the same run."""
    tj, tt = templates()
    assert not any(tdl.miss_mask(K * (r + 1), W, 1e-9).any()
                   for r in range(ROUNDS))
    runs = []
    for d in (0.0, 1e-9):
        _, ct = cfgs(alg, compress, deadline=d)
        et = teng.make_engine(ct, tt)
        st = et.init(from_numpy(jax.tree.map(np.asarray, params0())), W)
        for r in range(ROUNDS):
            gk = np.stack([grad_buf(et.spec, 60 + 10 * r + i)
                           for i in range(K)])
            st = et.round_step_flat(st, torch.from_numpy(gk))
        runs.append(_state_bufs(st))
    for name, a in runs[0].items():
        assert torch.equal(a, runs[1][name]), name


def test_hier_deadline_zero_is_the_no_deadline_program():
    _, et0, _, s0, _ = run_hier("int8", "topk:4", overlap=True,
                                deadline=0.0)
    _, et1, _, s1, _ = run_hier("int8", "topk:4", overlap=True,
                                deadline=1e-9)
    assert not any(tdl.miss_mask(4 * i, 2, 1e-9).any() for i in (1, 2))
    for a, b in ((s0.params, s1.params), (s0.delta1, s1.delta1),
                 (s0.delta2, s1.delta2), (s0.overlap.pend, s1.overlap.pend),
                 (s0.overlap.pend_k, s1.overlap.pend_k)):
        assert torch.equal(a, b)
    for a, b in zip(s0.comm, s1.comm):
        assert torch.equal(a, b)
