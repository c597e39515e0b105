"""PyTorch port, overlapped rounds vs the JAX package.

* ``overlap=True``: {vrl_sgd, local_sgd, bvr_l_sgd, stl_sgd on a stagewise
  schedule} × {uncompressed, int8, topk:4}, four rounds of
  ``round_step_flat`` (``round_begin`` → k local steps → ``round_fold``)
  from the same parameters on the same numpy gradients, against the JAX
  package's ``make_engine(update_backend="xla")``: params and pend atol
  1e-5, Δ, B atol 1e-5/(k·γ) and the residual 1e-5 (the reference's engine
  standard), pend_k bitwise.  Under compression the capture rides the EF
  round trip, and a quantisation level or top-k pick may flip between the
  two packages' fp32 roundings: top-k is held to atol everywhere (no pick
  flips, measured); under int8 at most a few elements may flip a level,
  each held, row by row, to twice the sum of the captures' steps
  (max|payload row|/127) — ``tests/test_torch_compress.py``.
* After every fold Σ_i Δ_i = 0 and Σ_i B_i = (1−β)Σ_i B_i (so 0), to the
  fp32 rounding of the stale mean, compressed or not: Σ_i c_i =
  W·mean(pend) − Σ_i pend_i = 0.
* ``overlap=False`` is the blocking round bitwise and adds no buffers; the
  per-step ``train_step`` stays blocking under overlap, as in the
  reference; the reference's overlap validations raise in the port too,
  and a valid deadline builds (its runs: ``tests/test_torch_deadline.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.comm import compressors as jcc  # noqa: E402
from repro.configs.base import VRLConfig as JVRL  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core.schedule import custom_stages as j_stages  # noqa: E402
from repro_torch.comm import compressors as tcc  # noqa: E402
from repro_torch.configs.base import VRLConfig as TVRL  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.schedule import custom_stages as t_stages  # noqa: E402
from repro_torch.models.param import from_numpy  # noqa: E402

from test_torch_compress import (close_or_flipped, grad_buf,  # noqa: E402
                                 params0, step_bound, templates)

W, K, LR = 4, 4, 0.05
STAGES = [(1, 2), (2, 2), (4, 2)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(alg, compress=None, **over):
    kw = dict(algorithm=alg, comm_period=K, learning_rate=LR,
              weight_decay=0.0, warmup=False, overlap=True)
    kw.update(over)
    stages = kw.pop("stages", None)
    cj = JVRL(update_backend="xla",
              compress=None if compress is None else
              jcc.parse_compressor(compress),
              comm_schedule=None if stages is None else j_stages(stages),
              **kw)
    ct = TVRL(compress=None if compress is None else
              tcc.parse_compressor(compress),
              comm_schedule=None if stages is None else t_stages(stages),
              **kw)
    return cj, ct


def rounds_of(alg):
    """Round sizes: stl_sgd runs the stagewise schedule (variable k feeds
    pend_k), the others the constant k."""
    if alg == "stl_sgd":
        return [k for k, n in STAGES for _ in range(n)]
    return [K] * 4


def run_overlap(alg, compress=None, **over):
    tj, tt = templates()
    if alg == "stl_sgd":
        over.setdefault("stages", STAGES)
    cj, ct = cfgs(alg, compress, **over)
    ej, et = jeng.make_engine(cj, tj), teng.make_engine(ct, tt)
    p0 = params0()
    sj = ej.init(p0, W)
    st = et.init(from_numpy(jax.tree.map(np.asarray, p0)), W)
    round_j = jax.jit(ej.round_step_flat)
    bound, sums = 0.0, []
    for r, k in enumerate(rounds_of(alg)):
        gk = np.stack([grad_buf(ej.spec, 700 + 10 * r + i) for i in range(k)])
        xbar = np.asarray(sj.overlap.pend).mean(axis=0)
        sj = round_j(sj, jnp.asarray(gk))
        st = et.round_step_flat(st, torch.from_numpy(gk))
        assert (st.step, st.last_sync) == (int(sj.step), int(sj.last_sync))
        if compress is not None:
            # the capture's payload: dec + e' = pend' − x̂_stale + e'
            x = np.asarray(sj.overlap.pend) - xbar[None]
            if not isinstance(sj.comm.resid, tuple):
                x = x + np.asarray(sj.comm.resid)
            bound += step_bound(compress, x)
        sums.append({name: teng.sum_invariant(getattr(st, name))
                     for name in ("delta", "bias")
                     if isinstance(getattr(st, name), torch.Tensor)})
        sums[-1]["max_pend"] = st.overlap.pend.abs().max().item()
        sums[-1]["k"] = k
    return ej, et, sj, st, bound, sums


MATRIX = [(alg, comp) for alg in ("vrl_sgd", "local_sgd", "bvr_l_sgd",
                                  "stl_sgd")
          for comp in (None, "int8", "topk:4")]


@pytest.mark.parametrize("alg,compress", MATRIX)
def test_overlap_matches_reference(alg, compress):
    ej, et, sj, st, bound, _ = run_overlap(alg, compress)
    flips = {}
    atol = 1e-5
    flip = 2 * bound
    kg = LR                     # Δ moves by c/(pend_k γ), pend_k ≥ 1
    flips["params"] = close_or_flipped(st.params.numpy(), sj.params, atol,
                                       flip, "params", compress)
    flips["pend"] = close_or_flipped(st.overlap.pend.numpy(),
                                     sj.overlap.pend, atol, flip, "pend",
                                     compress)
    np.testing.assert_array_equal(st.overlap.pend_k.numpy(),
                                  np.asarray(sj.overlap.pend_k))
    assert st.overlap.pend_k.shape == (W, 1, 1)
    for name in ("delta", "bias"):
        a, b = getattr(st, name), getattr(sj, name)
        assert isinstance(a, torch.Tensor) == hasattr(b, "shape"), name
        if isinstance(a, torch.Tensor):
            flips[name] = close_or_flipped(a.numpy(), b, atol / kg,
                                           flip / kg, name, compress)
    if compress is None:
        assert st.comm == () == sj.comm
    else:
        flips["resid"] = close_or_flipped(st.comm.resid.numpy(),
                                          sj.comm.resid, atol, flip, "resid",
                                          compress)
        flips["ref"] = close_or_flipped(st.comm.ref.numpy(), sj.comm.ref,
                                        atol, flip, "ref", compress)
    print(f"{alg}+{compress}: flipped elements {flips} (largest row step "
          f"bound {np.max(bound):.3e})")
    if alg == "stl_sgd":
        assert float(st.overlap.pend_k[0, 0, 0]) == 4.0   # the last k


@pytest.mark.parametrize("compress", [None, "int8", "topk:4"])
@pytest.mark.parametrize("alg", ["vrl_sgd", "bvr_l_sgd"])
def test_sums_vanish_after_every_fold(alg, compress):
    """Σ_i c_i = 0, so Σ_i Δ_i and Σ_i B_i stay 0 after every fold — also
    under compression — to 1e-4 · the run's largest |Δ| (|B|) plus the
    fp32 rounding of the stale mean, 2 W ulp(max|pend|)/(pend_k γ) per
    fold."""
    *_, sums = run_overlap(alg, compress)
    rounding = 0.0
    for r, s in enumerate(sums):
        if r:       # the first fold's correction is exactly zero
            rounding += (2 * W * float(np.spacing(np.float32(
                sums[r - 1]["max_pend"]))) / (sums[r - 1]["k"] * LR))
        for name in ("delta", "bias"):
            if name not in s:
                continue
            sum_b = s[name][0]
            max_b = max(x[name][1] for x in sums[:r + 1])
            assert sum_b <= 1e-4 * max_b + rounding, (r, name, sum_b, max_b)
    assert max(x["delta"][1] for x in sums) > 0


def test_overlap_off_is_the_blocking_round_bitwise():
    tj, tt = templates()
    _, ct_on = cfgs("vrl_sgd", "int8", overlap=False)
    ct_def = TVRL(algorithm="vrl_sgd", comm_period=K, learning_rate=LR,
                  weight_decay=0.0, warmup=False,
                  compress=tcc.parse_compressor("int8"))
    p0 = from_numpy(jax.tree.map(np.asarray, params0()))
    e1, e2 = teng.make_engine(ct_on, tt), teng.make_engine(ct_def, tt)
    assert e1.round_begin is None and e1.round_fold is None
    s1, s2 = e1.init(p0, W), e2.init(p0, W)
    assert s1.overlap == () == s2.overlap
    for r in range(3):
        gk = torch.from_numpy(np.stack([grad_buf(e1.spec, 40 + 4 * r + i)
                                        for i in range(K)]))
        s1 = e1.round_step_flat(s1, gk.clone())
        s2 = e2.round_step_flat(s2, gk.clone())
    for a, b in ((s1.params, s2.params), (s1.delta, s2.delta),
                 (s1.comm.resid, s2.comm.resid), (s1.comm.ref, s2.comm.ref)):
        assert torch.equal(a, b)


def test_train_step_stays_blocking_and_round_step_takes_trees():
    """Under overlap the per-step driver syncs as the blocking engine does
    (the reference's ``train_step``), leaving the overlap buffers as they
    are; ``round_step`` over gradient trees is ``round_step_flat``."""
    from repro_torch.core import flat as tflat
    tj, tt = templates()
    _, c_on = cfgs("vrl_sgd")
    _, c_off = cfgs("vrl_sgd", overlap=False)
    p0 = from_numpy(jax.tree.map(np.asarray, params0()))
    e_on, e_off = teng.make_engine(c_on, tt), teng.make_engine(c_off, tt)
    s_on, s_off = e_on.init(p0, W), e_off.init(p0, W)
    pend0 = s_on.overlap.pend.clone()
    for t in range(2 * K + 1):
        g = torch.from_numpy(grad_buf(e_on.spec, 60 + t))
        s_on = e_on.train_step(s_on, g.clone())
        s_off = e_off.train_step(s_off, g.clone())
    assert torch.equal(s_on.params, s_off.params)
    assert torch.equal(s_on.delta, s_off.delta)
    assert torch.equal(s_on.overlap.pend, pend0)
    s1, s2 = e_on.init(p0, W), e_on.init(p0, W)
    gk = torch.from_numpy(np.stack([grad_buf(e_on.spec, 80 + i)
                                    for i in range(K)]))
    tree = tflat.unflatten_stacked(e_on.spec, gk.reshape(-1, *gk.shape[2:]))
    tree = jax.tree.map(lambda x: x.reshape(K, W, *x.shape[1:]), tree)
    for _ in range(2):
        s1 = e_on.round_step_flat(s1, gk.clone())
        s2 = e_on.round_step(s2, tree)
    for a, b in ((s1.params, s2.params), (s1.delta, s2.delta),
                 (s1.overlap.pend, s2.overlap.pend)):
        assert torch.equal(a, b)


def test_overlap_validation_and_unported_deadline():
    """The reference's refusals raise in the port too; a valid deadline
    builds in both packages, the port drawing the reference's misses."""
    tj, tt = templates()
    for alg, over, exc, match in [
            ("ssgd", {}, ValueError, "overlap"),
            ("easgd", {}, ValueError, "overlap"),
            ("vrl_sgd", dict(overlap=False, deadline=0.5), ValueError,
             "deadline"),
            ("vrl_sgd", dict(deadline=1.5), ValueError, "deadline")]:
        cj, ct = cfgs(alg, **over)
        with pytest.raises(exc, match=match):
            jeng.make_engine(cj, tj)
        with pytest.raises(exc, match=match):
            teng.make_engine(ct, tt)
    cj, ct = cfgs("vrl_sgd", "int8:noef", deadline=0.5)
    with pytest.raises(ValueError, match="error.feedback|residual"):
        jeng.make_engine(cj, tj)
    with pytest.raises(ValueError, match="error.feedback|residual"):
        teng.make_engine(ct, tt)
    for d in (0.5, 1.0):
        cj, ct = cfgs("vrl_sgd", "int8", deadline=d)
        jeng.make_engine(cj, tj)
        et = teng.make_engine(ct, tt)
        assert et.misses(8, W).shape == (W, 1)
        assert et.misses(8, W).all() == (d == 1.0)
