"""PyTorch port, the hierarchy's compressed syncs vs the JAX package.

* Plain grid versions (``kernels/torch_update.fused_ef_{int8,topk}_grid``):
  BITWISE ``xla_update``'s twins over (P, D) ∈ {(2, 3), (3, 2), (1, 4),
  (4, 1)}, int8 and top-k k ∈ {1, 4, 8, 64, 256}, with and without the
  (P, 1, R, C) per-pod ref and the residual, on rows with ± ties, all-zero
  rows and rows with fewer than k non-zeros.  Against the Pallas kernels
  in interpret mode: top-k bitwise, int8 within one quantisation step per
  element (as ``tests/test_torch_compress.py`` explains).
* The wrappers on the CPU write the residual and ``out=`` in place, take a
  strided pod-row view ``params[:, 0]`` in the flat form (level 2), count
  no launch, and reject a ref that is not (P, 1, R, C) and ``out``
  aliasing the residual.
* Engine: hier_vrl_sgd on a (2, 3) grid at (k1, k2) = (2, 4), four rounds
  of ``round_step_flat`` on numpy gradients, against the reference's
  ``update_backend="xla"`` hier engine driven by its own ``local_step``,
  ``sync1``/``sync2`` (blocking) or ``round_begin``/``round_fold``
  (overlap), for compress ∈ {int8, topk:4, int8:noef} × {blocking,
  overlap}, the pair int8 / topk:4, and compress2 alone: params and pend
  atol 1e-5, Δ1 and Δ2 1e-5/(k1·γ), the residuals and references 1e-5,
  pend_k bitwise; an int8 level may flip between the packages' fp32
  roundings (the port's pod mean is ``torch.mean``, the reference's sum ÷
  D), so at most ``max_flips`` elements per buffer may stand off, each
  within twice the summed row steps of the run's communications
  (``close_or_flipped``, ``tests/test_torch_compress.py``'s rules);
  top-k flips nothing.  The state holds resid1 (P, D, R, C), ref1 (P, 1,
  R, C), resid2 (P, 1, R, C), ref2 (R, C).  Planted faults — ref1 not re-anchored after sync2, the fold's
  c_p shift of ref1 dropped — fail the comparison.
* ``Engine.compressors`` and ``pair_meta`` agree with the reference's.
* CLI: ``launch.train --smoke --device cpu`` with hier_vrl_sgd ``--compress
  int8`` (blocking: Σ_d Δ1 and Σ_p Δ2 move by their levels' EF terms, to
  fp32 rounding) and ``--compress int8 --compress2 topk:32 --overlap
  --deadline 0.25`` (the per-pod misses the reference draws).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.comm import compressors as jcc  # noqa: E402
from repro.configs.base import HierConfig as JHier  # noqa: E402
from repro.configs.base import VRLConfig as JVRL  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import flat as jflat  # noqa: E402
from repro.kernels import vrl_update as jvu  # noqa: E402
from repro.kernels import xla_update as jxu  # noqa: E402
from repro_torch.comm import compressors as tcc  # noqa: E402
from repro_torch.configs.base import HierConfig as THier  # noqa: E402
from repro_torch.configs.base import VRLConfig as TVRL  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.types import HierCommState  # noqa: E402
from repro_torch.kernels import torch_update as tu  # noqa: E402
from repro_torch.kernels import vrl_update as tvu  # noqa: E402
from repro_torch.launch import train as t_launch  # noqa: E402
from repro_torch.models.param import from_numpy  # noqa: E402

from test_torch_compress import (close_or_flipped, params0,  # noqa: E402
                                 special_rows, step_bound, templates)

R, C, BLOCK = 16, 256, 8
GRIDS = [(2, 3), (3, 2), (1, 4), (4, 1)]
MODES = ["int8", "topk:1", "topk:4", "topk:8", "topk:64", "topk:256"]
VARIANTS = [(False, False), (False, True), (True, False), (True, True)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid_inputs(seed, grid):
    """p (P, D, R, C) with the special rows in every worker, ref (P, 1, R,
    C), e (P, D, R, C), fp32 from numpy."""
    pp, dd = grid
    rng = np.random.RandomState(seed)
    p = special_rows(rng.randn(pp * dd, R, C).astype(np.float32))
    ref = 0.1 * rng.randn(pp, 1, R, C).astype(np.float32)
    e = 0.01 * rng.randn(pp, dd, R, C).astype(np.float32)
    return p.reshape(pp, dd, R, C), ref, e


def _call(mod, mode, p, ref, e, **kw):
    if mode == "int8":
        return mod.fused_ef_int8_grid(p, ref, e, **kw)
    return mod.fused_ef_topk_grid(p, ref, e, k=int(mode.split(":")[1]),
                                  **kw)


def _opt(x, on, conv):
    return conv(x) if on else None


# -------------------------------------------------- plain grid versions
@pytest.mark.parametrize("use_ref,use_e", VARIANTS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("grid", GRIDS)
def test_plain_grid_ef_bitwise_xla(grid, mode, use_ref, use_e):
    p, ref, e = _grid_inputs(10 * GRIDS.index(grid) + MODES.index(mode),
                             grid)
    t = torch.from_numpy
    dec, res = _call(tu, mode, t(p), _opt(ref, use_ref, t),
                     _opt(e, use_e, t))
    jdec, jres = _call(jxu, mode, jnp.asarray(p),
                       _opt(ref, use_ref, jnp.asarray),
                       _opt(e, use_e, jnp.asarray))
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))
    assert (res is None) == (jres is None) == (not use_e)
    if use_e:
        np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
        x = tu._ef_payload(t(p), _opt(ref, use_ref, t), t(e))
        assert torch.equal(res + dec, x)
    assert dec.shape == p.shape


@pytest.mark.parametrize("use_ref,use_e", [(True, True), (False, False),
                                           (True, False)])
@pytest.mark.parametrize("mode", ["int8", "topk:4", "topk:64"])
@pytest.mark.parametrize("grid", [(2, 3), (3, 2)])
def test_plain_grid_ef_vs_pallas_interpret(grid, mode, use_ref, use_e):
    """Top-k bitwise; int8 within one quantisation step per element."""
    p, ref, e = _grid_inputs(7, grid)
    t = torch.from_numpy
    dec, res = _call(tu, mode, t(p), _opt(ref, use_ref, t),
                     _opt(e, use_e, t))
    jdec, jres = _call(jvu, mode, jnp.asarray(p),
                       _opt(ref, use_ref, jnp.asarray),
                       _opt(e, use_e, jnp.asarray), block=BLOCK,
                       interpret=True)
    if mode != "int8":
        np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))
        if use_e:
            np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
        return
    x = tu._ef_payload(t(p), _opt(ref, use_ref, t),
                       _opt(e, use_e, t)).numpy()
    step = np.abs(x).max(axis=-1, keepdims=True) / np.float32(127.0)
    tol = step + np.spacing(np.abs(dec.numpy()))
    assert np.all(np.abs(dec.numpy() - np.asarray(jdec)) <= tol)
    if use_e:
        assert np.all(np.abs(res.numpy() - np.asarray(jres)) <= tol)


def test_grid_ef_wrappers_on_cpu():
    """In place resid and ``out=``, no launch counted for CPU tensors, the
    flat form on a strided pod-row view, and the refusals."""
    p, ref, e = (torch.from_numpy(a) for a in _grid_inputs(3, (2, 3)))
    tvu.reset_launches()
    want = tu.fused_ef_int8_grid(p, ref, e)
    e1, out = e.clone(), torch.empty_like(p)
    dec, res = tvu.fused_ef_int8_grid(p, ref, e1, out=out)
    assert dec is out and res is e1
    assert torch.equal(dec, want[0]) and torch.equal(res, want[1])
    dec2, none = tvu.fused_ef_topk_grid(p, None, None, k=8)
    assert none is None
    assert torch.equal(dec2, tu.fused_ef_topk_grid(p, None, None, k=8)[0])
    # level 2: the pod rows params[:, 0] as a strided (P, R, C) view, its
    # residual the contiguous resid2[:, 0] of a (P, 1, R, C) buffer
    pod = p[:, 0]
    assert not pod.is_contiguous()
    e2 = e[:, :1].clone()
    want2 = tu.fused_ef_topk(pod.contiguous(), ref[0, 0], e2[:, 0].clone(),
                             k=4)
    dec3, res3 = tvu.fused_ef_topk(pod, ref[0, 0], e2[:, 0], k=4)
    assert torch.equal(dec3, want2[0]) and torch.equal(e2[:, 0], want2[1])
    assert res3.data_ptr() == e2.data_ptr()
    assert not any(tvu.LAUNCHES.values()), tvu.LAUNCHES
    with pytest.raises(ValueError, match="per pod"):
        tvu.fused_ef_int8_grid(p, ref[:, :, :-1].contiguous(), e)
    with pytest.raises(ValueError, match="per pod"):
        tvu.fused_ef_int8_grid(p, ref.expand(2, 3, R, C).contiguous(), e)
    with pytest.raises(ValueError, match="one buffer"):
        tvu.fused_ef_int8_grid(p, ref, e, out=e)
    with pytest.raises(ValueError, match="k must be"):
        tvu.fused_ef_topk_grid(p, ref, e, k=0)
    with pytest.raises(ValueError, match=r"\(P, D, R, C\)"):
        tvu.fused_ef_int8_grid(p[0], ref, e)
    with pytest.raises(ValueError, match="not contiguous"):
        tvu.fused_ef_int8_grid(p.transpose(0, 1), ref, None)
    with pytest.raises(ValueError, match="worker slices"):
        tvu.fused_ef_int8(p[:, 0, :, ::2], None, None)


# ---------------------------------------------------------------- engine
GRID, K1, K2, LR, WD = (2, 3), 2, 4, 0.05, 1e-3


def _spec(mod, text):
    return None if text is None else mod.parse_compressor(text)


def hier_cfgs(compress=None, compress2=None, **over):
    kw = dict(algorithm="hier_vrl_sgd", learning_rate=LR, weight_decay=WD,
              warmup=False)
    kw.update(over)
    cj = JVRL(update_backend="xla", hier=JHier(k1=K1, k2=K2, grid=GRID),
              compress=_spec(jcc, compress),
              compress2=_spec(jcc, compress2), **kw)
    ct = TVRL(hier=THier(k1=K1, k2=K2, grid=GRID),
              compress=_spec(tcc, compress),
              compress2=_spec(tcc, compress2), **kw)
    return cj, ct


def grid_buf(spec, seed):
    """(P, D, R, C) fp32 gradients with zero pad lanes, from numpy."""
    rng = np.random.RandomState(seed)
    out = np.zeros(GRID + (spec.rows, spec.lanes), np.float32)
    n = GRID[0] * GRID[1]
    out.reshape(n, -1)[:, :spec.size] = rng.randn(n, spec.size)
    return out


def _np(x):
    return np.asarray(x, np.float32)


def run_hier(compress=None, compress2=None, rounds=4, seed=900, **over):
    """Both engines over ``rounds`` rounds of k1 on the same numpy
    gradients: the port by ``round_step_flat``, the reference by its own
    ``local_step`` and ``sync1``/``sync2`` (blocking) or ``round_begin``/
    ``round_fold`` (overlap), so that every payload is read off the
    reference's state.  Returns the engines, the final states and the
    summed row step bound of the run's communications, (R, 1)."""
    tj, tt = templates()
    cj, ct = hier_cfgs(compress, compress2, **over)
    ej, et = jeng.make_engine(cj, tj), teng.make_engine(ct, tt)
    assert et.spec.meta() == ej.spec.meta()
    p0 = params0()
    w = GRID[0] * GRID[1]
    sj = ej.init(p0, w)
    st = et.init(from_numpy(jax.tree.map(np.asarray, p0)), w)
    c1, c2 = et.compressors
    assert tuple(et.compressors) == tuple(
        None if c is None else tcc.parse_compressor(c.label())
        for c in ej.compressors)
    local_j, sync1_j, sync2_j = (jax.jit(f) for f in (ej.local_step,
                                                      ej.sync1, ej.sync2))
    overlap = ct.overlap
    if overlap:
        begin_j = jax.jit(ej.round_begin, static_argnums=1)
        fold_j = jax.jit(ej.round_fold)
    bound = np.zeros((et.spec.rows, 1))
    for r in range(rounds):
        gk = np.stack([grid_buf(ej.spec, seed + 10 * r + i)
                       for i in range(K1)])
        due = int(sj.step) + K1 - int(sj.last_sync2) >= K2
        glob = begin_j(sj, K1) if overlap else None
        for g in gk:
            sj = local_j(sj, jflat.unflatten_grid(ej.spec, jnp.asarray(g)))
        cm = sj.comm
        if c1 is not None:
            x = _np(sj.params) - _np(cm.ref1)
            if c1.error_feedback:
                x = x + _np(cm.resid1)
            bound += step_bound(c1.label(), x)
        e2 = (_np(cm.resid2)[:, 0] if c2 is not None and c2.error_feedback
              else 0.0)
        if overlap:
            sj = fold_j(sj, glob)
            if due and c2 is not None:
                # the capture's payload: the folded pod rows against x̂
                bound += step_bound(c2.label(), _np(sj.params)[:, 0]
                                    - _np(glob)[None] + e2)
        else:
            sj = sync1_j(sj)
            if due:
                if c2 is not None:
                    bound += step_bound(c2.label(), _np(sj.params)[:, 0]
                                        - _np(sj.comm.ref2)[None] + e2)
                sj = sync2_j(sj)
        st = et.round_step_flat(st, torch.from_numpy(gk))
        assert (st.step, st.last_sync1, st.last_sync2) == (
            int(sj.step), int(sj.last_sync1), int(sj.last_sync2))
    return ej, et, sj, st, bound


def _flip_mode(et):
    """The flip rule of the run: int8's when either level quantises."""
    labels = [c.label() for c in et.compressors if c is not None]
    return next((lb for lb in labels if lb.startswith("int8")),
                labels[0] if labels else None)


def compare_hier(sj, st, et, bound):
    """Every buffer of the port's state against the reference's under
    ``close_or_flipped``'s flip rules; returns the flipped counts."""
    mode, kg = _flip_mode(et), K1 * LR
    pairs = [("params", st.params, sj.params, 1.0),
             ("delta1", st.delta1, sj.delta1, 1 / kg),
             ("delta2", st.delta2, sj.delta2, 1 / kg)]
    if st.overlap != ():
        pairs.append(("pend", st.overlap.pend, sj.overlap.pend, 1.0))
        np.testing.assert_array_equal(st.overlap.pend_k.numpy(),
                                      np.asarray(sj.overlap.pend_k))
    if st.comm == ():
        assert sj.comm == () and et.compressors == (None, None)
    for name in HierCommState._fields if st.comm != () else ():
        a, b = getattr(st.comm, name), getattr(sj.comm, name)
        assert isinstance(a, torch.Tensor) == hasattr(b, "shape"), name
        if isinstance(a, torch.Tensor):
            pairs.append((name, a, b, 1.0))
    flips = {}
    for name, a, b, scale in pairs:
        flips[name] = close_or_flipped(a.numpy(), b, 1e-5 * scale,
                                       2 * bound * scale, name, mode)
    return flips


ENGINE_CASES = ([(c, None, ov) for c in ("int8", "topk:4", "int8:noef")
                 for ov in (False, True)]
                + [("int8", "topk:4", ov) for ov in (False, True)]
                + [(None, "topk:4", False), (None, "int8", True)])


@pytest.mark.parametrize("compress,compress2,overlap", ENGINE_CASES)
def test_hier_compressed_engine_matches_reference(compress, compress2,
                                                  overlap):
    ej, et, sj, st, bound = run_hier(compress, compress2, overlap=overlap)
    assert bound.max() > 0
    flips = compare_hier(sj, st, et, bound)
    print(f"{compress}/{compress2}, overlap={overlap}: flipped {flips} "
          f"(largest row step bound {bound.max():.3e})")
    rows, lanes = et.spec.rows, et.spec.lanes
    cm = st.comm
    c1, c2 = et.compressors
    want = {"resid1": (2, 3, rows, lanes) if c1 and c1.error_feedback
            else None, "ref1": (2, 1, rows, lanes) if c1 else None,
            "resid2": (2, 1, rows, lanes) if c2 and c2.error_feedback
            else None, "ref2": (rows, lanes) if c2 else None}
    for name, shape in want.items():
        buf = getattr(cm, name)
        assert (buf == () if shape is None else buf.shape == shape), name
    for a, b in zip(jax.tree.leaves(ej.average_model(sj)),
                    teng.tree_mod.leaves(et.average_model(st))):
        close_or_flipped(b.numpy(), a, 1e-5, 2 * bound.max(),
                         "average_model", _flip_mode(et))


def test_compressors_and_pair_meta_match_reference():
    """The hierarchy's resolved pair, and a flat algorithm's (which
    accepts compress2 and ignores it, as the reference does)."""
    tj, tt = templates()
    for alg, c1, c2 in (("hier_vrl_sgd", "int8", "topk:4"),
                        ("hier_vrl_sgd", None, "int8:noef"),
                        ("hier_vrl_sgd", "topk:8", None),
                        ("vrl_sgd", "int8", "topk:4"),
                        ("local_sgd", None, "int8")):
        cj, ct = hier_cfgs(c1, c2, algorithm=alg)
        ej, et = jeng.make_engine(cj, tj), teng.make_engine(ct, tt)
        assert tcc.pair_meta(et.compressors) == jcc.pair_meta(
            ej.compressors) == tcc.pair_meta(ct)
        assert tcc.describe_pair(et.compressors) == jcc.describe_pair(
            ej.compressors)


# ------------------------------------------------------- planted faults
def _no_reanchor(ref1, glob):
    del ref1, glob


def _no_shift(ref1, glob, pend):
    del ref1, glob, pend


@pytest.mark.parametrize("fault,overlap", [("ref1 not re-anchored", False),
                                           ("c_p shift dropped", True)])
def test_parity_check_catches_planted_faults(monkeypatch, fault, overlap):
    """The port with ref1 left at the pod mean after sync2, or with the
    fold's shift of ref1 by c_p dropped, fails the comparison the port
    passes (int8 at level 1, so ref1 exists)."""
    if fault == "ref1 not re-anchored":
        monkeypatch.setattr(teng, "_reanchor_ref1", _no_reanchor)
    else:
        monkeypatch.setattr(teng, "_shift_ref1", _no_shift)
    _, et, sj, st, bound = run_hier("int8", "topk:4", overlap=overlap)
    with pytest.raises(AssertionError):
        compare_hier(sj, st, et, bound)


# ------------------------------------------------------------------- CLI
SMOKE = ["--smoke", "--device", "cpu", "--algorithm", "hier_vrl_sgd",
         "--workers", "4", "--pods", "2", "--k1", "2", "--k2", "4",
         "--batch", "2", "--seq", "16", "--lr", "0.05", "--log-every", "1"]


def test_launch_train_hier_compressed_blocking_on_cpu(capsys):
    """Path (m) at smoke size: int8 at both levels, blocking.  Every round
    logs each level's EF term beside its Σ Δ move: Σ_d Δ1 moves by Σ_d
    (e1 − e1')/(k1 γ) per pod, Σ_p Δ2 (at sync2) by Σ_p (e2 − e2')/(k2 γ),
    within the logged limit."""
    res = t_launch.run(SMOKE + ["--steps", "8", "--compress", "int8"])
    out = capsys.readouterr().out
    assert "compress: int8 — sync wire 0.52 MiB (4.8x) vs raw" in out
    assert len(res.losses) == 8 and np.all(np.isfinite(res.losses))
    st = res.state
    assert isinstance(st.comm, HierCommState)
    assert (st.step, st.last_sync1, st.last_sync2) == (8, 8, 8)
    levels = [r["level"] for r in res.level_terms]
    assert levels == ["delta1", "delta1", "delta2", "delta1", "delta1",
                      "delta2"]
    for r in res.level_terms:
        assert r["off"] <= r["limit"], r
    assert max(r["term"] / r["limit"] for r in res.level_terms) > 10
    assert out.splitlines()[-1].startswith("kernels: ")


def test_launch_train_hier_pair_overlap_deadline_on_cpu(capsys):
    """Path (n) at smoke size: int8 at level 1, topk:32 at level 2,
    overlapped, deadline 0.25: the folds at steps 4, 8 and 12 draw the
    reference's per-pod misses [1, 0], [0, 1], [0, 0], and pend_k stretches
    where a pod missed."""
    res = t_launch.run(SMOKE + ["--steps", "12", "--compress", "int8",
                                "--compress2", "topk:32", "--overlap",
                                "--deadline", "0.25"])
    out = capsys.readouterr().out
    assert "deadline: miss prob 0.25" in out
    assert "compress: int8 / sync2=topk:32 — sync wire" in out
    assert len(res.losses) == 12 and np.all(np.isfinite(res.losses))
    assert [(t, m) for t, m, _ in res.misses] == [
        (4, [1.0, 0.0]), (8, [0.0, 1.0]), (12, [0.0, 0.0])]
    assert [k for _, _, k in res.misses] == [[5.0, 4.0], [4.0, 8.0],
                                             [4.0, 4.0]]
    for r in res.level_terms:
        assert r["off"] <= r["limit"], r
    assert {r["level"] for r in res.level_terms} == {"delta1", "delta2"}
    st = res.state
    assert (st.step, st.last_sync1, st.last_sync2) == (12, 12, 12)
    with pytest.raises(SystemExit, match="deadline"):
        t_launch.run(SMOKE + ["--steps", "4", "--overlap", "--deadline",
                              "1.5"])
