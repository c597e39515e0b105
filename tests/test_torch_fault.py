"""PyTorch port, elastic fault tolerance vs the JAX package
(``repro_torch.fault``, ``MemberState``, ``Engine.set_membership``, the
train loop's fault hooks).

* schedule — ``FaultSchedule`` parse / describe / events, ``random``,
  ``active_at``, ``grad_mul`` (consuming), ``killsave_at``, ``events_in``
  and the spec errors equal to the JAX package's over a grid of specs and
  seeds.
* engine — a drop / rejoin sequence from identical states (the JAX
  state carried over as numpy) within 1e-5 of the JAX engine for
  vrl_sgd, local_sgd, ssgd, stl_sgd, bvr_l_sgd, under int8, top-k and
  overlap, and for the hierarchy with a pod drop and a worker drop;
  ``set_membership`` and ``recenter_drift`` on random identical states;
  a full mask bitwise membership-off in the port; easgd's refusal; a dead
  worker's NaN rows never reaching a survivor, the average model or the
  diagnostics.
* train loop — a clean ``round_step_fault`` bitwise ``round_step``; a NaN
  multiplier trips ``health``, and after a drop the same round stays
  healthy; the per-leaf executor refuses membership and its
  ``round_step_fault`` runs.
* checkpoints — ``member`` leaves under the JAX package's keys, both
  ways; the resharding restore gives a fresh full mask.
* mesh — on a gloo group of 2 ranks the masked round is one counted
  model-state all-reduce (the repairs counted "membership"), within 1e-5
  of the JAX engine on a placeholder mesh of 2 devices.
"""
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

import torch_mesh_ranks as R  # noqa: E402
from repro import checkpoint as jck  # noqa: E402
from repro.checkpoint.checkpoint import _flatten  # noqa: E402
from repro.comm import compressors as jcc  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import HierConfig as JHC  # noqa: E402
from repro.configs.base import VRLConfig as JVRL  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.fault import FaultSchedule as JFS  # noqa: E402
from repro.train.train_loop import make_train_step as j_make  # noqa: E402
from repro_torch import checkpoint as tck  # noqa: E402
from repro_torch import tree as tm  # noqa: E402
from repro_torch.comm import compressors as tcc  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import HierConfig as THC  # noqa: E402
from repro_torch.configs.base import VRLConfig as TVRL  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.types import MemberState  # noqa: E402
from repro_torch.fault import FaultEvent, FaultSchedule  # noqa: E402
from repro_torch.models.param import from_numpy  # noqa: E402
from repro_torch.train.train_loop import make_train_step  # noqa: E402

from test_torch_compress import close_or_flipped  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- schedule
SPECS = ["nan@1:12, crash@1:30,rejoin@1:60,killsave:50",
         "scale@0:20:1e3,nan@1:12", "scale@2:5:0.125",
         "inf@3:0,nan@3:0,crash@0:2,rejoin@0:2,crash@2:7",
         "killsave:4,killsave:9,nan@0:9",
         "crash@1:3,rejoin@1:7,crash@2:5"]
BAD_SPECS = ["frob@1:3", "nan@1", "nan:3", "nan@1:x", "nan@z:3", "nan@-1:3",
             "nan@1:-3", "killsave@2:3", "  ,  ", "scale@1:12",
             "scale@1:12:zzz", "scale@1:12:inf", "scale@1:12:nan"]


def _drive(fs, steps=70, workers=4, k=3) -> list:
    """Everything a run asks of a schedule, in a run's order: per round
    the mask, the multiplier (consumed), the events, and per step the
    kill query."""
    out = [fs.describe(), len(fs), [tuple(e) for e in fs.events],
           [tuple(e) for e in fs.membership_events()]]
    for t0 in range(0, steps, k):
        g = fs.grad_mul(t0, k, workers)
        out.append((fs.active_at(t0, workers).tolist(),
                    None if g is None else np.nan_to_num(
                        g, nan=-1.0, posinf=-2.0).tolist(),
                    fs.events_in(t0, t0 + k),
                    [fs.killsave_at(t) for t in range(t0, t0 + k)]))
    # replays after a rollback: the masks again, the poisons consumed
    out.append([fs.active_at(t, workers).tolist() for t in range(steps)])
    out.append([fs.grad_mul(t0, k, workers) is None
                for t0 in range(0, steps, k)])
    return out


@pytest.mark.parametrize("spec", SPECS)
def test_schedule_matches_reference(spec):
    ft, fj = FaultSchedule.parse(spec), JFS.parse(spec)
    assert _drive(ft) == _drive(fj)
    assert FaultSchedule.parse(ft.describe()).events == ft.events


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
@pytest.mark.parametrize("shape", [(100, 8, 2, 2, True), (40, 4, 1, 1, False),
                                   (12, 2, 3, 1, True)])
def test_random_schedule_matches_reference(seed, shape):
    steps, workers, n_grad, n_churn, kill = shape
    kw = dict(seed=seed, n_grad=n_grad, n_churn=n_churn, killsave=kill)
    ft = FaultSchedule.random(steps, workers, **kw)
    fj = JFS.random(steps, workers, **kw)
    assert ft.describe() == fj.describe()
    assert _drive(ft, steps, workers) == _drive(fj, steps, workers)
    for t in range(steps):
        assert ft.active_at(t, workers).sum() >= 1


@pytest.mark.parametrize("bad", BAD_SPECS)
def test_spec_errors_match_reference(bad):
    with pytest.raises(ValueError) as et:
        FaultSchedule.parse(bad)
    with pytest.raises(ValueError) as ej:
        JFS.parse(bad)
    assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError, match=">= 2 workers"):
        FaultSchedule.random(100, 1, seed=0)
    assert FaultEvent("nan", 3, 1) == tuple(JFS.parse("nan@1:3").events[0])


# ------------------------------------------------------------ engine layer
W, K, LR = 5, 4, 0.05          # W deliberately not a power of 2
TEMPLATE = {"w": (12, 8), "b": (5,)}
P0 = {"w": np.full((12, 8), 0.3, np.float32),
      "b": np.full((5,), -0.2, np.float32)}
GRID = (2, 3)


def _tpl_j():
    return {k: jnp.zeros(s, jnp.float32) for k, s in TEMPLATE.items()}


def _tpl_t():
    return {k: torch.zeros(s) for k, s in TEMPLATE.items()}


def _cfgs(alg="vrl_sgd", compress=None, hier=False, **kw):
    kw = dict(dict(comm_period=K, learning_rate=LR, weight_decay=0.0,
                   warmup=False, membership=True), **kw)
    hj = JHC(k1=2, k2=4, grid=GRID) if hier else None
    ht = THC(k1=2, k2=4, grid=GRID) if hier else None
    cj = JVRL(algorithm=alg, update_backend="xla", hier=hj,
              compress=jcc.parse_compressor(compress) if compress else None,
              **kw)
    ct = TVRL(algorithm=alg, update_backend="xla", hier=ht,
              compress=tcc.parse_compressor(compress) if compress else None,
              **kw)
    return cj, ct


def _engines(alg="vrl_sgd", compress=None, hier=False, **kw):
    cj, ct = _cfgs(alg, compress, hier, **kw)
    ej, et = jeng.make_engine(cj, _tpl_j()), teng.make_engine(ct, _tpl_t())
    assert et.spec.meta() == ej.spec.meta()
    sj = ej.init(jax.tree.map(jnp.asarray, P0), W if not hier else 6)
    st = et.init(from_numpy(P0), W if not hier else 6)
    return ej, et, sj, st


def _grads(spec, lead, k, seed) -> np.ndarray:
    """(k, *lead, R, C) fp32 gradients, different per worker, zero pad."""
    rng = np.random.RandomState(seed)
    out = np.zeros((k, *lead, spec.rows, spec.lanes), np.float32)
    out.reshape(k, *lead, -1)[..., :spec.size] = rng.randn(
        k, *lead, spec.size)
    return out


def _jleaves(sj) -> dict:
    return {k: np.asarray(v) for k, v in _flatten(sj).items()}


def to_port(sj, st):
    """The port's state of the JAX state ``sj`` (by checkpoint key; the
    layout is the port state ``st``'s)."""
    flat = _jleaves(sj)

    def one(key, leaf):
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(flat[key].copy()).to(leaf.dtype)
        return int(flat[key])
    return tm.state_map(one, st)


SCALED = ("delta", "bias", "delta1", "delta2")


def compare(sj, st, mode=None, kg=K * LR, flip=None):
    """Every leaf of the port state within 1e-5 of the JAX state's, times
    max(1, max|leaf|) (a momentum buffer grows past 1) (Δ, B: 1e-5/(kγ));
    under compression at most ``max_flips`` elements one quantisation
    level ``flip`` apart.  The keys and the integers equal."""
    flat = _jleaves(sj)
    leaves = tm.state_leaves(st)
    assert sorted(k for k, _ in leaves) == sorted(flat), (
        sorted(k for k, _ in leaves), sorted(flat))
    for key, x in leaves:
        want = flat[key]
        if not isinstance(x, torch.Tensor):
            assert x == int(want), key
            continue
        scale = ((1.0 / kg if key.split("/")[0] in SCALED else 1.0)
                 * max(1.0, float(np.abs(want).max(initial=0.0))))
        got = x.detach().numpy()
        assert got.shape == want.shape, key
        if mode is None:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                                       err_msg=key)
        else:
            close_or_flipped(got, want, 1e-5 * scale, flip * scale, key,
                             mode)


FLAT_CASES = {
    "vrl_sgd": dict(alg="vrl_sgd"),
    "local_sgd": dict(alg="local_sgd"),
    "ssgd": dict(alg="ssgd"),
    "stl_sgd": dict(alg="stl_sgd"),
    "bvr_l_sgd": dict(alg="bvr_l_sgd", bvr_beta=0.5),
    "vrl_sgd+int8": dict(alg="vrl_sgd", compress="int8"),
    "vrl_sgd+topk": dict(alg="vrl_sgd", compress="topk:4"),
    "ssgd+int8": dict(alg="ssgd", compress="int8"),
    "vrl_sgd+overlap": dict(alg="vrl_sgd", overlap=True),
    "bvr_l_sgd+overlap": dict(alg="bvr_l_sgd", bvr_beta=0.5, overlap=True),
    "local_sgd+overlap": dict(alg="local_sgd", overlap=True),
    "vrl_sgd+momentum": dict(alg="vrl_sgd", inner_optimizer="momentum",
                             momentum=0.9),
    "bvr_l_sgd+adam": dict(alg="bvr_l_sgd", bvr_beta=0.5,
                           inner_optimizer="adam"),
}
# the sequence: rounds, with a new mask before some of them
SEQUENCE = [None, None, [1, 0, 1, 1, 1], None, [1, 0, 1, 0, 1], None,
            [1, 1, 1, 1, 1], None]
HIER_SEQUENCE = [None, None, [[1, 0, 1], [0, 0, 0]], None,
                 [[1, 1, 1], [0, 1, 0]], None, [[1, 1, 1], [1, 1, 1]],
                 None]


def _flip(sj, compress) -> float:
    """One quantisation level of the largest payload the JAX state could
    have sent (loose: max|params| + max|ref| + max|resid|, /127 for int8;
    top-k's threshold is at most that sum)."""
    if compress is None:
        return 0.0
    f = _jleaves(sj)
    big = sum(float(np.abs(v).max()) for k, v in f.items()
              if k in ("params", "comm/ref", "comm/resid", "comm/ref1",
                       "comm/resid1", "comm/ref2", "comm/resid2"))
    return 2 * big / (127.0 if compress.startswith("int8") else 1.0)


@pytest.mark.parametrize("case", list(FLAT_CASES) + ["hier",
                                                     "hier+int8+overlap"])
def test_drop_rejoin_sequence_matches_reference(case):
    """Rounds through ``round_step_flat`` with drops and rejoins between
    them, from the same start: every leaf within 1e-5 after every round
    and repair (compressed: each round from the JAX state, the packages'
    int8/top-k roundings may flip a few elements one level)."""
    hier = case.startswith("hier")
    kw = (dict(compress="int8", overlap=True) if case == "hier+int8+overlap"
          else {}) if hier else dict(FLAT_CASES[case])
    alg = "hier_vrl_sgd" if hier else kw.pop("alg")
    compress = kw.get("compress")
    ej, et, sj, st = _engines(alg, hier=hier, **kw)
    lead = GRID if hier else (W,)
    k = 2 if hier else K
    rnd = jax.jit(ej.round_step_flat)
    setm = jax.jit(ej.set_membership)
    for r, mask in enumerate(HIER_SEQUENCE if hier else SEQUENCE):
        if mask is not None:
            m = np.asarray(mask, np.float32)
            sj = setm(sj, jnp.asarray(m))
            st = et.set_membership(st, m)
            compare(sj, st, compress, k * LR, _flip(sj, compress))
            assert float(st.member.n_active) == float(sj.member.n_active)
        if compress is not None:
            st = to_port(sj, st)            # each round from the same state
        gk = _grads(et.spec, lead, k, seed=50 + r)
        sj = rnd(sj, jnp.asarray(gk))
        st = et.round_step_flat(st, torch.from_numpy(gk.copy()))
        compare(sj, st, compress, k * LR, _flip(sj, compress))
    # the invariant over the active set after the last sync (blocking
    # compression moves Σ Δ by its EF term by design)
    keep = st.member.active > 0
    if not hier and teng.get_spec(alg).use_delta and compress is None:
        s = torch.where(keep, st.delta, 0).sum(0).abs().max().item()
        assert s <= 1e-4 * st.delta.abs().max().item() + 1e-6
    for a, b in zip(jax.tree.leaves(ej.average_model(sj)),
                    tm.leaves(et.average_model(st))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5 + _flip(sj, compress))


def _random_state(ej, et, sj, st, seed):
    """Identical random states in both packages: every buffer of the JAX
    state replaced by numpy draws (counts and masks kept)."""
    rng = np.random.RandomState(seed)
    flat = _jleaves(sj)
    new = {}
    for key, v in flat.items():
        if key.startswith("member") or v.ndim < 2:
            new[key] = v
        elif key.endswith("pend_k"):
            new[key] = rng.randint(1, 4, v.shape).astype(np.float32)
        else:
            new[key] = rng.randn(*v.shape).astype(v.dtype) * 0.3
    sj = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(sj),
        [jnp.asarray(new[k]) for k in _flatten(sj)])
    return sj, to_port(sj, st)


@pytest.mark.parametrize("masks", [
    ([1, 0, 1, 1, 1], [1, 1, 1, 1, 1]),
    ([0, 0, 1, 1, 0], [1, 0, 1, 1, 1]),
    ([1, 1, 1, 1, 0], [0, 1, 1, 1, 1])])
@pytest.mark.parametrize("case", ["vrl_sgd", "bvr_l_sgd+adam",
                                  "vrl_sgd+int8", "vrl_sgd+overlap"])
def test_set_membership_and_recenter_on_identical_states(case, masks):
    kw = dict(FLAT_CASES[case])
    ej, et, sj, st = _engines(kw.pop("alg"), **kw)
    sj, st = _random_state(ej, et, sj, st, seed=3)
    for m in masks:
        m = np.asarray(m, np.float32)
        sj = jax.jit(ej.set_membership)(sj, jnp.asarray(m))
        st = et.set_membership(st, m)
        compare(sj, st, kg=1.0)
        keep = st.member.active.view(-1) > 0
        if teng.get_spec(et.algorithm).use_delta:
            assert st.delta[keep].sum(0).abs().max().item() < 1e-5
            assert st.delta[~keep].abs().sum().item() == 0.0
    # recentre over the rows in the buffers (masked by the last mask)
    sj, st = _random_state(ej, et, sj, st, seed=4)
    sj = jax.jit(ej.recenter_drift)(sj)
    st = et.recenter_drift(st)
    compare(sj, st, kg=1.0)


@pytest.mark.parametrize("masks", [
    ([[1, 0, 1], [0, 0, 0]], [[1, 1, 1], [1, 1, 1]]),
    ([[0, 1, 1], [1, 1, 0]], [[0, 1, 1], [0, 0, 0]])])
def test_hier_set_membership_on_identical_states(masks):
    ej, et, sj, st = _engines("hier_vrl_sgd", hier=True, compress="int8",
                              overlap=True)
    sj, st = _random_state(ej, et, sj, st, seed=5)
    for m in masks:
        m = np.asarray(m, np.float32)
        sj = jax.jit(ej.set_membership)(sj, jnp.asarray(m))
        st = et.set_membership(st, m)
        compare(sj, st, kg=1.0)
        np.testing.assert_array_equal(st.member.n_pod.view(-1).numpy(),
                                      np.asarray(sj.member.n_pod).ravel())
    dj, dt = ej.diagnostics(sj), et.diagnostics(st)
    assert set(dj) == set(dt)
    for key in dj:
        np.testing.assert_allclose(np.asarray(dt[key]), np.asarray(dj[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


FULL_MASK_CASES = [c for c in FLAT_CASES] + ["hier", "hier+int8+overlap"]


@pytest.mark.parametrize("case", FULL_MASK_CASES)
def test_full_mask_is_bitwise_membership_off(case):
    """With every worker active the membership engine's trajectory is the
    membership=False engine's BITWISE, at W = 5 (1/W inexact): the masked
    mean takes the plain mean's division on the device."""
    hier = case.startswith("hier")
    kw = (dict(compress="int8", overlap=True) if case == "hier+int8+overlap"
          else {}) if hier else dict(FLAT_CASES[case])
    alg = "hier_vrl_sgd" if hier else kw.pop("alg")
    out = []
    for member in (False, True):
        _, ct = _cfgs(alg, hier=hier, **dict(kw, membership=member))
        et = teng.make_engine(ct, _tpl_t())
        st = et.init(from_numpy(P0), 6 if hier else W)
        for r in range(4):
            gk = _grads(et.spec, GRID if hier else (W,), 2 if hier else K,
                        seed=70 + r)
            st = et.round_step_flat(st, torch.from_numpy(gk.copy()))
        out.append((st, et.average_model(st), et.diagnostics(st)))
    (a, am, ad), (b, bm, bd) = out
    for (ka, x), (kb, y) in zip(tm.state_leaves(a),
                                tm.state_leaves(b._replace(member=()))):
        assert ka == kb
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y), ka
    for x, y in zip(tm.leaves(am), tm.leaves(bm)):
        assert torch.equal(x, y)
    assert set(ad) == set(bd)


def test_easgd_refuses_membership():
    cj, ct = _cfgs("easgd")
    with pytest.raises(ValueError) as ej:
        jeng.make_engine(cj, _tpl_j())
    with pytest.raises(ValueError) as et:
        teng.make_engine(ct, _tpl_t())
    assert str(et.value) == str(ej.value) and "easgd" in str(et.value)


@pytest.mark.parametrize("hier", [False, True])
def test_dead_rows_never_reach_survivors(hier):
    """A dead worker's planted NaN rows: the survivors, the average model
    and the diagnostics stay finite (the masked means use where, never a
    multiply); the rejoin re-seeds the row from the consensus."""
    ej, et, sj, st = _engines("hier_vrl_sgd" if hier else "vrl_sgd",
                              hier=hier)
    lead = GRID if hier else (W,)
    k = 2 if hier else K
    for r in range(2):
        st = et.round_step_flat(st, torch.from_numpy(
            _grads(et.spec, lead, k, 90 + r)))
    mask = (np.array([[1, 0, 1], [1, 1, 1]], np.float32) if hier
            else np.array([1, 0, 1, 1, 1], np.float32))
    st = et.set_membership(st, mask)
    rows = st.params.view(-1, *st.params.shape[-2:])
    rows[1] = float("nan")
    for r in range(3):
        gk = _grads(et.spec, lead, k, 95 + r)
        gk.reshape(k, -1, *gk.shape[-2:])[:, 1] = np.nan
        st = et.round_step_flat(st, torch.from_numpy(gk.copy()))
    live = np.flatnonzero(mask.ravel())
    assert all(torch.isfinite(rows[i]).all() for i in live)
    assert all(torch.isfinite(v).all() for v in
               tm.leaves(et.average_model(st)))
    d = et.diagnostics(st)
    assert float(d["nonfinite_workers"]) == 0.0
    assert all(torch.isfinite(torch.as_tensor(v)).all() for v in d.values())
    xhat = torch.stack([rows[i] for i in live]).double().mean(0).float()
    st = et.set_membership(st, np.ones_like(mask))
    assert torch.isfinite(st.params).all()
    # the rejoiner restarts from the continuing workers' consensus
    torch.testing.assert_close(rows[1], xhat, rtol=0, atol=1e-6)


# ---------------------------------------------------- train-loop fault hooks
TINY = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=64, num_heads=4,
            num_kv_heads=2, head_dim=16)


def _bundle(backend="auto", membership=True, alg="vrl_sgd"):
    cfg = treg.smoke_arch("qwen2-0.5b", **TINY)
    vrl = TVRL(algorithm=alg, comm_period=3, learning_rate=0.2,
               weight_decay=0.0, warmup=False, update_backend=backend,
               membership=membership)
    return make_train_step(cfg, vrl, remat=False, device="cpu")


def _tokens(k=3, w=2, b=2, s=16, seed=3):
    toks = torch.from_numpy(np.random.RandomState(seed).randint(
        0, 64, (k, w, b, s))).long()
    return toks, torch.roll(toks, -1, -1)


@pytest.mark.parametrize("membership", [False, True])
def test_round_step_fault_clean_matches_round_step(membership):
    """An all-ones multiplier is a no-op: the fault round is the clean
    round bitwise."""
    bundle = _bundle(membership=membership)
    toks, labels = _tokens()
    s_a = bundle.init_state(0, 2)
    s_b = bundle.init_state(0, 2)
    s_a, l_a = bundle.round_step(s_a, toks, labels)
    s_b, l_b = bundle.round_step_fault(s_b, toks, labels,
                                       np.ones((3, 2), np.float32))
    assert torch.equal(l_a, l_b)
    assert torch.equal(s_a.params, s_b.params)
    assert torch.equal(s_a.delta, s_b.delta)


def test_nan_poison_trips_health_and_prior_drop_contains():
    """A NaN multiplier on an ACTIVE worker poisons the sync and health
    goes False; the same round after dropping that worker stays healthy
    (its loss left out of the mean, its rows out of every sync)."""
    bundle = _bundle()
    toks, labels = _tokens()
    gmul = np.ones((3, 2), np.float32)
    gmul[1, 1] = np.nan
    state = bundle.init_state(0, 2)
    sick, losses = bundle.round_step_fault(state, toks, labels, gmul)
    assert not bundle.health(sick, losses[-1])
    assert torch.isnan(sick.params).any()
    state = bundle.engine.set_membership(bundle.init_state(0, 2),
                                         np.array([1, 0], np.float32))
    state, losses = bundle.round_step_fault(state, toks, labels, gmul)
    assert bundle.health(state, losses[-1])
    assert torch.isfinite(losses).all()
    assert torch.isfinite(state.params[0]).all()
    # the per-leaf executor: its round_step_fault and health
    ref = _bundle(backend="reference", membership=False)
    sick, losses = ref.round_step_fault(ref.init_state(0, 2), toks, labels,
                                        gmul)
    assert not ref.health(sick, losses[-1])
    clean, losses = ref.round_step_fault(ref.init_state(0, 2), toks, labels,
                                         np.ones((3, 2), np.float32))
    assert ref.health(clean, losses[-1])


def test_round_step_fault_matches_reference_grad_mul():
    """The multiplier lands where the reference's does: one round from the
    same state (the JAX state carried over), a scale poison on worker 1
    at the second step, and a NaN in the membership-dropped worker 0."""
    cfg_j = jreg.smoke_arch("mamba2-370m", num_layers=1)
    cfg_t = treg.smoke_arch("mamba2-370m", num_layers=1)
    kw = dict(algorithm="vrl_sgd", comm_period=2, learning_rate=0.02,
              weight_decay=0.0, warmup=False, membership=True)
    bj = j_make(cfg_j, JVRL(update_backend="xla", **kw), remat=False)
    bt = make_train_step(cfg_t, TVRL(update_backend="xla", **kw),
                         remat=False, device="cpu")
    sj = bj.init_state(jax.random.PRNGKey(1), 2)
    sj = jax.jit(bj.engine.set_membership)(sj, jnp.array([0.0, 1.0]))
    st = to_port(sj, bt.init_state(0, 2))
    toks = np.random.RandomState(4).randint(0, cfg_t.vocab_size,
                                            (2, 2, 2, 40))
    labels = np.roll(toks, -1, -1)
    gmul = np.ones((2, 2), np.float32)
    gmul[1, 1] = 3.0
    gmul[0, 0] = np.nan
    sj, lj = jax.jit(bj.round_step_fault)(sj, jnp.asarray(toks),
                                          jnp.asarray(labels),
                                          jnp.asarray(gmul))
    st, lt = bt.round_step_fault(st, torch.from_numpy(toks),
                                 torch.from_numpy(labels), gmul)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5)
    np.testing.assert_allclose(st.params[1].numpy(),
                               np.asarray(sj.params)[1], rtol=0, atol=1e-5)
    assert bool(bj.health(sj, lj[-1])) == bt.health(st, lt[-1]) is True


def test_reference_backend_refuses_membership():
    with pytest.raises(ValueError) as et:
        _bundle(backend="reference")
    with pytest.raises(ValueError) as ej:
        j_make(jreg.smoke_arch("qwen2-0.5b", **TINY),
               JVRL(update_backend="reference", membership=True),
               remat=False)
    assert str(et.value) == str(ej.value)


# ------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("hier", [False, True])
def test_member_checkpoints_interchangeable(tmp_path, hier):
    """A membership state (after a drop) saved by either package restores
    in the other: the ``member/active``, ``member/n_active`` (and
    ``member/n_pod``) keys, bitwise."""
    ej, et, sj, st = _engines("hier_vrl_sgd" if hier else "vrl_sgd",
                              hier=hier, compress="int8")
    sj, st = _random_state(ej, et, sj, st, seed=8)
    m = (np.array([[1, 0, 1], [0, 0, 0]], np.float32) if hier
         else np.array([1, 0, 1, 1, 0], np.float32))
    sj = jax.jit(ej.set_membership)(sj, jnp.asarray(m))
    st = et.set_membership(st, m)
    st = to_port(sj, st)
    grid = GRID if hier else None
    pj = tcc.pair_meta(et.compressors)
    jck.save_flat_state(str(tmp_path / "j"), sj, ej.spec, grid=grid,
                        compressors=jcc.pair_meta(ej.compressors))
    tck.save_flat_state(str(tmp_path / "t"), st, et.spec, grid=grid,
                        compressors=pj)
    fresh = et.init(from_numpy(P0), 6 if hier else W)
    back = tck.restore_flat_state(str(tmp_path / "j"), fresh, et.spec,
                                  grid=grid, compressors=pj)
    for (k, x), (_, y) in zip(tm.state_leaves(back), tm.state_leaves(st)):
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y), k
    assert isinstance(back.member, MemberState)
    jback = jck.restore_flat_state(
        str(tmp_path / "t"), sj, ej.spec, grid=grid,
        compressors=jcc.pair_meta(ej.compressors))
    for k, v in _jleaves(sj).items():
        np.testing.assert_array_equal(np.asarray(_flatten(jback)[k]), v,
                                      err_msg=k)
    keys = tck.load_meta(str(tmp_path / "t"))["keys"]
    assert {"member/active", "member/n_active"} <= set(keys)
    assert ("member/n_pod" in keys) == hier


def test_reshard_gives_a_fresh_full_mask(tmp_path):
    ej, et, sj, st = _engines()
    st = et.set_membership(st, np.array([1, 0, 1, 1, 1], np.float32))
    tck.save_flat_state(str(tmp_path / "c"), st, et.spec)
    _, ct = _cfgs()
    e3 = teng.make_engine(ct, _tpl_t())
    fresh = e3.init(from_numpy(P0), 3)
    back = tck.restore_resharded(str(tmp_path / "c"), fresh, e3.spec)
    assert torch.equal(back.member.active, torch.ones(3, 1, 1))
    assert float(back.member.n_active) == 3.0
    assert back.delta.sum(0).abs().max().item() < 1e-6


# ------------------------------------------------------- gloo mesh, world 2
JAX_MESH = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    sys.path.insert(0, %r)
    import torch_mesh_ranks as R
    from repro.configs.base import HierConfig, VRLConfig
    from repro.core import engine as jeng

    out = {}
    for name, hier in (("flat", None), ("hier", R.HIER)):
        cfg = VRLConfig(algorithm="hier_vrl_sgd" if hier else "vrl_sgd",
                        comm_period=R.K, learning_rate=R.LR, warmup=False,
                        update_backend="xla", membership=True,
                        hier=HierConfig(**hier) if hier else None)
        shape = (1, 2)
        mesh = Mesh(np.array(jax.devices()[:2]).reshape(shape),
                    ("pod", "data"))
        tj = jax.tree.map(lambda s: jnp.zeros(s, jnp.float32), R.TEMPLATE,
                          is_leaf=lambda x: isinstance(x, tuple))
        eng = jeng.make_engine(cfg, tj, mesh=mesh,
                               worker_axes=("pod", "data"))
        sj = eng.init(jax.tree.map(jnp.asarray, R.params0_numpy()), R.W)
        spec = eng.spec
        rnd = jax.jit(eng.round_step_flat)
        for r, (k, mask) in enumerate(R.ELASTIC_ROUNDS):
            if mask is not None:
                sj = jax.jit(eng.set_membership)(
                    sj, jnp.asarray(mask, jnp.float32))
            gk = R.round_grads(spec.rows, spec.lanes, spec.size, 9, r, k)
            if hier:
                gk = gk.reshape(k, *hier["grid"], *gk.shape[-2:])
            sj = rnd(sj, jnp.asarray(gk))
        for f in ("params", "delta", "delta1", "delta2"):
            if hasattr(sj, f):
                out[name + "|" + f] = np.asarray(getattr(sj, f))
        out[name + "|n_active"] = np.asarray(sj.member.n_active)
    np.savez(sys.argv[1], **out)
""")


def test_masked_round_is_one_state_all_reduce_on_gloo(tmp_path):
    """W = 4 over a gloo group of 2 ranks, with membership: drops and
    rejoins between rounds; every round makes ONE model-state all-reduce
    (the hierarchy: one per level due), the repairs' sums are counted
    "membership"; the final buffers within 1e-5 of the JAX engine on a
    placeholder mesh of 2 devices."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), TESTS]), JAX_PLATFORMS="cpu",
        OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", JAX_MESH % TESTS,
                             str(tmp_path / "jax.npz")], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    tmp.start_processes(R.elastic, args=(2, str(tmp_path / "store"),
                                         str(tmp_path / "port")),
                        nprocs=2, start_method="spawn")
    ranks = [torch.load(f"{tmp_path / 'port'}.rank{r}", weights_only=False)
             for r in range(2)]
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    ref = dict(np.load(tmp_path / "jax.npz"))
    for name in ("flat", "hier"):
        for rank, res in enumerate(ranks):
            for rd, rec in enumerate(res[name]["rounds"]):
                rnd = rec["round"]
                assert set(rnd) == {"state"}, (name, rank, rd, rnd)
                calls = {g: c["calls"] for g, c in rnd["state"].items()}
                if name == "flat":
                    assert calls == {"pod+data": 1}, (rank, rd, calls)
                else:
                    # sync1 every round, sync2 every k2 = 2 rounds
                    assert calls == ({"data": 1, "pod": 1} if rd % 2
                                     else {"data": 1}), (rank, rd, calls)
                masked = R.ELASTIC_ROUNDS[rd][1] is not None
                assert rec["repair"] == (["membership"] if masked else [])
            assert res[name]["n_active"] == float(ref[name + "|n_active"])
        for f in ranks[0][name]["buffers"]:
            if f.startswith("member") or f not in ("params", "delta",
                                                   "delta1", "delta2"):
                continue
            parts = [ranks[r][name]["buffers"][f] for r in range(2)]
            full = (parts[0] if (name, f) == ("hier", "delta2") else
                    np.concatenate(parts, axis=1 if name == "hier" else 0))
            np.testing.assert_allclose(
                full, ref[name + "|" + f], rtol=0,
                atol=1e-5 / (R.K * R.LR if f.startswith("delta") else 1.0),
                err_msg=f"{name} {f}")
