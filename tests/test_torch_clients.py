"""PyTorch port, client sampling vs the JAX package (``repro_torch.core.
clients``: ``sample_cohort``, ``cohort_schedule``, ``ClientStore``).

* sampler — the cohorts equal the JAX package's over seeds × rounds ×
  populations; sorted, distinct, the identity at full participation; the
  size check's message.
* store — the M = W gather / round / scatter loop BITWISE the storeless
  trajectory for every flat algorithm (with and without membership);
  strict-subset cohorts (consensus seeding, ``recenter_drift``) within
  1e-5 of the JAX store over the same rounds from the same start; the
  seeding, the dead-slot skip, the tree round trip and its refusals.
* checkpoints — a client store saved by either package restores in the
  other (keys "clients/...", "server_params").
* driver — the flag refusals equal to the reference's; an M = 8, W = 4
  run with crash / rejoin / killsave faults checkpoints the store and a
  resume from its step-4 store is bitwise the uninterrupted run; the
  same run over 2 gloo ranks (``--mesh-grid``) is one process's.
"""
import os
import socket

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

import torch_mesh_ranks as R  # noqa: E402
from repro import checkpoint as jck  # noqa: E402
from repro.checkpoint.checkpoint import _flatten  # noqa: E402
from repro.configs.base import VRLConfig as JVRL  # noqa: E402
from repro.core import clients as jclients  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.launch import train as j_launch  # noqa: E402
from repro_torch import checkpoint as tck  # noqa: E402
from repro_torch import tree as tm  # noqa: E402
from repro_torch.configs.base import VRLConfig as TVRL  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import flat_algorithms  # noqa: E402
from repro_torch.core.clients import (ClientStore, cohort_schedule,  # noqa
                                      sample_cohort)
from repro_torch.launch import train as t_launch  # noqa: E402
from repro_torch.models.param import from_numpy  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------- sampler
@pytest.mark.parametrize("seed", [0, 3, 7])
@pytest.mark.parametrize("pop", [(32, 8), (24, 6), (6, 6), (9, 1)])
def test_cohorts_match_reference(seed, pop):
    m, w = pop
    for r in range(12):
        a = sample_cohort(m, w, r, seed)
        np.testing.assert_array_equal(a, jclients.sample_cohort(m, w, r,
                                                                seed))
        assert a.dtype == np.int64 and (np.diff(a) > 0).all()
    got = cohort_schedule(m, w, rounds=9, seed=seed, start_round=4)
    want = jclients.cohort_schedule(m, w, rounds=9, seed=seed, start_round=4)
    assert all(np.array_equal(x, y) for x, y in zip(got, want))
    if m == w:
        np.testing.assert_array_equal(sample_cohort(m, w, 11),
                                      np.arange(m))


def test_every_client_participates_and_size_checked():
    seen = set()
    for cohort in cohort_schedule(24, 6, rounds=40, seed=0):
        seen.update(cohort.tolist())
    assert seen == set(range(24))
    for bad in ((4, 5), (4, 0)):
        with pytest.raises(ValueError) as et:
            sample_cohort(*bad, 0)
        with pytest.raises(ValueError) as ej:
            jclients.sample_cohort(*bad, 0)
        assert str(et.value) == str(ej.value)


# ------------------------------------------------------------ engine layer
W, K, LR = 4, 4, 0.05
TEMPLATE = {"w": (12, 8), "b": (5,)}
P0 = {"w": np.full((12, 8), 0.3, np.float32),
      "b": np.full((5,), -0.2, np.float32)}


def _cfgs(alg="vrl_sgd", **kw):
    kw = dict(dict(algorithm=alg, comm_period=K, learning_rate=LR,
                   weight_decay=0.0, warmup=False, update_backend="xla"),
              **kw)
    return JVRL(**kw), TVRL(**kw)


def _engines(alg="vrl_sgd", **kw):
    cj, ct = _cfgs(alg, **kw)
    ej = jeng.make_engine(cj, {k: jnp.zeros(s) for k, s in TEMPLATE.items()})
    et = teng.make_engine(ct, {k: torch.zeros(s) for k, s in TEMPLATE.items()})
    return ej, et


def _grads(spec, k, seed):
    rng = np.random.RandomState(seed)
    out = np.zeros((k, W, spec.rows, spec.lanes), np.float32)
    out.reshape(k, W, -1)[..., :spec.size] = rng.randn(k, W, spec.size)
    return out


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("alg,membership", [
    (a, m) for m in (False, True) for a in flat_algorithms()
    if not (m and a == "easgd")])          # easgd refuses the mask
def test_full_participation_round_trip_is_bitwise(alg, membership):
    """M == W: the gather / round / scatter loop produces BITWISE the
    storeless trajectory (params and every per-client leaf)."""
    _, et = _engines(alg, membership=membership)
    s0 = et.init(from_numpy(P0), W)
    s1 = et.init(from_numpy(P0), W)
    store = ClientStore(s1, W)
    st = s1
    for r in range(3):
        gk = _grads(et.spec, K, 20 + r)
        s0 = et.round_step_flat(s0, torch.from_numpy(gk.copy()))
        cohort = sample_cohort(W, W, r)
        st = store.gather(cohort, member=st.member, like=st)
        st = et.round_step_flat(st, torch.from_numpy(gk.copy()))
        store.scatter(st, cohort)
    tree = store.to_tree()["clients"]
    a, b = tm.state_leaves(s0._replace(member=())), tm.state_leaves(tree)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert _same(x, y), k


def _compare_stores(jstore, store, kg):
    flat = {k: np.asarray(v) for k, v in _flatten(jstore.to_tree()).items()}
    leaves = tm.state_leaves(store.to_tree())
    assert sorted(k for k, _ in leaves) == sorted(flat)
    for key, x in leaves:
        if not isinstance(x, torch.Tensor):
            assert x == int(flat[key]), key
            continue
        scale = 1.0 / kg if key.split("/")[-1] in ("delta", "bias") else 1.0
        scale *= max(1.0, float(np.abs(flat[key]).max()))
        np.testing.assert_allclose(x.numpy(), flat[key], rtol=0,
                                   atol=1e-5 * scale, err_msg=key)


@pytest.mark.parametrize("alg", ["vrl_sgd", "bvr_l_sgd", "local_sgd",
                                 "ssgd", "easgd", "vrl_sgd+membership"])
def test_strict_subset_cohorts_match_reference(alg):
    """M = 8 over W = 4 slots, rotating cohorts: gather (seeded from the
    consensus, but EASGD), recentre, round, scatter; both stores within
    1e-5 after every round, Σ Δ over each gathered cohort ≈ 0 after the
    recentre."""
    membership = alg.endswith("+membership")
    alg = alg.split("+")[0]
    ej, et = _engines(alg, membership=membership)
    sj = ej.init({k: jnp.asarray(v) for k, v in P0.items()}, W)
    st = et.init(from_numpy(P0), W)
    js, ts = jclients.ClientStore(sj, 8), ClientStore(st, 8)
    seed = not ej.algo.has_center
    rnd = jax.jit(ej.round_step_flat)
    rec = jax.jit(ej.recenter_drift)
    setm = jax.jit(ej.set_membership) if membership else None
    for r in range(5):
        cohort = sample_cohort(8, W, r, seed=1)
        sj = js.gather(cohort, member=getattr(sj, "member", ()),
                       seed_params=seed and r > 0)
        st = ts.gather(cohort, member=st.member, like=st,
                       seed_params=seed and r > 0)
        if membership and r == 2:
            m = np.array([1, 0, 1, 1], np.float32)
            sj, st = setm(sj, jnp.asarray(m)), et.set_membership(st, m)
        sj, st = rec(sj), et.recenter_drift(st)
        if teng.get_spec(alg).use_delta:
            keep = (st.member.active.view(-1) > 0 if membership
                    else torch.ones(W, dtype=torch.bool))
            assert st.delta[keep].sum(0).abs().max().item() <= \
                1e-5 * max(1.0, st.delta.abs().max().item())
        gk = _grads(et.spec, K, 40 + r)
        sj = rnd(sj, jnp.asarray(gk))
        st = et.round_step_flat(st, torch.from_numpy(gk.copy()))
        js.scatter(sj, cohort)
        ts.scatter(st, cohort)
        _compare_stores(js, ts, K * LR)


def test_seed_params_installs_consensus():
    _, et = _engines()
    st = et.init(from_numpy(P0), W)
    store = ClientStore(st, 8)
    store.server_params.fill_(0.7)
    g = store.gather(sample_cohort(8, W, 1), seed_params=True)
    assert torch.equal(g.params, torch.full_like(g.params, 0.7))
    g = store.gather(sample_cohort(8, W, 1))
    assert torch.equal(g.params[0], st.params[0])


def test_scatter_skips_dead_slots():
    """A dead slot's client keeps its pre-round rows."""
    _, et = _engines(membership=True)
    st = et.init(from_numpy(P0), W)
    store = ClientStore(st, 8)
    cohort = sample_cohort(8, W, 0)
    st = store.gather(cohort, member=st.member, like=st)
    st = et.set_membership(st, np.array([1, 1, 0, 1], np.float32))
    before = store.to_tree()["clients"].params.clone()
    st = et.round_step_flat(st, torch.from_numpy(_grads(et.spec, K, 3)))
    store.scatter(st, cohort)
    after = store.to_tree()["clients"].params
    assert torch.equal(after[cohort[2]], before[cohort[2]])
    for j in (0, 1, 3):
        assert torch.equal(after[cohort[j]], st.params[j])


def test_store_tree_round_trips_and_validates():
    _, et = _engines(compress=None)
    st = et.init(from_numpy(P0), W)
    store = ClientStore(st, 8)
    store.to_tree()["clients"].params.add_(0.5)
    tree = store.to_tree()
    other = ClientStore(et.init(from_numpy(P0), W), 8)
    other.load_tree(tree)
    for (k, x), (_, y) in zip(tm.state_leaves(other.to_tree()),
                              tm.state_leaves(tree)):
        assert _same(x, y), k
    assert other.global_leaf("step") == 0
    assert store.meta() == {"num_clients": 8, "cohort_size": W,
                            "store_bytes": store.nbytes}
    with pytest.raises(ValueError, match="must be {'clients'"):
        other.load_tree({"clients": tree["clients"]})
    small = ClientStore(et.init(from_numpy(P0), W), 6)
    with pytest.raises(ValueError, match="leaf shape mismatch"):
        small.load_tree(tree)


def test_store_refusals_match_reference():
    for kw, m in ((dict(overlap=True), 8), ({}, W - 1)):
        ej, et = _engines(**kw)
        with pytest.raises(ValueError) as a:
            ClientStore(et.init(from_numpy(P0), W), m)
        with pytest.raises(ValueError) as b:
            jclients.ClientStore(ej.init({k: jnp.asarray(v)
                                          for k, v in P0.items()}, W), m)
        assert str(a.value) == str(b.value)
    _, et = _engines()
    store = ClientStore(et.init(from_numpy(P0), W), 8)
    with pytest.raises(ValueError, match=r"cohort must have shape \(4,\)"):
        store.gather(np.arange(3))


def test_store_checkpoints_interchangeable(tmp_path):
    """A store saved by the JAX package restores into the port's, and the
    port's into the JAX package's, bitwise; the keys the same."""
    ej, et = _engines("bvr_l_sgd", inner_optimizer="momentum", momentum=0.9)
    sj = ej.init({k: jnp.asarray(v) for k, v in P0.items()}, W)
    st = et.init(from_numpy(P0), W)
    js, ts = jclients.ClientStore(sj, 8), ClientStore(st, 8)
    for r in range(2):
        cohort = sample_cohort(8, W, r)
        sj = jax.jit(ej.round_step_flat)(
            js.gather(cohort, seed_params=r > 0),
            jnp.asarray(_grads(et.spec, K, 60 + r)))
        js.scatter(sj, cohort)
    jck.save(str(tmp_path / "j"), js.to_tree(), meta={"clients": 8})
    fresh = ClientStore(et.init(from_numpy(P0), W), 8)
    fresh.load_tree(tck.restore(str(tmp_path / "j"), fresh.to_tree()))
    _compare_stores(js, fresh, 1e9)
    flat = {k: np.asarray(v) for k, v in _flatten(js.to_tree()).items()}
    for key, x in tm.state_leaves(fresh.to_tree()):
        want = flat[key]
        assert (np.array_equal(x.numpy(), want) if isinstance(x, torch.Tensor)
                else x == int(want)), key
    tck.save(str(tmp_path / "t"), fresh.to_tree(), meta={"clients": 8})
    assert (sorted(tck.load_meta(str(tmp_path / "t"))["keys"])
            == sorted(jck.load_meta(str(tmp_path / "j"))["keys"]))
    other = jclients.ClientStore(ej.init({k: jnp.asarray(v)
                                          for k, v in P0.items()}, W), 8)
    other.load_tree(jck.restore(str(tmp_path / "t"), other.to_tree()))
    for k, v in _flatten(other.to_tree()).items():
        np.testing.assert_array_equal(np.asarray(v), flat[k], err_msg=k)


# ------------------------------------------------------------------ driver
@pytest.mark.parametrize("flags", [
    ["--clients", "-1"],
    ["--workers", "4", "--clients", "2"],
    ["--participation", "0.5"],
    ["--clients", "8", "--participation", "1.5"],
    ["--workers", "4", "--clients", "8", "--participation", "0.25"],
    ["--workers", "2", "--clients", "4", "--overlap"],
    ["--workers", "2", "--clients", "4", "--no-round"],
    ["--workers", "2", "--clients", "4", "--backend", "reference"],
    ["--workers", "4", "--clients", "8", "--algorithm", "hier_vrl_sgd"],
])
def test_bad_client_flags_match_reference(flags):
    base = ["--smoke", "--steps", "4"]
    with pytest.raises(SystemExit) as ej:
        j_launch.main(base + flags)
    with pytest.raises(SystemExit) as et:
        t_launch.run(base + flags + ["--device", "cpu"])
    assert str(et.value) == str(ej.value)


CLIENT_RUN = ["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
              "--workers", "4", "--clients", "8", "--batch", "2", "--seq",
              "16", "--k", "2", "--alpha", "0.1", "--lr", "0.05",
              "--steps", "8", "--log-every", "1", "--ckpt-every", "2",
              "--faults", "crash@2:3,rejoin@2:5,killsave:6"]


def test_client_run_resumes_bitwise_from_its_store(tmp_path):
    """M = 8 over W = 4 with a crash/rejoin pair and a killed save (step
    6's): the store checkpoints record the population, 'latest' skips the
    killed one; a resume from the step-4 store reproduces steps 5-8 and the
    step-8 store bitwise."""
    full = t_launch.run(CLIENT_RUN + ["--ckpt", str(tmp_path / "a")])
    found = tck.latest_step(str(tmp_path / "a"))
    assert found is not None and found[0] == 8
    meta = tck.load_meta(found[1])["meta"]
    assert meta["clients"] == 8 and len(meta["assignment"]) == 8
    assert not os.path.exists(os.path.join(tck.step_dir(str(tmp_path / "a"),
                                                        6), "arrays.npz"))
    assert full.elastic["masks"] == [(4, [1, 1, 0, 1]), (6, [1, 1, 1, 1])]
    res = t_launch.run(CLIENT_RUN + [
        "--ckpt", str(tmp_path / "b"),
        "--resume", tck.step_dir(str(tmp_path / "a"), 4)])
    assert res.start_step == 4 and res.losses == full.losses[4:]
    with tck.ArrayFile(os.path.join(tck.step_dir(str(tmp_path / "a"), 8),
                                    "arrays.npz")) as fa, \
            tck.ArrayFile(os.path.join(tck.step_dir(str(tmp_path / "b"), 8),
                                       "arrays.npz")) as fb:
        keys = sorted(k for k in fa.files if k != "__meta__")
        assert keys == sorted(k for k in fb.files if k != "__meta__")
        assert "server_params" in keys and "clients/params" in keys
        for k in keys:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    # a plain state is refused by a client run, and the reverse
    plain = ["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
             "--workers", "4", "--k", "2", "--batch", "2", "--seq", "16",
             "--steps", "2", "--ckpt", str(tmp_path / "c"), "--ckpt-every",
             "2"]
    t_launch.run(plain)
    with pytest.raises(SystemExit, match="without --clients"):
        t_launch.run(plain[:-4] + ["--clients", "8", "--resume",
                                   tck.step_dir(str(tmp_path / "c"), 2)])
    with pytest.raises(SystemExit, match="--clients 8 to resume it"):
        t_launch.run(plain[:-4] + ["--resume",
                                   tck.step_dir(str(tmp_path / "a"), 4)])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_client_run_on_a_gloo_mesh_matches_one_process(tmp_path):
    """CLIENT_RUN's flags over 2 gloo ranks (``--mesh-grid``, two slots a
    rank, each rank a whole copy of the store), on mamba2-370m's smoke
    model (qwen2's parts two runs from one ulp): the losses of one process
    (fp32 rounding of the cross-rank sums); one model-state all-reduce a
    round and the scatter's all-gathers counted "clients"; rank 0's step-8
    store that of one process."""
    run = CLIENT_RUN[:]
    run[run.index("--arch") + 1] = "mamba2-370m"
    run[run.index("--seq") + 1] = "40"
    tmp.start_processes(R.cli, args=(2, _free_port(), run + [
        "--ckpt", str(tmp_path / "mesh"), "--mesh-grid"],
        str(tmp_path / "cli")), nprocs=2, start_method="spawn")
    ranks = [torch.load(f"{tmp_path / 'cli'}.rank{r}", weights_only=False)
             for r in range(2)]
    one = t_launch.run(run + ["--ckpt", str(tmp_path / "one")])
    for res in ranks:
        np.testing.assert_allclose(res["losses"], one.losses, rtol=1e-5)
        np.testing.assert_allclose(res["avg"], one.avg_model_losses,
                                   rtol=1e-5)
        counts = res["collectives"]
        assert counts["state"]["pod+data"]["calls"] == 4      # 4 rounds
        # params and Δ all-gathered at each of the 4 rounds' scatters
        assert counts["clients"]["pod+data"]["calls"] == 8
        assert counts["membership"]                 # the crash and rejoin
    paths = [os.path.join(tck.step_dir(str(tmp_path / d), 8), "arrays.npz")
             for d in ("mesh", "one")]
    with tck.ArrayFile(paths[0]) as fa, tck.ArrayFile(paths[1]) as fb:
        keys = sorted(k for k in fa.files if k != "__meta__")
        assert keys == sorted(k for k in fb.files if k != "__meta__")
        for k in keys:
            # Δ = (x̂ − x)/(kγ): x̂'s rounding over k·γ = 0.1
            np.testing.assert_allclose(
                fa[k], fb[k], rtol=1e-5,
                atol=1e-4 if k.endswith("delta") else 1e-6, err_msg=k)
