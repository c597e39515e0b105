"""PyTorch port, the distributed worker axis vs the JAX package.

The port's mesh (``launch/mesh``'s rank grid, ``comm/collectives``'
``WorkerMesh`` over gloo ranks, each holding its block of the worker
grid) runs every worker mean as a local
sum, one all-reduce over its group and ÷ the global count.  The ranks are
processes spawned by ``torch.multiprocessing`` over a ``file://`` store
(``tests/torch_mesh_ranks.py``); the JAX side runs in a subprocess that
sets ``XLA_FLAGS=--xla_force_host_platform_device_count=N`` before
importing jax, as ``tests/test_engine_collectives.py`` does.

* (i) Against JAX on a placeholder mesh, N = 2 and 4: ``repro.core.
  make_engine(update_backend="xla")`` on a (p_r, d_r) ("pod", "data") mesh
  — (1, N) for the flat algorithms, the port's rank grid for the
  hierarchy — with W = 4, and the port's ranks from the same numpy
  parameters and per-step gradients: vrl_sgd + sgd with warm-up, ssgd,
  easgd + momentum, bvr_l_sgd + adam, vrl_sgd overlapped at deadline 0.25,
  vrl_sgd + int8, hier (2, 2) overlapped at deadline 0.25; four rounds.
  Every buffer within atol 1e-5 (Δ, B over k γ; Δ1 over k1 γ, Δ2 over
  k2 γ), as ``tests/test_engine_parity.py``; pend_k bitwise; int8 through
  ``close_or_flipped``.  Each rank's deadline masks are bitwise the
  reference's draws with the rank's axis indices folded in.
* (ii) Collective counts, every ``torch.distributed`` entry point wrapped
  in each of 4 ranks: for every flat algorithm of ``ALGO_SPECS`` a sync
  makes one model-state all-reduce (ssgd none) and a local step none
  (ssgd one); a round exactly one (ssgd k), at every stage of a stagewise
  stl_sgd and under int8 and topk; the overlapped round's is issued
  ``async_op=True`` at its start, not waited on during its local steps,
  and waited on in the fold; the hierarchy's sync1 is one all-reduce on
  the data group and sync2 one on the pod group (each of 2 ranks, the
  (2, 2) rank grid); a train-loop round adds one loss all-reduce of ≤ 64
  bytes, counted apart; the port's own counter agrees.
* (iii) World N against one process in the port, no deadline: atol 1e-6
  times the field's largest magnitude (over k γ for Δ, B and the moments;
  int8: ``close_or_flipped``), the ulps by which x̂'s reassociated sum
  may differ.
* (iv) The CLI: ``launch.train.run([... "--mesh-grid", "--device", "cpu",
  "--smoke"])`` on 2 ranks with the launcher's environment set, rank 0's
  losses within rtol 1e-5 of the one-process log.  W = 2 flat and the
  (2, 2) hierarchy with int8 / topk:32, overlap and deadline 0.25: there
  every all-reduce sums two values, whose fp32 sum does not depend on the
  order, so the runs agree to fp32 rounding over any number of steps.  At
  W = 4 over 2 ranks the sums reassociate ((a + b) + (c + d) against the
  mean's order) and the smoke model, chaotic under the reference's init
  (``tests/test_torch_train.py`` softens wq, wk by 0.1 for it), takes a
  one-ulp difference in x̂ to 2e-3 in the loss within four steps; (iii)
  holds that configuration at the engine, on fixed gradients.
* (v) Every refusal and its message.
"""
import os
import socket
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

import torch_mesh_ranks as R  # noqa: E402
from repro_torch.comm import collectives as coll  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import deadline as tdl  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import train as t_launch  # noqa: E402
from repro_torch.train.train_loop import make_train_step  # noqa: E402

from test_torch_compress import close_or_flipped, step_bound  # noqa: E402

WORLDS = (2, 4)
TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%d"
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    sys.path.insert(0, %r)
    import torch_mesh_ranks as R
    from repro.comm import compressors as jcc
    from repro.configs.base import HierConfig, VRLConfig
    from repro.core import engine as jeng
    from repro.core import flat as jflat
    from repro_torch.launch.mesh import rank_grid

    N = %d
    out = {}

    def buffers(state, prefix=""):
        res = {}
        for f in state._fields:
            v = getattr(state, f)
            if isinstance(v, tuple) and hasattr(v, "_fields"):
                res.update(buffers(v, prefix + f + "."))
            elif getattr(v, "ndim", 0) >= 2:
                res[prefix + f] = np.asarray(v)
        return res

    for ci, name in enumerate(R.CASES):
        kw = R.fields(name)
        comp, hier = kw.pop("compress", None), kw.pop("hier", None)
        cfg = VRLConfig(update_backend="xla",
                        compress=jcc.parse_compressor(comp) if comp else None,
                        hier=HierConfig(**hier) if hier else None, **kw)
        shape = rank_grid(R.W, N, R.PODS if hier else 0)
        mesh = Mesh(np.array(jax.devices()[:N]).reshape(shape),
                    ("pod", "data"))
        tj = jax.tree.map(lambda s: jnp.zeros(s, jnp.float32), R.TEMPLATE,
                          is_leaf=lambda x: isinstance(x, tuple))
        eng = jeng.make_engine(cfg, tj, mesh=mesh,
                               worker_axes=("pod", "data"))
        sj = eng.init(jax.tree.map(jnp.asarray, R.params0_numpy()), R.W)
        spec = eng.spec
        rnd = jax.jit(eng.round_step_flat)
        local, sync = jax.jit(eng.local_step), jax.jit(eng.sync)
        for r, k in enumerate(R.CASES[name][1]):
            gk = R.round_grads(spec.rows, spec.lanes, spec.size, ci, r, k)
            if hier:
                gk = gk.reshape(k, *hier["grid"], *gk.shape[-2:])
            if comp:
                # the sync's payload, for the flip bound
                for g in gk:
                    sj = local(sj, jflat.unflatten_stacked(
                        spec, jnp.asarray(g)))
                x = np.asarray(sj.params) - np.asarray(sj.comm.ref)[None]
                out[name + "|payload|" + str(r)] = (
                    x + np.asarray(sj.comm.resid))
                sj = sync(sj)
            else:
                sj = rnd(sj, jnp.asarray(gk))
            step = int(sj.step)
            last = int(sj.last_sync2 if hier else sj.last_sync)
            if cfg.deadline and last == step:
                # each rank's draw: the step, then its axis indices
                for rank in range(N):
                    pi, di = divmod(rank, shape[1])
                    key = jax.random.fold_in(jax.random.PRNGKey(0), step)
                    if hier and shape[0] > 1:
                        key = jax.random.fold_in(key, pi)
                    elif not hier and N > 1:
                        for a in (pi, di):
                            key = jax.random.fold_in(key, a)
                    n = (R.PODS // shape[0]) if hier else R.W // N
                    u = jax.random.uniform(key, (n, 1))
                    out["%%s|mask|%%d|%%d" %% (name, step, rank)] = np.asarray(
                        (u < cfg.deadline).astype(jnp.float32))
        for f, v in buffers(sj).items():
            out[name + "|" + f] = v
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spawn(fn, world, *args):
    tmp.start_processes(fn, args=(world, *args), nprocs=world,
                        start_method="spawn")


def _load(out, world):
    return [torch.load(f"{out}.rank{r}", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both JAX placeholder-mesh runs (subprocesses, started first), the
    port's parity ranks at N = 2 and 4, the port's one-process runs and
    the counting ranks."""
    d = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), TESTS]), JAX_PLATFORMS="cpu",
        OMP_NUM_THREADS="1")
    jax_runs = {n: subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT % (n, TESTS, n),
         str(d / f"jax{n}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for n in WORLDS}
    port = {}
    for n in WORLDS:
        _spawn(R.parity, n, str(d / f"store{n}"), str(d / f"port{n}"))
        port[n] = _load(str(d / f"port{n}"), n)
    _spawn(R.counts, 4, str(d / "store_counts"), str(d / "counts"))
    counts = _load(str(d / "counts"), 4)
    one = {name: R.run_case(name) for name in R.CASES}
    ref = {}
    for n, proc in jax_runs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        ref[n] = dict(np.load(d / f"jax{n}.npz"))
    return {"jax": ref, "port": port, "one": one, "counts": counts}


def assemble(blocks, name, field, shape):
    """The global buffer from the ranks' blocks: flat (W, ...) buffers in
    rank order; the hierarchy's (P, D, ...) and (P, 1, ...) ones by each
    rank's (pod, data) index; buffers every rank holds whole (ref, center,
    ref2) from rank 0, after checking that the ranks agree."""
    hier = "hier" in name
    out = np.zeros(shape, np.float32)
    for rank, b in enumerate(blocks):
        x = b[name]["state"][field]
        if x.shape == tuple(shape):
            np.testing.assert_array_equal(x, blocks[0][name]["state"][field])
            out = x
            continue
        pi, di = b[name]["coords"]
        if not hier:
            w = x.shape[0]
            out[rank * w:(rank + 1) * w] = x
            continue
        pl, dl = x.shape[:2]
        out[pi * pl:(pi + 1) * pl,
            (di * dl if dl < shape[1] else 0):
            (di * dl if dl < shape[1] else 0) + dl] = x
    return out


def scale(name, field):
    """What a field's atol is divided by: k γ for Δ and B (k1 γ, k2 γ for
    the hierarchy's) and for the inner optimizer's moments, which carry
    Δ (v = g − Δ − B), 1 otherwise."""
    if field in ("delta", "bias", "delta1") or field.startswith("inner"):
        return R.K * R.LR
    if field == "delta2":
        return R.HIER["k2"] * R.LR
    return 1.0


def flip_bound(ref, name):
    """Twice the summed int8 step of the run's sync payloads (JAX's)."""
    pays = [v for k, v in ref.items() if k.startswith(name + "|payload|")]
    return 2 * sum(step_bound("int8", x) for x in pays) if pays else 0.0


CASE_IDS = [(n, c) for n in WORLDS for c in R.CASES]


@pytest.mark.parametrize("world,name", CASE_IDS)
def test_mesh_matches_jax_placeholder_mesh(runs, world, name):
    ref, blocks = runs["jax"][world], runs["port"][world]
    comp = R.CASES[name][0].get("compress")
    flip = flip_bound(ref, name)
    fields = [k.split("|", 1)[1] for k in ref
              if k.startswith(name + "|") and "|payload|" not in k
              and "|mask|" not in k]
    assert set(fields) == set(blocks[0][name]["state"]), name
    for f in fields:
        want = ref[f"{name}|{f}"]
        got = assemble(blocks, name, f, want.shape)
        if f == "overlap.pend_k":
            np.testing.assert_array_equal(got, want, err_msg=name)
            continue
        s = scale(name, f)
        close_or_flipped(got, want, 1e-5 / s, flip / s, f"{name} {f}", comp)


@pytest.mark.parametrize("world", WORLDS)
def test_deadline_masks_are_the_reference_draws(runs, world):
    """Each rank's fold masks bitwise the JAX draws with its axis indices
    folded in; some fold misses."""
    ref, blocks = runs["jax"][world], runs["port"][world]
    seen = []
    for name in ("vrl_overlap_deadline", "hier_overlap_deadline"):
        for rank, b in enumerate(blocks):
            assert b[name]["masks"], name
            for step, mask in b[name]["masks"]:
                np.testing.assert_array_equal(
                    mask, ref[f"{name}|mask|{step}|{rank}"])
                seen.append((name, step, rank, mask.ravel().tolist()))
    assert any(any(m) for *_, m in seen)


@pytest.mark.parametrize("world,name", [
    (n, c) for n in WORLDS for c in R.CASES if "deadline" not in c])
def test_mesh_matches_one_process(runs, world, name):
    """atol 1e-6 relative to the field's largest magnitude: the two runs
    differ only in the order of x̂'s fp32 sum ((a + b) + (c + d) against
    the mean's), a few ulp of max|p|, which Δ carries over k γ."""
    one, blocks = runs["one"][name]["state"], runs["port"][world]
    comp = R.CASES[name][0].get("compress")
    flip = flip_bound(runs["jax"][world], name)
    assert set(one) == set(blocks[0][name]["state"])
    for f, want in one.items():
        s = scale(name, f)
        atol = 1e-6 * max(1.0, float(np.abs(want).max()) * s) / s
        close_or_flipped(assemble(blocks, name, f, want.shape), want,
                         atol, flip / s, f"{name} {f}", comp)


def test_deadline_fold_in_is_jax_fold_in():
    """``core/deadline`` with axis indices folded in is bitwise jax's
    ``uniform(fold_in(fold_in(... PRNGKey(0), step), i), ...), (n, 1))``."""
    for step in (1, 4, 9):
        for idx in ((0, 1), (0, 3), (1,), (2, 5)):
            key = jax.random.fold_in(jax.random.PRNGKey(0), step)
            for i in idx:
                key = jax.random.fold_in(key, i)
            want = np.asarray(jax.random.uniform(key, (3, 1)))
            np.testing.assert_array_equal(tdl.uniform(step, 3, idx), want)
    assert not np.array_equal(tdl.uniform(4, 3, (0, 1)), tdl.uniform(4, 3))


# ------------------------------------------------------------- (ii) counts
def _state(recs):
    """The model-state all-reduces of a phase (> 64 bytes)."""
    return [r for r in recs if r["bytes"] > 64]


FLAT_ALGS = [n for n in sorted(teng.ALGO_SPECS)
             if teng.get_spec(n).sync != "vrl2"]


@pytest.mark.parametrize("alg", FLAT_ALGS)
def test_each_algorithm_one_all_reduce_per_round(runs, alg):
    spec = teng.get_spec(alg)
    for res in runs["counts"]:
        c = res["algs"][alg]
        assert all(r["fn"] == "all_reduce" for p in c.values() for r in p)
        assert len(_state(c["local"])) == int(spec.grad_all_reduce), c
        assert len(_state(c["sync"])) == int(spec.sync != "none"), c
        want = R.K if spec.grad_all_reduce else 1
        assert len(_state(c["round"])) == want, c
        for r in _state(c["round"]):
            assert r["group"] == [0, 1, 2, 3] and not r["async"]


def test_stagewise_and_compressed_rounds_one_all_reduce(runs):
    for res in runs["counts"]:
        for key in ("stl_sgd k=1", "stl_sgd k=2", "stl_sgd k=4", "int8",
                    "topk:4"):
            recs = res["rounds"][key]
            assert len(recs) == 1 and recs[0]["fn"] == "all_reduce", (key,
                                                                      recs)


def test_overlap_all_reduce_async_and_waited_in_fold(runs):
    for res in runs["counts"]:
        begin = res["rounds"]["overlap begin"]
        assert len(begin) == 1 and begin[0]["async"], begin
        for steps, waited in res["rounds"]["overlap steps"]:
            assert steps == [] and waited is False
        assert res["rounds"]["overlap fold"] == []
        assert res["overlap_waited"] is True


def test_hier_levels_one_all_reduce_each_on_its_group(runs):
    for rank, res in enumerate(runs["counts"]):
        assert res["hier_shape"] == (2, 2) and res["flat_shape"] == (1, 4)
        pi, di = res["coords"]
        data = [pi * 2, pi * 2 + 1]
        pod = [di, 2 + di]
        h = res["hier"]
        assert [r["group"] for r in h["sync1"]] == [data], h["sync1"]
        assert [r["group"] for r in h["sync2"]] == [pod], h["sync2"]
        # a round off the k2 cadence: sync1 only; on it, one per level
        assert [r["group"] for r in h["round k1"]] == [data]
        assert [r["group"] for r in h["round k2"]] == [data, pod]
        # overlapped: level 2 issued async at the start of its round
        assert [r["group"] for r in h["overlap k1"]] == [data]
        ov = h["overlap k2"]
        assert [(r["group"], r["async"], r["waited"]) for r in ov] == [
            (pod, True, True), (data, False, False)], ov


def test_train_round_loss_counted_apart(runs):
    for res in runs["counts"]:
        recs = res["train_round"]
        assert len(_state(recs)) == 1
        scalars = [r for r in recs if r["bytes"] <= 64]
        assert len(scalars) == 1 and scalars[0]["bytes"] == 4 * R.K
        assert all(np.isfinite(res["train_losses"]))
        own = res["port_counts"]
        assert own["scalar"]["pod+data"] == {"calls": 1,
                                             "bytes": 4 * R.K, "async": 0}


# ------------------------------------------------------------------ (iv) CLI
CLI = ["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu", "--batch", "2",
       "--seq", "32", "--lr", "0.05"]
CLI_CASES = {
    "flat W=2": ["--workers", "2", "--steps", "6", "--k", "2", "--warmup"],
    "hier (2, 2)": ["--workers", "4", "--steps", "8",
                    "--algorithm", "hier_vrl_sgd", "--pods", "2",
                    "--k1", "2", "--k2", "4", "--compress", "int8",
                    "--compress2", "topk:32", "--overlap",
                    "--deadline", "0.25"]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_mesh_grid_matches_one_process(tmp_path, case):
    argv = CLI + CLI_CASES[case]
    _spawn(R.cli, 2, _free_port(), argv + ["--mesh-grid"],
           str(tmp_path / "cli"))
    ranks = _load(str(tmp_path / "cli"), 2)
    one = t_launch.run(argv)
    for res in ranks:
        np.testing.assert_allclose(res["losses"], one.losses, rtol=1e-5)
        np.testing.assert_allclose(res["avg"], one.avg_model_losses,
                                   rtol=1e-5)
        assert res["misses"] == one.misses
        assert res["collectives"]["state"]
    if "hier" in case:
        # (1, 2) rank grid: sync1 over the data group at every round,
        # level 2 (async) over the one-rank pod group at steps 4 and 8
        st = ranks[0]["collectives"]["state"]
        assert st["data"]["calls"] == 4 and st["pod"]["calls"] == 2
        assert st["pod"]["async"] == 2 and one.misses


# --------------------------------------------------------------- (v) refusals
@pytest.mark.parametrize("workers,world,pods,match", [
    (4, 3, 0, "W % world must be 0"),
    (6, 4, 0, "6 workers do not split over 4 ranks"),
    (4, 8, 1, "P % p_r must be 0"),
    (4, 2, 3, "do not split into 3 pods"),
    (4, 0, 0, "at least one rank")])
def test_rank_grid_refusals(workers, world, pods, match):
    with pytest.raises(ValueError, match=match):
        mesh_mod.rank_grid(workers, world, pods)


def test_rank_grid_fills_the_data_axis_first():
    assert mesh_mod.rank_grid(4, 2) == (1, 2)
    assert mesh_mod.rank_grid(4, 4, 2) == (2, 2)
    assert mesh_mod.rank_grid(4, 2, 2) == (1, 2)
    assert mesh_mod.rank_grid(8, 4, 4) == (2, 2)
    assert mesh_mod.rank_grid(6, 3, 3) == (3, 1)


def _fake_mesh(shape=(1, 2), rank=0):
    """A mesh object with no groups: enough for what is refused before any
    collective."""
    return coll.WorkerMesh(shape, rank, {})


def test_engine_refusals_on_a_mesh():
    from repro_torch.configs.base import EngineConfig
    tpl = R.template()
    with pytest.raises(ValueError, match="row-shard count must equal"):
        teng.make_engine(R.port_cfg("vrl_sgd", engine=EngineConfig(shards=2)),
                         tpl, mesh=_fake_mesh((1, 2, 4)))
    with pytest.raises(ValueError, match="worker axes"):
        _fake_mesh().size(("model",))
    with pytest.raises(ValueError, match="do not split over the mesh"):
        teng.make_engine(R.port_cfg("vrl_sgd"), tpl,
                         mesh=_fake_mesh((2, 1))).init(R.params0(), 3)
    with pytest.raises(ValueError, match="does not split over the mesh"):
        teng.make_engine(R.port_cfg("hier_overlap_deadline"), tpl,
                         mesh=_fake_mesh((4, 1)))
    with pytest.raises(ValueError, match="easgd"):
        teng.make_engine(R.port_cfg("easgd_momentum", membership=True), tpl,
                         mesh=_fake_mesh())


def test_per_leaf_executor_refused_on_a_mesh():
    cfg = treg.smoke_arch("qwen2-0.5b")
    with pytest.raises(ValueError, match="single-process"):
        make_train_step(cfg, R.port_cfg("vrl_sgd", update_backend="reference"),
                        device="cpu", mesh=_fake_mesh())


def test_mesh_grid_without_a_launcher_fails(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit, match="under a launcher.*RANK, "
                       "WORLD_SIZE, MASTER_ADDR, MASTER_PORT not set"):
        t_launch.run(CLI + ["--workers", "2", "--steps", "2",
                            "--mesh-grid"])


def test_without_a_mesh_nothing_is_communicated(monkeypatch):
    """No mesh: the engine and the train loop call no collective (the
    existing tests hold their results bitwise as before)."""
    import torch.distributed as dist
    called = []
    for fn in R.ENTRY_POINTS:
        if hasattr(dist, fn):
            monkeypatch.setattr(dist, fn, lambda *a, _fn=fn, **k:
                                called.append(_fn))
    for name in ("vrl_overlap_deadline", "hier_overlap_deadline", "ssgd"):
        R.run_case(name)
    assert called == []
