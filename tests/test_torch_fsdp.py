"""PyTorch port: a VRL worker over fsdp ranks (a mesh with an "fsdp" axis:
each rank runs its slice of the worker's batch; one gradient mean over
the fsdp group before the clip; the MoE dispatch and aux loss over the
worker's whole batch) against one process on the whole batch and against
the JAX package's whole-batch step, on the CPU.

  (a) The routed layer split over F ∈ {2, 4} ranks (``models.moe`` with a
      ``MeshGroup``), the smoke MoE at capacity factor 0.5 (it drops): the
      kept mask and the slots bitwise one process's, y and the aux loss
      within 1e-6 relative, the ranks' mean router gradient within 1e-6
      relative of one process's, and the whole batch against the JAX
      package's ``moe.moe_mlp`` at ``tests/test_torch_moe.py``'s tolerance.
  (b) The step on three gloo grids — (1 worker x fsdp 2), (2 workers x
      fsdp 2) and (1 x fsdp 2 x shards 2) — for the dense and the MoE
      smoke models, vrl_sgd + sgd and + adam, two rounds with a binding
      clip: the losses within 1e-5 relative and the gathered state within
      fp32 atol 1e-5 of one process on the whole worker batch (Δ and the
      moments atol 1e-5/(kγ); for adam on all but 1 % of the elements,
      the rest within 2γ a step, as ``tests/test_torch_train.py`` holds
      two fp32 Adam runs); every fsdp rank's state bitwise its peers'; the first step's
      loss within 1e-5 relative and its gradients within 1e-5 · max|g| a
      leaf of the JAX package's ``make_train_step`` on the whole batch;
      at bf16 parameters within 2^-5 · max|g|.
  (c) Three planted faults each fail the checks above: clipping before
      the fsdp mean (on the gradient), the aux gradient at 1/F (on the
      router's gradient), a rank's own capacity (on the kept mask).
  (d) A batch that F does not divide: every fsdp rank runs the whole
      batch, bitwise one process; the diagnostics equal one process's.
  (e) Checkpoints: the save from (1 x fsdp 2) bitwise the one-process
      save of the same state; a restore onto the grid resumes bitwise.

Ranks are spawned by ``torch.multiprocessing`` over a ``file://`` store;
their code is ``tests/torch_fsdp_ranks.py``.
"""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

import torch_fsdp_ranks as FR  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import VRLConfig as JVRL  # noqa: E402
from repro.core import flat as jflat  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train.train_loop import make_train_step as j_make  # noqa: E402
from repro_torch import tree as tree_mod  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.comm import collectives as coll  # noqa: E402
from repro_torch.configs.base import EngineConfig  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402

CASES = [(g, k, i) for g in FR.GRIDS for k in FR.ARCHS for i in FR.LR]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(kind):
    cfg = jreg.smoke_arch(FR.ARCHS[kind])
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=FR.CAPACITY_FACTOR)
    return cfg


def _jparams(kind):
    """The JAX package's draw (seed 0) with wq, wk × 0.1."""
    params = JT.init_params(_jcfg(kind), jax.random.PRNGKey(0))
    attn = params["layers"]["attn"]
    attn["wq"], attn["wk"] = attn["wq"] * 0.1, attn["wk"] * 0.1
    return params


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("fsdp")
    out = {"ckpt": str(d / "ckpt")}
    for kind in FR.ARCHS:
        out[kind] = str(d / f"{kind}.npz")
        leaves = tree_mod.leaves_with_path(
            jax.tree.map(np.asarray, _jparams(kind)))
        np.savez(out[kind], **dict(leaves))
    cfg = FR.model_cfg("moe")
    d_, ff, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    rng = np.random.RandomState(FR.DISPATCH_SEED)
    out["x"] = str(d / "x.npz")
    np.savez(out["x"], x=rng.randn(FR.DISPATCH_T, d_).astype(np.float32),
             **{"p/router": 0.5 * rng.randn(d_, e).astype(np.float32),
                "p/w_gate": 0.1 * rng.randn(e, d_, ff).astype(np.float32),
                "p/w_up": 0.1 * rng.randn(e, d_, ff).astype(np.float32),
                "p/w_down": 0.1 * rng.randn(e, ff, d_).astype(np.float32)})
    return out


@pytest.fixture(scope="module")
def ranks(paths, tmp_path_factory):
    """{world: [each rank's record]} from one spawn of each world."""
    d = tmp_path_factory.mktemp("fsdp_ranks")
    out = {}
    for world in (2, 4):
        tmp.start_processes(
            FR.run_world, args=(world, str(d / f"store{world}"), paths,
                                str(d / f"out{world}")),
            nprocs=world, start_method="spawn")
        out[world] = [torch.load(str(d / f"out{world}.rank{r}"),
                                 weights_only=False) for r in range(world)]
    return out


@pytest.fixture(scope="module")
def one(paths):
    """One process on every worker's whole batch: each grid's workers."""
    out = {}
    for w in sorted({g[0] for g in FR.GRIDS.values()}):
        for kind in FR.ARCHS:
            for inner in FR.LR:
                for s in (1, 2):
                    _, st, losses, _, first = FR.trajectory(
                        kind, inner, None, w, paths[kind], shards=s)
                    out[w, kind, inner, s] = {
                        "losses": losses, "state": FR.state_numpy(st),
                        "first": first}
    _, st, losses, _, _ = FR.trajectory("moe", "sgd", None, 1, paths["moe"],
                                        shards=2, gmul=FR.GMUL)
    out["gmul"] = {"losses": losses, "state": FR.state_numpy(st)}
    for variant in FR.VARIANTS:
        _, st, losses, _, _ = FR.trajectory("moe", "sgd", None, 1,
                                            paths["moe"], variant=variant)
        out["variant", variant] = {"losses": losses,
                                   "state": FR.state_numpy(st)}
    for kind in FR.ARCHS:
        out["bf16", kind] = FR.trajectory(kind, "sgd", None, 1, paths[kind],
                                          dtype=torch.bfloat16,
                                          rounds=0)[4]
        bundle, st, losses, _, _ = FR.trajectory(kind, "sgd", None, 1,
                                                 paths[kind], b=3)
        out["odd", kind] = {"losses": losses, "state": st,
                            "diag": FR.diagnostics(bundle, st)}
        out["dispatch"] = FR.dispatch(FR.model_cfg("moe"), paths["x"], None)
    return out


@pytest.fixture(scope="module")
def jax_first():
    """The JAX package's ``grads_fn`` on each whole worker batch from the
    start (fp32 and bf16 parameters): the (W, R, C) gradient and loss."""
    out = {}
    for kind in FR.ARCHS:
        for w, dt in ((1, jnp.float32), (2, jnp.float32),
                      (1, jnp.bfloat16)):
            inner = "sgd"
            jb = j_make(_jcfg(kind), JVRL(
                comm_period=FR.K, learning_rate=FR.LR[inner], warmup=False,
                clip_norm=FR.CLIP, update_backend="xla"), remat=False,
                param_dtype=dt)
            params = jax.tree.map(lambda x: x.astype(dt), _jparams(kind))
            js = jb.engine.init(params, w)
            tok, lab = FR.batches(kind, w)
            g, loss = jax.jit(jb.grads_fn)(js, jnp.asarray(tok[0].numpy()),
                                           jnp.asarray(lab[0].numpy()))
            g = np.asarray(jflat.flatten_stacked(jb.engine.spec, g)
                           ).astype(np.float32)
            out[kind, w, np.dtype(dt).name] = (g, float(loss))
    return out


def _leaf_close(got, want, spec, rel, w=None):
    """Per leaf of the flat layout: |got - want| <= rel · max|want|."""
    n = want.shape[0] if w is None else w
    got, want = got.reshape(n, -1), want.reshape(n, -1)
    for leaf in spec.leaves:
        sl = slice(leaf.offset, leaf.offset + leaf.size)
        a, b = want[:, sl], got[:, sl]
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=rel * np.abs(a).max() + 1e-12,
                                   err_msg=leaf.path)


def _spec(kind, shards=1):
    from repro_torch.models import transformer
    from repro_torch.models.param import abstract
    cfg = FR.model_cfg(kind)
    return teng.make_engine(FR.vrl_cfg("sgd", shards), abstract(
        transformer.model_defs(cfg), torch.float32)).spec


def _pad(jg, w, spec):
    """The JAX (W, R', C) gradient in the port's (W, R, C) layout: the
    leaves at the same offsets, the pad rows (the row shards' blocks)
    zero."""
    flat = np.zeros((w, spec.rows * spec.lanes), np.float32)
    flat[:, :spec.size] = jg.reshape(w, -1)[:, :spec.size]
    return flat.reshape(w, spec.rows, spec.lanes)


def _rank_rows(rec, grid, g_full):
    """This rank's part of a one-process (W, R, C) gradient: its workers,
    and on a shard axis its rows."""
    w, f, s = FR.GRIDS[grid]
    c = rec[grid]["coords"]
    g = g_full[c["data"]:c["data"] + 1] if w > 1 else g_full
    if s > 1:
        r = g.shape[-2] // s
        g = g[..., c["shard"] * r:(c["shard"] + 1) * r, :]
    return g


def _full_rows(rec, grid, g_rank, spec):
    """A rank's gradient rows in the (w, R, C) layout, zeros elsewhere."""
    w, f, s = FR.GRIDS[grid]
    if s == 1:
        return g_rank
    c = rec[grid]["coords"]
    out = np.zeros((g_rank.shape[0], spec.rows, spec.lanes), np.float32)
    r = spec.rows // s
    out[:, c["shard"] * r:(c["shard"] + 1) * r] = g_rank
    return out


# --------------------------------------------------------- (a) dispatch
@pytest.mark.parametrize("fsdp", [2, 4])
def test_dispatch_over_ranks_is_one_process(ranks, one, paths, fsdp):
    recs = [r["dispatch", fsdp] for r in ranks[fsdp]]
    ref = one["dispatch"]
    keep = np.concatenate([r["keep"] for r in recs])
    slot = np.concatenate([r["slot"] for r in recs])
    assert not ref["keep"].all() and ref["keep"].any()     # drops happen
    np.testing.assert_array_equal(keep, ref["keep"])
    np.testing.assert_array_equal(slot, ref["slot"])
    y = np.concatenate([r["y"] for r in recs])
    scale = np.abs(ref["y"]).max()
    np.testing.assert_allclose(y, ref["y"], rtol=0, atol=1e-6 * scale)
    for r in recs:
        np.testing.assert_allclose(r["aux"], ref["aux"], rtol=1e-6)
    gr = np.mean([r["router_grad"] for r in recs], axis=0)
    np.testing.assert_allclose(gr, ref["router_grad"], rtol=0,
                               atol=1e-6 * np.abs(ref["router_grad"]).max())
    # the whole batch against the JAX package's layer
    cj = _jcfg("moe")
    with np.load(paths["x"]) as z:
        x = z["x"]
        p = {k[2:]: jnp.asarray(z[k]) for k in z.files if k != "x"}
    yj, aj = JM.moe_mlp(cj, p, jnp.asarray(x))
    yj = np.asarray(yj)
    np.testing.assert_allclose(y, yj, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(yj).max()))
    np.testing.assert_allclose(recs[0]["aux"], float(aj), rtol=0, atol=1e-6)


# ----------------------------------------------------------- (b) the step
@pytest.mark.parametrize("grid,kind,inner", CASES)
def test_step_over_ranks_is_one_process(ranks, one, grid, kind, inner):
    w, f, s = FR.GRIDS[grid]
    recs = ranks[FR.WORLD[grid]]
    ref = one[w, kind, inner, s]
    got = recs[0][grid][kind, inner]
    assert recs[0][grid]["grid"] == dict(zip(
        mesh_mod.grid_axes(f, s), mesh_mod.rank_grid(w, w * f * s, 0, s,
                                                     f)))
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    lr, steps = FR.LR[inner], FR.K * FR.ROUNDS
    for key, want in ref["state"].items():
        atol = 1e-5 if key == "params" else 1e-5 / (FR.K * lr)
        if inner != "adam":
            np.testing.assert_allclose(got["full"][key], want, rtol=0,
                                       atol=atol, err_msg=key)
            continue
        # Adam's ±γ steps on cancelling gradient elements (the rule of
        # tests/test_torch_train.py): atol on all but 1 %, and bounded
        diff = np.abs(got["full"][key] - want)
        assert (diff > atol).mean() <= 0.01, (key, (diff > atol).mean())
        bound = {"params": 2 * lr * steps, "delta": 2 * steps / FR.K}
        assert diff.max() <= bound.get(key, 1.0), (key, diff.max())
    # the fsdp peers of a (worker, shard) place hold bitwise one state
    for r in recs:
        peers = [q for q in recs
                 if {a: c for a, c in q[grid]["coords"].items()
                     if a != coll.FSDP}
                 == {a: c for a, c in r[grid]["coords"].items()
                     if a != coll.FSDP}]
        assert len(peers) == f
        for q in peers:
            for key, v in r[grid][kind, inner]["own"].items():
                np.testing.assert_array_equal(
                    q[grid][kind, inner]["own"][key], v, err_msg=key)
    # one gradient mean ("grad" over fsdp) a step, the loss's fsdp mean a
    # round; with row shards the clip's squared sums over "shard" too
    spec = _spec(kind, s)
    rows = spec.rows // s
    c = got["counts"][0]
    # one worker a rank
    grad = {"fsdp": {"calls": FR.K, "bytes": FR.K * rows * spec.lanes * 4,
                     "async": 0}}
    if s > 1:
        grad["shard"] = {"calls": FR.K, "bytes": FR.K * 4, "async": 0}
    assert c["grad"] == grad, c
    assert c["scalar"]["fsdp"]["calls"] == 1, c
    assert ("moe" in c) == (kind == "moe")
    if kind == "moe":
        # per layer, forward and the remat recompute: an all-gather of the
        # (E,) counts and an all-reduce of the 2E aux sums
        layers, e = FR.model_cfg(kind).num_layers, FR.model_cfg(
            kind).num_experts
        assert c["moe"] == {"fsdp": {"calls": FR.K * layers * 2 * 2,
                                     "bytes": FR.K * layers * 2 * (
                                         e * 8 + 2 * e * 4),
                                     "async": 0}}, c


@pytest.mark.parametrize("grid,kind", [(g, k) for g in FR.GRIDS
                                       for k in FR.ARCHS])
def test_first_step_matches_reference(ranks, one, jax_first, grid, kind):
    """The first step's loss and gradient: against the port's one process
    and the JAX package's whole-batch ``grads_fn``."""
    w, f, s = FR.GRIDS[grid]
    spec = _spec(kind, s)
    jg, jl = jax_first[kind, w, "float32"]
    for rec in ranks[FR.WORLD[grid]]:
        g, loss = rec[grid][kind, "sgd"]["first"]
        np.testing.assert_allclose(loss, jl, rtol=1e-5)
        np.testing.assert_allclose(loss, one[w, kind, "sgd", s]["first"][1],
                                   rtol=1e-5)
        want = _rank_rows(rec, grid, _pad(jg, w, spec))
        full = _full_rows(rec, grid, g, spec)
        wfull = _full_rows(rec, grid, want, spec)
        _leaf_close(full, wfull, spec, 1e-5)


@pytest.mark.parametrize("kind", list(FR.ARCHS))
def test_bf16_first_step_matches_reference(ranks, one, jax_first, kind):
    """At bf16 parameters the (1 x fsdp 2) gradient within 2^-5 · max|g| a
    leaf of the JAX package's whole-batch step and of one process's."""
    spec = _spec(kind)
    jg, jl = jax_first[kind, 1, "bfloat16"]
    for rec in ranks[2]:
        g, loss = rec["1x2"][kind, "bf16"]["first"]
        np.testing.assert_allclose(loss, jl, rtol=2 ** -5)
        _leaf_close(g, _pad(jg, 1, spec), spec, 2 ** -5)
        _leaf_close(g, one["bf16", kind][0], spec, 2 ** -5)


@pytest.mark.parametrize("variant", list(FR.VARIANTS))
def test_engine_options_over_ranks_are_one_process(ranks, one, variant):
    """The overlapped round with deadline misses, int8 and top-k
    compression, bvr_l_sgd, S-SGD and EASGD + momentum on (1 worker x
    fsdp 2), the MoE smoke model: within fp32 rounding of one process on
    the whole batch, the fsdp ranks bitwise each other."""
    ref = one["variant", variant]
    recs = [r["variant", variant] for r in ranks[2]]
    np.testing.assert_allclose(recs[0]["losses"], ref["losses"], rtol=1e-5)
    for key, want in ref["state"].items():
        np.testing.assert_allclose(recs[0]["own"][key], want, rtol=0,
                                   atol=1e-5 / (FR.K * FR.LR["sgd"]),
                                   err_msg=key)
        np.testing.assert_array_equal(recs[1]["own"][key],
                                      recs[0]["own"][key], err_msg=key)
    np.testing.assert_allclose(recs[0]["own"]["params"],
                               ref["state"]["params"], rtol=0, atol=1e-5)


def test_gradient_multiplier_on_shard_rows(ranks, one):
    """``round_step_fault``'s multiplier applied to a shard rank's own rows
    of the fsdp-averaged, clipped gradient (1 x fsdp 2 x shards 2): one
    process's run at shards 2."""
    got = ranks[4][0]["1x2x2"]["gmul"]
    ref = one["gmul"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    full = FR.state_numpy(got["full"])
    for key, want in ref["state"].items():
        np.testing.assert_allclose(full[key], want, rtol=0,
                                   atol=1e-5 if key == "params" else
                                   1e-5 / (FR.K * FR.LR["sgd"]), err_msg=key)


# ---------------------------------------------------- (c) planted faults
@pytest.mark.parametrize("fault", FR.FAULTS)
def test_planted_faults_fail_the_checks(ranks, one, paths, fault):
    recs = ranks[2]
    if fault == "rank_capacity":
        keep = np.concatenate([r["fault", fault]["keep"] for r in recs])
        # the true dispatch passes the same check
        np.testing.assert_array_equal(np.concatenate(
            [r["dispatch", 2]["keep"] for r in recs]), one["dispatch"]["keep"])
        with pytest.raises(AssertionError):
            np.testing.assert_array_equal(keep, one["dispatch"]["keep"])
        return
    kind = "dense" if fault == "clip_first" else "moe"
    spec = _spec(kind)
    g, _ = recs[0]["fault", fault]
    want = one[1, kind, "sgd", 1]["first"][0]
    _leaf_close(recs[0]["1x2"][kind, "sgd"]["first"][0], want, spec, 1e-5)
    if fault == "clip_first":
        # the clip binds: the unclipped gradient's norm is past it
        from repro_torch.train.train_loop import make_train_step
        b = make_train_step(FR.model_cfg(kind), dataclasses.replace(
            FR.vrl_cfg("sgd"), clip_norm=0.0), device="cpu")
        st = b.engine.init(FR.params0(paths[kind]), 1)
        tok, lab = FR.batches(kind, 1)
        assert float(torch.linalg.vector_norm(
            b.grads_fn(st, tok[0], lab[0])[0])) > 2 * FR.CLIP
        with pytest.raises(AssertionError):
            _leaf_close(g, want, spec, 1e-5)
        return
    # the 1/F aux gradient shows on the router's leaves
    router = [lf for lf in spec.leaves if lf.path.endswith("router")]
    assert router
    got, ref = g.reshape(-1), want.reshape(-1)
    bad = False
    for lf in router:
        sl = slice(lf.offset, lf.offset + lf.size)
        a, b = ref[sl], got[sl]
        bad |= bool(np.abs(a - b).max() > 1e-5 * np.abs(a).max())
    assert bad


# ------------------------------------------------ (d) a batch of 3 over 2
@pytest.mark.parametrize("kind", list(FR.ARCHS))
def test_undivided_batch_runs_whole_on_every_rank(ranks, one, kind):
    ref = one["odd", kind]
    want = FR.state_numpy(ref["state"])
    for rec in ranks[2]:
        got = rec["odd", kind]
        np.testing.assert_array_equal(got["losses"], ref["losses"])
        for key, v in want.items():
            np.testing.assert_array_equal(got["own"][key], v, err_msg=key)
        # no gradient mean: the batch is not split
        assert all("grad" not in c for c in got["counts"])
        # the diagnostics' sums run over the state's ranks, not the fsdp
        # replicas
        assert set(got["diag"]) == set(ref["diag"])
        for key, v in ref["diag"].items():
            np.testing.assert_allclose(got["diag"][key], v, rtol=1e-6,
                                       err_msg=key)


# ---------------------------------------------------- (e) checkpoints
@pytest.mark.parametrize("kind", list(FR.ARCHS))
def test_checkpoint_over_ranks_is_one_process(ranks, one, paths, tmp_path,
                                              kind):
    """The grid's save (rank 0's gather from fsdp index 0) bitwise the one
    process's save of the same state; the restore gives both fsdp ranks
    the saved state and resumes bitwise the uninterrupted run."""
    mine = str(tmp_path / "one")
    from repro_torch.train.train_loop import make_train_step
    eng = make_train_step(FR.model_cfg(kind), FR.vrl_cfg("sgd"),
                          device="cpu").engine
    ckpt.save_flat_state(mine, one["odd", kind]["state"], eng.spec)
    theirs = f"{paths['ckpt']}_{kind}"
    a = ckpt.ArrayFile(os.path.join(mine, "arrays.npz"))
    b = ckpt.ArrayFile(os.path.join(theirs, "arrays.npz"))
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        np.testing.assert_array_equal(b[key], a[key], err_msg=key)
    for rec in ranks[2]:
        got = rec["ckpt", kind]
        for key, v in got["saved_from"].items():
            np.testing.assert_array_equal(got["restored"][key], v,
                                          err_msg=key)
        np.testing.assert_array_equal(got["resumed"][0], got["on"][0])
        for key, v in got["on"][1].items():
            np.testing.assert_array_equal(got["resumed"][1][key], v,
                                          err_msg=key)


# -------------------------------------------------------- the refusals
def _fake(shape=(1, 1, 2)):
    return coll.WorkerMesh(shape, 0, {}, mesh_mod.grid_axes(2, 1))


def test_refusals_on_an_fsdp_axis():
    from repro_torch.configs.base import HierConfig, VRLConfig
    from repro_torch.core.clients import ClientStore
    tpl = {"w": torch.empty((8, 4), device="meta")}
    with pytest.raises(NotImplementedError, match="hier_vrl_sgd"):
        teng.make_engine(VRLConfig(algorithm="hier_vrl_sgd",
                                   hier=HierConfig(k1=2, k2=4, grid=(1, 1))),
                         tpl, mesh=_fake())
    with pytest.raises(NotImplementedError, match="membership"):
        teng.make_engine(VRLConfig(membership=True), tpl, mesh=_fake())
    eng = teng.make_engine(VRLConfig(update_backend="xla"), tpl)
    st = eng.init({"w": torch.zeros(8, 4)}, 1)
    with pytest.raises(NotImplementedError, match="client store"):
        ClientStore(st, 4, mesh=_fake())
    assert mesh_mod.rank_grid(2, 8, shards=2, fsdp=2) == (1, 2, 2, 2)
    assert mesh_mod.rank_grid(1, 2, fsdp=2) == (1, 1, 2)
    with pytest.raises(ValueError, match=r"world % \(fsdp x shards\)"):
        mesh_mod.rank_grid(1, 6, shards=4, fsdp=2)
    # F = 1 is today's grid
    for args in ((4, 2), (4, 4, 2), (2, 4, 0, 2)):
        assert mesh_mod.rank_grid(*args) == mesh_mod.rank_grid(*args,
                                                               fsdp=1)


def test_production_grid_reads_the_roles():
    from repro_torch.configs import registry
    for arch, multi, shards, want in (
            ("phi3.5-moe-42b-a6.6b", False, 1, ((1, 1, 16),
                                                 ("pod", "data", "fsdp"))),
            ("phi3.5-moe-42b-a6.6b", True, 16,
             ((1, 2, 16, 16), ("pod", "data", "fsdp", "shard"))),
            ("qwen2-0.5b", False, 16, ((1, 16, 16),
                                       ("pod", "data", "shard"))),
            ("qwen2-0.5b", True, 1, ((1, 32), ("pod", "data")))):
        m = registry.mesh_roles(arch, multi_pod=multi)
        assert mesh_mod.production_grid(m, shards=shards) == want
    with pytest.raises(ValueError, match="must be equal"):
        mesh_mod.production_grid(registry.mesh_roles("qwen2-0.5b"),
                                 shards=8)
    assert EngineConfig().shards == 1
