"""PyTorch port: tensor-parallel serving on a (data, model) rank grid — the
reference's serving layout (``mesh_roles(serving=True)``,
``partition_specs``, ``cache_specs``) on real gloo ranks — against one
process on whole weights and against the JAX package's ``make_prefill`` /
``make_serve_step``, on the CPU.

  (a) Seven cases on four grids (``tests/torch_tp_ranks.py``: model 2
      with kv heads split — qwen2-0.5b with 2 kv heads, gemma-7b (tied
      embeddings), musicgen-large (the codec frontend, through the API);
      model 4 with the cache split by slots and padded heads — qwen2-0.5b
      with 6 heads (8 padded), also under a window of 8 (the ring buffer);
      data 2 × model 2 — phi3.5-moe at capacity factor 0.5 (it drops);
      kimi-k2's 2D layout in bf16 with its shared expert; model 2 for the
      ssm and hybrid families — mamba2-370m and hymba-1.5b with their
      inner channels and 8 SSM heads split, and each with 3 heads of 64
      over 192 channels, a head split over the two ranks), every smoke
      model from the JAX package's draw (wq, wk × 0.1).  Every rank's
      prefill logits and teacher-forced decode logits: fp32 within atol
      1e-4 of the JAX package's on whole weights (``tests/
      test_torch_model.py``'s tolerance) and within 1e-5 · max|logits| of
      the port's one process; bf16 within 2^-5 of each row's max|logits|
      (kimi-k2's MoE bound, PERF.md §2).  Every rank's cache block equal
      to one process's cache cut by ``cache_specs`` (within the same
      tolerances).  Greedy tokens equal one process's, or the step where
      they part is a near-tie of its top-2 logits (reported).
  (b) The routed layer's keep and drop over the whole served batch: the
      ranks' (keep, slot) per entry, joined over the grid, equal one
      process's.
  (c) The collectives of a prefill and of a decode step equal the design
      count (``design_count``), on the gloo ranks and on the dry mesh
      (``launch.dryrun.lower_one`` on the same case), whose FLOPs equal
      rank 0's ``FlopCounterMode`` count.
  (d) Each rank's weight bytes, and rank 0's blocks at full width for
      every architecture on both production meshes (``rank_params`` and
      the dry run's blocks, on meta tensors), equal the leaves' bytes ÷
      the mesh sizes the JAX package's ``partition_specs`` name.
  (e) Planted faults, each of which fails its check: the sum after
      ``wo`` skipped; the flash-decode combine without the e^{m−M}
      rescale; the shared expert inside the "model" sum; a rank's
      capacity from its own tokens; the SSM's gated norm over the rank's
      channels alone; the hybrid's SSM branch normalised before its sum.
  (f) Whole weights given to a rank of a grid are refused; the ssm
      family serves on one, its blocks cut by the ``ssm_inner`` rule, and
      the dry run's mamba2-370m row splits them too.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import torch_tp_ranks as TR  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import pad_for_mesh as j_pad  # noqa: E402
from repro.models import param as jparam  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.engine import make_prefill as j_prefill  # noqa: E402
from repro.serve.engine import make_serve_step as j_step  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro_torch import tree as tree_mod  # noqa: E402
from repro_torch.comm.collectives import WorkerMesh  # noqa: E402
from repro_torch.configs import base, registry  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import param as tparam  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.sharding import specs as sh  # noqa: E402

CASES = list(TR.CASES)
TOKEN_CASES = [c for c in CASES if c != "musicgen_m2"]
MOE_CASES = ("phi_d2m2", "kimi_d2m2")
JAX_ATOL = 1e-4          # fp32 against the JAX package
ONE_RTOL = 1e-5          # fp32 against one process, × max|logits|
BF16_TOL = 2.0 ** -5     # bf16, × each row's max|logits|
SERVE_ARCHS = registry.list_archs()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(name):
    arch, over, shape, *_ = TR.CASES[name]
    return j_pad(jreg.smoke_arch(arch, **over), shape[1])


def _soften(t):
    if not isinstance(t, dict):
        return t
    out = {k: _soften(v) for k, v in t.items()}
    if "wq" in out and "wk" in out:
        out["wq"], out["wk"] = out["wq"] * 0.1, out["wk"] * 0.1
    return out


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """Per case: the npz the ranks start from (the JAX draw, softened, at
    the case's dtype) and the JAX package's prefill logits, cache and
    teacher-forced decode logits on the whole batch and whole weights."""
    d = tmp_path_factory.mktemp("tp_serve")
    paths, out = {}, {}
    for name in CASES:
        cfg = _jcfg(name)
        assert cfg.__dict__ == TR.model_cfg(name).__dict__
        jdt = jnp.bfloat16 if TR.CASES[name][3] == "bfloat16" \
            else jnp.float32
        pj = jax.tree.map(lambda a: a.astype(jdt), _soften(
            JT.init_params(cfg, jax.random.PRNGKey(0))))
        paths[name] = str(d / f"{name}.npz")
        np.savez(paths[name], **dict(tree_mod.leaves_with_path(
            jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), pj))))
        s, cache_len = TR.CASES[name][4], TR.CASES[name][5]
        x = TR.inputs(name)
        x = jnp.asarray(x, jdt) if x.dtype == np.float32 else \
            jnp.asarray(x.astype(np.int32))
        logits, cache = j_prefill(cfg, cache_len)(pj, x[:, :s])
        rec = {"prefill": np.asarray(logits.astype(jnp.float32)),
               "cache": {k: np.asarray(v.astype(jnp.float32))
                         for k, v in tree_mod.leaves_with_path(cache)}}
        step = jax.jit(j_step(cfg), static_argnums=())
        dec = []
        for i in range(TR.GEN):
            lg, cache = step(pj, cache, x[:, s + i:s + i + 1], s + i)
            dec.append(np.asarray(lg.astype(jnp.float32)))
        rec["decode"] = np.concatenate(dec, axis=1)
        out[name] = rec
    return paths, out


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """{world: [each rank's record]} from one spawn of each world."""
    paths, _ = jax_side
    d = tmp_path_factory.mktemp("tp_ranks")
    out = {}
    for world in sorted(set(TR.WORLD.values())):
        tmp.start_processes(
            TR.run_world, args=(world, str(d / f"store{world}"), paths,
                                str(d / f"out{world}")),
            nprocs=world, start_method="spawn")
        out[world] = [torch.load(str(d / f"out{world}.rank{r}"),
                                 weights_only=False) for r in range(world)]
    return out


@pytest.fixture(scope="module")
def one(jax_side):
    """The port's one process on the whole batch and whole weights."""
    paths, _ = jax_side
    return {name: TR.serve(name, TR.params0(paths[name], TR.dtype(name)),
                           None, TR.dtype(name)) for name in CASES}


def _recs(ranks, name):
    return [r["cases"][name] for r in ranks[TR.WORLD[name]]]


def _close(got, want, name, ref_scale=None):
    """True when ``got`` holds ``want`` at the case's tolerance: fp32
    atol ``ref_scale`` (a number), bf16 2^-5 of each row's max|want|."""
    if TR.CASES[name][3] == "bfloat16":
        row = np.abs(want).max(axis=-1, keepdims=True)
        return bool((np.abs(got - want) <= BF16_TOL * row).all())
    return bool(np.abs(got - want).max() <= ref_scale)


def _hold(got, want, name, against):
    tol = (JAX_ATOL if against == "jax"
           else ONE_RTOL * float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert _close(got, want, name, tol), (name, against, err, tol)


# ------------------------------------------------------------- (a) logits
@pytest.mark.parametrize("key", ["prefill", "decode"])
@pytest.mark.parametrize("name", CASES)
def test_logits_hold_jax_and_one_process(ranks, one, jax_side, name, key):
    _, jx = jax_side
    for rec in _recs(ranks, name):
        a, b = rec["rows"]
        assert rec[key].shape == one[name][key][a:b].shape
        _hold(rec[key], jx[name][key][a:b], name, "jax")
        _hold(rec[key], one[name][key][a:b], name, "one")


def _grid(name, coords):
    shape = TR.CASES[name][2]
    rank = int(np.ravel_multi_index([coords[a] for a in ("data", "model")],
                                    shape))
    return WorkerMesh(shape, rank, {}, ("data", "model"))


@pytest.mark.parametrize("name", CASES)
def test_cache_block_is_the_specs_block(ranks, one, jax_side, name):
    """Each rank's prefill cache is one process's cut by ``cache_specs``
    (its rows, its kv heads or its slots, the ring buffer's slot = pos %
    8 under the window; its SSM heads' state where they divide the
    tensor ranks, else every head's, and the whole conv window), and one
    process's holds the JAX package's."""
    _, jx = jax_side
    cfg, roles = TR.model_cfg(name), TR.roles(name)
    length = TR.CASES[name][5] if cfg.attn_window is None \
        else cfg.attn_window
    spec = dict(tree_mod.leaves_with_path(
        sh.cache_specs(cfg, roles, TR.B, length)))
    assert sorted(spec) == sorted(one[name]["cache"])
    for key in spec:
        whole = one[name]["cache"][key]
        _hold(whole, jx[name]["cache"][key], name, "jax")
        for rec in _recs(ranks, name):
            want = sh.rank_block(torch.from_numpy(whole), spec[key],
                                 _grid(name, rec["coords"])).numpy()
            assert rec["cache"][key].shape == want.shape, (key, spec)
            _hold(rec["cache"][key], want, name, "one")


@pytest.mark.parametrize("name", TOKEN_CASES)
def test_greedy_tokens_equal_one_process(ranks, one, jax_side, name):
    """Every rank's greedy tokens equal one process's rows of them; where
    they part, the parting step is a near-tie (one process's top-2 logits
    after the common prefix within the case's tolerance), which is
    reported."""
    paths, _ = jax_side
    s, cache_len = TR.CASES[name][4], TR.CASES[name][5]
    for rec in _recs(ranks, name):
        a, b = rec["rows"]
        want = one[name]["greedy"][a:b]
        assert rec["greedy"].shape == want.shape == (b - a, s + TR.GEN)
        parts = np.nonzero((rec["greedy"] != want).any(axis=0))[0]
        if not len(parts):
            continue
        step = int(parts[0])
        assert step >= s, "the prompt itself differs"
        print(f"{name}: rank rows {a}:{b} part from one process at token "
              f"{step}")
        with torch.no_grad():
            lg = TT.prefill(TR.model_cfg(name),
                            TR.params0(paths[name], TR.dtype(name)),
                            torch.from_numpy(want[:, :step]),
                            cache_len)[0][:, -1].float().numpy()
        top2 = np.sort(lg, axis=-1)[:, -2:]
        tol = (BF16_TOL if TR.CASES[name][3] == "bfloat16"
               else ONE_RTOL) * np.abs(lg).max(axis=-1)
        assert (top2[:, 1] - top2[:, 0] <= tol).any(), (name, step, top2)


# --------------------------------------------------------- (b) keep / drop
def _joined(recs, key, name):
    """The grid's per-entry (keep, slot) of each dispatch, one process's
    numbering: data rank j's entries are its rows' tokens (in order); a
    model rank keeps only its experts' entries, so an entry is kept where
    any model rank keeps it, at the slot that rank gives it."""
    data = TR.CASES[name][2][0]
    by_data = [[r for r in recs if r["coords"]["data"] == j]
               for j in range(data)]
    out = []
    for i in range(len(recs[0][key])):
        keeps, slots = [], []
        for group in by_data:
            k = np.any([r[key][i][0] for r in group], axis=0)
            sl = np.max([r[key][i][1] for r in group], axis=0)
            keeps.append(k)
            slots.append(sl)
        out.append((np.concatenate(keeps), np.concatenate(slots)))
    return out


@pytest.mark.parametrize("key", ["prefill_trace", "decode_trace"])
@pytest.mark.parametrize("name", MOE_CASES)
def test_keep_and_drop_are_one_process(ranks, one, name, key):
    recs = _recs(ranks, name)
    got, want = _joined(recs, key, name), one[name][key]
    assert len(got) == len(want) > 0
    dropped = 0
    for (gk, gs), (wk, ws) in zip(got, want):
        assert np.array_equal(gk, wk) and np.array_equal(gs, ws)
        dropped += int((~wk).sum())
    if name == "phi_d2m2" and key == "prefill_trace":
        assert dropped > 0          # capacity factor 0.5 drops entries


# ---------------------------------------------------- (c) collectives
def design_count(name, fn: str) -> dict:
    """The design count of one prefill or decode step on the case's grid,
    {kind: calls}: per layer one "tensor" sum after ``wo``
    (where the heads split) and one after the MLP or the routed experts
    (their partial parts summed together; the shared experts added after
    it), plus in decode with the cache split by slots the query's gather
    (where the heads split), the max and the sum; an SSM block whose
    inner channels split three (the x channels' all-gather for the conv
    window, with the conv's output where a head splits; the gated norm's
    sum of squares; the sum after ``out_proj``), prefill or decode; one
    sum for the vocab-split embedding (token inputs), one all-gather of
    the logits; "moe" one all-gather of the expert counts a routed layer
    where the batch splits over the data ranks; "weights" (the d dims
    over FSDP ranks) one gather a weight a use."""
    cfg, roles = TR.model_cfg(name), TR.roles(name)
    t, L = roles.tensor_size, cfg.num_layers
    attn = cfg.family != "ssm"
    heads = attn and cfg.num_heads % t == 0
    seq = attn and cfg.num_kv_heads % t != 0
    per = int(heads) + int(attn)
    if fn == "decode" and seq:
        per += 2 + int(heads)
    if cfg.family in ("ssm", "hybrid") and cfg.ssm_d_inner % t == 0:
        per += 3
    tokens = cfg.frontend != "codec"
    counts = {"tensor": L * per + int(tokens) + 1}
    if cfg.family == "moe" and roles.num_workers * roles.fsdp_size > 1:
        counts["moe"] = L
    if roles.fsdp_size > 1:
        mlp = (1 + 3 + 3 * bool(cfg.num_shared_experts)
               if cfg.family == "moe" else 2 + (cfg.mlp_act != "gelu"))
        # the norms, wq, wk, wv, wo and the MLP's a layer; the final norm,
        # the logits' weight and the embedding (or the codec projection)
        counts["weights"] = L * (2 + 4 + mlp) + 3
    return counts


@pytest.mark.parametrize("fn", ["prefill", "decode"])
@pytest.mark.parametrize("name", CASES)
def test_collectives_equal_the_design_count(ranks, name, fn):
    want = design_count(name, fn)
    for rec in _recs(ranks, name):
        got = {k: sum(v["calls"] for v in d.values())
               for k, d in rec[f"{fn}_counts"].items()}
        assert got == want, (name, fn, rec[f"{fn}_counts"])
        assert set(rec[f"{fn}_counts"]["tensor"]) == {"model"}


@pytest.mark.parametrize("fn", ["prefill", "decode"])
@pytest.mark.parametrize("name", CASES)
def test_dry_mesh_equals_rank0(ranks, name, fn):
    """The case on the dry serving grid (``lower_one``: rank 0's blocks of
    the same padded model, batch and cache): its FLOPs equal rank 0's
    ``FlopCounterMode`` count, its collectives rank 0's, its ``chips``
    the grid."""
    rec = ranks[TR.WORLD[name]][0]["cases"][name]
    cfg = TR.model_cfg(name)
    arch, _, grid, dt, s, cache_len = TR.CASES[name]
    over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    shape = base.InputShape(name, s if fn == "prefill" else cache_len,
                            TR.B, fn)
    res = dryrun.lower_one(arch, "decode_32k", multi_pod=False, fn_kind=fn,
                           mesh_override={"shape": grid},
                           cfg_override=over, shape_override=shape,
                           param_dtype=getattr(torch, dt), verbose=False)
    assert res.counted.flops == rec[f"{fn}_flops"] > 0
    assert res.counted.counts == rec[f"{fn}_counts"]
    assert res.counted.launches() == {}
    assert res.roofline.chips == math.prod(grid)
    assert res.roofline.coll_bytes > 0


# ------------------------------------------------------- (d) the layout
def _jax_bytes(defs, specs, sizes, itemsize):
    """Σ over leaves of the leaf's bytes ÷ the mesh sizes its spec names."""
    leaves = jax.tree.leaves(defs, is_leaf=jparam.is_def)
    spec_l = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_l)
    total = 0
    for d, spec in zip(leaves, spec_l):
        div = 1
        for e in spec:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                div *= sizes[a]
        total += math.prod(d.shape) * itemsize // div
    return total


@pytest.mark.parametrize("name", CASES)
def test_rank_weight_bytes_equal_the_reference_specs(ranks, name):
    roles = TR.roles(name)
    jm = dataclasses.replace(jreg.mesh_roles(TR.CASES[name][0],
                                             serving=True),
                             shape=roles.shape)
    cfg = _jcfg(name)
    want = _jax_bytes(JT.model_defs(cfg),
                      jspecs.partition_specs(JT.model_defs(cfg), cfg, jm),
                      dict(zip(jm.axis_names, jm.shape)),
                      TR.dtype(name).itemsize)
    for rec in _recs(ranks, name):
        assert rec["weight_bytes"] == want


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_full_width_blocks_follow_the_reference_specs(arch, multi):
    """Rank 0's bf16 blocks at full width on the production serving mesh:
    ``rank_params`` over the dry serving grid and the dry run's
    ``rank_block`` give the bytes the JAX package's specs give."""
    jm = jreg.mesh_roles(arch, multi_pod=multi, serving=True)
    jc = jreg.padded_arch(arch, jm)
    want = _jax_bytes(JT.model_defs(jc),
                      jspecs.partition_specs(JT.model_defs(jc), jc, jm),
                      dict(zip(jm.axis_names, jm.shape)), 2)
    m = registry.mesh_roles(arch, multi_pod=multi, serving=True)
    c = registry.padded_arch(arch, m)
    smesh = mesh_mod.dry_serve_mesh(m)
    whole = tparam.abstract(TT.model_defs(c), torch.bfloat16)
    blocks = smesh.params(whole, c)
    dry = tree_mod.tree_map(lambda t, s: dryrun.rank_block(t, s, m, True),
                            whole, smesh.specs(c))
    for tree in (blocks, dry):
        assert sum(t.numel() * t.element_size()
                   for t in tree_mod.leaves(tree)) == want


@pytest.mark.parametrize("shape_id", ["prefill_32k", "decode_32k",
                                      "long_500k"])
@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_ssm_serving_rows_split_by_the_specs(arch, shape_id):
    """The ssm and hybrid families' serving rows on the (16, 16) grid: ok
    on all 256 chips; rank 0's bytes its blocks by the specs — the
    weights by the JAX package's ``partition_specs`` (``ssm_inner`` over
    "model"), the cache by ``cache_specs`` (mamba2-370m's 32 SSM heads
    split, hymba-1.5b's 50 whole beside its 200 channels a rank, its
    window's slots split), the tokens by the batch spec; its "tensor"
    collectives the design count (3 an SSM block; the hybrid's attention
    and MLP as the dense family's)."""
    res = dryrun.lower_one(arch, shape_id, multi_pod=False, verbose=False)
    assert res.ok and res.roofline.chips == 256
    jm = jreg.mesh_roles(arch, serving=True)
    jc = jreg.padded_arch(arch, jm)
    sizes = dict(zip(jm.axis_names, jm.shape))
    weights = _jax_bytes(JT.model_defs(jc),
                         jspecs.partition_specs(JT.model_defs(jc), jc, jm),
                         sizes, 2)
    m = registry.mesh_roles(arch, serving=True)
    c = registry.padded_arch(arch, m)
    shape = registry.get_shape(shape_id)
    ins = dryrun.input_specs(arch, shape_id, m)
    spec = sh.batch_sharding_spec(m, shape.global_batch,
                                  ins["tokens"].dim() - 1,
                                  worker_stacked=False)
    inputs = [(ins["tokens"], spec)]
    if shape.kind == "decode":
        window = dryrun._decode_window(c, shape)
        eff = min(window or shape.seq_len, shape.seq_len)
        inputs += list(zip(
            tree_mod.leaves(ins["cache"]),
            tree_mod.leaves(sh.cache_specs(c, m, shape.global_batch, eff))))
    held = sum(math.prod(sh.block_shape(t.shape, sp, sizes))
               * t.element_size() for t, sp in inputs)
    assert res.counted.base_bytes == weights + held
    t, L = m.tensor_size, c.num_layers
    per = 3
    if c.family == "hybrid":
        per += int(c.num_heads % t == 0) + 1
        if shape.kind == "decode" and c.num_kv_heads % t:
            per += 2 + int(c.num_heads % t == 0)
    assert res.counted.counts == {"tensor": {"model": {
        "calls": L * per + 2,
        "bytes": res.counted.counts["tensor"]["model"]["bytes"],
        "async": 0}}}


# ------------------------------------------------------------ (e) faults
@pytest.mark.parametrize("fault", list(TR.FAULTS))
def test_planted_fault_fails(ranks, one, fault):
    name = TR.FAULTS[fault]
    recs = [r["faults"][fault] for r in ranks[TR.WORLD[name]]]
    if fault == "rank_capacity":
        got = _joined(recs, "prefill_trace", name)
        want = one[name]["prefill_trace"]
        assert any(not np.array_equal(g[0], w[0])
                   for g, w in zip(got, want))
        return
    key = "decode" if fault == "no_rescale" else "prefill"
    failed = False
    for rec in recs:
        a, b = rec["rows"]
        want = one[name][key][a:b]
        tol = ONE_RTOL * float(np.abs(want).max())
        failed |= not _close(rec[key], want, name, tol)
    assert failed, fault


# ----------------------------------------------------------- (f) refusals
def test_whole_weights_and_ssm_are_refused():
    """A rank of a grid given whole weights refuses them (no quiet fall
    back to whole weights); the ssm family, refused on a grid until its
    ssm_inner split was ported, serves on one from its blocks (and refuses
    whole ones), and the dry run splits its row over the 16 "model"
    ranks."""
    from repro_torch.serve.engine import Engine
    roles = TR.roles("qwen_m2")
    smesh = mesh_mod.dry_serve_mesh(roles)
    cfg = TR.model_cfg("qwen_m2")
    whole = TT.init_params(cfg, 0)
    with pytest.raises(ValueError, match="this rank's block"):
        Engine(cfg, whole, max_len=16, mesh=smesh)
    Engine(cfg, smesh.params(whole, cfg), max_len=16, mesh=smesh)
    with pytest.raises(ValueError, match="serving layout gives this rank"):
        TT.prefill(cfg, whole, torch.zeros(2, 4, dtype=torch.long), 8,
                   **smesh.groups(2))
    ssm = registry.smoke_arch("mamba2-370m")
    whole = TT.init_params(ssm, 0)
    with pytest.raises(ValueError, match="serving layout gives this rank"):
        TT.decode_step(ssm, whole, TT.init_cache(ssm, 1, 8),
                       torch.zeros(1, 1, dtype=torch.long), 0, tp=smesh.tp)
    # on the dry grid: meta tensors, as the dry run steps them
    blocks = smesh.params(tparam.abstract(TT.model_defs(ssm),
                                          torch.float32), ssm)
    assert blocks["layers"]["ssm"]["wx"].shape[-1] == ssm.ssm_d_inner // 2
    cache = TT.init_cache(ssm, 1, 8, dtype=torch.float32, device="meta",
                          tp=smesh.tp)
    assert cache["state"].shape[2] == ssm.ssm_num_heads // 2
    logits, _ = TT.decode_step(ssm, blocks, cache,
                               torch.zeros(1, 1, dtype=torch.long,
                                           device="meta"), 0, tp=smesh.tp)
    assert logits.shape == (1, 1, ssm.vocab_size)
    row = dryrun.lower_one("mamba2-370m", "decode_32k", multi_pod=False,
                           verbose=False, cfg_override={"num_layers": 1})
    assert row.ok and row.roofline.chips == 256
    assert row.counted.counts["tensor"]["model"]["calls"] == 3 + 2
