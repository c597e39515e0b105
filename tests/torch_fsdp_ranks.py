"""Rank-side code of ``tests/test_torch_fsdp.py`` (and of the fsdp grids
of ``tests/torch_dryrun_ranks.py``): each function runs in one process of
a gloo group (``torch.multiprocessing`` spawn, a ``file://`` store),
imports torch, numpy and ``repro_torch`` only, and writes what it
measured to ``out`` (``torch.save``) for the test process to compare.

The smoke models: qwen2-0.5b ("dense") and phi3.5-moe-42b-a6.6b ("moe",
capacity factor 0.5 so that its experts drop entries), both started from
the JAX package's draw with wq, wk × 0.1 (the test writes it to an npz;
the smoke models are chaotic from the plain draw); a worker's batch 4 ×
16, k = 2, two rounds, clip_norm 0.5 (it binds), vrl_sgd with sgd (γ
0.05) or adam (γ 1e-3), fp32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

ARCHS = {"dense": "qwen2-0.5b", "moe": "phi3.5-moe-42b-a6.6b"}
B, S, K, ROUNDS, CLIP = 4, 16, 2, 2, 0.5
LR = {"sgd": 0.05, "adam": 1e-3}
CAPACITY_FACTOR = 0.5           # the smoke MoE drops entries at it
DISPATCH_T, DISPATCH_SEED = 64, 11   # tokens of the dispatch check
# (name, workers, fsdp, shards) of the grids the step is held on
GRIDS = {"1x2": (1, 2, 1), "2x2": (2, 2, 1), "1x2x2": (1, 2, 2)}
WORLD = {name: w * f * s for name, (w, f, s) in GRIDS.items()}
FAULTS = ("clip_first", "aux_over_f", "rank_capacity")
GMUL = np.array([[1.0], [0.5]], np.float32)   # (K, W): step 2's g halved
# the engine's options on the (1 x fsdp 2) grid: VRLConfig fields
VARIANTS = {"overlap_deadline": dict(overlap=True, deadline=0.5),
            "int8": dict(compress="int8"), "topk": dict(compress="topk:8"),
            "bvr": dict(algorithm="bvr_l_sgd"), "ssgd": dict(algorithm="ssgd"),
            "easgd": dict(algorithm="easgd", inner_optimizer="momentum",
                          momentum=0.9)}


def _init(rank: int, world: int, store: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)


def model_cfg(kind: str):
    from repro_torch.configs import registry
    cfg = registry.smoke_arch(ARCHS[kind])
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=CAPACITY_FACTOR)
    return cfg


def vrl_cfg(inner: str, shards: int = 1, variant: str = ""):
    from repro_torch.comm import compressors as cm
    from repro_torch.configs.base import EngineConfig, VRLConfig
    kw = dict(algorithm="vrl_sgd", comm_period=K, learning_rate=LR[inner],
              warmup=False, clip_norm=CLIP, inner_optimizer=inner,
              update_backend="xla", engine=EngineConfig(shards=shards))
    kw.update(VARIANTS.get(variant, {}))
    if "compress" in kw:
        kw["compress"] = cm.parse_compressor(kw["compress"])
    return VRLConfig(**kw)


def batches(kind: str, workers: int, b: int = B, seed: int = 0):
    """((ROUNDS + 1)·K, W, b, S) token ids and their next-token labels."""
    rng = np.random.RandomState(seed)
    t = rng.randint(0, model_cfg(kind).vocab_size,
                    ((ROUNDS + 1) * K, workers, b, S)).astype(np.int64)
    return torch.from_numpy(t), torch.from_numpy(np.roll(t, -1, axis=-1))


def params0(path: str) -> dict:
    """The start the test wrote: the JAX draw, wq and wk × 0.1."""
    from repro_torch import tree as tree_mod
    with np.load(path) as z:
        return tree_mod.from_paths([(k, torch.from_numpy(z[k].copy()))
                                    for k in z.files])


def state_numpy(state) -> dict:
    """Every tensor leaf of a state, as numpy, by its checkpoint key."""
    from repro_torch import tree as tree_mod
    return {k: v.detach().to(torch.float32).numpy().copy()
            for k, v in tree_mod.state_leaves(state)
            if isinstance(v, torch.Tensor)}


def trajectory(kind: str, inner: str, mesh, workers: int, path: str, *,
               b: int = B, dtype=torch.float32, shards: int = 1,
               rounds: int = ROUNDS, state=None, start: int = 0,
               variant: str = "", gmul=None):
    """``round_step`` over the rounds from ``params0`` (or ``state``) on
    ``mesh`` (None: one process) -> (bundle, state, (rounds·K,) losses,
    each round's collectives, the first step's ``grads_fn`` output);
    ``gmul``: each round's (K, W) gradient multipliers
    (``round_step_fault``)."""
    from repro_torch.comm import collectives as coll
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.train.train_loop import make_train_step
    cfg = model_cfg(kind)
    bundle = make_train_step(cfg, vrl_cfg(inner, shards, variant),
                             device="cpu", mesh=mesh, param_dtype=dtype)
    first = None
    if state is None:
        from repro_torch import tree as tree_mod
        state = bundle.engine.init(tree_mod.tree_map(
            lambda x: x.to(dtype), params0(path)), workers)
    tok, lab = batches(kind, workers, b)
    idx = (np.arange(workers) if mesh is None
           else mesh_mod.local_workers(mesh, workers))
    tok, lab = tok[:, idx], lab[:, idx]
    if start == 0:
        g, loss = bundle.grads_fn(state, tok[0], lab[0])
        first = (g.to(torch.float32).numpy().copy(), float(loss))
    losses, counts = [], []
    for r in range(start, start + rounds):
        coll.reset_counts()
        sl = slice(r * K, (r + 1) * K)
        state, l = bundle.round_step_fault(state, tok[sl], lab[sl], gmul)
        losses.append(l)
        counts.append(json_counts(coll.COUNTS))
    return (bundle, state, torch.cat(losses).numpy() if losses else None,
            counts, first)


def diagnostics(bundle, state) -> dict:
    """``Engine.diagnostics`` of a state, as numpy."""
    return {k: v.numpy().copy()
            for k, v in bundle.engine.diagnostics(state).items()}


def json_counts(counts: dict) -> dict:
    return {k: {g: dict(v) for g, v in d.items()} for k, d in counts.items()}


def dispatch(cfg, path_x: str, group):
    """The routed layer of ``cfg`` on this rank's slice of the
    ``DISPATCH_T`` tokens (the whole of them without ``group``): its
    output, aux loss and per-entry (keep, slot); the router's gradient of
    mean(y²) + aux (a mean over the group's ranks is one process's)."""
    from repro_torch.models import moe
    with np.load(path_x) as z:
        x = torch.from_numpy(z["x"].copy())
        p = {k[2:]: torch.from_numpy(z[k].copy()) for k in z.files
             if k.startswith("p/")}
    if group is not None:
        n = x.shape[0] // group.size
        x = x[group.index * n:(group.index + 1) * n]
    p["router"].requires_grad_()
    moe.TRACE = []
    try:
        y, aux = moe.moe_mlp(cfg, p, x, group)
        keep, slot = moe.TRACE[0]
    finally:
        moe.TRACE = None
    (y.square().mean() + aux).backward()
    return {"y": y.detach().numpy().copy(), "aux": aux.item(),
            "keep": keep.numpy().copy(), "slot": slot.numpy().copy(),
            "router_grad": p["router"].grad.numpy().copy()}


def plant(fault: str, fsdp: int):
    """Plant one fault the checks must catch -> a function that undoes it.
    ``clip_first``: each rank clips its slice's gradient in the backward,
    before the fsdp mean; ``aux_over_f``: the aux sums' backward gives
    this rank's own share, so the group mean counts 1/F of the aux
    gradient; ``rank_capacity``: each rank's capacity is its own T's."""
    from repro_torch.comm import collectives as coll
    from repro_torch.models import moe
    from repro_torch.train import train_loop as tl
    if fault == "clip_first":
        orig = tl._worker_grads

        def clipped(loss_fn, clip_norm, *a):
            return orig(loss_fn, clip_norm or CLIP, *a)
        tl._worker_grads = clipped
        return lambda: setattr(tl, "_worker_grads", orig)
    if fault == "aux_over_f":
        orig = coll._GroupSum.backward
        coll._GroupSum.backward = staticmethod(lambda ctx, g: (g, None,
                                                               None))
        return lambda: setattr(coll._GroupSum, "backward",
                               staticmethod(orig))
    orig = moe.capacity
    moe.capacity = lambda cfg, n: orig(cfg, n // fsdp)
    return lambda: setattr(moe, "capacity", orig)


def run_world(rank: int, world: int, store: str, paths: dict,
              out: str) -> None:
    """World 2: the (1 x fsdp 2) grid's cases, the dispatch at F = 2, the
    planted faults, a batch that 2 does not divide and the checkpoints.
    World 4: the (2 x fsdp 2) and (1 x fsdp 2 x shard 2) grids' cases and
    the dispatch at F = 4.  Each rank saves what it measured."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.comm import collectives as coll
    from repro_torch.launch import mesh as mesh_mod
    torch.set_num_threads(1)
    _init(rank, world, store)
    res = {}
    grids = [g for g in GRIDS if WORLD[g] == world]
    for name in grids:
        w, f, s = GRIDS[name]
        mesh = mesh_mod.make_engine_mesh(w, fsdp=f, shards=s)
        res[name] = {"grid": dict(zip(mesh.axes, mesh.shape)),
                     "coords": dict(zip(mesh.axes, mesh.coords))}
        for kind in ARCHS:
            for inner in LR:
                _, st, losses, counts, first = trajectory(
                    kind, inner, mesh, w, paths[kind], shards=s)
                full = mesh_mod.gather_state(mesh, st)
                res[name][kind, inner] = {
                    "losses": losses, "counts": counts, "first": first,
                    "own": state_numpy(st),
                    "full": None if full is None else state_numpy(full)}
        if s > 1:
            # a gradient multiplier on a shard rank's own rows
            _, st, losses, _, _ = trajectory("moe", "sgd", mesh, w,
                                             paths["moe"], shards=s,
                                             gmul=GMUL)
            res[name]["gmul"] = {"losses": losses,
                                 "full": mesh_mod.gather_state(mesh, st)}
        if name == "1x2":
            for kind in ARCHS:
                first = trajectory(kind, "sgd", mesh, w, paths[kind],
                                   dtype=torch.bfloat16, rounds=0)[4]
                res[name][kind, "bf16"] = {"first": first}
    f = 2 if world == 2 else 4
    gmesh = mesh_mod.make_mesh((f,), (coll.FSDP,))
    group = coll.MeshGroup(gmesh, (coll.FSDP,))
    res["dispatch", f] = dispatch(model_cfg("moe"), paths["x"], group)
    if world == 2:
        mesh = mesh_mod.make_engine_mesh(1, fsdp=2)
        for variant in VARIANTS:
            _, st, losses, _, _ = trajectory("moe", "sgd", mesh, 1,
                                             paths["moe"], variant=variant)
            res["variant", variant] = {"losses": losses,
                                       "own": state_numpy(st)}
        for fault in FAULTS:
            undo = plant(fault, 2)
            try:
                if fault == "rank_capacity":
                    res["fault", fault] = dispatch(model_cfg("moe"),
                                                   paths["x"], group)
                else:
                    kind = "dense" if fault == "clip_first" else "moe"
                    res["fault", fault] = trajectory(
                        kind, "sgd", mesh, 1, paths[kind], rounds=0)[4]
            finally:
                undo()
        # a batch of 3: each fsdp rank runs all of it, as one process
        for kind in ARCHS:
            bundle, st, losses, counts, _ = trajectory(
                kind, "sgd", mesh, 1, paths[kind], b=3)
            res["odd", kind] = {"losses": losses, "counts": counts,
                                "own": state_numpy(st),
                                "diag": diagnostics(bundle, st)}
            # the save from this state (one process's bitwise), a restore
            # onto the grid and one more round, against the same round run
            # on without the save
            eng = bundle.engine
            saved_from = state_numpy(st)
            full = mesh_mod.gather_state(mesh, st)
            ck = f"{paths['ckpt']}_{kind}"
            if rank == 0:
                ckpt.save_flat_state(ck, full, eng.spec)
            dist.barrier()
            like = trajectory(kind, "sgd", mesh, 1, paths[kind],
                              rounds=0)[1]
            back = ckpt.restore_flat_state(
                ck, like, eng.spec, block=mesh_mod.state_block(mesh))
            restored = state_numpy(back)    # the rounds below write in place
            on = trajectory(kind, "sgd", mesh, 1, paths[kind], rounds=1,
                            state=st, start=ROUNDS)
            resumed = trajectory(kind, "sgd", mesh, 1, paths[kind],
                                 rounds=1, state=back, start=ROUNDS)
            res["ckpt", kind] = {
                "restored": restored, "saved_from": saved_from,
                "on": (on[2], state_numpy(on[1])),
                "resumed": (resumed[2], state_numpy(resumed[1]))}
    torch.save(res, f"{out}.rank{rank}")
    dist.destroy_process_group()
