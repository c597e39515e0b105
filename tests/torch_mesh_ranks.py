"""Rank-side code of ``tests/test_torch_mesh.py``: each function runs in one
process of a gloo group (``torch.multiprocessing`` spawn, a ``file://``
store), imports torch, numpy and ``repro_torch`` only, and writes what it
measured to ``out`` (``torch.save``) for the test process to compare.

The cases run the port's engine on a small template (1,600 parameters, 7
rows of 256 lanes) over W = 4 workers from the same numpy parameters and
the same numpy per-step gradients as the JAX side: each rank takes its
workers' slice of the global (k, W, R, C) gradients.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

W, K, LR = 4, 2, 0.05
TEMPLATE = {"w": (40, 30), "b": (70,), "deep": {"u": (2, 5, 33)}}
HIER = dict(k1=2, k2=4, grid=(2, 2))
PODS = HIER["grid"][0]
# name -> (VRLConfig fields of both packages, round lengths)
CASES = {
    "vrl_sgd": (dict(algorithm="vrl_sgd", warmup=True), [1, 2, 2, 2]),
    "ssgd": (dict(algorithm="ssgd"), [2] * 4),
    "easgd_momentum": (dict(algorithm="easgd", inner_optimizer="momentum",
                            momentum=0.9), [2] * 4),
    "bvr_adam": (dict(algorithm="bvr_l_sgd", inner_optimizer="adam",
                      bvr_beta=0.5), [2] * 4),
    "vrl_overlap_deadline": (dict(algorithm="vrl_sgd", overlap=True,
                                  deadline=0.25), [2] * 4),
    "vrl_int8": (dict(algorithm="vrl_sgd", compress="int8"), [2] * 4),
    "hier_overlap_deadline": (dict(algorithm="hier_vrl_sgd", overlap=True,
                                   deadline=0.25, hier=HIER), [2] * 4),
}
# the collective entry points of torch.distributed that a rank may call
ENTRY_POINTS = ("all_reduce", "all_gather", "all_gather_into_tensor",
                "all_gather_object", "reduce_scatter",
                "reduce_scatter_tensor", "broadcast",
                "broadcast_object_list", "reduce", "all_to_all",
                "all_to_all_single", "gather", "gather_object", "scatter",
                "scatter_object_list", "barrier", "send", "recv", "isend",
                "irecv", "batch_isend_irecv", "monitored_barrier")


def fields(name: str) -> dict:
    """The VRLConfig fields of a case, compressor and hierarchy as text
    and dicts (each package parses its own)."""
    kw = dict(comm_period=K, learning_rate=LR, warmup=False)
    kw.update(CASES[name][0])
    return kw


def port_cfg(name: str, **over):
    from repro_torch.comm import compressors as tcc
    from repro_torch.configs.base import HierConfig, VRLConfig
    kw = dict(fields(name), update_backend="xla")
    kw.update(over)
    comp, hier = kw.pop("compress", None), kw.pop("hier", None)
    return VRLConfig(**kw,
                     compress=tcc.parse_compressor(comp) if comp else None,
                     hier=HierConfig(**hier) if hier else None)


def template(tree=TEMPLATE):
    """The template as meta tensors."""
    return {k: template(v) if isinstance(v, dict) else
            torch.empty(v, device="meta") for k, v in tree.items()}


def params0_numpy() -> dict:
    """The starting parameters, fp32 from numpy seed 7."""
    rng = np.random.RandomState(7)
    return {"w": rng.randn(40, 30).astype(np.float32),
            "b": rng.randn(70).astype(np.float32),
            "deep": {"u": rng.randn(2, 5, 33).astype(np.float32)}}


def params0():
    from repro_torch import tree as tree_mod
    return tree_mod.tree_map(torch.from_numpy, params0_numpy())


def round_grads(rows: int, lanes: int, size: int, case: int, r: int,
                k: int) -> np.ndarray:
    """Round r's (k, W, R, C) fp32 gradients, zero pad lanes."""
    out = np.zeros((k, W, rows, lanes), np.float32)
    for i in range(k):
        rng = np.random.RandomState(1000 * case + 10 * r + i)
        out[i].reshape(W, -1)[:, :size] = rng.randn(W, size)
    return out


def buffers(state, prefix: str = "") -> dict:
    """The state's buffers (ndim >= 2) by dotted field name, as numpy."""
    out = {}
    for f in state._fields:
        v = getattr(state, f)
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            out.update(buffers(v, f"{prefix}{f}."))
        elif isinstance(v, torch.Tensor) and v.ndim >= 2:
            # bf16 as fp32 (exact), every other dtype as it is
            v = v.float() if v.dtype == torch.bfloat16 else v
            out[prefix + f] = v.detach().cpu().numpy().copy()
    return out


def run_case(name: str, mesh=None) -> dict:
    """One case through ``round_step_flat``: this rank's block (all of it
    without a mesh).  Returns the final buffers and, per fold under a
    deadline, (step, this rank's miss mask)."""
    from repro_torch.core import engine as teng
    from repro_torch.launch import mesh as mesh_mod
    cfg = port_cfg(name)
    rounds = CASES[name][1]
    hier = cfg.hier is not None
    et = teng.make_engine(cfg, template(), mesh=mesh)
    st = et.init(params0(), W)
    spec = et.spec
    idx = (np.arange(W) if mesh is None else
           mesh_mod.local_workers(mesh, W, PODS if hier else 0))
    local = tuple(st.params.shape[:-2])
    masks = []
    for r, k in enumerate(rounds):
        gk = round_grads(spec.rows, spec.lanes, spec.size,
                         list(CASES).index(name), r, k)[:, idx]
        gk = np.ascontiguousarray(gk.reshape(k, *local, *gk.shape[-2:]))
        st = et.round_step_flat(st, torch.from_numpy(gk))
        last = st.last_sync2 if hier else st.last_sync
        if cfg.deadline and last == st.step:
            masks.append((st.step, et.misses(st.step,
                                             st.overlap.pend_k.shape[0])))
    return {"state": buffers(st), "masks": masks}


def _init(rank: int, world: int, store: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)


def parity(rank: int, world: int, store: str, out: str) -> None:
    """Every case on this rank's block of a mesh over ``world`` ranks."""
    from repro_torch.launch import mesh as mesh_mod
    torch.set_num_threads(1)
    _init(rank, world, store)
    meshes = {0: mesh_mod.make_engine_mesh(W),
              PODS: mesh_mod.make_engine_mesh(W, pods=PODS)}
    res = {}
    for name in CASES:
        mesh = meshes[PODS if CASES[name][0].get("hier") else 0]
        res[name] = dict(run_case(name, mesh), coords=mesh.coords,
                         shape=mesh.shape)
    torch.save(res, f"{out}.rank{rank}")
    dist.destroy_process_group()


class _Watched:
    """An async work handle whose ``wait`` is recorded."""

    def __init__(self, work, rec):
        self._work, self._rec = work, rec

    def wait(self, *args, **kwargs):
        self._rec["waited"] = True
        return self._work.wait(*args, **kwargs)


def record_collectives(log: list) -> None:
    """Wrap every collective entry point of ``torch.distributed`` in this
    process: each call appends {fn, bytes, group ranks, async, waited}."""
    for fn in ENTRY_POINTS:
        orig = getattr(dist, fn, None)
        if orig is None:
            continue

        def wrapped(*args, _orig=orig, _fn=fn, **kwargs):
            t = args[0] if args else kwargs.get("tensor")
            group = kwargs.get("group")
            rec = {"fn": _fn,
                   "bytes": (t.numel() * t.element_size()
                             if isinstance(t, torch.Tensor) else 0),
                   "group": (dist.get_process_group_ranks(group)
                             if group is not None
                             else list(range(dist.get_world_size()))),
                   "async": bool(kwargs.get("async_op")), "waited": False}
            log.append(rec)
            work = _orig(*args, **kwargs)
            return _Watched(work, rec) if rec["async"] else work
        setattr(dist, fn, wrapped)


def _phase(log: list, fn) -> tuple:
    """(fn's result, the collectives it made)."""
    log.clear()
    out = fn()
    return out, [dict(r) for r in log]


def counts(rank: int, world: int, store: str, out: str) -> None:
    """The collectives each engine phase makes on this rank: every
    algorithm of the registry (local step, sync, round), stl_sgd's rounds
    at every stage, int8 and topk, the overlapped round, the hierarchy's
    syncs and overlapped round, and a train-loop round's loss."""
    from repro_torch.comm import collectives as coll
    from repro_torch.configs import registry
    from repro_torch.core import engine as teng
    from repro_torch.core import schedule as tsched
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.train.train_loop import make_train_step
    torch.set_num_threads(1)
    _init(rank, world, store)
    log: list = []
    flat_mesh = mesh_mod.make_engine_mesh(W)
    hier_mesh = mesh_mod.make_engine_mesh(W, pods=PODS)
    record_collectives(log)
    res = {"flat_shape": flat_mesh.shape, "hier_shape": hier_mesh.shape,
           "coords": hier_mesh.coords, "algs": {}, "rounds": {}}

    def engine(cfg, mesh=flat_mesh):
        et = teng.make_engine(cfg, template(), mesh=mesh)
        return et, et.init(params0(), W)

    def grads(et, st, k):
        g = round_grads(et.spec.rows, et.spec.lanes, et.spec.size, 0, 0, k)
        return torch.from_numpy(np.ascontiguousarray(
            g[:, :st.params.shape[0]].reshape(k, *st.params.shape)))

    for name in teng.ALGO_SPECS:
        if teng.get_spec(name).sync == "vrl2":
            continue
        et, st = engine(port_cfg("vrl_sgd", algorithm=name))
        gk = grads(et, st, K)
        st, local = _phase(log, lambda: et.local_step(st, gk[0]))
        st, sync = _phase(log, lambda: et.sync(st))
        _, rnd = _phase(log, lambda: et.round_step_flat(st, gk))
        res["algs"][name] = {"local": local, "sync": sync, "round": rnd}
    # stl_sgd's stagewise rounds: one all-reduce at every stage k
    sched = tsched.custom_stages([(1, 1), (2, 1), (4, 1)])
    et, st = engine(port_cfg("vrl_sgd", algorithm="stl_sgd",
                             comm_schedule=sched))
    for k in (1, 2, 4):
        st, rnd = _phase(log, lambda: et.round_step_flat(
            st, grads(et, st, k)))
        res["rounds"][f"stl_sgd k={k}"] = rnd
    for comp in ("int8", "topk:4"):
        et, st = engine(port_cfg("vrl_sgd", compress=comp))
        _, rnd = _phase(log, lambda: et.round_step_flat(st, grads(et, st,
                                                                    K)))
        res["rounds"][comp] = rnd
    # the overlapped round: issued async at its start, waited in the fold
    et, st = engine(port_cfg("vrl_sgd", overlap=True))
    gk = grads(et, st, K)
    xbar, begin = _phase(log, lambda: et.round_begin(st))
    for g in gk:
        st, steps = _phase(log, lambda: et.local_step(st, g))
        res["rounds"].setdefault("overlap steps", []).append(
            (steps, xbar.work._rec["waited"]))
    _, fold = _phase(log, lambda: et.round_fold(st, xbar))
    res["rounds"]["overlap begin"] = begin
    res["rounds"]["overlap fold"] = fold
    res["overlap_waited"] = xbar.work._rec["waited"]
    # the hierarchy: sync1 over the data group, sync2 over the pod group
    hcfg = port_cfg("hier_overlap_deadline", overlap=False, deadline=0.0)
    et, st = engine(hcfg, hier_mesh)
    gk = grads(et, st, K)
    st, sync1 = _phase(log, lambda: et.sync1(st))
    st, sync2 = _phase(log, lambda: et.sync2(st))
    st, rnd1 = _phase(log, lambda: et.round_step_flat(st, gk))
    _, rnd2 = _phase(log, lambda: et.round_step_flat(st, gk))
    res["hier"] = {"sync1": sync1, "sync2": sync2, "round k1": rnd1,
                   "round k2": rnd2}
    et, st = engine(port_cfg("hier_overlap_deadline", deadline=0.0),
                    hier_mesh)
    gk = grads(et, st, K)
    st, rnd1 = _phase(log, lambda: et.round_step_flat(st, gk))
    _, rnd2 = _phase(log, lambda: et.round_step_flat(st, gk))
    res["hier"]["overlap k1"], res["hier"]["overlap k2"] = rnd1, rnd2
    # a train-loop round: the model-state all-reduce and one (k,) loss
    cfg = registry.smoke_arch("qwen2-0.5b")
    bundle = make_train_step(cfg, port_cfg("vrl_sgd"), device="cpu",
                             mesh=flat_mesh)
    st = bundle.init_state(0, W)
    toks = torch.zeros((K, st.params.shape[0], 1, 8), dtype=torch.long)
    (_, losses), rnd = _phase(log, lambda: bundle.round_step(st, toks,
                                                             toks))
    res["train_round"] = rnd
    res["train_losses"] = losses.tolist()
    res["port_counts"] = coll.COUNTS
    torch.save(res, f"{out}.rank{rank}")
    dist.destroy_process_group()


def cli(rank: int, world: int, port: int, argv: list, out: str) -> None:
    """``launch.train.run(argv)`` as rank ``rank`` of a launcher's group
    (the environment ``torch.distributed.run`` sets)."""
    from repro_torch.launch import train as launch
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    res = launch.run(argv)
    torch.save({"losses": res.losses, "avg": res.avg_model_losses,
                "misses": res.misses, "collectives": res.collectives,
                "invariant": res.invariant}, f"{out}.rank{rank}")


# the elastic case (tests/test_torch_fault.py): (round length, the mask set
# before the round or None), over the W = 4 workers (pod-major for the
# hierarchy's (2, 2) grid)
ELASTIC_ROUNDS = [(2, None), (2, [1, 0, 1, 1]), (2, None), (2, [0, 0, 1, 1]),
                  (2, [1, 1, 1, 1]), (2, None)]


def elastic(rank: int, world: int, store: str, out: str) -> None:
    """vrl_sgd and the hierarchy with membership on this rank's block: the
    ``ELASTIC_ROUNDS`` through ``round_step_flat`` with the repairs
    between them; per round the collectives' counts by kind of the repair
    and of the round (``comm.collectives.COUNTS``); the final buffers."""
    from repro_torch.comm import collectives as coll
    from repro_torch.core import engine as teng
    from repro_torch.launch import mesh as mesh_mod
    torch.set_num_threads(1)
    _init(rank, world, store)
    res = {}
    for name, pods in (("flat", 0), ("hier", PODS)):
        mesh = mesh_mod.make_engine_mesh(W, pods=pods)
        cfg = (port_cfg("hier_overlap_deadline", overlap=False,
                        deadline=0.0, membership=True) if pods
               else port_cfg("vrl_sgd", warmup=False, membership=True))
        et = teng.make_engine(cfg, template(), mesh=mesh)
        st = et.init(params0(), W)
        spec = et.spec
        idx = mesh_mod.local_workers(mesh, W, pods)
        local = tuple(st.params.shape[:-2])
        rounds = []
        for r, (k, mask) in enumerate(ELASTIC_ROUNDS):
            coll.reset_counts()
            if mask is not None:
                st = et.set_membership(st, np.asarray(mask, np.float32))
            repair = {kind for kind in coll.COUNTS}
            coll.reset_counts()
            gk = round_grads(spec.rows, spec.lanes, spec.size, 9, r, k)[:, idx]
            gk = np.ascontiguousarray(gk.reshape(k, *local, *gk.shape[-2:]))
            st = et.round_step_flat(st, torch.from_numpy(gk))
            rounds.append({"repair": sorted(repair),
                           "round": {kind: {g: dict(c) for g, c in v.items()}
                                     for kind, v in coll.COUNTS.items()}})
        res[name] = {"rounds": rounds, "buffers": buffers(st),
                     "n_active": float(st.member.n_active)}
    torch.save(res, f"{out}.rank{rank}")
    dist.destroy_process_group()


# bf16 parameters on a mesh: name -> (VRLConfig fields, workers)
BF16_CASES = {
    "vrl_w2": (dict(algorithm="vrl_sgd"), 2),
    "vrl_overlap_w2": (dict(algorithm="vrl_sgd", overlap=True), 2),
    "hier_w4": (dict(algorithm="hier_vrl_sgd", hier=HIER), 4),
    "vrl_w4": (dict(algorithm="vrl_sgd"), 4),
    "bvr_adam_w4": (dict(algorithm="bvr_l_sgd", inner_optimizer="adam",
                         bvr_beta=0.5, delta_dtype="bfloat16"), 4),
}


def run_bf16(name: str, mesh=None, presync: bool = False):
    """A ``BF16_CASES`` case through ``round_step_flat`` at bf16
    parameters (the fp32 numpy parameters and gradients rounded to bf16):
    this rank's block (all of it without a mesh), its buffers as numpy
    (bf16 ones as fp32).  Three rounds where a rank holds one worker of
    each mean; one where it holds two (the x̂ of a later round would start
    from the first one's rounding).  ``presync``: the engine and the state
    before that round's sync (one process, no overlap)."""
    from repro_torch import tree as tree_mod
    from repro_torch.core import engine as teng
    from repro_torch.launch import mesh as mesh_mod
    fields, w = BF16_CASES[name]
    cfg = port_cfg("vrl_sgd", **fields)
    hier = cfg.hier is not None
    tpl = tree_mod.tree_map(lambda t: t.to(torch.bfloat16), template())
    et = teng.make_engine(cfg, tpl, mesh=mesh)
    st = et.init(tree_mod.tree_map(lambda t: t.to(torch.bfloat16),
                                   params0()), w)
    spec = et.spec
    idx = (np.arange(w) if mesh is None else
           mesh_mod.local_workers(mesh, w, PODS if hier else 0))
    local = tuple(st.params.shape[:-2])
    for r in range(3 if w == 2 or hier else 1):
        gk = np.zeros((K, w, spec.rows, spec.lanes), np.float32)
        rng = np.random.RandomState(500 + r)
        gk.reshape(K, w, -1)[..., :spec.size] = rng.randn(K, w, spec.size)
        gk = torch.from_numpy(np.ascontiguousarray(
            gk[:, idx].reshape(K, *local, *gk.shape[-2:]))).to(
            torch.bfloat16)
        if presync:
            for g in gk:
                st = et.local_step(st, g)
            return et, st
        st = et.round_step_flat(st, gk)
    return buffers(st)


def bf16_mesh(rank: int, world: int, store: str, out: str) -> None:
    """Every ``BF16_CASES`` case on this rank's block of a mesh over
    ``world`` ranks."""
    from repro_torch.launch import mesh as mesh_mod
    torch.set_num_threads(1)
    _init(rank, world, store)
    res = {}
    for name, (fields, w) in BF16_CASES.items():
        pods = PODS if "hier" in fields else 0
        mesh = mesh_mod.make_engine_mesh(w, pods=pods)
        res[name] = {"state": run_bf16(name, mesh), "coords": mesh.coords,
                     "idx": mesh_mod.local_workers(mesh, w, pods)}
    torch.save(res, f"{out}.rank{rank}")
    dist.destroy_process_group()
