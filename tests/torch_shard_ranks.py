"""Rank-side code of ``tests/test_torch_row_shards.py`` and
``tests/test_torch_moe_shardmap.py``: each function runs in one process of
a gloo group (``torch.multiprocessing`` spawn, a ``file://`` store),
imports torch, numpy and ``repro_torch`` only, and writes what it measured
to ``out`` (``torch.save``) for the test process to compare.

Row shards run the reference contract's template
(``tests/test_engine_collectives.py::test_row_sharded_round_is_one_all_reduce``):
``{"w": (64, 16), "b": (33,)}``, vrl_sgd + adam at block 8, W = 2, k = 4,
nine ``train_step``s whose gradients are sin(3x + t) + 0.1x of the
parameters the engine holds.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from torch_mesh_ranks import PODS, W as HIER_W, _init, port_cfg, round_grads

TEMPLATE = {"w": (64, 16), "b": (33,)}
W, K, LR, BLOCK, STEPS = 2, 4, 0.05, 8, 9
# the MoE case of the reference's test: smoke phi3.5-moe with 8 experts
MOE_TOKENS = 64


def params0_numpy() -> dict:
    rng = np.random.RandomState(0)
    return {"w": rng.randn(64, 16).astype(np.float32),
            "b": rng.randn(33).astype(np.float32)}


def port_shard_cfg(shards: int, sm3: bool = False):
    """The contract's config (vrl_sgd + adam, block 8); ``sm3``: bf16
    moments and SM3's factored second moment."""
    from repro_torch.configs.base import EngineConfig, VRLConfig
    return VRLConfig(algorithm="vrl_sgd", comm_period=K, learning_rate=LR,
                     weight_decay=0.0, warmup=False, update_backend="xla",
                     inner_optimizer="adam",
                     moment_dtype="bfloat16" if sm3 else "float32", sm3=sm3,
                     engine=EngineConfig(block=BLOCK, shards=shards))


def template():
    return {k: torch.empty(v, device="meta") for k, v in TEMPLATE.items()}


def trajectory(eng, state, counts: bool = False):
    """The contract's nine steps; with ``counts`` the collectives of each
    local step (after the gradient's parameter gather) and of each sync
    (``comm.collectives.COUNTS`` by kind)."""
    from repro_torch import tree as tree_mod
    from repro_torch.comm import collectives as coll
    local, sync = [], []
    for t in range(STEPS):
        grads = tree_mod.tree_map(
            lambda x, t=t: torch.sin(3.0 * x + float(t)) + 0.1 * x,
            eng.params_tree(state))
        coll.reset_counts()
        state = eng.local_step(state, grads)
        local.append(json_counts(coll.COUNTS))
        if eng.sync_due(state):
            coll.reset_counts()
            state = eng.step_sync(state)
            sync.append(json_counts(coll.COUNTS))
    return state, (local, sync) if counts else None


def row_shards(rank: int, world: int, store: str, out: str,
               shards: int) -> None:
    """vrl_sgd + adam and its SM3 bf16 variant on a (data world / S ×
    shard S) grid: each rank's block shapes, the collectives of the local
    steps and syncs, and (rank 0) the gathered final parameter trees."""
    from repro_torch.core import engine as teng
    from repro_torch.core import flat
    from repro_torch.launch import mesh as mesh_mod
    torch.set_num_threads(1)
    _init(rank, world, store)
    mesh = mesh_mod.make_engine_mesh(W, shards=shards)
    p0 = {k: torch.from_numpy(v) for k, v in params0_numpy().items()}
    res = {"grid": dict(zip(mesh.axes, mesh.shape))}
    for name, sm3 in (("adam", False), ("sm3", True)):
        eng = teng.make_engine(port_shard_cfg(shards, sm3), template(),
                               mesh=mesh)
        st = eng.init(p0, W)
        res[name] = {"shape": list(st.params.shape),
                     "rows": eng.spec.rows}
        if sm3:
            res[name]["col"] = list(st.inner.nu.col.shape)
        st, counts = trajectory(eng, st, counts=True)
        res[name]["local"], res[name]["sync"] = counts
        full = mesh_mod.gather_state(mesh, st)
        if rank == 0:
            res[name]["params"] = {
                k: v.numpy().copy() for k, v in
                flat.unflatten_stacked(eng.spec, full.params).items()}
            res[name]["full_shape"] = list(full.params.shape)
    torch.save(res, f"{out}.rank{rank}")
    dist.destroy_process_group()


def hier_rows(rank: int, world: int, store: str, out: str) -> None:
    """The overlapped (2, 2) hierarchy at shards 2 on a (data 2 × shard 2)
    grid through ``round_step_flat`` over ``torch_mesh_ranks``' numpy
    gradients (every row of its workers' cut to this rank's with
    ``Engine.own_rows``), and the state gathered to rank 0."""
    from repro_torch.launch import mesh as mesh_mod
    from torch_mesh_ranks import buffers
    torch.set_num_threads(1)
    _init(rank, world, store)
    mesh = mesh_mod.make_engine_mesh(HIER_W, pods=PODS, shards=2)
    et, st, idx = hier_engine(mesh)
    for r in range(4):
        gk = round_grads(et.spec.rows, et.spec.lanes, et.spec.size, 3, r,
                         2)[:, idx]
        gk = np.ascontiguousarray(gk.reshape(2, *st.params.shape[:2],
                                             *gk.shape[-2:]))
        st = et.round_step_flat(
            st, et.own_rows(torch.from_numpy(gk)).contiguous())
    full = mesh_mod.gather_state(mesh, st, PODS)
    res = {"grid": dict(zip(mesh.axes, mesh.shape)),
           "shape": list(st.params.shape)}
    if rank == 0:
        res["state"] = buffers(full)
    torch.save(res, f"{out}.rank{rank}")
    dist.destroy_process_group()


def hier_engine(mesh=None):
    """The hierarchy's engine at shards 2 and its state (this rank's
    block), with this rank's workers' global indices."""
    from repro_torch.configs.base import EngineConfig
    from repro_torch.core import engine as teng
    from repro_torch.launch import mesh as mesh_mod
    from torch_mesh_ranks import params0
    from torch_mesh_ranks import template as hier_template
    cfg = port_cfg("hier_overlap_deadline", deadline=0.0,
                   engine=EngineConfig(shards=2))
    et = teng.make_engine(cfg, hier_template(), mesh=mesh)
    idx = (np.arange(HIER_W) if mesh is None
           else mesh_mod.local_workers(mesh, HIER_W, PODS))
    return et, et.init(params0(), HIER_W), idx


# -------------------------------------------------------------------- MoE
def moe_cfg():
    """The reference test's case: smoke phi3.5-moe, 8 experts top-2,
    capacity factor 8, no shared experts."""
    from repro_torch.configs import registry
    cfg = registry.smoke_arch("phi3.5-moe-42b-a6.6b")
    return dataclasses.replace(cfg, num_experts=8, experts_per_token=2,
                               capacity_factor=8.0, num_shared_experts=0)


def moe_inputs(cfg) -> dict:
    """The layer's whole parameters, tokens and output cotangent, fp32
    from numpy seed 0."""
    rng = np.random.RandomState(0)
    d, ff, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    return {"router": (rng.randn(d, e) * 0.1).astype(np.float32),
            "w_gate": (rng.randn(e, d, ff) * 0.05).astype(np.float32),
            "w_up": (rng.randn(e, d, ff) * 0.05).astype(np.float32),
            "w_down": (rng.randn(e, ff, d) * 0.05).astype(np.float32),
            "x": rng.randn(MOE_TOKENS, d).astype(np.float32),
            "cot": rng.randn(MOE_TOKENS, d).astype(np.float32)}


AUX_WEIGHT = 0.3


def moe_ranks(rank: int, world: int, store: str, out: str) -> None:
    """``moe_mlp_shardmap`` on a (data 2 × model world / 2) grid, twice:
    this rank's output rows and aux, and the gradients of the loss Σ y ·
    cot + 0.3 · aux (each rank's share, as ``models.moe_shardmap`` says:
    x's summed over the model ranks, each weight block's whole), with the
    collectives' counts of the forward."""
    from repro_torch.comm import collectives as coll
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import moe_shardmap as ms
    torch.set_num_threads(1)
    _init(rank, world, store)
    cfg = moe_cfg()
    mesh = mesh_mod.make_mesh((2, world // 2), ("data", "model"))
    dn, mn = mesh.size(("data",)), mesh.size(("model",))
    inp = {k: torch.from_numpy(v) for k, v in moe_inputs(cfg).items()}
    runs = []
    for _ in range(2):
        p = {k: v.clone().requires_grad_() for k, v in
             ms.shard_params(inp, mesh).items()}
        x = ms.shard_tokens(inp["x"], mesh).clone().requires_grad_()
        coll.reset_counts()
        y, aux = ms.moe_mlp_shardmap(cfg, p, x, mesh)
        counts = json_counts(coll.COUNTS)
        loss = ((y * ms.shard_tokens(inp["cot"], mesh)).sum() / mn
                + AUX_WEIGHT * aux / (dn * mn))
        loss.backward()
        gx = x.grad.clone()
        dist.all_reduce(gx, group=mesh.group(("model",)))
        runs.append({"y": y.detach().numpy().copy(),
                     "aux": float(aux.detach()), "gx": gx.numpy().copy(),
                     "gw": {k: p[k].grad.numpy().copy()
                            for k in ("w_gate", "w_up", "w_down")},
                     "counts": counts})
    torch.save({"coords": mesh.index(("data", "model")), "runs": runs},
               f"{out}.rank{rank}")
    dist.destroy_process_group()


def json_counts(counts: dict) -> dict:
    return {k: {g: dict(v) for g, v in d.items()} for k, d in counts.items()}
