"""Rank-side code of ``tests/test_torch_dryrun.py``: the collectives that
gloo ranks count for the engine cases of ``torch_mesh_ranks``, the
row-shard contract of ``torch_shard_ranks`` and the training step of a
worker over fsdp ranks (``torch_fsdp_ranks``' smoke models, remat on),
and the same drives on the dry mesh (``comm.collectives.DryMesh``) over
meta tensors, whose counts the test holds to rank 0's.  Imports torch,
numpy and ``repro_torch`` only."""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from torch_mesh_ranks import (CASES, PODS, W, _init, params0, port_cfg,
                              round_grads, template)
import torch_shard_ranks as SR

FLAT_CASES = ("vrl_sgd", "hier_overlap_deadline")   # (1 x 2), (1 x 2) hier
SHARD_W, SHARDS = SR.W, 2                            # data 2 x shard 2
# a worker over fsdp ranks: name -> (fsdp, shards) of a one-worker grid
FSDP_CASES = {"fsdp": (2, 1), "fsdp_rows": (2, 2)}


def _meta(tree):
    from repro_torch import tree as tree_mod
    return tree_mod.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


def case_counts(name: str, mesh, meta: bool) -> list:
    """A ``torch_mesh_ranks`` case's rounds through ``round_step_flat`` on
    ``mesh`` (this rank's block), the collectives of each round (by kind
    and group); on meta tensors with ``meta``."""
    from repro_torch.comm import collectives as coll
    from repro_torch.core import engine as teng
    from repro_torch.launch import mesh as mesh_mod
    cfg = port_cfg(name)
    hier = cfg.hier is not None
    eng = teng.make_engine(cfg, template(), mesh=mesh)
    st = eng.init(_meta(params0()) if meta else params0(), W)
    spec, local = eng.spec, tuple(st.params.shape[:-2])
    idx = mesh_mod.local_workers(mesh, W, PODS if hier else 0)
    out = []
    for r, k in enumerate(CASES[name][1]):
        if meta:
            gk = torch.empty((k, *local, spec.rows, spec.lanes),
                             device="meta")
        else:
            g = round_grads(spec.rows, spec.lanes, spec.size,
                            list(CASES).index(name), r, k)[:, idx]
            gk = torch.from_numpy(np.ascontiguousarray(
                g.reshape(k, *local, *g.shape[-2:])))
        coll.reset_counts()
        st = eng.round_step_flat(st, gk)
        out.append(SR.json_counts(coll.COUNTS))
    return out


def shard_counts(mesh, meta: bool):
    """The row-shard contract's nine steps (``torch_shard_ranks``): each
    local step's and sync's collectives."""
    from repro_torch.core import engine as teng
    eng = teng.make_engine(SR.port_shard_cfg(SHARDS), SR.template(),
                           mesh=mesh)
    p0 = {k: torch.from_numpy(v) for k, v in SR.params0_numpy().items()}
    st = eng.init(_meta(p0) if meta else p0, SHARD_W)
    return SR.trajectory(eng, st, counts=True)[1]


def fsdp_counts(mesh, meta: bool, shards: int) -> list:
    """The smoke dense and MoE models' two rounds of vrl_sgd + adam (a
    binding clip, remat on) on ``mesh``: each round's collectives; on meta
    tensors with ``meta``."""
    import torch_fsdp_ranks as FR
    from repro_torch.comm import collectives as coll
    from repro_torch.models import transformer
    from repro_torch.models.param import abstract
    from repro_torch.train.train_loop import make_train_step
    out = []
    dev = "meta" if meta else "cpu"
    for kind in FR.ARCHS:
        cfg = FR.model_cfg(kind)
        bundle = make_train_step(cfg, FR.vrl_cfg("adam", shards), device=dev,
                                 mesh=mesh)
        st = bundle.engine.init(
            abstract(transformer.model_defs(cfg), torch.float32) if meta
            else transformer.init_params(cfg, 0), 1)
        tok, lab = FR.batches(kind, 1)
        if meta:
            tok, lab = (torch.empty(t.shape, dtype=t.dtype, device="meta")
                        for t in (tok, lab))
        for r in range(FR.ROUNDS):
            coll.reset_counts()
            sl = slice(r * FR.K, (r + 1) * FR.K)
            st, _ = bundle.round_step(st, tok[sl], lab[sl])
            out.append(SR.json_counts(coll.COUNTS))
    return out


def counts(rank: int, world: int, store: str, out: str) -> None:
    """World 2: the flat (1 x 2) and hierarchical cases and one worker over
    fsdp 2; world 4: the row shards on (data 2 x shard 2) and one worker
    over fsdp 2 x shard 2.  Each rank saves its counts."""
    from repro_torch.launch import mesh as mesh_mod
    torch.set_num_threads(1)
    _init(rank, world, store)
    res = {}
    if world == 2:
        for name in FLAT_CASES:
            hier = port_cfg(name).hier is not None
            mesh = mesh_mod.make_engine_mesh(W, pods=PODS if hier else 0)
            res[name] = {"grid": mesh.shape,
                         "counts": case_counts(name, mesh, meta=False)}
    else:
        mesh = mesh_mod.make_engine_mesh(SHARD_W, shards=SHARDS)
        res["rows"] = {"grid": mesh.shape,
                       "counts": shard_counts(mesh, meta=False)}
    for name, (f, s) in FSDP_CASES.items():
        if f * s == world:
            mesh = mesh_mod.make_engine_mesh(1, fsdp=f, shards=s)
            res[name] = {"grid": mesh.shape,
                         "counts": fsdp_counts(mesh, meta=False, shards=s)}
    torch.save(res, f"{out}.rank{rank}")
    dist.destroy_process_group()
