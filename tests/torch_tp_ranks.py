"""Rank-side code of ``tests/test_torch_tp_serve.py``: each function runs
in one process of a gloo group (``torch.multiprocessing`` spawn, a
``file://`` store), imports torch, numpy and ``repro_torch`` only, and
writes what it measured to ``out`` (``torch.save``) for the test process
to compare.

The cases (``CASES``): a smoke model on a serving grid of (data, model)
ranks, the reference's serving roles (``mesh_roles(serving=True)``) with
the grid's shape, the model padded for its tensor ranks
(``pad_for_mesh``) and started from the JAX package's draw with wq, wk ×
0.1 (the test writes it to an npz).  Every rank serves its rows of a
batch of ``B`` prompts: the prefill's logits and cache, then ``GEN``
decode steps teacher-forced over the test's tokens, and (token models)
``Engine.generate``'s greedy tokens; the collectives of the prefill and
of the first decode step; the routed layer's per-entry (keep, slot).
``FAULTS``: planted faults, each run once more with the fault in.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

B, GEN = 4, 6
# name: (arch, overrides of the smoke config, (data, model), dtype name,
#        prompt length, cache length)
CASES = {
    # kv 2 over model 2: kv heads split
    "qwen_m2": ("qwen2-0.5b", {"num_kv_heads": 2}, (1, 2), "float32", 8,
                16),
    # tied embeddings, GeGLU, kv 4 split
    "gemma_m2": ("gemma-7b", {}, (1, 2), "float32", 8, 16),
    # the codec frontend (frames in, no embedding lookup)
    "musicgen_m2": ("musicgen-large", {}, (1, 2), "float32", 8, 16),
    # 6 heads pad to 8 (kv 2, g' 4); kv 2 over model 4: the cache splits
    # by slots (the flash-decode)
    "qwen_m4": ("qwen2-0.5b", {"num_heads": 6, "num_kv_heads": 2}, (1, 4),
                "float32", 8, 16),
    # the same under a window of 8: a ring buffer of 8 slots, 2 a rank
    "qwen_m4w": ("qwen2-0.5b", {"num_heads": 6, "num_kv_heads": 2,
                                "attn_window": 8}, (1, 4), "float32", 8,
                 16),
    # experts over model 2, the batch over data 2, capacity factor 0.5:
    # 128 prompt tokens, capacity 32 an expert (16 over a rank's own 64)
    "phi_d2m2": ("phi3.5-moe-42b-a6.6b", {"capacity_factor": 0.5}, (2, 2),
                 "float32", 32, 40),
    # the 2D layout: d dims over data, the shared expert, bf16
    "kimi_d2m2": ("kimi-k2-1t-a32b", {}, (2, 2), "bfloat16", 8, 16),
    # ssm_inner over model 2, 8 SSM heads split (4 a rank); a prompt of
    # two chunks of 32, the second padded
    "mamba_m2": ("mamba2-370m", {}, (1, 2), "float32", 40, 48),
    # d_inner 192 over model 2: 96 channels a rank, 3 heads of 64 that do
    # not divide it (a head splits over the ranks: every rank scans every
    # head, the state whole)
    "mamba_m2x": ("mamba2-370m", {"d_model": 96, "ssm_head_dim": 64},
                  (1, 2), "float32", 40, 48),
    # attention (4 heads split, kv 1: the cache by slots, 32 of the
    # window's 64 a rank, the flash-decode) and SSM heads (8 split) in
    # parallel
    "hymba_m2": ("hymba-1.5b", {}, (1, 2), "float32", 40, 64),
    # the hybrid with 3 SSM heads over model 2 (a head splits)
    "hymba_m2x": ("hymba-1.5b", {"d_model": 96, "ssm_head_dim": 64},
                  (1, 2), "float32", 40, 64),
}
WORLD = {name: c[2][0] * c[2][1] for name, c in CASES.items()}
# fault -> the case it is planted in
FAULTS = {"wo_sum": "qwen_m2", "no_rescale": "qwen_m4",
          "shared_inside": "kimi_d2m2", "rank_capacity": "phi_d2m2",
          "norm_local": "mamba_m2x", "norm_before_sum": "hymba_m2"}


def _init(rank: int, world: int, store: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)


def roles(name: str):
    """The case's serving ``MeshConfig``: the arch's serving roles on a
    grid of the case's shape."""
    from repro_torch.configs import registry
    arch, _, shape, *_ = CASES[name]
    return dataclasses.replace(registry.mesh_roles(arch, serving=True),
                               shape=shape)


def model_cfg(name: str):
    """The case's smoke config, padded for its tensor ranks."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import pad_for_mesh
    arch, over, shape, *_ = CASES[name]
    return pad_for_mesh(registry.smoke_arch(arch, **over), shape[1])


def dtype(name: str) -> torch.dtype:
    return getattr(torch, CASES[name][3])


def inputs(name: str) -> np.ndarray:
    """The whole batch's (B, S + GEN) token ids, or (B, S + GEN, F) frames
    for the codec frontend (numpy, seed 5)."""
    cfg, s = model_cfg(name), CASES[name][4]
    rng = np.random.RandomState(5)
    if cfg.frontend == "codec":
        return rng.randn(B, s + GEN, cfg.frontend_dim).astype(np.float32)
    return rng.randint(0, cfg.vocab_size, (B, s + GEN)).astype(np.int64)


def params0(path: str, dt: torch.dtype) -> dict:
    from repro_torch import tree as tree_mod
    with np.load(path) as z:
        return tree_mod.from_paths([(k, torch.from_numpy(z[k].copy()).to(dt))
                                    for k in z.files])


def json_counts(counts: dict) -> dict:
    return {k: {g: dict(v) for g, v in d.items()} for k, d in counts.items()}


def serve(name: str, params: dict, smesh, dt: torch.dtype) -> dict:
    """The case's serving on ``smesh`` (None: one process on the whole
    batch and whole weights): prefill logits (all positions) and the cache,
    the teacher-forced decode logits, the greedy tokens, the collectives
    and the routed layer's (keep, slot) per dispatch."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import tree as tree_mod
    from repro_torch.comm import collectives as coll
    from repro_torch.models import moe
    from repro_torch.serve.engine import (Engine, make_prefill,
                                          make_serve_step)
    cfg, s, cache_len = model_cfg(name), CASES[name][4], CASES[name][5]
    x = torch.from_numpy(inputs(name))
    if x.is_floating_point():
        x = x.to(dt)
    rows = slice(0, B) if smesh is None else smesh.rows(B)
    groups = None if smesh is None else smesh.groups(B)
    rec = {"rows": (rows.start, rows.stop)}
    moe.TRACE = []
    try:
        with torch.no_grad():
            coll.reset_counts()
            with FlopCounterMode(display=False) as fm:
                logits, cache = make_prefill(cfg, cache_len,
                                             groups=groups)(params,
                                                            x[rows, :s])
            rec["prefill_flops"] = fm.get_total_flops()
            rec["prefill_counts"] = json_counts(coll.COUNTS)
            rec["prefill"] = logits.float().numpy().copy()
            rec["cache"] = {k: v.float().numpy().copy()
                            for k, v in tree_mod.leaves_with_path(cache)}
            rec["prefill_trace"] = [tuple(t.numpy().copy() for t in e)
                                    for e in moe.TRACE]
            moe.TRACE = []
            step = make_serve_step(cfg, groups=groups)
            dec = []
            for i in range(GEN):
                coll.reset_counts()
                with FlopCounterMode(display=False) as fm:
                    out, cache = step(params, cache, x[rows, s + i:s + i + 1],
                                      s + i)
                if i == 0:
                    rec["decode_flops"] = fm.get_total_flops()
                    rec["decode_counts"] = json_counts(coll.COUNTS)
                dec.append(out.float().numpy().copy())
            rec["decode"] = np.concatenate(dec, axis=1)
            rec["decode_trace"] = [tuple(t.numpy().copy() for t in e)
                                   for e in moe.TRACE]
        moe.TRACE = None
        if cfg.frontend != "codec":
            eng = Engine(cfg, params, max_len=cache_len, mesh=smesh)
            rec["greedy"] = eng.generate(x[:, :s], GEN).numpy().copy()
    finally:
        moe.TRACE = None
    return rec


def plant(fault: str, data: int):
    """Plant one fault the checks must catch -> a function that undoes it.
    ``wo_sum``: attention's ``wo`` skips its sum over the tensor ranks;
    ``no_rescale``: the flash-decode's combine sums the partials without
    the e^{m−M} rescale; ``shared_inside``: the shared experts are added
    inside the routed experts' sum over the tensor ranks;
    ``rank_capacity``: each rank's capacity is its own tokens';
    ``norm_local``: the SSM's gated norm takes its rank's sum of squares
    alone (no sum over the tensor ranks); ``norm_before_sum``: the hybrid
    normalises the SSM branch's partial ``out_proj`` product and sums
    after the norm (one sum after the fuse's norm, not before it)."""
    from repro_torch.models import attention, hybrid, moe, ssm
    if fault == "norm_local":
        orig = ssm._gated_norm

        def local(y, z, w, eps, tp=None, n=0):
            if tp is None:
                return orig(y, z, w, eps)
            dt = y.dtype
            y = (y * torch.nn.functional.silu(z)).float()
            y = y * torch.rsqrt(y.pow(2).sum(-1, keepdim=True) / n + eps)
            return (y * w.float()).to(dt)
        ssm._gated_norm = local
        return lambda: setattr(ssm, "_gated_norm", orig)
    if fault == "norm_before_sum":
        orig_out, orig_fuse = ssm._out_proj, hybrid._fuse
        seen = {}

        def partial(p, y, tp, split):
            seen["tp"] = tp if split else None
            return orig_out(p, y, tp, False)

        def fuse_after(p, ya, ys, eps):
            tp = seen.get("tp")
            if tp is None:
                return orig_fuse(p, ya, ys, eps)
            from repro_torch.models.layers import rms_norm
            ya = rms_norm(ya, p["attn_out_norm"], eps)
            ys = tp.all_sum(rms_norm(ys, p["ssm_out_norm"], eps)) / tp.size
            beta = p["fuse_beta"].to(ya.dtype)
            return 0.5 * (beta[0] * ya + beta[1] * ys)
        ssm._out_proj, hybrid._fuse = partial, fuse_after

        def undo():
            ssm._out_proj, hybrid._fuse = orig_out, orig_fuse
        return undo
    if fault == "wo_sum":
        orig = attention._out_proj

        def no_sum(cfg, p, out, tp, fsdp, split):
            return orig(cfg, p, out, tp, fsdp, False)
        attention._out_proj = no_sum
        return lambda: setattr(attention, "_out_proj", orig)
    if fault == "no_rescale":
        orig = attention._combine

        def plain(tp, m, l, o):
            both = tp.all_sum(torch.cat([o, l], dim=-1))
            return both[..., :-1] / both[..., -1:]
        attention._combine = plain
        return lambda: setattr(attention, "_combine", orig)
    if fault == "shared_inside":
        orig = moe._tp_combine

        def inside(tp, routed, routed_split, shared, shared_split):
            return tp.all_sum(routed + shared)
        moe._tp_combine = inside
        return lambda: setattr(moe, "_tp_combine", orig)
    orig = moe.capacity
    moe.capacity = lambda cfg, n: orig(cfg, n // data)
    return lambda: setattr(moe, "capacity", orig)


def run_world(rank: int, world: int, store: str, paths: dict,
              out: str) -> None:
    """Every case of this world's grid size, then its planted faults; each
    rank saves {case: record}, {fault: record} and its weight bytes."""
    from repro_torch.launch import mesh as mesh_mod
    torch.set_num_threads(1)
    _init(rank, world, store)
    res = {"cases": {}, "faults": {}}
    meshes = {}
    for name in CASES:
        if WORLD[name] != world:
            continue
        dt = dtype(name)
        smesh = mesh_mod.make_serve_mesh(roles(name))
        meshes[name] = smesh
        cfg = model_cfg(name)
        blocks = smesh.params(params0(paths[name], dt), cfg)
        rec = serve(name, blocks, smesh, dt)
        rec["weight_bytes"] = sum(t.numel() * t.element_size()
                                  for t in _leaves(blocks))
        rec["coords"] = dict(zip(smesh.mesh.axes, smesh.mesh.coords))
        res["cases"][name] = rec
    for fault, name in FAULTS.items():
        if WORLD[name] != world:
            continue
        undo = plant(fault, CASES[name][2][0])
        try:
            cfg = model_cfg(name)
            blocks = meshes[name].params(params0(paths[name], dtype(name)),
                                         cfg)
            rec = serve(name, blocks, meshes[name], dtype(name))
            rec["coords"] = res["cases"][name]["coords"]
            res["faults"][fault] = rec
        finally:
            undo()
    torch.save(res, f"{out}.rank{rank}")
    dist.barrier()
    dist.destroy_process_group()


def _leaves(tree):
    from repro_torch import tree as tree_mod
    return tree_mod.leaves(tree)
