"""The dry run (``repro.launch.dryrun``): the port's step at the production
layout, counted on meta tensors, with no card and no process group.

For an (architecture × input shape × mesh) combination, ``lower_one`` runs
the port's own step function — ``train.train_loop.make_train_step``'s
train, local, sync, sync1, sync2 or round step, or the serve engine's
prefill or decode — on meta tensors (``torch.device("meta")``: shapes and
dtypes, nothing allocated) under a counting ``TorchDispatchMode``, where
the reference compiles for a placeholder mesh.  It records, per device:

  * ``hlo_flops`` — the FLOPs of every product (``torch.utils.flop_counter``
    's formulas: what ``FlopCounterMode`` counts on the same step run on a
    card), split by dtype for the roofline's rates;
  * ``hlo_bytes`` — the input and output bytes of every aten op that is
    not a view, plus the engine kernels' bytes (``kernels.costs``: each
    wrapper charges its call on meta tensors).  The port runs eagerly, one
    kernel per op, so this unfused sum is its HBM traffic, cache aside;
  * ``per_device_bytes`` — the peak of live bytes: the state and inputs,
    plus every storage the step makes, while any tensor holds it;
  * the collectives of the dry mesh (``comm.collectives.DryMesh``: rank
    0's view of the grid), each priced at its link tier by
    ``launch.roofline``.

The per-device view is the grid the port would launch.  Training
(``launch.mesh.production_grid``, from the ``MeshConfig``'s roles): the
mesh's worker axes are worker ranks, one worker a rank; its FSDP axes
(kimi-k2, chameleon-34b and phi3.5-moe in training) an fsdp axis over
which one worker spans its ranks, each running its slice of the worker's
batch with the whole worker state (the reference splits the batch so,
``batch_sharding_spec``; the state it spreads over "model" only, as
``engine_mem`` sizes it); its "model" axis becomes the engine's row
shards when ``shards`` > 1 (the reference maps it so, with
``EngineConfig(shard_axis="model")``).  Each rank runs its worker's whole
model, given each of rank 0's workers' whole batch; the step takes its
fsdp slice itself (``train.train_loop``).  Serving runs on the serving
grid itself (``launch.mesh.dry_serve_mesh``, the reference's serving
layout): rank 0 holds its block of every weight, of the batch and of the
cache with the tensor axes split (``rank_block`` by ``partition_specs``,
``batch_sharding_spec``, ``cache_specs``; kimi-k2's weights over the
FSDP axes too), the step's collectives are counted on the dry mesh and
priced, and ``chips`` is the whole grid.  The ssm and hybrid families'
SSM blocks split by the ``ssm_inner`` rule and their state by heads
where the heads divide the tensor axis (``models.ssm``), as every
family's rows do.

``engine_mem`` builds the engine state with ``make_engine`` and ``init``
on meta tensors and sizes every buffer under the reference's placement
rule, its fit in the card's memory and its HBM pass time on the card's
constants (``launch.mesh``: NVIDIA H100 SXM5 80GB, 700 W, data sheet),
in the reference's layout (bf16 params, a bf16 Δ for the FSDP archs: the
fields its reader and CI gate use), which is the layout the port trains
(``port`` repeats it, for the readers of the key).  The training steps
run at that layout too: bf16 parameters (``param_dtype``, the
reference's dry run's), so their products are counted and priced as
bf16.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --engine-mem --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape train_4k --mesh single --fn sync
  PYTHONPATH=src python -m repro_torch.launch.dryrun --engine-mem \\
      --arch qwen2-0.5b --shards 8 --moment-dtype bfloat16 \\
      --gate-bytes 700000000

The JSONL rows (``--out``) carry the reference's keys, so one reader
(``scripts/roofline_report.py``, ``scripts/gen_experiments_tables.py``)
serves both packages.  Nothing here calls ``torch.cuda``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree as tree_mod
from repro_torch.comm import collectives as coll
from repro_torch.comm import compressors as comm_mod
from repro_torch.configs import registry
from repro_torch.configs.base import (EngineConfig, HierConfig, InputShape,
                                      MeshConfig, VRLConfig)
from repro_torch.core import engine as engine_mod
from repro_torch.core import schedule as schedule_mod
from repro_torch.kernels import costs
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import (CHIPS_PER_POD, HBM_PER_CHIP,
                                     dry_serve_mesh, production_grid)
from repro_torch.models import transformer
from repro_torch.models.param import abstract
from repro_torch.serve.engine import make_prefill, make_serve_step
from repro_torch.sharding import specs as sh
from repro_torch.sharding.specs import (batch_sharding_spec,  # noqa: F401
                                        cache_specs)
from repro_torch.train.train_loop import make_train_step

META = torch.device("meta")


_entry_axes = sh.entry_axes


# -------------------------------------------------------------- input specs
def input_specs(arch_id: str, shape_id: str, mesh_cfg: MeshConfig,
                cfg=None, shape: Optional[InputShape] = None,
                param_dtype: torch.dtype = torch.bfloat16) -> dict:
    """Meta-tensor stand-ins for every model input of this combination, at
    the global shapes (train: worker-stacked (W, b, S)); ``shape``
    replaces the registry's input shape of ``shape_id``; the codec
    frontend's frames and the decode cache come in ``param_dtype``."""
    cfg = cfg or registry.padded_arch(arch_id, mesh_cfg)
    shape = shape or registry.get_shape(shape_id)
    if shape.kind == "train":
        w = mesh_cfg.num_workers
        return _train_inputs(cfg, w, shape.global_batch // w, shape.seq_len,
                             param_dtype)
    if shape.kind == "prefill":
        return {"tokens": _tokens(cfg, (shape.global_batch, shape.seq_len),
                                  param_dtype)}
    window = _decode_window(cfg, shape)
    return {"tokens": _tokens(cfg, (shape.global_batch, 1), param_dtype),
            "cache": transformer.init_cache(
                cfg, shape.global_batch, shape.seq_len,
                dtype=param_dtype, window=window, device=META),
            "pos": shape.seq_len - 1}


def _tokens(cfg, lead, dtype=torch.bfloat16) -> torch.Tensor:
    """Token ids (int64), or the codec frontend's frame embeddings in
    ``dtype``."""
    if cfg.frontend == "codec":
        return torch.empty((*lead, cfg.frontend_dim), dtype=dtype,
                           device=META)
    return torch.empty(lead, dtype=torch.int64, device=META)


def _train_inputs(cfg, w: int, b: int, s: int,
                  dtype: torch.dtype = torch.bfloat16) -> dict:
    if cfg.frontend == "codec":
        # frame embeddings in the training parameters' dtype (bf16 in the
        # reference's dry run)
        tok = torch.empty((w, b, s, cfg.frontend_dim), dtype=dtype,
                          device=META)
    else:
        tok = torch.empty((w, b, s), dtype=torch.int64, device=META)
    return {"tokens": tok,
            "labels": torch.empty((w, b, s), dtype=torch.int64,
                                  device=META)}


def _decode_window(cfg, shape: InputShape) -> Optional[int]:
    """long_500k needs sub-quadratic attention: SSM/hybrid run natively,
    full-attention archs run the sliding-window variant."""
    if shape.name == "long_500k" and cfg.family not in ("ssm",):
        if cfg.attn_window is not None:
            return cfg.attn_window
        return cfg.long_context_window
    return cfg.attn_window


# ------------------------------------------------------------------ specs
# The production layout's specs (the reference's ``PartitionSpec`` entries
# as tuples) decide what ``lower_one`` runs on rank 0: its block of every
# input and, in serving, of every weight (``rank_block``).
def state_specs(cfg, mesh_cfg: MeshConfig, vrl_cfg: VRLConfig) -> dict:
    """The spec tree of the per-leaf executor's ``WorkerState`` (its
    fields by name; None where the algorithm holds nothing)."""
    pspec = sh.partition_specs(transformer.model_defs(cfg), cfg, mesh_cfg)
    wspec = tree_mod.tree_map(lambda s: sh.worker_stacked_spec(s, mesh_cfg),
                              pspec)
    if vrl_cfg.inner_optimizer == "sgd" and not vrl_cfg.momentum:
        inner = None
    elif vrl_cfg.inner_optimizer == "adam":
        inner = {"mu": wspec, "nu": wspec, "count": ()}
    else:
        inner = wspec
    spec = engine_mod.get_spec(vrl_cfg.algorithm)
    comp, _ = comm_mod.resolve_pair(vrl_cfg)
    comm = None
    if comp is not None:
        comm = {"resid": wspec if comp.error_feedback else None,
                "ref": (None if (spec.grad_all_reduce or spec.sync == "none")
                        else pspec)}
    return {"params": wspec, "delta": wspec, "inner": inner,
            "center": pspec if vrl_cfg.algorithm == "easgd" else None,
            "step": (), "last_sync": (),
            "bias": wspec if engine_mod.use_bias(spec, vrl_cfg) else None,
            "comm": comm}


def rank_block(t: torch.Tensor, spec: tuple, mesh_cfg: MeshConfig,
               tensor: bool = False) -> torch.Tensor:
    """Rank 0's block of a meta tensor laid out by ``spec``: each dim split
    over its entry's ranks, the tensor axes held whole unless ``tensor``
    (serving on the grid splits them; training does not)."""
    sizes = dict(zip(mesh_cfg.axis_names, mesh_cfg.shape))
    skip = () if tensor else tuple(mesh_cfg.tensor_axes)
    return torch.empty(sh.block_shape(t.shape, spec, sizes, skip),
                       dtype=t.dtype, device=META)


# ------------------------------------------------------------- the counter
_NO_TRAFFIC = {torch.ops.aten.empty.memory_format,
               torch.ops.aten.empty_strided.default,
               torch.ops.aten.empty_like.default}


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _unique_bytes(t: torch.Tensor) -> int:
    """Bytes a kernel reads or writes of ``t``: its elements, a broadcast
    (stride 0) dim counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


class Counter(TorchDispatchMode):
    """Counts what a step does on meta tensors, under a ``FlopCounterMode``
    entered just before it: each op's FLOPs are the flop counter's for it
    (so the total is ``FlopCounterMode``'s), filed under the dtype of its
    first tensor operand; the input and output bytes of every op that is
    not a view (nor a bare allocation); and the live bytes: ``baseline``
    (the storages of the state and inputs) plus every storage an op makes,
    until its last tensor is collected, with their peak."""

    def __init__(self, flop_mode: FlopCounterMode, baseline=()):
        super().__init__()
        self.fm = flop_mode
        self.flops = 0
        self.flops_by_dtype: dict = {}
        self.bytes = 0
        self.ops = 0
        self._base, self.base_bytes = set(), 0
        for t in tree_flatten(list(baseline))[0]:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st._cdata not in self._base:
                    self._base.add(st._cdata)
                    self.base_bytes += st.nbytes()
        self._live: dict = {}
        self.live = self.peak = self.base_bytes

    def _total_flops(self) -> int:
        return sum(self.fm.flop_counts["Global"].values())

    def _release(self, key: int) -> None:
        rec = self._live[key]
        rec[1] -= 1
        if rec[1] == 0:
            self.live -= rec[0]
            del self._live[key]

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._base:
            return
        rec = self._live.get(key)
        if rec is None:
            self._live[key] = [st.nbytes(), 1]
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
        else:
            rec[1] += 1
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        before = self._total_flops()
        out = func(*args, **kwargs)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        df = self._total_flops() - before
        if df:
            self.flops += df
            key = _dtype_name(ins[0].dtype) if ins else "float32"
            self.flops_by_dtype[key] = self.flops_by_dtype.get(key, 0) + df
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if not func.is_view and func not in _NO_TRAFFIC:
            self.ops += 1
            self.bytes += sum(_unique_bytes(t) for t in ins + outs)
        for t in outs:
            self._track(t)
        return out


class Counted:
    """What one counted run did: the counter's totals, the engine kernels'
    charges (``kernels.costs.CHARGES``) and the dry mesh's collectives
    (``comm.collectives.COUNTS``)."""

    def __init__(self, counter: Counter, mesh, seconds: float):
        self.flops = counter.flops
        self.flops_by_dtype = dict(counter.flops_by_dtype)
        self.bytes = counter.bytes
        self.ops = counter.ops
        self.peak_bytes = counter.peak
        self.base_bytes = counter.base_bytes
        self.kernels = {k: dict(v, shapes=dict(v["shapes"]))
                        for k, v in costs.CHARGES.items()}
        self.counts = json.loads(json.dumps(coll.COUNTS))
        self.mesh = mesh
        self.seconds = seconds

    def launches(self) -> dict:
        """{kernel: calls}: what the charges say would have launched."""
        return {k: v["calls"] for k, v in self.kernels.items()}


def count(fn, *args, baseline=(), mesh=None) -> tuple:
    """``fn(*args)`` under a fresh counter (the kernels' charges and the
    collectives' counts reset first) -> (its result, ``Counted``)."""
    costs.reset_charges()
    coll.reset_counts()
    if mesh is not None:
        mesh.wire.clear()
    t0 = time.time()
    with FlopCounterMode(display=False) as fm:
        with Counter(fm, baseline=(baseline, args)) as c:
            out = fn(*args)
    return out, Counted(c, mesh, time.time() - t0)


# ------------------------------------------------------------------ result
@dataclasses.dataclass
class DryrunResult:
    arch: str
    shape: str
    mesh: str
    fn: str
    ok: bool
    compile_s: float             # seconds of the counted run on the host
    per_device_bytes: int        # the meta peak of live bytes
    roofline: Optional[rl.Roofline]
    error: str = ""
    compressor: str = ""         # active compressor for this fn's level
    comp_bytes: int = 0          # compressed wire bytes of the sync payload
    counted: Optional[Counted] = None

    def to_json(self) -> dict:
        d = {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "fn": self.fn, "ok": self.ok,
            "compile_s": round(self.compile_s, 2),
            "per_device_bytes": self.per_device_bytes, "error": self.error,
        }
        if self.compressor:
            d.update(compressor=self.compressor, comp_bytes=self.comp_bytes)
        if self.roofline:
            r = self.roofline
            d.update(hlo_flops=r.hlo_flops, hlo_bytes=r.hlo_bytes,
                     coll_bytes=r.coll_bytes, dci_bytes=r.dci_bytes,
                     model_flops=r.model_flops,
                     t_compute=r.t_compute, t_memory=r.t_memory,
                     t_collective=r.t_collective, bottleneck=r.bottleneck,
                     useful_ratio=r.useful_ratio, coll_detail=r.coll_detail,
                     flops_by_dtype=r.flops_by_dtype,
                     kernel_flops=r.kernel_flops, chips=r.chips)
        if self.counted is not None:
            d.update(kernels=self.counted.launches(),
                     collectives=self.counted.counts)
        return d


def _model_flops_train(cfg, shape: InputShape) -> float:
    return 6.0 * cfg.active_param_count() * shape.global_batch * shape.seq_len


def _model_flops_prefill(cfg, shape: InputShape) -> float:
    return 2.0 * cfg.active_param_count() * shape.global_batch * shape.seq_len


def _model_flops_decode(cfg, shape: InputShape) -> float:
    return 2.0 * cfg.active_param_count() * shape.global_batch


# --------------------------------------------------- engine-state memory
def _leaf_per_device(shape, nbytes: int, workers: int, shards: int) -> int:
    """Per-device bytes of one engine-state leaf under the engine's
    placement rules: worker-stacked leading dims ((W, ...) or pod-major
    (P, D, ...)) split over the worker axes, and the row dim (-2) splits
    over the shard axis when ``shape[-2] > 1 and shape[-2] % shards ==
    0``.  Everything else replicates."""
    div = 1
    if len(shape) >= 3 and shape[0] == workers:
        div *= workers                              # (W, R, C) stacks
    elif len(shape) >= 4 and shape[0] * shape[1] == workers:
        div *= workers                              # (P, D, R, C) grids
    if (shards > 1 and len(shape) >= 2
            and shape[-2] > 1 and shape[-2] % shards == 0):
        div *= shards
    return nbytes // div


def _engine_state_bytes(cfg, vrl_cfg: VRLConfig, workers: int,
                        param_dtype: torch.dtype) -> dict:
    """{leaf key: {shape, dtype, bytes, per_device_bytes}} of the flat
    engine's state from parameters in ``param_dtype``, built on meta
    tensors: nothing allocated, so it works at kimi-k2-1t scale on any
    host.  Host integers (the step counters, Adam's count) are no leaves
    here: the port keeps them off the device."""
    template = abstract(transformer.model_defs(cfg), param_dtype)
    eng = engine_mod.make_engine(vrl_cfg, template, device=META)
    state = eng.init(template, workers)
    out = {}
    for key, leaf in tree_mod.state_leaves(state):
        if not isinstance(leaf, torch.Tensor):
            continue
        nb = leaf.numel() * leaf.element_size()
        out[key] = {"shape": list(leaf.shape),
                    "dtype": _dtype_name(leaf.dtype), "bytes": nb,
                    "per_device_bytes": _leaf_per_device(
                        tuple(leaf.shape), nb, workers,
                        vrl_cfg.engine.shards)}
    return out


def engine_mem(arch_id: str, *, algorithm: str = "vrl_sgd",
               inner: str = "adam", workers: int = 0, shards: int = 1,
               moment_dtype: str = "float32", sm3: bool = False,
               clients: int = 0, delta_bf16: bool = False,
               verbose: bool = True) -> dict:
    """The engine-state memory artifact for one (arch, sharding,
    moment-storage) point.  Its fields are the reference's and size its
    layout, which is the one the port trains: bf16 parameters (the
    ``param_dtype`` of both dry runs) and the Δ dtype (bf16 for the FSDP
    archs, or with ``delta_bf16``):

      buffers            — per engine-state leaf: shape, dtype, total bytes,
                           per-device bytes under the placement rules
      total_bytes        — over all workers (what a checkpoint holds)
      per_device_bytes   — what one card persists between steps
      baseline_per_device_bytes, reduction
                         — the same arch at shards=1 / fp32 / no SM3, and
                           baseline / current
      devices_used       — workers × shards cards the placement occupies
      fits_pod           — devices_used <= CHIPS_PER_POD and
                           per_device_bytes <= HBM_PER_CHIP (80 GB, H100)
      t_engine_pass      — the HBM seconds of one fused local step's engine
                           traffic (2 × per-device bytes / 3.35 TB/s)
      client_store_bytes — with ``clients`` = M > 0: the HOST bytes of a
                           client store of M clients behind the W slots
                           (each per-participant leaf × M/W, globals once)
      client_store_rank_bytes
                         — with ``clients``: one rank's store on a grid
                           with ``shards`` row shards (every leaf whose rows
                           split over them ÷ S, the rest whole; the
                           client store's row split, ``launch.mesh
                           .store_block``)

    ``port`` sizes the state the port trains at the same point, the same
    layout (its ``param_dtype``, ``delta_dtype``, ``total_bytes``,
    ``per_device_bytes``, ``fits_pod``, ``t_engine_pass`` equal the fields
    above; the key stays for its readers).
    """
    mesh_cfg = registry.mesh_roles(arch_id, multi_pod=False, serving=False)
    cfg = registry.padded_arch(arch_id, mesh_cfg)
    workers = workers or mesh_cfg.num_workers
    delta_dt = ("bfloat16" if (arch_id in registry._FSDP_ARCHS or delta_bf16)
                else "float32")

    def _cfg(s, mdt, sm, ddt=delta_dt):
        return VRLConfig(algorithm=algorithm, inner_optimizer=inner,
                         update_backend="fused", delta_dtype=ddt,
                         moment_dtype=mdt, sm3=sm,
                         engine=EngineConfig(shards=s))

    def _fits(per_dev):
        return (workers * shards <= CHIPS_PER_POD
                and per_dev <= HBM_PER_CHIP)

    bf16 = torch.bfloat16
    bufs = _engine_state_bytes(cfg, _cfg(shards, moment_dtype, sm3),
                               workers, bf16)
    base = _engine_state_bytes(cfg, _cfg(1, "float32", False), workers,
                               bf16)
    per_dev = sum(b["per_device_bytes"] for b in bufs.values())
    base_dev = sum(b["per_device_bytes"] for b in base.values())
    total = sum(b["bytes"] for b in bufs.values())
    devices = workers * shards
    art = {
        "arch": arch_id, "algorithm": algorithm, "inner": inner,
        "workers": workers, "shards": shards,
        "moment_dtype": moment_dtype, "sm3": sm3,
        "delta_dtype": delta_dt,
        "buffers": bufs,
        "total_bytes": total,
        "per_device_bytes": per_dev,
        "baseline_per_device_bytes": base_dev,
        "reduction": round(base_dev / per_dev, 2) if per_dev else 0.0,
        "devices_used": devices,
        "hbm_per_chip": HBM_PER_CHIP, "chips_per_pod": CHIPS_PER_POD,
        "fits_pod": _fits(per_dev),
        "t_engine_pass": rl.engine_pass_time(per_dev),
        "port": {"param_dtype": "bfloat16", "delta_dtype": delta_dt,
                 "total_bytes": total, "per_device_bytes": per_dev,
                 "fits_pod": _fits(per_dev),
                 "t_engine_pass": rl.engine_pass_time(per_dev)},
    }
    if clients:
        if clients < workers:
            raise ValueError(f"clients ({clients}) must be >= workers "
                             f"({workers}) — the cohort size is the "
                             f"worker count")
        store = rank = 0
        for b in bufs.values():
            per_participant = (len(b["shape"]) >= 3
                               and b["shape"][0] == workers)
            nb = (b["bytes"] // workers * clients if per_participant
                  else b["bytes"])
            store += nb
            rows = b["shape"][-2] if len(b["shape"]) >= 2 else 1
            rank += (nb // shards if shards > 1 and rows > 1
                     and rows % shards == 0 else nb)
        art["clients"] = clients
        art["client_store_bytes"] = store
        art["client_store_rank_bytes"] = rank
    if verbose:
        extra = (f", client store {art['client_store_bytes']/2**30:.2f} "
                 f"GiB host (M={clients})"
                 + (f", {art['client_store_rank_bytes']/2**30:.2f} a rank "
                    f"of {shards} row shards" if shards > 1 else "")
                 if clients else "")
        print(f"[engine-mem] {arch_id} {algorithm}/{inner} W={workers} "
              f"shards={shards} moments={moment_dtype}"
              f"{'+sm3' if sm3 else ''}: the reference's layout and the "
              f"port's (bf16 params, {delta_dt} Δ) "
              f"{per_dev/2**30:.2f} GiB/device (baseline "
              f"{base_dev/2**30:.2f}, {art['reduction']}x), {devices} "
              f"chips, fits_pod={art['fits_pod']}{extra}")
    return art


# ------------------------------------------------------------------- lower
TRAIN_FNS = ("train", "local", "sync", "sync1", "sync2", "round")


def lower_one(arch_id: str, shape_id: str, *, multi_pod: bool,
              vrl_cfg: Optional[VRLConfig] = None,
              fn_kind: Optional[str] = None, verbose: bool = True,
              algorithm: str = "vrl_sgd",
              comm_period: int = 20, k1: int = 5, k2: int = 20,
              comm_schedule: Optional[str] = None, round_k: int = 0,
              backend: str = "fused",
              overlap: bool = False, deadline: float = 0.0,
              compress: Optional[str] = None,
              compress2: Optional[str] = None,
              shards: int = 1, moment_dtype: str = "float32",
              sm3: bool = False,
              mesh_override: Optional[dict] = None,
              cfg_override: Optional[dict] = None, tag: str = "",
              last_only: bool = False, no_remat: bool = False,
              one_process: bool = False,
              shape_override: Optional[InputShape] = None,
              allow_tf32: Optional[bool] = None,
              param_dtype: torch.dtype = torch.bfloat16) -> DryrunResult:
    """Run one combination's step on meta tensors and count it.  fn_kind in
    {train, local, sync, sync1, sync2, round, prefill, decode} (default by
    the shape's kind; sync1/sync2 are the hierarchy's per-level syncs and
    need ``algorithm="hier_vrl_sgd"``; "round" is ``round_step``: one
    round of ``round_k`` (default the period, k1 for the hierarchy) local
    steps and its sync; "train" is one ``train_step`` from a fresh state,
    which under VRL-SGD-W's first period of 1 syncs after it).

    The train family runs on the dry engine mesh (``launch.mesh
    .production_grid``) as rank 0: one worker a rank over the mesh's
    worker axes, times its FSDP axes' ranks (one worker over them, each
    running its slice of the worker's batch), times ``shards`` row-shard
    ranks, each given rank 0's workers' whole batches (``rank_block``
    over the worker axes; the step takes its fsdp slice by
    ``batch_sharding_spec``'s rule); serving runs on the dry serving grid
    as its rank 0 (``launch.mesh.dry_serve_mesh``), with its blocks of the
    weights, the batch and the cache (``partition_specs``,
    ``batch_sharding_spec``, ``cache_specs``).
    ``one_process`` runs the
    whole batch in one process instead, with no mesh (as a one-card run
    does).  ``mesh_override`` replaces fields of the arch's
    ``MeshConfig``, ``shape_override`` the input shape, ``cfg_override``
    fields of the padded model (``num_layers`` cuts depth).  The training
    steps hold their parameters in ``param_dtype`` (bf16 by default, the
    reference's dry run's; the engine's kernels take it) with a bf16 Δ for
    the FSDP archs (``registry._FSDP_ARCHS``), as the reference's;
    serving holds ``param_dtype`` parameters and caches (bf16, as the
    reference's dry run, by default).
    ``backend`` is the update backend ("fused": the kernels' wrappers,
    which charge their calls on meta tensors).  ``allow_tf32`` prices the
    fp32 products at the TF32 rate (default: PyTorch's current setting)."""
    shape = shape_override or registry.get_shape(shape_id)
    serving = fn_kind in ("prefill", "decode") or (
        fn_kind is None and shape.kind != "train")
    mesh_cfg = registry.mesh_roles(arch_id, multi_pod=multi_pod,
                                   serving=serving)
    if mesh_override:
        mesh_cfg = dataclasses.replace(mesh_cfg, **mesh_override)
    cfg = registry.padded_arch(arch_id, mesh_cfg)
    if cfg_override:
        cfg = dataclasses.replace(cfg, **cfg_override)
    if fn_kind is None:
        fn_kind = {"train": "train", "prefill": "prefill",
                   "decode": "decode"}[shape.kind]
    if allow_tf32 is None:
        allow_tf32 = bool(torch.backends.cuda.matmul.allow_tf32)
    mesh_name = "multi" if multi_pod else "single"
    name = f"{arch_id}/{shape_id}/{mesh_name}/{fn_kind}"
    if tag:
        name += f"/{tag}"
    if compress2 and algorithm != "hier_vrl_sgd":
        raise ValueError("--compress2 drives the hierarchical cross-pod "
                         "sync2; flat algorithms have one level "
                         "(--compress)")
    if shards > 1 and shards != mesh_cfg.tensor_size:
        raise ValueError(f"engine shards={shards} ride the mesh's tensor "
                         f"axis {mesh_cfg.tensor_axes} of size "
                         f"{mesh_cfg.tensor_size}: they must be equal")

    def block(t, spec):
        return t if one_process else rank_block(t, spec, mesh_cfg)

    eng_spec, mesh, rk = None, None, 0
    if fn_kind in TRAIN_FNS:
        w = mesh_cfg.num_workers
        sizes = dict(zip(mesh_cfg.axis_names, mesh_cfg.shape))
        pods = sizes.get("pod", 1)
        hier = None
        if algorithm == "hier_vrl_sgd" and vrl_cfg is None:
            hier = HierConfig(k1=k1, k2=k2, grid=(pods, w // pods))
        sched = (schedule_mod.parse_schedule(comm_schedule, comm_period)
                 if comm_schedule else None)
        vrl_cfg = vrl_cfg or VRLConfig(
            algorithm=algorithm, comm_period=comm_period, hier=hier,
            comm_schedule=sched, update_backend=backend,
            overlap=overlap, deadline=deadline,
            compress=(comm_mod.parse_compressor(compress) if compress
                      else None),
            compress2=(comm_mod.parse_compressor(compress2) if compress2
                       else None),
            moment_dtype=moment_dtype, sm3=sm3,
            engine=EngineConfig(shards=shards),
            delta_dtype=("bfloat16" if arch_id in registry._FSDP_ARCHS
                         else "float32"))
        if vrl_cfg.membership:
            raise NotImplementedError(
                "membership reads the active mask on the host at every "
                "masked sync (comm.collectives.masked_sum): a meta tensor "
                "holds no mask to read")
        hier_on = vrl_cfg.algorithm == "hier_vrl_sgd"
        if not one_process:
            mesh = coll.DryMesh(*production_grid(
                mesh_cfg, pods=engine_mod.hier_config(vrl_cfg).grid[0]
                if hier_on else 0, shards=vrl_cfg.engine.shards))
        bundle = make_train_step(cfg, vrl_cfg, remat=not no_remat,
                                 device=META, mesh=mesh,
                                 param_dtype=param_dtype)
        if bundle.engine is None:
            raise NotImplementedError(
                "update_backend='reference' (the per-leaf executor) is "
                "single-process and has no engine to count on a mesh")
        eng_spec = bundle.engine.spec
        state = bundle.engine.init(
            abstract(transformer.model_defs(cfg), param_dtype), w)
        if fn_kind in ("sync", "sync1", "sync2"):
            step_fn = {"sync": bundle.sync_step, "sync1": bundle.sync1_step,
                       "sync2": bundle.sync2_step}[fn_kind]
            if step_fn is None:
                raise ValueError(f"fn_kind {fn_kind!r} requires hier_vrl_sgd")
            args = (state,)
        else:
            ins = input_specs(arch_id, shape_id, mesh_cfg, cfg, shape=shape,
                              param_dtype=param_dtype)
            spec = batch_sharding_spec(mesh_cfg, shape.global_batch // w,
                                       ins["tokens"].dim() - 2,
                                       worker_stacked=True)
            # each worker's whole batch: the step takes its fsdp slice
            spec = (spec[0], None, *spec[2:])
            if fn_kind == "round":
                hcfg = engine_mod.hier_config(vrl_cfg)
                rk = round_k or (hcfg.k1 if hier_on else vrl_cfg.comm_period)
                # k steps' batches stacked on a leading (unsplit) dim
                ins = {key: torch.empty((rk, *t.shape), dtype=t.dtype,
                                        device=META)
                       for key, t in ins.items()}
                spec = (None, *spec)
                step_fn = bundle.round_step
            else:
                step_fn = (bundle.train_step if fn_kind == "train"
                           else bundle.local_step)
            args = (state, block(ins["tokens"], spec),
                    block(ins["labels"], spec))
        _, counted = count(step_fn, *args, mesh=mesh)
        mf = _model_flops_train(cfg, shape)
        if fn_kind in ("sync", "sync1", "sync2"):
            mf = 0.0
        elif fn_kind == "round":
            mf *= rk
        chips = math.prod(mesh.shape) if mesh is not None else 1
    elif fn_kind in ("prefill", "decode"):
        params = abstract(transformer.model_defs(cfg), param_dtype)
        ins = input_specs(arch_id, shape_id, mesh_cfg, cfg,
                          shape=dataclasses.replace(shape, kind=fn_kind),
                          param_dtype=param_dtype)
        spec = batch_sharding_spec(mesh_cfg, shape.global_batch,
                                   ins["tokens"].dim() - 1,
                                   worker_stacked=False)
        groups, chips = None, 1
        if not one_process:
            smesh = dry_serve_mesh(mesh_cfg)
            mesh, groups = smesh.mesh, smesh.groups(shape.global_batch)
            params = tree_mod.tree_map(
                lambda t, s: rank_block(t, s, mesh_cfg, tensor=True),
                params, smesh.specs(cfg))
            chips = math.prod(mesh_cfg.shape)

        def block(t, spec):
            return t if one_process else rank_block(t, spec, mesh_cfg,
                                                    tensor=True)
        tokens = block(ins["tokens"], spec)
        if fn_kind == "prefill":
            fn = make_prefill(cfg, shape.seq_len, last_only=last_only,
                              groups=groups)
            args = (params, tokens)
            mf = _model_flops_prefill(cfg, shape)
        else:
            window = _decode_window(cfg, shape)
            eff = window if window is not None else shape.seq_len
            cspec = cache_specs(cfg, mesh_cfg, shape.global_batch,
                                min(eff, shape.seq_len))
            cache = tree_mod.tree_map(block, ins["cache"], cspec)
            if not one_process:
                # the block the step reads; a cache whose slots do not
                # split over the tensor ranks is refused there
                want = transformer.init_cache(
                    cfg, tokens.shape[0], shape.seq_len, dtype=param_dtype,
                    window=window, device=META, tp=groups["tp"])
                if tree_mod.tree_map(lambda t: t.shape, cache) != \
                        tree_mod.tree_map(lambda t: t.shape, want):
                    raise ValueError("the cache's spec block is not the "
                                     "block the serving step reads")
            fn = make_serve_step(cfg, window=window, groups=groups)
            args = (params, cache, tokens, ins["pos"])
            mf = _model_flops_decode(cfg, shape)
        with torch.no_grad():
            _, counted = count(fn, *args, mesh=mesh)
    else:
        raise ValueError(fn_kind)

    roof = rl.analyze(name, counted, mf, chips, mesh=mesh,
                      overlap=(fn_kind == "round" and vrl_cfg.overlap),
                      allow_tf32=allow_tf32)
    comp_label, comp_bytes = "", 0
    if eng_spec is not None:
        c1, c2 = comm_mod.resolve_pair(vrl_cfg)
        level_comp = c2 if fn_kind == "sync2" else c1
        if level_comp is not None and fn_kind != "local":
            comp_label = level_comp.label()
            comp_bytes = comm_mod.wire_bytes(
                level_comp, rows=eng_spec.rows, lanes=eng_spec.lanes,
                size=eng_spec.size, itemsize=4)
    res = DryrunResult(arch=arch_id, shape=shape_id, mesh=mesh_name,
                       fn=fn_kind + (f"+{tag}" if tag else ""), ok=True,
                       compile_s=counted.seconds,
                       per_device_bytes=int(counted.peak_bytes),
                       roofline=roof, compressor=comp_label,
                       comp_bytes=comp_bytes, counted=counted)
    if verbose:
        comp_note = (f"  wire[{comp_label}]={comp_bytes/2**20:.2f} MiB"
                     if comp_label else "")
        print(f"[{name}] counted {counted.seconds:.1f}s  mem/device "
              f"{res.per_device_bytes/2**30:.2f} GiB  flops "
              f"{roof.hlo_flops:.4g}  bytes {roof.hlo_bytes:.4g}  coll "
              f"{roof.coll_bytes:.4g} (IB {roof.dci_bytes:.4g})  "
              f"bottleneck={roof.bottleneck}  terms(ms) "
              f"c={roof.t_compute*1e3:.3f} m={roof.t_memory*1e3:.3f} "
              f"coll={roof.t_collective*1e3:.3f}  kernels "
              f"{counted.launches()}" + comp_note)
    return res


FN_KINDS_BY_SHAPE = {
    "train_4k": ["train", "local", "sync"],
    "prefill_32k": ["prefill"],
    "decode_32k": ["decode"],
    "long_500k": ["decode"],
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="The port's dry run: steps counted on meta tensors at "
                    "the production layout, and the engine-state memory.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--fn", default=None,
                    help="train|local|sync|sync1|sync2|round|prefill|decode "
                         "(default by shape; sync1/sync2 need hier_vrl_sgd; "
                         "round = one round of local steps and its sync)")
    ap.add_argument("--all", action="store_true",
                    help="run the full arch x shape matrix")
    ap.add_argument("--algorithm", default="vrl_sgd",
                    choices=sorted(engine_mod.ALGO_SPECS))
    ap.add_argument("--backend", default="fused",
                    choices=["fused", "reference", "xla", "auto"],
                    help="update backend of the train steps (fused: the "
                         "kernels' wrappers, charged on meta tensors)")
    ap.add_argument("--k1", type=int, default=5,
                    help="hier_vrl_sgd intra-pod period")
    ap.add_argument("--k2", type=int, default=20,
                    help="hier_vrl_sgd cross-pod period")
    ap.add_argument("--comm-schedule", default=None,
                    help="stagewise round schedule (const|stagewise[:k0:"
                         "rounds:k_max]|custom:kxr,..)")
    ap.add_argument("--overlap", action="store_true",
                    help="the overlapped round (fn=round): the roofline "
                         "prices only the exposed collective remainder")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="straggler miss probability (requires --overlap)")
    ap.add_argument("--round-k", type=int, default=0,
                    help="fn=round: the round's length (0 = the period)")
    ap.add_argument("--compress", default=None,
                    help="sync-payload compressor (none|int8|topk[:rate]"
                         "[:noef]); rows gain its wire bytes")
    ap.add_argument("--compress2", default=None,
                    help="the cross-pod sync2 compressor (hier_vrl_sgd; "
                         "default: --compress)")
    ap.add_argument("--shards", type=int, default=1,
                    help="row-shard the engine state over the mesh's "
                         "'model' axis (must equal its size when > 1); "
                         "also sets the --engine-mem placement")
    ap.add_argument("--moment-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="inner-optimizer moment storage dtype")
    ap.add_argument("--sm3", action="store_true",
                    help="SM3-factored adam second moment")
    ap.add_argument("--engine-mem", action="store_true",
                    help="emit the engine-state memory artifact (meta "
                         "tensors only, works at kimi-k2-1t scale): per-"
                         "buffer and per-device bytes, the unsharded-fp32 "
                         "baseline and reduction, and the fit in the H100's "
                         "80 GB.  Appends one JSON line per arch to --out")
    ap.add_argument("--inner", default="adam",
                    choices=["sgd", "momentum", "adam"],
                    help="--engine-mem inner optimizer")
    ap.add_argument("--workers", type=int, default=0,
                    help="--engine-mem worker count (0 = the arch's "
                         "single-pod mesh role)")
    ap.add_argument("--clients", type=int, default=0,
                    help="--engine-mem: also size the HOST client store of "
                         "M clients behind the W worker slots")
    ap.add_argument("--gate-bytes", type=int, default=0,
                    help="--engine-mem gate: exit 1 if any arch's "
                         "per-device engine bytes in the reference's layout "
                         "(bf16 params, the port's too) exceed this budget")
    ap.add_argument("--tag", default="", help="label for this variant")
    ap.add_argument("--no-remat", action="store_true",
                    help="no activation recomputation in the train steps")
    ap.add_argument("--delta-bf16", action="store_true",
                    help="--engine-mem: hold Δ in bf16 (the FSDP archs "
                         "always do)")
    ap.add_argument("--last-only", action="store_true",
                    help="prefill emits last-position logits only")
    ap.add_argument("--two-layer", action="store_true",
                    help="run the model at 2 layers")
    ap.add_argument("--out", default=None, help="append JSONL results here")
    args = ap.parse_args(argv)

    archs = registry.list_archs() if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(registry.INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if args.mesh == "both" else [args.mesh == "multi"]

    if args.engine_mem:
        over_budget = []
        for arch in archs:
            art = engine_mem(arch, algorithm=args.algorithm,
                             inner=args.inner, workers=args.workers,
                             shards=args.shards,
                             moment_dtype=args.moment_dtype, sm3=args.sm3,
                             clients=args.clients,
                             delta_bf16=args.delta_bf16)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(art) + "\n")
            if not args.gate_bytes:
                continue
            per_dev = art["per_device_bytes"]
            print(f"engine-mem gate {arch}: the reference's layout, which "
                  f"the port trains, {per_dev} B/device, "
                  f"{'over' if per_dev > args.gate_bytes else 'within'} "
                  f"{args.gate_bytes}")
            if art["per_device_bytes"] > args.gate_bytes:
                over_budget.append(f"{arch}: {art['per_device_bytes']} > "
                                   f"{args.gate_bytes}")
        if over_budget:
            print("engine-mem gate FAILED (the reference's layout):\n  "
                  + "\n  ".join(over_budget), file=sys.stderr)
            return 1
        print(f"engine-mem: {len(archs)} arch(s) OK"
              + (f" (gate {args.gate_bytes} B/device, the reference's "
                 f"layout)" if args.gate_bytes else ""))
        return 0

    cfg_override = {}
    if args.two_layer:
        cfg_override["num_layers"] = 2
    results, failures = [], 0
    for arch in archs:
        for shape in shapes:
            fns = [args.fn] if args.fn else FN_KINDS_BY_SHAPE[shape]
            for multi in meshes:
                for fn_kind in fns:
                    try:
                        res = lower_one(
                            arch, shape, multi_pod=multi, fn_kind=fn_kind,
                            algorithm=args.algorithm,
                            backend=args.backend, k1=args.k1, k2=args.k2,
                            overlap=args.overlap, deadline=args.deadline,
                            comm_schedule=args.comm_schedule,
                            round_k=args.round_k, compress=args.compress,
                            compress2=args.compress2, shards=args.shards,
                            moment_dtype=args.moment_dtype, sm3=args.sm3,
                            cfg_override=cfg_override or None,
                            tag=args.tag or ("l2" if args.two_layer
                                             else ""),
                            last_only=args.last_only,
                            no_remat=args.no_remat)
                    except Exception as e:  # noqa: BLE001
                        failures += 1
                        mesh_name = "multi" if multi else "single"
                        fl = fn_kind + (f"+{args.tag}" if args.tag
                                        else "")
                        res = DryrunResult(
                            arch=arch, shape=shape, mesh=mesh_name,
                            fn=fl, ok=False, compile_s=0.0,
                            per_device_bytes=-1, roofline=None,
                            error=f"{type(e).__name__}: {e}"[:500])
                        print(f"[FAIL] {arch}/{shape}/{mesh_name}/{fn_kind}: "
                              f"{res.error}", file=sys.stderr)
                    results.append(res)
                    if args.out:
                        with open(args.out, "a") as f:
                            f.write(json.dumps(res.to_json()) + "\n")
    print(f"\ndry-run complete: {len(results) - failures}/{len(results)} OK")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
