"""Roofline of a dry-run step (``repro.launch.roofline``), on the card's
constants (``launch.mesh``: NVIDIA H100 SXM5 80GB, 700 W, data sheet).

Three terms, each in seconds, per device and per step:

  compute    = Σ_dtype products' FLOPs / that dtype's peak
               + the engine kernels' fp32 operations / PEAK_FLOPS_FP32
  memory     = bytes / HBM_BW
  collective = NVLink-tier bytes / NVLINK_BW + IB-tier bytes / IB_BW

The products run at the bf16 peak in bf16 (and fp16), at the TF32 peak in
fp32 where ``torch.backends.cuda.matmul.allow_tf32`` is on, else at the
fp32 CUDA-core peak (the port trains in fp32 with TF32 off).  The counts
come from the dry run (``launch.dryrun``), which runs the port's own step
on meta tensors: no HLO to parse.  A collective group is priced by where
its ranks lie: ranks are laid out row-major over the grid, the last axis
fastest, ``GPUS_PER_NODE`` to a node; a group within one node rides
NVLink, any other InfiniBand.  Like the reference, the term counts each
collective's output bytes over the link's bandwidth.
"""
from __future__ import annotations

import dataclasses

from repro_torch.launch.mesh import (GPUS_PER_NODE, HBM_BW, IB_BW,
                                     NVLINK_BW, PEAK_FLOPS_BF16,
                                     PEAK_FLOPS_FP32, PEAK_FLOPS_TF32)


def peak_flops(dtype: str, allow_tf32: bool = False) -> float:
    """The card's peak rate for products in ``dtype`` (a torch dtype's
    name without the ``torch.`` prefix)."""
    if dtype in ("bfloat16", "float16"):
        return PEAK_FLOPS_BF16
    if dtype == "float32" and allow_tf32:
        return PEAK_FLOPS_TF32
    return PEAK_FLOPS_FP32


def link_bw(ranks) -> float:
    """NVLink's bandwidth for a group whose ranks sit within one node,
    InfiniBand's for any other."""
    return NVLINK_BW if len({r // GPUS_PER_NODE for r in ranks}) <= 1 \
        else IB_BW


@dataclasses.dataclass
class Roofline:
    name: str
    hlo_flops: float            # per device: the counted products' FLOPs
    hlo_bytes: float            # per device: aten ops' and kernels' bytes
    coll_bytes: float           # per device: collectives' output bytes
    model_flops: float          # 6·N_active·D, whole step, all devices
    chips: int                  # ranks of the grid the port would launch
    dci_bytes: float = 0.0      # share of coll_bytes on the inter-node
                                # (InfiniBand) tier
    coll_detail: dict = dataclasses.field(default_factory=dict)
    overlap: bool = False       # overlapped rounds: the sync collective
                                # runs concurrently with the local steps,
                                # hidden up to min(coll, k·local)
    flops_by_dtype: dict = dataclasses.field(default_factory=dict)
    kernel_flops: float = 0.0   # the engine kernels' fp32 operations
    allow_tf32: bool = False

    @property
    def t_compute(self) -> float:
        t = sum(f / peak_flops(dt, self.allow_tf32)
                for dt, f in self.flops_by_dtype.items())
        return t + self.kernel_flops / PEAK_FLOPS_FP32

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        """Each byte at its tier: the inter-node share at InfiniBand's
        bandwidth, the rest at NVLink's."""
        nv = max(self.coll_bytes - self.dci_bytes, 0.0)
        return nv / NVLINK_BW + self.dci_bytes / IB_BW

    @property
    def t_coll_hidden(self) -> float:
        """Collective time hidden behind the round's local steps under
        overlapped rounds: up to min(coll, k·local), k·local the larger of
        the compute and memory terms.  0 when overlap is off."""
        if not self.overlap:
            return 0.0
        return min(self.t_collective, max(self.t_compute, self.t_memory))

    @property
    def t_coll_exposed(self) -> float:
        return self.t_collective - self.t_coll_hidden

    @property
    def bottleneck(self) -> str:
        """The largest term, the collective at its exposed time."""
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_coll_exposed}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0


def engine_pass_time(per_device_engine_bytes: float) -> float:
    """HBM time of one fused local step's engine-state traffic: the flat
    buffers stream through once and are written back in place, 2× the
    per-device engine bytes over HBM bandwidth."""
    return 2.0 * per_device_engine_bytes / HBM_BW


def analyze(name: str, counted, model_flops: float, chips: int,
            mesh=None, overlap: bool = False,
            allow_tf32: bool = False) -> Roofline:
    """The roofline of a counted step.  ``counted``: the dry run's counts
    (``flops_by_dtype``, ``bytes``, ``kernels`` — the engine kernels'
    charges); ``mesh``: the ``DryMesh`` it ran on (None: one process, no
    collective), whose ``wire`` gives each group's output bytes, priced by
    the group's span (``link_bw``)."""
    coll, dci, detail = 0.0, 0.0, {}
    if mesh is not None:
        for (op, kind, label), nb in sorted(mesh.wire.items()):
            detail[f"{op}/{kind}/{label}"] = nb
            coll += nb
            if link_bw(mesh.group_ranks(tuple(label.split("+")))) == IB_BW:
                dci += nb
    detail["total"] = coll
    kb = sum(r["bytes"] for r in counted.kernels.values())
    kf = sum(r["flops"] for r in counted.kernels.values())
    return Roofline(name=name, hlo_flops=float(counted.flops),
                    hlo_bytes=float(counted.bytes + kb), coll_bytes=coll,
                    model_flops=model_flops, chips=chips, dci_bytes=dci,
                    coll_detail=detail, overlap=overlap,
                    flops_by_dtype=dict(counted.flops_by_dtype),
                    kernel_flops=float(kf), allow_tf32=allow_tf32)
