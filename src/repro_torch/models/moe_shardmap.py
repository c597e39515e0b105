"""The shard-mapped MoE dispatch over a (data, model) rank grid
(``repro.models.moe_shardmap``).

The reference runs the layer under ``shard_map``; here every rank of a
``comm.collectives.WorkerMesh`` over ("data", "model") runs the block
itself, on its own blocks of the arrays:

  tokens split over "data" ((T / D, d) a rank); experts split over
  "model" and their d dimension over "data" (w_gate, w_up (E / M, d / D,
  ff); w_down (E / M, ff, d / D)); the router whole on every rank.

  per (data j, model i) rank:
    1. all-gather its experts' weights over "data" (w_gate and w_up on
       dim 1, w_down on dim 2);
    2. route its local tokens (``moe.route``: weights, ids over all E
       experts, the aux loss of these tokens);
    3. dispatch locally, keeping only the entries of its E / M experts
       (``moe.dispatch_compute``: other experts' entries sort last and are
       masked like drops, capacity ``moe.capacity(cfg, T / D)``; the
       token side a permutation, so a forward and backward are run-to-run
       bitwise on the card);
    4. sum the partial outputs over "model"; the aux loss is averaged
       over "data".

The collectives carry the gradient (the sums are
``torch.distributed.nn.functional``'s all-reduce, the weight gather a
Function of its own whose backward sums over "data"): the backward of
every rank is that of the sum over ranks of each rank's loss.  So an
expert weight block's gradient is whole on the rank that holds it, while
a token's gradient is split over the "model" ranks that routed it and the
router's over every rank (sum them to get the whole), and a loss that
every model rank computes from the same output should carry 1 / M of its
weight, the aux loss 1 / (D · M).  Each collective is counted under kind
"moe" (``comm.collectives.COUNTS``): three weight gathers over "data" and
the output sum over "model" a call, the aux mean over "data", and in a
backward the sums of those gathers' gradients.  Under gloo a CUDA tensor
goes through host memory.
"""
from __future__ import annotations

import torch
import torch.distributed.nn.functional as dist_nn

from repro_torch.comm import collectives as coll
from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe

# the expert weights' dims split over "model" (experts) and "data"
_SPLIT = {"w_gate": 1, "w_up": 1, "w_down": 2}


def shard_params(p: dict, mesh, data_axis: str = "data",
                 model_axis: str = "model") -> dict:
    """This rank's blocks of a whole MoE layer's parameters ``p``: the
    router whole, each expert weight's experts over ``model_axis`` and its
    d dimension over ``data_axis`` (contiguous copies)."""
    (j, i), (dn, mn) = (mesh.index((data_axis, model_axis)),
                        (mesh.size((data_axis,)), mesh.size((model_axis,))))
    out = {"router": p["router"]}
    for name, dim in _SPLIT.items():
        w = p[name]
        e, n = w.shape[0] // mn, w.shape[dim] // dn
        out[name] = w[i * e:(i + 1) * e].narrow(dim, j * n, n).contiguous()
    return out


def shard_tokens(x: torch.Tensor, mesh,
                 data_axis: str = "data") -> torch.Tensor:
    """This rank's block of the (T, d) tokens over ``data_axis``."""
    j, n = mesh.index((data_axis,))[0], x.shape[0] // mesh.size((data_axis,))
    return x[j * n:(j + 1) * n]


class _Gather(torch.autograd.Function):
    """Every rank's block of ``x`` over ``group`` joined along ``dim``;
    the backward sums the whole gradient over the group and keeps this
    rank's block (torch.distributed.nn's gather falls back under gloo on a
    scatter that names the group's ranks by their index, which a subgroup
    refuses)."""

    @staticmethod
    def forward(ctx, x, dim, mesh, axis):
        ctx.dim, ctx.mesh, ctx.axis = dim, mesh, axis
        ctx.block = (mesh.index((axis,))[0], x.shape[dim])
        parts = mesh.all_gather(x, kind="moe", axes=(axis,))
        return torch.cat(list(parts.unbind(0)), dim)

    @staticmethod
    def backward(ctx, g):
        gw = g.to(coll.wire_device(ctx.mesh), copy=True).contiguous()
        ctx.mesh.all_reduce(gw, (ctx.axis,), kind="moe")
        j, n = ctx.block
        return gw.narrow(ctx.dim, j * n, n).to(g.device), None, None, None


def _gather(mesh, w: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """``w``'s blocks over ``axis`` joined along ``dim`` (counted "moe")."""
    return _Gather.apply(w, dim, mesh, axis)


def _sum(mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """Σ of ``x`` over the ranks of ``axis`` (counted "moe")."""
    mesh.count(x, (axis,), "moe")
    return dist_nn.all_reduce(x.to(coll.wire_device(mesh)),
                              group=mesh.group((axis,))).to(x.device)


def moe_mlp_shardmap(cfg: ModelConfig, p: dict, x: torch.Tensor, mesh,
                     data_axis: str = "data", model_axis: str = "model"):
    """The MoE layer on this rank's blocks.

    ``p``: this rank's parameter blocks (``shard_params``); ``x``: its
    (T / D, d) tokens (``shard_tokens``).  Returns (y, aux): this rank's
    (T / D, d) output rows, the same on every model rank, and the aux
    loss averaged over the data ranks."""
    if cfg.num_shared_experts:
        raise ValueError("moe_mlp_shardmap dispatches the routed experts "
                         "only (as the reference's); a config with shared "
                         "experts runs through moe.moe_mlp")
    e_loc = cfg.num_experts // mesh.size((model_axis,))
    wg = _gather(mesh, p["w_gate"], 1, data_axis)
    wu = _gather(mesh, p["w_up"], 1, data_axis)
    wd = _gather(mesh, p["w_down"], 2, data_axis)
    weights, ids, aux = moe.route(cfg, p["router"], x)
    shard = mesh.index((model_axis,))[0]
    y_part = moe.dispatch_compute(cfg, x, weights, ids, wg, wu, wd, e_loc,
                                  shard)
    y = _sum(mesh, y_part, model_axis)
    aux = _sum(mesh, aux, data_axis) / mesh.size((data_axis,))
    return y, aux
