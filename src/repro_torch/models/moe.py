"""Top-k routed mixture-of-experts MLP (``repro.models.moe``).

Dispatch is capacity-bounded and sort-based, as the reference's: the
router in fp32 (softmax, then top-k, the weights renormalised over k), a
stable sort of the flat expert ids, each entry's position within its
expert's block by ``searchsorted``, entries past the capacity dropped
(masked to zero and parked at slot ``cap - 1`` of expert 0), an
(experts, capacity, d) buffer, three batched expert products, and the router-weighted combine;
the shared experts run densely.  The residual path keeps a dropped token
intact.  ``dispatch_compute`` is the routed part over a block of the
experts (all of them here; one model rank's in ``models.moe_shardmap``,
the reference's explicit sharding).  The reference's ``maybe_constrain``
sharding hints have no counterpart.

One worker's batch over several ranks (``group``: a
``comm.collectives.MeshGroup`` over the worker's fsdp ranks, each holding
a contiguous slice of the worker's tokens, rank f the f-th): the layer
computes what one process computes on the whole batch.  The capacity is
the whole batch's, ``capacity(cfg, T·F)``; each entry's position within
its expert is offset by the entries that earlier ranks route to that
expert (one all-gather of the (E,) counts), so the kept and dropped
entries are exactly one process's, whose stable sort runs over the whole
batch in token order; a rank's buffer holds only its own entries, at
most min(capacity, T) an expert.  The aux loss takes f_e and p_e as means
over the whole batch (one all-reduce of the 2E sums), and its gradient
comes out once over the group (``MeshGroup.sum``).  Under remat both
collectives run again in the recompute, on the same operands.

Serving on a rank grid (``moe_mlp(..., tp=, fsdp=, group=)``, this
rank's blocks of the weights, ``sharding.specs.rank_params``): the
experts split over the tensor ranks ``tp`` where they divide them (the
reference's ``axis_rules``), each rank dispatching to its E/t
(``dispatch_compute``, as ``models.moe_shardmap`` does), then one sum
over ``tp``; the keep and drop are one process's over the whole served
batch, split over ``group`` as above; the shared experts ("ff" whole when
the experts split) run once on every tensor rank and are added after the
sum (``_tp_combine``); with ``fsdp`` (kimi-k2's 2D layout) the router's,
the experts' and the shared experts' d dims are all-gathered over it,
each weight just before its product.  The aux loss of a serving call is
this rank's tokens' (serving drops it, as the reference's).

Determinism on the card.  The reference gathers ``x[token]`` with k
entries per token and combines with ``y.at[token].add(...)``: both the
combine and the gather's backward are scatter-adds with k collisions per
token, which CUDA adds in no fixed order.  Here the token side is a
permutation instead: x is expanded to (T, k, d) and its rows reordered by
the sort (``_permute``, whose backward gathers by the inverse
permutation), and the combine reorders the sorted rows back to (T, k, d)
and sums the k weighted rows.  The expand's backward is a reduction, a
permutation's backward writes distinct rows, and the only collisions left
— slot ``cap - 1`` of the buffer and its gather's backward — add masked
zeros to at most one nonzero value, which any order adds exactly.  So a
forward and backward are run-to-run bitwise.  The combine's order of
addition is not the reference scatter's: the two agree to fp32 rounding,
not bitwise.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import fsdp_weight, split_count
from repro_torch.models.param import ParamDef

F32 = torch.float32
# when a list, every dispatch appends its per-entry (keep, slot) on the
# host (``Plan.per_entry``): a check's record of which entries a run kept
TRACE: Optional[list] = None


def moe_defs(cfg: ModelConfig) -> dict:
    d, ff, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.num_experts
    defs = {
        "router": ParamDef((d, e), ("embed", None), scale=0.02),
        "w_gate": ParamDef((e, d, ff), ("experts", "expert_embed",
                                        "expert_ff")),
        "w_up": ParamDef((e, d, ff), ("experts", "expert_embed",
                                      "expert_ff")),
        "w_down": ParamDef((e, ff, d), ("experts", "expert_ff",
                                        "expert_embed")),
    }
    if cfg.num_shared_experts:
        s = cfg.num_shared_experts
        defs["shared_w_gate"] = ParamDef((d, s * ff), ("embed", "ff"))
        defs["shared_w_up"] = ParamDef((d, s * ff), ("embed", "ff"))
        defs["shared_w_down"] = ParamDef((s * ff, d), ("ff", "embed"))
    return defs


def capacity(cfg: ModelConfig, num_tokens: int) -> int:
    """Slots per expert: ⌊T·k·cf/E⌋ rounded up to a multiple of 8, at
    least 8."""
    c = int(num_tokens * cfg.experts_per_token * cfg.capacity_factor
            / cfg.num_experts)
    return max(8, ((c + 7) // 8) * 8)


def route(cfg: ModelConfig, router: torch.Tensor, x: torch.Tensor,
          group=None):
    """x: (T, d) -> (weights (T, k) fp32, ids (T, k), aux_loss scalar).
    With ``group`` (x one rank's slice of the batch) f_e and p_e are the
    whole batch's means: this rank's sums, one all-reduce of the 2E of
    them over the group, ÷ T·F."""
    logits = x.to(F32) @ router.to(F32)
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    weights, ids = torch.topk(probs, cfg.experts_per_token, dim=-1)
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    # Switch-style load-balance loss: E · Σ_e f_e · p_e, f_e from the
    # top-1 ids
    e = cfg.num_experts
    top1 = F.one_hot(ids[:, 0], e).to(F32)
    if group is None:
        me = torch.mean(probs, dim=0)                           # (E,)
        fe = torch.mean(top1, dim=0)
    else:
        n = x.shape[0] * group.size
        sums = group.sum(torch.cat([probs.sum(dim=0), top1.sum(dim=0)]),
                         kind="moe")
        me, fe = sums[:e] / n, sums[e:].detach() / n
    aux = e * torch.sum(fe * me)
    return weights, ids, aux


class _Permute(torch.autograd.Function):
    """``x[order]`` for a permutation ``order`` (``inv`` its inverse),
    whose backward is the gather ``g[inv]``: no scatter, so no colliding
    adds."""

    @staticmethod
    def forward(ctx, x, order, inv):
        ctx.save_for_backward(inv)
        return x.index_select(0, order)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return g.index_select(0, inv), None, None


def _permute(x: torch.Tensor, order: torch.Tensor,
             inv: torch.Tensor) -> torch.Tensor:
    return _Permute.apply(x, order, inv)


class Plan(NamedTuple):
    """Where a dispatch puts each of its T·k entries, in the stable sort's
    order (``order``; ``inv`` its inverse): ``keep`` the kept ones,
    ``slot`` each entry's row of this rank's (e_loc · ``rows``, d) buffer
    (a masked entry's the parked slot), ``pos`` its position within its
    expert over the whole batch, ``sorted_e`` its local expert (e_loc for
    another block's), ``cap`` the capacity, ``base`` the block's first
    expert."""

    order: torch.Tensor
    inv: torch.Tensor
    sorted_e: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    cap: int
    rows: int
    base: int = 0

    def per_entry(self):
        """(keep, slot) per entry in token order (T·k,), the slot as one
        process's: e · cap + the position over the whole batch (e the
        global expert), -1 where the entry is dropped or masked."""
        slot = torch.where(self.keep,
                           (self.base + self.sorted_e) * self.cap + self.pos,
                           -1)
        return self.keep[self.inv], slot[self.inv]


def plan(cfg: ModelConfig, ids: torch.Tensor, e_loc: int, shard: int,
         group=None) -> Plan:
    """The dispatch of ``ids`` (T, k) over experts [shard·e_loc,
    (shard+1)·e_loc): entries for other experts sort last (stable) and
    are masked like drops; an expert's entries past the capacity are
    dropped.  Without ``group`` the capacity is ``capacity(cfg, T)`` and
    the buffer has ``cap`` rows an expert; with one (``ids`` this rank's
    slice of a batch split over the group) the capacity is the whole
    batch's, ``capacity(cfg, T·F)``, each position is offset by the
    earlier ranks' entries for its expert (one all-gather of the counts)
    and the buffer has min(cap, T) rows an expert, each entry at its
    position among this rank's own."""
    t, k = ids.shape
    flat_e = ids.reshape(-1)                                    # (T·k,)
    is_local = (flat_e // e_loc) == shard
    local_e = torch.where(is_local, flat_e - shard * e_loc, e_loc)
    order = torch.argsort(local_e, stable=True)     # other experts last
    inv = torch.argsort(order)
    sorted_e = local_e[order]
    # position of each entry within its expert's block
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    local = torch.arange(t * k, device=ids.device) - first
    pos = local
    if group is None:
        cap = rows = capacity(cfg, t)
    else:
        cap = capacity(cfg, t * group.size)
        rows = min(cap, t)
        # this rank's entries an expert, then the earlier ranks' before it
        edges = torch.searchsorted(sorted_e, torch.arange(
            e_loc + 1, device=ids.device, dtype=sorted_e.dtype))
        counts = group.all_gather(edges[1:] - edges[:-1], kind="moe")
        offset = torch.cat([counts[:group.index].sum(dim=0),
                            counts.new_zeros(1)])
        pos = local + offset[sorted_e]
    keep = (sorted_e < e_loc) & (pos < cap)
    # masked entries parked at slot rows - 1 of expert 0 as zeros; slot =
    # e · rows + the position among this rank's entries
    slot = (torch.where(keep, sorted_e, 0) * rows
            + torch.where(keep, local, rows - 1))
    return Plan(order, inv, sorted_e, pos, keep, slot, cap, rows,
                shard * e_loc)


def dispatch_compute(cfg: ModelConfig, x: torch.Tensor,
                     weights: torch.Tensor, ids: torch.Tensor,
                     wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
                     e_loc: int, shard: int, group=None,
                     fsdp=None) -> torch.Tensor:
    """The routed entries of experts [shard·e_loc, (shard+1)·e_loc)
    through those experts -> their (T, d) share of the output.

    x: (T, d); weights, ids: (T, k) routing over all experts; wg, wu:
    (e_loc, d, ff); wd: (e_loc, ff, d).  Entries for other experts sort
    last (stable) and are masked like drops; an expert's entries past
    the capacity are dropped (``plan``; with ``group`` over the whole
    batch split over it); masked entries are zeros parked at the last slot
    of expert 0.  With e_loc = E and shard 0 it is the whole layer's
    routed output.  With ``fsdp`` the weights' d dims are this rank's
    blocks, each all-gathered over it just before its product."""
    t, d = x.shape
    k = cfg.experts_per_token
    pl = plan(cfg, ids, e_loc, shard, group)
    if TRACE is not None:
        TRACE.append(tuple(v.cpu() for v in pl.per_entry()))
    order, inv, keep, slot = pl.order, pl.inv, pl.keep, pl.slot
    mask = keep[:, None].to(x.dtype)

    xk = _permute(x[:, None, :].expand(t, k, d).reshape(t * k, d), order,
                  inv) * mask
    buf = torch.zeros((e_loc * pl.rows, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((slot,), xk, accumulate=True).view(
        e_loc, pl.rows, d)

    h = F.silu(torch.einsum("ecd,edf->ecf", buf, fsdp_weight(wg, 1, fsdp)))
    h = h * torch.einsum("ecd,edf->ecf", buf, fsdp_weight(wu, 1, fsdp))
    out_buf = torch.einsum("ecf,efd->ecd", h,
                           fsdp_weight(wd, 2, fsdp))           # (e, C, d)

    contrib = out_buf.reshape(e_loc * pl.rows, d).index_select(0, slot) \
        * mask
    w = _permute(weights.reshape(-1), order, inv).to(x.dtype)
    return _permute(contrib * w[:, None], inv, order).view(t, k, d).sum(
        dim=1)


def moe_mlp(cfg: ModelConfig, p: dict, x: torch.Tensor, group=None,
            tp=None, fsdp=None):
    """x: (T, d) -> (y (T, d), aux_loss). The caller flattens batch·seq.
    ``group``: the ranks a worker's batch is split over (x this rank's
    slice, the f-th of F equal ones), or None.  ``tp`` / ``fsdp``:
    serving on this rank's blocks of the weights (``_moe_serving``)."""
    if tp is not None or fsdp is not None:
        return _moe_serving(cfg, p, x, group, tp, fsdp)
    weights, ids, aux = route(cfg, p["router"], x, group)
    y = dispatch_compute(cfg, x, weights, ids, p["w_gate"], p["w_up"],
                         p["w_down"], cfg.num_experts, 0, group)
    if cfg.num_shared_experts:
        hs = F.silu(x @ p["shared_w_gate"]) * (x @ p["shared_w_up"])
        y = y + hs @ p["shared_w_down"]
    return y, aux


def _tp_combine(tp, routed: torch.Tensor, routed_split: bool,
                shared: Optional[torch.Tensor],
                shared_split: bool) -> torch.Tensor:
    """The layer's output from its parts: the partial ones (split over
    ``tp``) summed in one all-reduce, the whole ones added after it (the
    shared experts when the routed ones take the tensor axis)."""
    parts = [routed] + ([shared] if shared is not None else [])
    split = [routed_split] + ([shared_split] if shared is not None else [])
    partial = [y for y, s in zip(parts, split) if s]
    y = tp.all_sum(sum(partial[1:], partial[0])) if partial else None
    for part, s in zip(parts, split):
        if not s:
            y = part if y is None else y + part
    return y


def _moe_serving(cfg: ModelConfig, p: dict, x: torch.Tensor, group, tp,
                 fsdp):
    """``moe_mlp`` on this rank's blocks of a serving grid: its experts'
    dispatch (keep and drop over the whole batch split over ``group``),
    the shared experts, the parts combined over ``tp`` (``_tp_combine``).
    Returns (y, this rank's tokens' aux loss)."""
    e = cfg.num_experts
    experts_split = split_count(e, tp, p["w_gate"], 0, "w_gate")
    weights, ids, aux = route(cfg, fsdp_weight(p["router"], 0, fsdp), x)
    e_loc = e // tp.size if experts_split else e
    y = dispatch_compute(cfg, x, weights, ids, p["w_gate"], p["w_up"],
                         p["w_down"], e_loc,
                         tp.index if experts_split else 0, group, fsdp)
    ys = shared_split = None
    if cfg.num_shared_experts:
        ff = cfg.num_shared_experts * (cfg.moe_d_ff or cfg.d_ff)
        shared_split = split_count(ff, tp, p["shared_w_up"], 1,
                                   "shared_w_up", split=not experts_split)
        hs = F.silu(x @ fsdp_weight(p["shared_w_gate"], 0, fsdp)) * (
            x @ fsdp_weight(p["shared_w_up"], 0, fsdp))
        ys = hs @ fsdp_weight(p["shared_w_down"], 1, fsdp)
    return _tp_combine(tp, y, experts_split, ys, shared_split), aux
