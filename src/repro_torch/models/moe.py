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

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.param import ParamDef

F32 = torch.float32


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


def route(cfg: ModelConfig, router: torch.Tensor, x: torch.Tensor):
    """x: (T, d) -> (weights (T, k) fp32, ids (T, k), aux_loss scalar)."""
    logits = x.to(F32) @ router.to(F32)
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    weights, ids = torch.topk(probs, cfg.experts_per_token, dim=-1)
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    # Switch-style load-balance loss: E · Σ_e f_e · p_e, f_e from the
    # top-1 ids
    e = cfg.num_experts
    me = torch.mean(probs, dim=0)                               # (E,)
    fe = torch.mean(F.one_hot(ids[:, 0], e).to(F32), dim=0)
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


def dispatch_compute(cfg: ModelConfig, x: torch.Tensor,
                     weights: torch.Tensor, ids: torch.Tensor,
                     wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
                     e_loc: int, shard: int) -> torch.Tensor:
    """The routed entries of experts [shard·e_loc, (shard+1)·e_loc)
    through those experts -> their (T, d) share of the output.

    x: (T, d); weights, ids: (T, k) routing over all experts; wg, wu:
    (e_loc, d, ff); wd: (e_loc, ff, d).  Entries for other experts sort
    last (stable) and are masked like drops; an expert's entries past
    ``capacity(cfg, T)`` are dropped; masked entries are zeros parked at
    slot ``cap - 1`` of expert 0.  With e_loc = E and shard 0 it is the
    whole layer's routed output."""
    t, d = x.shape
    k = cfg.experts_per_token
    cap = capacity(cfg, t)

    flat_e = ids.reshape(-1)                                    # (T·k,)
    is_local = (flat_e // e_loc) == shard
    local_e = torch.where(is_local, flat_e - shard * e_loc, e_loc)
    order = torch.argsort(local_e, stable=True)     # other experts last
    inv = torch.argsort(order)
    sorted_e = local_e[order]
    # position of each entry within its expert's block
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.arange(t * k, device=x.device) - first
    keep = (sorted_e < e_loc) & (pos < cap)
    mask = keep[:, None].to(x.dtype)

    # the entries into the expert buffer, masked ones parked at slot
    # cap - 1 of expert 0 as zeros; slot = e · cap + position
    slot = (torch.where(keep, sorted_e, 0) * cap
            + torch.where(keep, pos, cap - 1))
    xk = _permute(x[:, None, :].expand(t, k, d).reshape(t * k, d), order,
                  inv) * mask
    buf = torch.zeros((e_loc * cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((slot,), xk, accumulate=True).view(e_loc, cap, d)

    h = F.silu(torch.einsum("ecd,edf->ecf", buf, wg))
    h = h * torch.einsum("ecd,edf->ecf", buf, wu)
    out_buf = torch.einsum("ecf,efd->ecd", h, wd)              # (e, C, d)

    contrib = out_buf.reshape(e_loc * cap, d).index_select(0, slot) * mask
    w = _permute(weights.reshape(-1), order, inv).to(x.dtype)
    return _permute(contrib * w[:, None], inv, order).view(t, k, d).sum(
        dim=1)


def moe_mlp(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x: (T, d) -> (y (T, d), aux_loss). The caller flattens batch·seq."""
    weights, ids, aux = route(cfg, p["router"], x)
    y = dispatch_compute(cfg, x, weights, ids, p["w_gate"], p["w_up"],
                         p["w_down"], cfg.num_experts, 0)
    if cfg.num_shared_experts:
        hs = F.silu(x @ p["shared_w_gate"]) * (x @ p["shared_w_up"])
        y = y + hs @ p["shared_w_down"]
    return y, aux
