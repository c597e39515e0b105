"""GQA attention: training/prefill forward and KV-cache decode
(``repro.models.attention``).

Plain tensor ops, as in the reference (which calls no kernel here): QKV
projections with optional bias, split-half RoPE, KV heads repeated to the
query heads, scores and softmax in fp32 with a causal ``NEG_INF`` mask,
softmax probabilities cast back to the input dtype before PV.

Cache layouts
  full window : k/v (batch, seq_len, kv_heads, head_dim), append at position
  sliding     : same shape with seq_len = window, ring-buffer writes

A cache is a dict of tensors.  The functions here return new caches and
leave their arguments as they were, as the reference's do.

Serving on a rank grid (``tp``: the tensor ranks, ``fsdp``: the FSDP
ranks of a 2D layout, ``comm.collectives.MeshGroup``s), on this rank's
blocks of the weights (``sharding.specs.rank_params``):

  * query heads over ``tp`` where they divide it (the padded GQA map of
    ``configs.base.pad_for_mesh`` keeps query head i on kv head i // g
    inside each rank's block); ``wo`` row-parallel, then one sum;
  * kv heads over ``tp`` where they divide it (``kv_layout`` "heads"):
    ``wk``, ``wv`` and the cache split by kv heads, each rank attends
    locally.  Otherwise ("seq") ``wk``, ``wv`` stay whole and the cache
    splits by slots, rank r holding slots [r·n, (r+1)·n) of n·t (the ring
    buffer's slot = pos % cache_len too): prefill writes each rank's
    slots, and decode is the distributed flash-decode — the step's query
    all-gathered over ``tp``, each rank's partial max m, sum l and output
    o over its slots, one max and one sum over ``tp`` that combine them
    with the e^{m−M} rescale (``_combine``), each rank keeping its heads'
    slice for ``wo``;
  * with ``fsdp``, each of ``wq``, ``wk``, ``wv``, ``wo`` all-gathered
    over it just before its product (``layers.fsdp_weight``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, fsdp_weight, split_count
from repro_torch.models.param import ParamDef

NEG_INF = -1e30


def attention_defs(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    defs = {
        "wq": ParamDef((d, h, hd), ("embed", "heads", None)),
        "wk": ParamDef((d, kv, hd), ("embed", "kv_heads", None)),
        "wv": ParamDef((d, kv, hd), ("embed", "kv_heads", None)),
        "wo": ParamDef((h, hd, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h, hd), ("heads", None), init="zeros")
        defs["bk"] = ParamDef((kv, hd), ("kv_heads", None), init="zeros")
        defs["bv"] = ParamDef((kv, hd), ("kv_heads", None), init="zeros")
    return defs


def kv_layout(cfg: ModelConfig, tp) -> str:
    """How the KV side lies over the tensor ranks ``tp``: "whole" without
    them, "heads" where the kv heads divide them, else "seq" (the cache
    split by slots; the reference's ``cache_specs``)."""
    if tp is None:
        return "whole"
    return "heads" if cfg.num_kv_heads % tp.size == 0 else "seq"


def _serving_blocks(cfg: ModelConfig, p: dict, tp) -> tuple:
    """(kv layout, whether the query heads split) of this rank's attention
    blocks, each checked against the layout."""
    layout = kv_layout(cfg, tp)
    split_count(cfg.num_kv_heads, tp, p["wk"], 1, "wk",
                split=layout == "heads")
    return layout, split_count(cfg.num_heads, tp, p["wq"], 1, "wq")


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, fsdp=None):
    q = torch.einsum("...sd,dhk->...shk", x, fsdp_weight(p["wq"], 0, fsdp))
    k = torch.einsum("...sd,dhk->...shk", x, fsdp_weight(p["wk"], 0, fsdp))
    v = torch.einsum("...sd,dhk->...shk", x, fsdp_weight(p["wv"], 0, fsdp))
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def _repeat_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    """(..., s, kv, hd) -> (..., s, kv*group, hd)"""
    if group == 1:
        return x
    return torch.repeat_interleave(x, group, dim=-2)


def _kv_for_heads(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor,
                  layout: str, heads_split: bool, tp):
    """k, v repeated to this rank's query heads: GQA's repeat over its own
    kv heads, or, with whole kv heads beside split query heads, the kv
    head i // g of each of its query heads i."""
    group = cfg.num_heads // cfg.num_kv_heads
    if layout == "seq" and heads_split:
        h_loc = cfg.num_heads // tp.size
        idx = torch.div(torch.arange(h_loc, device=k.device)
                        + tp.index * h_loc, group, rounding_mode="floor")
        return k.index_select(-2, idx), v.index_select(-2, idx)
    return _repeat_kv(k, group), _repeat_kv(v, group)


def _out_proj(cfg: ModelConfig, p: dict, out: torch.Tensor, tp, fsdp,
              split: bool) -> torch.Tensor:
    """``wo`` over this rank's heads of ``out`` (..., q, h, hd); row-
    parallel where the heads split: then one sum over ``tp``."""
    y = torch.einsum("...qhk,hkd->...qd", out, fsdp_weight(p["wo"], 2, fsdp))
    return tp.all_sum(y) if split else y


def attend_full(cfg: ModelConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor,
                window: Optional[int] = None, return_kv: bool = False,
                tp=None, fsdp=None):
    """Training / prefill attention over a full sequence.

    x: (..., seq, d_model); positions: (..., seq) absolute positions.
    With ``return_kv`` also returns the roped (k, v), before the KV heads
    are repeated, for cache prefill (this rank's kv heads, all of them in
    the "seq" layout).  ``tp`` / ``fsdp``: serving on this rank's blocks.
    """
    layout, heads_split = _serving_blocks(cfg, p, tp)
    q, k, v = _project_qkv(cfg, p, x, fsdp)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    kv_cache = (k, v) if return_kv else None
    k, v = _kv_for_heads(cfg, k, v, layout, heads_split, tp)

    scale = cfg.head_dim ** -0.5
    scores = torch.einsum("...qhk,...shk->...hqs", q, k).to(torch.float32) \
        * scale
    qi = positions[..., None, :, None]   # (..., 1, q, 1)
    ki = positions[..., None, None, :]   # (..., 1, 1, s)
    mask = ki <= qi                      # (..., 1, q, s) broadcast over heads
    if window is not None:
        mask = mask & (ki > qi - window)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = _out_proj(cfg, p, torch.einsum("...hqs,...shk->...qhk", probs, v),
                    tp, fsdp, heads_split)
    if return_kv:
        return out, kv_cache
    return out


def _slot_block(cfg: ModelConfig, length: int, tp) -> tuple:
    """(first slot, slots) of this rank's block of a cache of ``length``
    slots: all of them but in the "seq" layout, where rank r holds
    [r·n, (r+1)·n), n = length / t."""
    if kv_layout(cfg, tp) != "seq":
        return 0, length
    if length % tp.size:
        raise ValueError(
            f"a cache of {length} slots does not split over {tp.size} "
            f"tensor ranks: {cfg.num_kv_heads} kv heads do not divide them, "
            f"so the cache splits by slots (pick a length they divide)")
    n = length // tp.size
    return tp.index * n, n


def prefill_kv_cache(cfg: ModelConfig, kv, cache_len: int,
                     window: Optional[int], dtype: torch.dtype,
                     tp=None) -> dict:
    """Build a decode cache from prefill (k, v): (b, s, kvh, hd).

    For windowed attention the cache is a ring buffer of size ``window``
    whose slot layout matches ``decode_attend`` (slot = pos % window).
    With ``tp``, this rank's block of it (``init_kv_cache``): its kv
    heads, or in the "seq" layout its slots of each position's.
    """
    k, v = kv
    b, s = k.shape[0], k.shape[1]
    if tp is not None:
        length = window if window is not None else cache_len
        a, n = _slot_block(cfg, length, tp)
        cache = {"k": torch.zeros((b, n, *k.shape[2:]), dtype=dtype,
                                  device=k.device),
                 "v": torch.zeros((b, n, *v.shape[2:]), dtype=dtype,
                                  device=v.device)}
        # the positions whose slots are this rank's (host arithmetic)
        first = s - min(window, s) if window is not None else 0
        pos = [q for q in range(first, s)
               if a <= (q % length if window is not None else q) < a + n]
        if pos:
            src = torch.tensor(pos, device=k.device)
            dst = torch.tensor([(q % length if window is not None else q)
                                - a for q in pos], device=k.device)
            cache["k"][:, dst] = k.index_select(1, src).to(dtype)
            cache["v"][:, dst] = v.index_select(1, src).to(dtype)
        return cache
    if window is not None:
        cache = init_kv_cache(cfg, b, window, dtype, k.device)
        take = min(window, s)
        slots = torch.remainder(torch.arange(s - take, s, device=k.device),
                                window)
        cache["k"][:, slots] = k[:, s - take:].to(dtype)
        cache["v"][:, slots] = v[:, s - take:].to(dtype)
        return cache
    cache = init_kv_cache(cfg, b, cache_len, dtype, k.device)
    cache["k"][:, :s] = k.to(dtype)
    cache["v"][:, :s] = v.to(dtype)
    return cache


# ------------------------------------------------------------------ decode
def init_kv_cache(cfg: ModelConfig, batch: int, cache_len: int,
                  dtype: torch.dtype,
                  device: torch.device | str = "cpu", tp=None) -> dict:
    """Zeros of (batch, cache_len, kv heads, head_dim); with ``tp`` this
    rank's block: its kv heads ("heads"), or its slots ("seq")."""
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    if tp is not None:
        if kv_layout(cfg, tp) == "heads":
            kv //= tp.size
        else:
            cache_len = _slot_block(cfg, cache_len, tp)[1]
    return {
        "k": torch.zeros((batch, cache_len, kv, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, cache_len, kv, hd), dtype=dtype,
                         device=device),
    }


def _update_slot(cache: torch.Tensor, new: torch.Tensor,
                 slot: int) -> torch.Tensor:
    """``jax.lax.dynamic_update_slice_in_dim(cache, new, slot, axis=1)`` for
    a one-position ``new``: a copy of ``cache`` with ``new`` at ``slot``,
    the start clamped into [0, cache_len − 1] as XLA clamps it."""
    slot = min(max(slot, 0), cache.shape[1] - 1)
    out = cache.clone()
    out[:, slot:slot + 1] = new.to(cache.dtype)
    return out


def decode_attend(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict,
                  pos: int, window: Optional[int] = None, tp=None,
                  fsdp=None):
    """One-token decode. x: (batch, 1, d); pos: the current position (an
    int, or a 0-d integer tensor, which is read on the host).

    Returns (out (batch, 1, d), new_cache). The cache holds positions
    [0, cache_len) for full attention, or a ring buffer of the last
    ``window`` positions when ``window`` is set (cache_len == window).  A
    position at or past cache_len (full attention) is written to the last
    slot, as the reference's clamped update writes it.  ``tp`` / ``fsdp``:
    serving on this rank's blocks of the weights and the cache (in the
    "seq" layout the distributed flash-decode, ``_flash_decode``).
    """
    pos = int(pos)
    layout, heads_split = _serving_blocks(cfg, p, tp)
    if layout == "seq":
        return _flash_decode(cfg, p, x, cache, pos, window, tp, fsdp,
                             heads_split)
    group = cfg.num_heads // cfg.num_kv_heads
    cache_len = cache["k"].shape[1]
    q, k, v = _project_qkv(cfg, p, x, fsdp)           # (b, 1, h/kv, hd)
    posv = torch.full(x.shape[:-2] + (1,), pos, dtype=torch.int32,
                      device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)

    # floor-mod, as jnp's % (a negative pos lands in [0, cache_len))
    slot = pos % cache_len if window is not None else pos
    ck = _update_slot(cache["k"], k, slot)
    cv = _update_slot(cache["v"], v, slot)

    scale = cfg.head_dim ** -0.5
    # (b, kv, g, hd) x (b, s, kv, hd) -> (b, kv, g, s), in the promoted
    # dtype of q and the cache (jnp.einsum promotes; torch's does not)
    qh = q[:, 0].reshape(q.shape[0], k.shape[2], group, cfg.head_dim)
    dt = torch.promote_types(qh.dtype, ck.dtype)
    scores = torch.einsum("bkgh,bskh->bkgs", qh.to(dt),
                          ck.to(dt)).to(torch.float32) * scale
    valid = _valid_slots(pos, torch.arange(cache_len, device=x.device),
                         cache_len, window)
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    dt = torch.promote_types(probs.dtype, cv.dtype)
    out = torch.einsum("bkgs,bskh->bkgh", probs.to(dt), cv.to(dt))
    out = out.reshape(x.shape[0], 1, q.shape[2], cfg.head_dim)
    return _out_proj(cfg, p, out, tp, fsdp, heads_split), {"k": ck, "v": cv}


def _valid_slots(pos: int, sidx: torch.Tensor, cache_len: int,
                 window: Optional[int]) -> torch.Tensor:
    """Which of the slots ``sidx`` of a cache of ``cache_len`` slots hold a
    position that ``pos`` attends to."""
    if window is not None:
        # ring buffer: slot s holds absolute position p' with p' % W == s,
        # the latest such p' <= pos:
        abs_pos = pos - torch.remainder(pos - sidx, cache_len)
        return (abs_pos >= 0) & (abs_pos <= pos) & (abs_pos > pos - window)
    return sidx <= pos


def _combine(tp, m: torch.Tensor, l: torch.Tensor,
             o: torch.Tensor) -> torch.Tensor:
    """The flash-decode's combine over ``tp``: each rank's partial max
    ``m``, sum ``l`` (..., 1) and output ``o`` (..., hd) rescaled by
    e^{m − M} to the global max M (one max), then summed (one sum of o
    and l together) and divided."""
    c = torch.exp(m - tp.all_max(m))
    both = tp.all_sum(torch.cat([o * c, l * c], dim=-1))
    return both[..., :-1] / both[..., -1:]


def _flash_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict,
                  pos: int, window: Optional[int], tp, fsdp,
                  heads_split: bool):
    """``decode_attend`` with the cache split by slots over ``tp`` (rank r
    holds slots [r·n, (r+1)·n) of n·t): the new k, v (whole kv heads)
    written by the rank that holds the step's slot; every query head
    scored against this rank's slots (the query all-gathered over ``tp``
    where the heads split), the partials combined (``_combine``, in
    fp32), this rank's heads kept for ``wo``."""
    b, hd, t = x.shape[0], cfg.head_dim, tp.size
    group = cfg.num_heads // cfg.num_kv_heads
    n = cache["k"].shape[1]
    length, first = n * t, tp.index * n
    q, k, v = _project_qkv(cfg, p, x, fsdp)
    posv = torch.full(x.shape[:-2] + (1,), pos, dtype=torch.int32,
                      device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    slot = pos % length if window is not None else min(max(pos, 0),
                                                       length - 1)
    ck, cv = cache["k"], cache["v"]
    if first <= slot < first + n:
        ck = _update_slot(ck, k, slot - first)
        cv = _update_slot(cv, v, slot - first)
    if heads_split:
        q = tp.gather_dim(q, -2)                       # (b, 1, h, hd)
    qh = q[:, 0].reshape(b, cfg.num_kv_heads, group, hd)
    dt = torch.promote_types(qh.dtype, ck.dtype)
    scores = torch.einsum("bkgh,bskh->bkgs", qh.to(dt),
                          ck.to(dt)).to(torch.float32) * hd ** -0.5
    valid = _valid_slots(pos, first + torch.arange(n, device=x.device),
                         length, window)[None, None, None, :]
    m = torch.where(valid, scores, NEG_INF).amax(dim=-1, keepdim=True)
    e = torch.where(valid, torch.exp(scores - m), 0.0)
    o = torch.einsum("bkgs,bskh->bkgh", e, cv.to(torch.float32))
    out = _combine(tp, m, e.sum(dim=-1, keepdim=True), o).to(x.dtype)
    out = out.reshape(b, 1, cfg.num_heads, hd)
    if heads_split:
        h_loc = cfg.num_heads // t
        out = out[:, :, tp.index * h_loc:(tp.index + 1) * h_loc]
    return _out_proj(cfg, p, out, tp, fsdp, heads_split), {"k": ck,
                                                           "v": cv}
