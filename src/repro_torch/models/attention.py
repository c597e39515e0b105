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
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope
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


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor):
    q = torch.einsum("...sd,dhk->...shk", x, p["wq"])
    k = torch.einsum("...sd,dhk->...shk", x, p["wk"])
    v = torch.einsum("...sd,dhk->...shk", x, p["wv"])
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


def attend_full(cfg: ModelConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor,
                window: Optional[int] = None, return_kv: bool = False):
    """Training / prefill attention over a full sequence.

    x: (..., seq, d_model); positions: (..., seq) absolute positions.
    With ``return_kv`` also returns the roped (k, v), before the KV heads
    are repeated, for cache prefill.
    """
    group = cfg.num_heads // cfg.num_kv_heads
    q, k, v = _project_qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    kv_cache = (k, v) if return_kv else None
    k = _repeat_kv(k, group)
    v = _repeat_kv(v, group)

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
    out = torch.einsum("...hqs,...shk->...qhk", probs, v)
    out = torch.einsum("...qhk,hkd->...qd", out, p["wo"])
    if return_kv:
        return out, kv_cache
    return out


def prefill_kv_cache(cfg: ModelConfig, kv, cache_len: int,
                     window: Optional[int], dtype: torch.dtype) -> dict:
    """Build a decode cache from prefill (k, v): (b, s, kvh, hd).

    For windowed attention the cache is a ring buffer of size ``window``
    whose slot layout matches ``decode_attend`` (slot = pos % window).
    """
    k, v = kv
    b, s = k.shape[0], k.shape[1]
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
                  device: torch.device | str = "cpu") -> dict:
    kv, hd = cfg.num_kv_heads, cfg.head_dim
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
                  pos: int, window: Optional[int] = None):
    """One-token decode. x: (batch, 1, d); pos: the current position (an
    int, or a 0-d integer tensor, which is read on the host).

    Returns (out (batch, 1, d), new_cache). The cache holds positions
    [0, cache_len) for full attention, or a ring buffer of the last
    ``window`` positions when ``window`` is set (cache_len == window).  A
    position at or past cache_len (full attention) is written to the last
    slot, as the reference's clamped update writes it.
    """
    pos = int(pos)
    group = cfg.num_heads // cfg.num_kv_heads
    cache_len = cache["k"].shape[1]
    q, k, v = _project_qkv(cfg, p, x)                 # (b, 1, h/kv, hd)
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
    qh = q[:, 0].reshape(q.shape[0], cfg.num_kv_heads, group, cfg.head_dim)
    dt = torch.promote_types(qh.dtype, ck.dtype)
    scores = torch.einsum("bkgh,bskh->bkgs", qh.to(dt),
                          ck.to(dt)).to(torch.float32) * scale
    sidx = torch.arange(cache_len, device=x.device)
    if window is not None:
        # ring buffer: slot s holds absolute position p' with p' % W == s,
        # the latest such p' <= pos:
        abs_pos = pos - torch.remainder(pos - sidx, cache_len)
        valid = (abs_pos >= 0) & (abs_pos <= pos) & (abs_pos > pos - window)
    else:
        valid = sidx <= pos
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    dt = torch.promote_types(probs.dtype, cv.dtype)
    out = torch.einsum("bkgs,bskh->bkgh", probs.to(dt), cv.to(dt))
    out = out.reshape(x.shape[0], 1, cfg.num_heads, cfg.head_dim)
    out = torch.einsum("bqhk,hkd->bqd", out, p["wo"])
    return out, {"k": ck, "v": cv}
