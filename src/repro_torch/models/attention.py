"""GQA attention, training/prefill forward (``repro.models.attention``).

Plain tensor ops, as in the reference (which calls no kernel here): QKV
projections with optional bias, split-half RoPE, KV heads repeated to the
query heads, scores and softmax in fp32 with a causal ``NEG_INF`` mask,
softmax probabilities cast back to the input dtype before PV.
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
                window: Optional[int] = None) -> torch.Tensor:
    """Training / prefill attention over a full sequence.

    x: (..., seq, d_model); positions: (..., seq) absolute positions.
    """
    group = cfg.num_heads // cfg.num_kv_heads
    q, k, v = _project_qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
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
    scores = torch.where(mask, scores, torch.tensor(NEG_INF,
                                                    dtype=scores.dtype,
                                                    device=scores.device))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("...hqs,...shk->...qhk", probs, v)
    return torch.einsum("...qhk,hkd->...qd", out, p["wo"])
