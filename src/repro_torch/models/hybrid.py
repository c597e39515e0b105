"""Hymba-style hybrid block (``repro.models.hybrid``): attention heads and
SSM heads run in parallel on the same input; their outputs, each
RMS-normalised, are averaged with a learnable scale per branch
(``fuse_beta``).  [arXiv:2411.13676 §2]

The block reuses the port's ``attention`` and ``ssm`` modules as they
are.  Its decode cache nests the two: ``{"attn": {k, v}, "ssm": {state,
conv}}``, the reference's tree.

Serving on a rank grid (``tp``, a ``comm.collectives.MeshGroup``): the
two branches run in parallel on this rank's blocks, attention as
``models.attention`` splits it (its heads, the cache by kv heads or by
slots), the SSM as ``models.ssm`` does (its inner channels and heads).
Each branch's row-parallel product is summed over ``tp`` inside the
branch, before its own RMS norm in ``_fuse``: a norm does not commute
with a partial sum, so the block takes two sums, never one after the
fuse.  The cache is this rank's block of each branch's.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, ssm
from repro_torch.models.layers import rms_norm, rms_norm_def
from repro_torch.models.param import ParamDef


def hybrid_defs(cfg: ModelConfig) -> dict:
    return {
        "attn": attention.attention_defs(cfg),
        "ssm": ssm.ssm_defs(cfg),
        "attn_out_norm": rms_norm_def(cfg.d_model),
        "ssm_out_norm": rms_norm_def(cfg.d_model),
        # learnable fusion scale (Hymba's beta)
        "fuse_beta": ParamDef((2,), (None,), init="ones"),
    }


def _fuse(p: dict, ya: torch.Tensor, ys: torch.Tensor,
          eps: float) -> torch.Tensor:
    ya = rms_norm(ya, p["attn_out_norm"], eps)
    ys = rms_norm(ys, p["ssm_out_norm"], eps)
    beta = p["fuse_beta"].to(ya.dtype)
    return 0.5 * (beta[0] * ya + beta[1] * ys)


def hybrid_forward(cfg: ModelConfig, p: dict, x: torch.Tensor,
                   positions: torch.Tensor, window: Optional[int] = None,
                   return_cache: bool = False, cache_len: int = 0, tp=None):
    """x: (B, L, d).  With ``return_cache`` also the decode cache after
    the sequence: the attention's KV (a ring buffer of the window when
    there is one, else ``cache_len`` slots) and the SSM's state and conv
    window.  ``tp``: serving on this rank's blocks (the module's
    docstring)."""
    w = window if window is not None else cfg.attn_window
    ya = attention.attend_full(cfg, p["attn"], x, positions, window=w,
                               return_kv=return_cache, tp=tp)
    ys = ssm.ssm_forward(cfg, p["ssm"], x, return_cache=return_cache, tp=tp)
    if return_cache:
        ya, kv = ya
        ys, ssm_cache = ys
        alen = min(cache_len, w) if w else cache_len
        attn_cache = attention.prefill_kv_cache(cfg, kv, alen, w, x.dtype,
                                                tp)
        return _fuse(p, ya, ys, cfg.norm_eps), {"attn": attn_cache,
                                                "ssm": ssm_cache}
    return _fuse(p, ya, ys, cfg.norm_eps)


def init_hybrid_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      dtype: torch.dtype,
                      device: torch.device | str = "cpu", tp=None) -> dict:
    return {
        "attn": attention.init_kv_cache(cfg, batch, cache_len, dtype,
                                        device, tp),
        "ssm": ssm.init_ssm_cache(cfg, batch, dtype, device, tp),
    }


def hybrid_decode_step(cfg: ModelConfig, p: dict, x: torch.Tensor,
                       cache: dict, pos, window: Optional[int] = None,
                       tp=None):
    """One-token decode. x: (B, 1, d) -> (y (B, 1, d), new cache);
    ``tp`` as ``hybrid_forward``'s."""
    w = window if window is not None else cfg.attn_window
    ya, kv = attention.decode_attend(cfg, p["attn"], x, cache["attn"], pos,
                                     window=w, tp=tp)
    ys, st = ssm.ssm_decode_step(cfg, p["ssm"], x, cache["ssm"], tp)
    return _fuse(p, ya, ys, cfg.norm_eps), {"attn": kv, "ssm": st}
