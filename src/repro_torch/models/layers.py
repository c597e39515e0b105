"""Shared low-level layers (``repro.models.layers``): RMSNorm, RoPE, the
MLPs (SiLU- and GELU-gated, plain GELU) — same numerics as the reference
(norm in fp32, split-half rotary embedding, tanh-approximated GELU as
``jax.nn.gelu(approximate=True)``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.param import ParamDef


# ----------------------------------------------------------------- rms norm
def rms_norm_def(d: int) -> ParamDef:
    return ParamDef((d,), ("embed",), init="ones")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.to(torch.float32)).to(dt)


# --------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str = "cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Split-half
    rotation: the first and second halves of head_dim form the pairs."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # (hd/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., :, None, :]                   # over heads
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------- mlp
def mlp_defs(cfg: ModelConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.mlp_act not in ("silu", "geglu", "gelu"):
        raise ValueError(f"mlp_act {cfg.mlp_act!r}")
    defs = {
        "w_up": ParamDef((d, ff), ("embed", "ff")),
        "w_down": ParamDef((ff, d), ("ff", "embed")),
    }
    if cfg.mlp_act != "gelu":
        defs["w_gate"] = ParamDef((d, ff), ("embed", "ff"))
    return defs


def mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_act == "silu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif cfg.mlp_act == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_up"])
    else:
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]
