"""Shared low-level layers (``repro.models.layers``): RMSNorm, RoPE, the
MLPs (SiLU- and GELU-gated, plain GELU) — same numerics as the reference
(norm in fp32, split-half rotary embedding, tanh-approximated GELU as
``jax.nn.gelu(approximate=True)``).

Serving on a rank grid (``tp``, ``fsdp``: ``comm.collectives.MeshGroup``s
or None): the MLP is column-parallel in ``w_gate`` and ``w_up`` over
"ff", row-parallel in ``w_down``, then one sum over the tensor ranks;
where the weights' d dims split over FSDP ranks too, each weight is
all-gathered over them just before its product (``fsdp_weight``) and
dropped after it."""
from __future__ import annotations

from typing import Optional

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


def fsdp_weight(w: torch.Tensor, dim: int, fsdp) -> torch.Tensor:
    """``w`` whole along ``dim`` (its d dim): all-gathered over the FSDP
    ranks ``fsdp`` (counted "weights"), ``w`` itself without them."""
    return w if fsdp is None else fsdp.gather_dim(w, dim, kind="weights")


def split_count(n: int, tp, w: torch.Tensor, dim: int, name: str,
                split: Optional[bool] = None) -> bool:
    """Whether ``w``'s dim ``dim`` (``n`` whole) is split over the tensor
    ranks ``tp``: ``split`` (the layout's rule), by default where they
    divide ``n`` (``sharding.specs.axis_rules``'s for heads, kv heads and
    experts), checked against the block the rank holds (a whole weight
    given to a rank of a grid that splits it is refused)."""
    if split is None:
        split = n % tp.size == 0 if tp is not None else False
    split = split and tp is not None
    want = n // tp.size if split else n
    if w.shape[dim] != want:
        raise ValueError(f"{name}: dim {dim} is {w.shape[dim]}, the "
                         f"serving layout gives this rank {want} of {n}")
    return split


def mlp(cfg: ModelConfig, p: dict, x: torch.Tensor, tp=None,
        fsdp=None) -> torch.Tensor:
    """The MLP; with ``tp`` / ``fsdp`` on this rank's blocks (serving)."""
    split = split_count(cfg.d_ff, tp, p["w_up"], 1, "w_up", split=True)

    def w(name, dim=0):
        return fsdp_weight(p[name], dim, fsdp)
    if cfg.mlp_act == "silu":
        h = F.silu(x @ w("w_gate")) * (x @ w("w_up"))
    elif cfg.mlp_act == "geglu":
        h = F.gelu(x @ w("w_gate"), approximate="tanh") * (x @ w("w_up"))
    else:
        h = F.gelu(x @ w("w_up"), approximate="tanh")
    y = h @ w("w_down", 1)
    return tp.all_sum(y) if split else y
