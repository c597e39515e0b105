"""Model assembly (``repro.models.transformer``), dense family:
embedding -> pre-norm blocks (GQA attention + gated MLP) -> norm -> tied
logits.

Layer parameters stay stacked on a leading "layers" axis, the reference's
tree layout; a Python loop over that axis takes the place of ``lax.scan``.
The reference's ``remat`` only saves activation memory and is left out:
at the sizes the port trains, activations are a small share of the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import tree as tree_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention
from repro_torch.models.layers import mlp, mlp_defs, rms_norm, rms_norm_def
from repro_torch.models.param import ParamDef, materialize, stack_defs


# --------------------------------------------------------------------- defs
def layer_defs(cfg: ModelConfig) -> dict:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1)")
    return {
        "attn": attention.attention_defs(cfg),
        "norm1": rms_norm_def(cfg.d_model),
        "norm2": rms_norm_def(cfg.d_model),
        "mlp": mlp_defs(cfg),
    }


def model_defs(cfg: ModelConfig) -> dict:
    defs = {
        "layers": stack_defs(layer_defs(cfg), cfg.num_layers, "layers"),
        "final_norm": rms_norm_def(cfg.d_model),
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                          scale=0.02),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                   ("embed", "vocab"), scale=0.02)
    return defs


def init_params(cfg: ModelConfig, seed: int = 0,
                dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cpu") -> dict:
    return materialize(model_defs(cfg), seed, dtype, device)


# ------------------------------------------------------------------- blocks
def _block(cfg: ModelConfig, p: dict, x: torch.Tensor,
           positions: torch.Tensor, window: Optional[int]) -> torch.Tensor:
    """One dense layer."""
    x = x + attention.attend_full(
        cfg, p["attn"], rms_norm(x, p["norm1"], cfg.norm_eps), positions,
        window=window if window is not None else cfg.attn_window)
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + mlp(cfg, p["mlp"], h)


def logits_out(cfg: ModelConfig, params: dict,
               x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return torch.einsum("...d,vd->...v", x, params["embed"])
    return x @ params["lm_head"]


def forward(cfg: ModelConfig, params: dict, inputs: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            window: Optional[int] = None) -> torch.Tensor:
    """Full-sequence forward over token ids (..., S) -> logits (..., S, V).

    (The reference also returns an MoE aux loss, always 0 for the dense
    family; the port returns the logits alone.)"""
    x = params["embed"][inputs]
    if positions is None:
        positions = torch.arange(x.shape[-2], device=x.device).expand(
            x.shape[:-1])
    # unbind once: its backward stacks the L layer gradients in one pass,
    # where L separate a[i] selects would each scatter into a zeroed
    # full-depth buffer (O(L²) traffic)
    per_layer = tree_mod.tree_map(lambda a: a.unbind(0), params["layers"])
    for i in range(cfg.num_layers):
        layer_p = tree_mod.tree_map(lambda t: t[i], per_layer)
        x = _block(cfg, layer_p, x, positions, window)
    return logits_out(cfg, params, x)
