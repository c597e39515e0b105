"""Model assembly (``repro.models.transformer``): embedding -> pre-norm
blocks -> norm -> logits, for the families the port runs:
  dense / vlm / audio : GQA attention + MLP blocks (silu- or gelu-gated,
                        or plain gelu); vlm takes early-fusion token ids,
                        audio the codec frontend's frame embeddings
  moe                 : attention + routed-expert MLP (``models/moe.py``);
                        its router's aux loss comes out of ``forward``
                        with ``return_aux``
  ssm                 : Mamba2 SSD blocks (no MLP, as in Mamba2;
                        ``models/ssm.py``)
  hybrid              : parallel attention + SSM block + MLP
                        (``models/hybrid.py``); its per-layer cache nests
                        the KV cache and the SSM state

Layer parameters stay stacked on a leading "layers" axis, the reference's
tree layout; a Python loop over that axis takes the place of ``lax.scan``
(decode and prefill stack every leaf of their per-layer caches on a
leading layer axis, so the cache tree, nested for the hybrid, is the
reference's too).  So the reference's ``unroll``,
a ``lax.scan`` knob, has no counterpart here.  ``forward(remat=True)``
runs each layer's block under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` of the scan body): its activations are recomputed in
the backward instead of kept, and the layer's aux loss comes out of the
checkpoint beside them.

Serving on a rank grid (the reference's serving layout; ``prefill``,
``decode_step`` and ``init_cache`` take ``tp``, ``fsdp`` and ``group``,
``comm.collectives.MeshGroup``s or None, as ``launch.mesh.ServeMesh
.groups`` gives them): the parameters are this rank's blocks
(``sharding.specs.rank_params``), the inputs its rows of the served batch
and the cache its block (``sharding.specs.cache_specs``).  The vocab
splits over the tensor ranks ``tp``: the embedding looks up the rank's
rows (zeros for the other ranks' ids), then one sum; the logits are the
rank's vocab columns, then one all-gather, so every rank returns the
whole logits of its rows.  Attention, the MLP and the routed experts
split as ``models.attention``, ``models.layers`` and ``models.moe`` say;
``group`` is the data-like ranks the batch splits over, over which the
routed layer keeps one process's keep and drop; ``fsdp`` the ranks the
weights' d dims split over (kimi-k2), each weight gathered over them just
before its product.  The ssm and hybrid families' SSM blocks split their
inner channels and heads as ``models.ssm`` says (the ``ssm_inner``
rule), the hybrid's attention as every other family's.  Training's
``forward`` splits no weight.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tree_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, hybrid, moe, ssm
from repro_torch.models.layers import (fsdp_weight, mlp, mlp_defs,
                                       rms_norm, rms_norm_def, split_count)
from repro_torch.models.param import ParamDef, materialize, stack_defs


# --------------------------------------------------------------------- defs
def layer_defs(cfg: ModelConfig) -> dict:
    if cfg.family == "ssm":
        return {"ssm": ssm.ssm_defs(cfg), "norm1": rms_norm_def(cfg.d_model)}
    if cfg.family == "hybrid":
        return {"hyb": hybrid.hybrid_defs(cfg),
                "norm1": rms_norm_def(cfg.d_model),
                "norm2": rms_norm_def(cfg.d_model), "mlp": mlp_defs(cfg)}
    if cfg.family not in ("dense", "vlm", "audio", "moe"):
        raise ValueError(cfg.family)
    d = {
        "attn": attention.attention_defs(cfg),
        "norm1": rms_norm_def(cfg.d_model),
        "norm2": rms_norm_def(cfg.d_model),
    }
    if cfg.family == "moe":
        d["moe"] = moe.moe_defs(cfg)
    else:
        d["mlp"] = mlp_defs(cfg)
    return d


def model_defs(cfg: ModelConfig) -> dict:
    defs = {
        "layers": stack_defs(layer_defs(cfg), cfg.num_layers, "layers"),
        "final_norm": rms_norm_def(cfg.d_model),
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                          scale=0.02),
    }
    if cfg.frontend == "codec":
        defs["frontend_proj"] = ParamDef((cfg.frontend_dim, cfg.d_model),
                                         (None, "embed"))
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
           positions: torch.Tensor, window: Optional[int], group=None):
    """One layer. Returns (x, aux_loss): the router's aux loss for the moe
    family, None for the others (the reference's zero).  ``group``: the
    ranks the batch is split over (``forward``)."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if cfg.family == "ssm":
        return x + ssm.ssm_forward(cfg, p["ssm"], h), None
    if cfg.family == "hybrid":
        y = hybrid.hybrid_forward(cfg, p["hyb"], h, positions, window=window)
    else:
        y = attention.attend_full(
            cfg, p["attn"], h, positions,
            window=window if window is not None else cfg.attn_window)
    return _mlp_residual(cfg, p, x + y, group)


def _mlp_residual(cfg: ModelConfig, p: dict, x: torch.Tensor, group=None,
                  tp=None, fsdp=None):
    """(x + the layer's MLP of the normed x, None), or for the moe family
    (x + its routed experts over the flattened tokens, the aux loss; over
    the whole batch split over ``group``); ``tp`` / ``fsdp``: serving on
    this rank's blocks."""
    h = rms_norm(x, _norm_w(p["norm2"], fsdp), cfg.norm_eps)
    if cfg.family == "moe":
        y, aux = moe.moe_mlp(cfg, p["moe"], h.reshape(-1, h.shape[-1]),
                             group, tp, fsdp)
        return x + y.view(h.shape), aux
    return x + mlp(cfg, p["mlp"], h, tp, fsdp), None


def _norm_w(w: torch.Tensor, fsdp) -> torch.Tensor:
    """A norm's weight, whole (gathered over ``fsdp`` where its d dim
    splits over it)."""
    return fsdp_weight(w, 0, fsdp)


def _vocab_split(cfg: ModelConfig, w: torch.Tensor, dim: int, tp,
                 name: str) -> bool:
    """Whether this rank's ``w`` holds a block of the vocab (dim ``dim``)
    over ``tp`` (always on a grid: the reference's rule)."""
    return split_count(cfg.vocab_size, tp, w, dim, name, split=True)


def embed_inputs(cfg: ModelConfig, params: dict,
                 inputs: torch.Tensor, tp=None, fsdp=None) -> torch.Tensor:
    """Token ids (..., S) int -> embeddings (..., S, d); for the codec
    frontend, precomputed frame embeddings (..., S, F) pass through
    ``frontend_proj`` (in their promoted dtype, as ``jnp``'s matmul).
    With ``tp``: this rank's vocab rows looked up, zeros for the other
    ranks' ids, then one sum over ``tp``."""
    if cfg.frontend == "codec":
        proj = fsdp_weight(params["frontend_proj"], 1, fsdp)
        dt = torch.promote_types(inputs.dtype, proj.dtype)
        return inputs.to(dt) @ proj.to(dt)
    split = _vocab_split(cfg, params["embed"], 0, tp, "embed")
    emb = fsdp_weight(params["embed"], 1, fsdp)
    if not split:
        return emb[inputs]
    n = emb.shape[0]
    local = inputs - tp.index * n
    mine = (local >= 0) & (local < n)
    rows = emb[torch.where(mine, local, 0)]
    return tp.all_sum(torch.where(mine[..., None], rows,
                                  torch.zeros((), dtype=rows.dtype,
                                              device=rows.device)))


def logits_out(cfg: ModelConfig, params: dict,
               x: torch.Tensor, tp=None, fsdp=None) -> torch.Tensor:
    """The final norm, then the logits; with ``tp`` this rank's vocab
    columns, then one all-gather over ``tp`` (every rank the whole
    logits)."""
    x = rms_norm(x, _norm_w(params["final_norm"], fsdp), cfg.norm_eps)
    if cfg.tie_embeddings:
        split = _vocab_split(cfg, params["embed"], 0, tp, "embed")
        y = torch.einsum("...d,vd->...v", x,
                         fsdp_weight(params["embed"], 1, fsdp))
    else:
        split = _vocab_split(cfg, params["lm_head"], 1, tp, "lm_head")
        y = x @ fsdp_weight(params["lm_head"], 0, fsdp)
    return tp.gather_dim(y, -1) if split else y


def forward(cfg: ModelConfig, params: dict, inputs: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            window: Optional[int] = None, remat: bool = False,
            return_hidden: bool = False, return_aux: bool = False,
            group=None):
    """Full-sequence forward over token ids (..., S) (codec: frame
    embeddings (..., S, F)) -> logits (..., S, V), or with
    ``return_hidden`` the post-final-norm hidden states (..., S, d), for
    the vocab-streaming loss (``train.loss.chunked_cross_entropy_lm``).
    ``remat`` recomputes each layer's activations in the backward.
    ``group`` (a ``comm.collectives.MeshGroup``): the inputs are this
    rank's slice, the f-th of F equal ones, of a batch split over the
    group's ranks; the routed layers dispatch and take their aux loss over
    the whole batch (``models.moe``).  Every other layer is per token.

    With ``return_aux`` it returns (that, aux) as the reference always
    does: the router's aux loss summed over layers ÷ the layer count, an
    fp32 scalar (0 for the families without a router)."""
    x = embed_inputs(cfg, params, inputs)
    if positions is None:
        positions = torch.arange(x.shape[-2], device=x.device).expand(
            x.shape[:-1])
    block = _block_remat if remat else _block
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # unbind once: its backward stacks the L layer gradients in one pass,
    # where L separate a[i] selects would each scatter into a zeroed
    # full-depth buffer (O(L²) traffic)
    for layer_p in _layers(cfg, params):
        x, a = block(cfg, layer_p, x, positions, window, group)
        if a is not None:
            aux = aux + a
    out = (rms_norm(x, params["final_norm"], cfg.norm_eps) if return_hidden
           else logits_out(cfg, params, x))
    return (out, aux / cfg.num_layers) if return_aux else out


def _block_remat(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 positions: torch.Tensor, window: Optional[int],
                 group=None):
    """``_block`` under non-reentrant activation checkpointing.  The
    layer's parameter views (of the one ``unbind`` in ``_layers``) go in
    as the checkpoint's inputs, so the recomputed block's gradients reach
    them, and through the unbind the stacked leaves; the block's (x, aux)
    come out of the checkpoint, so the aux loss's gradient flows through
    the recomputed router too; a ``group``'s collectives run again in the
    recompute, on the same operands."""
    paths, leaves = zip(*tree_mod.leaves_with_path(p))

    def run(x, *leaves):
        return _block(cfg, tree_mod.from_paths(list(zip(paths, leaves))), x,
                      positions, window, group)
    return checkpoint(run, x, *leaves, use_reentrant=False)


def _layers(cfg: ModelConfig, params: dict) -> list:
    """The per-layer parameter trees, views of the stacked leaves."""
    per_layer = tree_mod.tree_map(lambda a: a.unbind(0), params["layers"])
    return [tree_mod.tree_map(lambda t: t[i], per_layer)
            for i in range(cfg.num_layers)]


def _stack(caches: list) -> dict:
    """Per-layer cache trees -> one tree, every leaf stacked on a leading
    layer axis."""
    return tree_mod.tree_map(lambda *xs: torch.stack(xs), *caches)


def _layer_cache(cache: dict, i: int) -> dict:
    """Layer ``i``'s cache tree (views of the stacked leaves)."""
    return tree_mod.tree_map(lambda t: t[i], cache)


# ------------------------------------------------------------------- decode
def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype: torch.dtype = torch.bfloat16,
               window: Optional[int] = None,
               device: torch.device | str = "cpu", tp=None) -> dict:
    """Per-layer caches (KV; for ssm the SSM state and conv window; for
    the hybrid both, nested ``{"attn": {k, v}, "ssm": {state, conv}}``,
    its KV over min(cache_len, window) slots) stacked on a leading layer
    axis (zeros).  With ``tp`` this rank's block (``batch`` its rows):
    its kv heads, or its slots where the kv heads do not divide ``tp``;
    its SSM heads' state where they divide ``tp``, the conv window
    whole."""
    if cfg.family == "ssm":
        layer = ssm.init_ssm_cache(cfg, batch, dtype, device, tp)
    elif cfg.family == "hybrid":
        w = window if window is not None else cfg.attn_window
        alen = min(cache_len, w) if w else cache_len
        layer = hybrid.init_hybrid_cache(cfg, batch, alen, dtype, device,
                                         tp)
    else:
        eff_len = min(cache_len, window) if window is not None \
            else cache_len
        layer = attention.init_kv_cache(cfg, batch, eff_len, dtype, device,
                                        tp)
    return tree_mod.tree_map(
        lambda t: torch.zeros((cfg.num_layers, *t.shape), dtype=t.dtype,
                              device=t.device), layer)


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                inputs: torch.Tensor, pos,
                window: Optional[int] = None, tp=None, fsdp=None,
                group=None):
    """One-token decode against a cache. inputs: (B, 1) ids (codec: frame
    embeddings (B, 1, F)); pos: the position of that token (an int or a
    0-d tensor, read on the host; the ssm family's decode does not read
    it).  ``tp``, ``fsdp``, ``group``: serving on this rank's blocks of a
    grid (the module's docstring).

    Returns (logits (B, 1, V), new_cache); ``cache`` is left as it was.
    """
    x = embed_inputs(cfg, params, inputs, tp, fsdp)
    eff_window = window if window is not None else cfg.attn_window
    new = []
    for i, layer_p in enumerate(_layers(cfg, params)):
        layer_c = _layer_cache(cache, i)
        h = rms_norm(x, _norm_w(layer_p["norm1"], fsdp), cfg.norm_eps)
        if cfg.family == "ssm":
            y, c = ssm.ssm_decode_step(cfg, layer_p["ssm"], h, layer_c, tp)
            x = x + y
        else:
            if cfg.family == "hybrid":
                y, c = hybrid.hybrid_decode_step(cfg, layer_p["hyb"], h,
                                                 layer_c, pos, window=window,
                                                 tp=tp)
            else:
                y, c = attention.decode_attend(cfg, layer_p["attn"], h,
                                               layer_c, pos,
                                               window=eff_window, tp=tp,
                                               fsdp=fsdp)
            # the aux loss is dropped, as the reference's decode drops it
            x, _ = _mlp_residual(cfg, layer_p, x + y, group, tp, fsdp)
        new.append(c)
    return logits_out(cfg, params, x, tp, fsdp), _stack(new)


def prefill(cfg: ModelConfig, params: dict, inputs: torch.Tensor,
            cache_len: int, window: Optional[int] = None,
            last_only: bool = False, tp=None, fsdp=None, group=None):
    """Cache-building prefill: the full-sequence forward over ``inputs``
    (B, S) ids (codec: frame embeddings (B, S, F)) that also emits every
    layer's decode cache (KV; for ssm the final SSM state and the conv
    window, ``cache_len`` unused; for the hybrid both), stacked on the
    layer axis.

    Returns (logits (B, S, V) — (B, 1, V) with ``last_only`` — , cache);
    the cache is layout-compatible with ``init_cache``/``decode_step``, in
    the activations' dtype.  ``tp``, ``fsdp``, ``group``: serving on this
    rank's blocks of a grid (the module's docstring).
    """
    x = embed_inputs(cfg, params, inputs, tp, fsdp)
    positions = torch.arange(x.shape[-2], device=x.device).expand(
        x.shape[:-1])
    eff_window = window if window is not None else cfg.attn_window
    caches = []
    for layer_p in _layers(cfg, params):
        h = rms_norm(x, _norm_w(layer_p["norm1"], fsdp), cfg.norm_eps)
        if cfg.family == "ssm":
            y, c = ssm.ssm_forward(cfg, layer_p["ssm"], h, return_cache=True,
                                   tp=tp)
            x = x + y
        else:
            if cfg.family == "hybrid":
                y, c = hybrid.hybrid_forward(
                    cfg, layer_p["hyb"], h, positions, window=window,
                    return_cache=True, cache_len=cache_len, tp=tp)
            else:
                y, kv = attention.attend_full(cfg, layer_p["attn"], h,
                                              positions, window=eff_window,
                                              return_kv=True, tp=tp,
                                              fsdp=fsdp)
                c = attention.prefill_kv_cache(cfg, kv, cache_len,
                                               eff_window, x.dtype, tp)
            x, _ = _mlp_residual(cfg, layer_p, x + y, group, tp, fsdp)
        caches.append(c)
    if last_only:
        # serving needs only the next-token distribution: logits for every
        # prefill position would be a (B, S, V) tensor for nothing
        x = x[..., -1:, :]
    return logits_out(cfg, params, x, tp, fsdp), _stack(caches)
