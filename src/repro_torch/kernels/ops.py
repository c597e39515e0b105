"""User-facing kernel ops (``repro.kernels.ops``): the attention op, the
SSD op and the tree-update API.

``mha_flash`` is causal (and sliding-window) attention over (B, S, H, D)
queries with GQA keys and values, the reference wrapper's function: on the
card one launch of ``csrc/flash_attention.cu``, which reads the KV head
h // group and the caller's strides in place (the reference repeats the KV
heads, moves the heads next to the batch and pads a copy); for CPU tensors
the plain version with the reference's layout steps
(``kernels/flash_attention.mha_flash_ref``).

``ssd_chunk_scan`` is the Mamba2 SSD chunked scan over (B, L, H, P) inputs
with B and C shared across heads, the reference wrapper's function: on the
card one launch of ``csrc/ssd_scan.cu``, which reads the caller's strides
in place and reads a short last chunk as zero-padded (the reference moves
the heads next to the batch and pads a copy); for CPU tensors the plain
version with the reference's layout steps
(``kernels/ssd_scan.ssd_chunk_scan_ref``).

``vrl_local_update_tree`` / ``vrl_sync_update_tree`` apply the paper's
local step (eqs. 5-6) and sync (eq. 4) leaf by leaf over whole parameter
trees, one kernel launch per leaf (``kernels/vrl_update.vrl_local_update``
/ ``vrl_sync_update``, ``csrc/leaf_update.cu`` on the card, the plain
versions for CPU tensors).  The flat-buffer engine (``core.engine
.make_engine``) is the preferred path for training — one kernel for the
whole model instead of one per leaf.

The reference pads each leaf to a (R, 256) tile multiple for its Pallas
blocks (``_leaf_tile``, ``_to_2d``); the kernels here take the element
count and handle the tail, so nothing is padded and ``block`` is accepted
and ignored.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch import tree as tree_mod
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels import vrl_update as vu


# ------------------------------------------------------------ attention op
def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, KVH, D) -> (B, S, H, D) in q's dtype.

    The KV heads serve H / KVH query heads each (GQA), and S is padded with
    zeros to a multiple of max(block_q, block_k), as the reference pads: so
    with ``causal=False`` the queries attend to the padded zero keys too
    (score 0, value 0), as they do in the reference.
    """
    if q.device.type == "cpu":
        return fa.mha_flash_ref(q, k, v, causal=causal, window=window,
                                block_q=block_q, block_k=block_k)
    s = q.shape[1]
    s_pad = s + (-s) % max(block_q, block_k)
    fa.check_blocks(s_pad, block_q, block_k)
    return fa.attend_bshd(q, k, v, causal=causal, window=window,
                          s_pad=s_pad)


# ------------------------------------------------------------------ ssd op
def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, *,
                   chunk: int = 256) -> torch.Tensor:
    """x: (B, L, H, P); dt: (B, L, H); a_log: (H,); b, c: (B, L, N) ->
    y (B, L, H, P) in x's dtype, in chunks of min(chunk, L) steps (L
    zero-padded to a multiple: the padded steps are exact no-ops)."""
    if x.device.type == "cpu":
        return ssd.ssd_chunk_scan_ref(x, dt, a_log, b, c, chunk=chunk)
    return ssd.scan_blhp(x, dt, a_log, b, c, chunk=min(chunk, x.shape[1]))


def vrl_local_update_tree(params: Any, grads: Any, delta: Any, *, lr: float,
                          block: int = 0) -> Any:
    """p' = p − γ(g − Δ) over a whole tree; Δ is cast to p's dtype (in the
    kernel), as the reference's wrapper casts it.  Returns the new
    parameter tree."""
    def one(p, g, d):
        return vu.vrl_local_update(p.contiguous(), g.contiguous(),
                                   d.contiguous(), lr=lr, block=block)

    return tree_mod.tree_map(one, params, grads, delta)


def _xbar_operand(xb: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """x̂ for one leaf of ``shape``: its leading size-1 axes dropped, so a
    worker-mean (1, ...) or a single-model x̂ reaches the kernel as p's
    trailing shape (read with a stride of 0 over the leading axes);
    another broadcast is materialised."""
    try:
        fits = torch.broadcast_shapes(xb.shape, shape) == shape
    except RuntimeError:
        fits = False
    if not fits:
        raise ValueError(f"xbar {tuple(xb.shape)} does not broadcast to the "
                         f"leaf's {tuple(shape)}")
    while xb.dim() > 0 and xb.shape[0] == 1 and \
            tuple(xb.shape) != tuple(shape[len(shape) - xb.dim():]):
        xb = xb[0]
    if tuple(xb.shape) != tuple(shape[len(shape) - xb.dim():]):
        xb = xb.expand(shape)
    return xb.contiguous()


def vrl_sync_update_tree(params: Any, xbar: Any, delta: Any, *, k: int,
                         lr: float, block: int = 0):
    """Δ' = Δ + (x̂ − p)/(kγ); p' = x̂ over a whole tree, as a product by
    inv_kg = 1/(k·γ) formed in double on the host (the reference's
    ``inv_kg``), rounded to fp32 once.  x̂ broadcasts to each leaf's shape.
    Returns (new params tree, new Δ tree): p' in p's dtype, Δ' in Δ's."""
    inv_kg = 1.0 / (k * lr)

    def one(p, xb, d):
        return vu.vrl_sync_update(p.contiguous(), _xbar_operand(xb, p.shape),
                                  d.contiguous(), inv_kg=inv_kg, block=block)

    outs = tree_mod.tree_map(one, params, xbar, delta)
    return tree_mod.pick(outs, 0), tree_mod.pick(outs, 1)
