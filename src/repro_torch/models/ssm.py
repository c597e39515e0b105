"""Mamba2 SSD (state-space duality) block (``repro.models.ssm``): chunked
training forward and O(1)-state decode.

Layout notes
  d_inner = expand * d_model, heads h = d_inner / ssm_head_dim, state n.
  B, C are shared across heads (n_groups = 1, as in Mamba2 small configs).

Recurrence (discrete):
  a_t     = exp(dt_t * A_h)                      (per head)
  S_t     = a_t * S_{t-1} + dt_t * x_t ⊗ B_t     (S: (h, p, n))
  y_t     = S_t · C_t + D_h * x_t

Training uses the chunked SSD algorithm (intra-chunk quadratic term +
inter-chunk state carry); the reference's ``lax.scan`` over chunks is a
Python loop carrying the (B, h, p, n) fp32 state.  This is the model's own
plain-tensor scan, as in the reference: it also returns the final state,
which prefill needs.  The hand-written kernel of the same scan is an op of
its own (``kernels.ssd_chunk_scan``), which no model calls (as in the
reference).

``jax.nn.softplus`` is ``logaddexp(x, 0)``: ``_softplus`` keeps that form
(``F.softplus`` switches to x above a threshold).

Serving on a rank grid (``tp``: the tensor ranks, a
``comm.collectives.MeshGroup``), on this rank's blocks of the weights
(``sharding.specs.rank_params``, the ``ssm_inner`` rule: where d_inner
divides the tensor ranks):

  * ``wz``, ``wx`` and ``conv_x`` hold the rank's columns of the inner
    channels, ``norm_w`` its slice and ``out_proj`` its rows; ``wB``,
    ``wC``, ``wdt``, ``conv_B``, ``conv_C``, ``A_log``, ``D`` and
    ``dt_bias`` stay whole;
  * the rank's SSM heads are the contiguous block under its channels.
    Where the heads divide the tensor ranks (``cache_specs``' rule), the
    rank scans its own heads, with ``dt``, ``A_log`` and ``D`` sliced to
    them, and its cache holds their state; otherwise (a head splits over
    two ranks) the channels after the conv are all-gathered, every rank
    scans every head and holds the whole state, then keeps its channels;
  * the conv window (B, k−1, d_inner + 2N) is whole on every rank, so the
    rank's new x channels are all-gathered before they join it (in the
    split-head case in the same all-gather as the conv's output);
  * the gated norm over the split inner dim takes its fp32 sum of squares
    with one sum over ``tp``, and ``out_proj`` is row-parallel, then one
    sum: three "tensor" collectives a layer, prefill or decode.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import split_count
from repro_torch.models.param import ParamDef

F32 = torch.float32


def ssm_defs(cfg: ModelConfig) -> dict:
    d, di, n = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
    h, k = cfg.ssm_num_heads, cfg.conv_kernel
    return {
        "wz": ParamDef((d, di), ("embed", "ssm_inner")),
        "wx": ParamDef((d, di), ("embed", "ssm_inner")),
        "wB": ParamDef((d, n), ("embed", None)),
        "wC": ParamDef((d, n), ("embed", None)),
        "wdt": ParamDef((d, h), ("embed", None)),
        "conv_x": ParamDef((k, di), (None, "ssm_inner"), scale=0.5),
        "conv_B": ParamDef((k, n), (None, None), scale=0.5),
        "conv_C": ParamDef((k, n), (None, None), scale=0.5),
        "A_log": ParamDef((h,), (None,), init="zeros"),
        "D": ParamDef((h,), (None,), init="ones"),
        "dt_bias": ParamDef((h,), (None,), init="zeros"),
        "norm_w": ParamDef((di,), ("ssm_inner",), init="ones"),
        "out_proj": ParamDef((di, d), ("ssm_inner", "embed")),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, x.new_zeros(()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (b, l, c); w: (K, c).  The K shifted
    products summed in the reference's order, then silu."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    l = x.shape[1]
    out = pad[:, 0:l, :] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + l, :] * w[i]
    return F.silu(out)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                eps: float, tp=None, n: int = 0) -> torch.Tensor:
    """The gated RMS norm over the inner dim; with ``tp`` over a rank's
    slice of it (``n`` channels whole): the fp32 sum of squares summed
    over ``tp``, ÷ ``n``."""
    dt = y.dtype
    y = (y * F.silu(z)).to(F32)
    if tp is None:
        ms = torch.mean(y * y, dim=-1, keepdim=True)
    else:
        ms = tp.all_sum(torch.sum(y * y, dim=-1, keepdim=True)) / n
    y = y * torch.rsqrt(ms + eps)
    return (y * w.to(F32)).to(dt)


class _Layout(NamedTuple):
    """How this rank's SSM blocks lie over the tensor ranks: ``split``
    (the inner channels split over them), ``heads`` (so do the heads),
    this rank's first channel ``c0`` and channels ``c``, its first head
    ``h0`` and heads ``h`` (all of them where they do not split)."""

    split: bool
    heads: bool
    c0: int
    c: int
    h0: int
    h: int


def _layout(cfg: ModelConfig, p: dict, tp) -> _Layout:
    """This rank's ``_Layout``, its blocks checked against it (a whole
    weight on a rank of a grid that splits it is refused)."""
    di, nh = cfg.ssm_d_inner, cfg.ssm_num_heads
    split = split_count(di, tp, p["wx"], 1, "wx")
    split_count(di, tp, p["out_proj"], 0, "out_proj", split=split)
    if not split:
        return _Layout(False, False, 0, di, 0, nh)
    t, r = tp.size, tp.index
    heads = nh % t == 0
    c = di // t
    h = nh // t if heads else nh
    return _Layout(True, heads, r * c, c, r * h if heads else 0, h)


def _heads(lay: _Layout, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``t``'s slice of this rank's heads along ``dim`` (all where the
    heads do not split)."""
    return t.narrow(dim, lay.h0, lay.h) if lay.heads else t


def _own(lay: _Layout, t: torch.Tensor) -> torch.Tensor:
    """The rank's channels of ``t`` (..., channels of the rank's heads):
    all of them but where a head splits, which scans every head."""
    return t.narrow(-1, lay.c0, lay.c) if lay.split and not lay.heads \
        else t


def _gather_channels(tp, *parts: torch.Tensor) -> list:
    """Each of ``parts`` (B, n_i, c) with every rank's channels joined in
    rank order (B, n_i, c·t): one all-gather over ``tp`` of the parts
    stacked along dim 1."""
    whole = tp.gather_dim(torch.cat(parts, dim=1), -1)
    return list(whole.split([t.shape[1] for t in parts], dim=1))


def _out_proj(p: dict, y: torch.Tensor, tp, split: bool) -> torch.Tensor:
    """``out_proj`` over this rank's channels of ``y``; row-parallel
    where the inner dim splits: then one sum over ``tp``."""
    out = y @ p["out_proj"]
    return tp.all_sum(out) if split else out


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                state_in: torch.Tensor | None = None,
                return_state: bool = False):
    """Chunked SSD scan.

    x: (B, L, h, p)   dt: (B, L, h)   a_log: (h,)  (A = -exp(a_log))
    b, c: (B, L, n)   chunk: Q, must divide L.
    Returns y: (B, L, h, p) [, final_state (B, h, p, n)].
    """
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    q = chunk
    nc = l // q
    assert nc * q == l, (l, q)

    xd = (x * dt[..., None]).to(F32)                     # dt folded into x
    la = dt.to(F32) * (-torch.exp(a_log.to(F32)))        # (B, L, h) log-decay
    xd = xd.reshape(bsz, nc, q, h, p)
    la = la.reshape(bsz, nc, q, h)
    bc = b.to(F32).reshape(bsz, nc, q, n)
    cc = c.to(F32).reshape(bsz, nc, q, n)

    cum = torch.cumsum(la, dim=2)                        # (B, nc, q, h)
    # --- intra-chunk (quadratic in q) --------------------------------------
    # decay[i, j] = exp(cum_i - cum_j) for j <= i
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, i, j, h)
    ar = torch.arange(q, device=x.device)
    mask = (ar[:, None] >= ar[None, :])[None, None, :, :, None]
    decay = torch.exp(torch.where(mask, seg, -1e30))  # finite: NaN-safe grads
    cb = torch.einsum("bzin,bzjn->bzij", cc, bc)         # (B, nc, i, j)
    y_intra = torch.einsum("bzij,bzijh,bzjhp->bzihp", cb, decay, xd)

    # --- chunk summary states ----------------------------------------------
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)    # (B, nc, q, h)
    s_chunk = torch.einsum("bzqn,bzqh,bzqhp->bzhpn", bc, decay_to_end, xd)
    lam = torch.exp(cum[:, :, -1, :])                    # (B, nc, h)

    # --- inter-chunk recurrence (a loop over chunks) ------------------------
    if state_in is None:
        state_in = torch.zeros((bsz, h, p, n), dtype=F32, device=x.device)
    carry, states = state_in, []
    for z in range(nc):
        states.append(carry)                             # state entering z
        carry = lam[:, z, :, None, None] * carry + s_chunk[:, z]
    final_state = carry
    states_in = torch.stack(states, dim=1)               # (B, nc, h, p, n)

    # --- inter-chunk contribution -------------------------------------------
    decay_from_start = torch.exp(cum)                    # (B, nc, q, h)
    y_inter = torch.einsum("bzqn,bzhpn,bzqh->bzqhp", cc, states_in,
                           decay_from_start)

    y = (y_intra + y_inter).reshape(bsz, l, h, p).to(x.dtype)
    if return_state:
        return y, final_state
    return y


def ssm_forward(cfg: ModelConfig, p: dict, u: torch.Tensor,
                return_cache: bool = False, tp=None):
    """Full-sequence forward. u: (B, L, d_model).  ``tp``: serving on this
    rank's blocks (the module's docstring); the cache is then this rank's
    block of it (``init_ssm_cache``)."""
    bsz, l, _ = u.shape
    lay = _layout(cfg, p, tp)
    hd = cfg.ssm_head_dim
    z = u @ p["wz"]
    x_in, b_in, c_in = u @ p["wx"], u @ p["wB"], u @ p["wC"]
    x = _causal_conv(x_in, p["conv_x"])
    b = _causal_conv(b_in, p["conv_B"])
    c = _causal_conv(c_in, p["conv_C"])
    dt = _softplus(u @ p["wdt"] + p["dt_bias"])          # (B, L, h)
    k = cfg.conv_kernel
    # the last k − 1 inputs, the conv window the cache keeps
    tail = F.pad(x_in, (0, 0, max(0, k - 1 - l), 0))[:, -(k - 1):]
    if lay.split and not lay.heads:
        # a head splits over two ranks: every rank scans every head
        x, tail = _gather_channels(tp, x, tail)
    elif lay.split:
        tail = _gather_channels(tp, tail)[0]
    xh = x.reshape(bsz, l, lay.h, hd)
    dt = _heads(lay, dt)
    chunk = min(cfg.ssm_chunk, l)
    pad = (-l) % chunk
    if pad:
        # padded steps are exact no-ops: dt = 0 there (decay exp(0) = 1)
        # and B = 0 (no update), so the final state is the unpadded one
        xp = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dtp, bp, cp = (F.pad(t, (0, 0, 0, pad)) for t in (dt, b, c))
    else:
        xp, dtp, bp, cp = xh, dt, b, c
    y = ssd_chunked(xp, dtp, _heads(lay, p["A_log"]), bp, cp, chunk,
                    return_state=return_cache)
    if return_cache:
        y, final_state = y
    if pad:
        y = y[:, :l]
    y = y + _heads(lay, p["D"])[None, None, :, None] * xh
    y = _own(lay, y.reshape(bsz, l, lay.h * hd))
    y = _gated_norm(y, z, p["norm_w"], cfg.norm_eps,
                    tp if lay.split else None, cfg.ssm_d_inner)
    out = _out_proj(p, y, tp, lay.split)
    if return_cache:
        b_tail, c_tail = (F.pad(t, (0, 0, max(0, k - 1 - l), 0))[:, -(k - 1):]
                          for t in (b_in, c_in))
        conv_window = torch.cat([tail, b_tail, c_tail], -1)
        return out, {"state": final_state,
                     "conv": conv_window.to(out.dtype)}
    return out


# ---------------------------------------------------------------- decode
def init_ssm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device: torch.device | str = "cpu", tp=None) -> dict:
    """Zeros of the decode cache; with ``tp`` this rank's block
    (``sharding.specs.cache_specs``): the state of its heads where the
    heads divide the tensor ranks, else every head's; the conv window
    whole."""
    h, hd, n, k = (cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state,
                   cfg.conv_kernel)
    if tp is not None and h % tp.size == 0:
        h //= tp.size
    return {
        "state": torch.zeros((batch, h, hd, n), dtype=F32, device=device),
        "conv": torch.zeros((batch, k - 1, cfg.ssm_d_inner + 2 * n),
                            dtype=dtype, device=device),
    }


def ssm_decode_step(cfg: ModelConfig, p: dict, u: torch.Tensor,
                    cache: dict, tp=None):
    """One-token decode. u: (B, 1, d_model). Returns (y (B,1,d), cache).

    The conv window keeps the cache's dtype (the new xbc is rounded to it
    before it joins); jnp's einsum promotes the window against the conv
    weights, which ``torch.einsum`` does not, so the cast is explicit.
    ``tp``: serving on this rank's blocks and its cache block (the
    module's docstring): the conv over its own channels of the window."""
    bsz = u.shape[0]
    lay = _layout(cfg, p, tp)
    hd, n, di = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_d_inner
    u0 = u[:, 0]
    z = u0 @ p["wz"]
    x_new, b_new, c_new = u0 @ p["wx"], u0 @ p["wB"], u0 @ p["wC"]
    window = cache["conv"]
    # this rank's channels of the window, then B's and C's, the new step
    # last
    own = torch.cat([window[..., lay.c0:lay.c0 + lay.c], window[..., di:]],
                    -1)
    xbc = torch.cat([x_new, b_new, c_new], -1)
    own = torch.cat([own, xbc[:, None, :].to(window.dtype)], 1)
    conv_w = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], -1)
    ct = torch.promote_types(own.dtype, conv_w.dtype)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", own.to(ct), conv_w.to(ct)))
    x, b, c = (conv_out[:, :lay.c], conv_out[:, lay.c:lay.c + n],
               conv_out[:, lay.c + n:])
    if lay.split and not lay.heads:
        # a head splits over two ranks: every head's channels, beside the
        # window's new x
        x_new, x = (t[:, 0] for t in _gather_channels(
            tp, x_new.to(ct)[:, None], x[:, None]))
    elif lay.split:
        x_new = _gather_channels(tp, x_new[:, None])[0][:, 0]
    new = torch.cat([x_new, b_new, c_new], -1)[:, None, :]
    window = torch.cat([window[:, 1:], new.to(window.dtype)], 1)
    dt = _heads(lay, _softplus(u0 @ p["wdt"] + p["dt_bias"]).to(F32))
    a = torch.exp(dt * (-torch.exp(_heads(lay, p["A_log"]).to(F32))))
    xh = x.reshape(bsz, lay.h, hd).to(F32)
    outer = torch.einsum("bhp,bn->bhpn", xh * dt[..., None], b.to(F32))
    state = a[..., None, None] * cache["state"] + outer
    y = torch.einsum("bhpn,bn->bhp", state, c.to(F32))
    y = y + _heads(lay, p["D"]).to(F32)[None, :, None] * xh
    y = _own(lay, y.reshape(bsz, lay.h * hd).to(u.dtype))
    y = _gated_norm(y, z, p["norm_w"], cfg.norm_eps,
                    tp if lay.split else None, di)
    y = _out_proj(p, y, tp, lay.split)[:, None, :]
    return y, {"state": state, "conv": window}
