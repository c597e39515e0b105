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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
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
                eps: float) -> torch.Tensor:
    dt = y.dtype
    y = (y * F.silu(z)).to(F32)
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + eps)
    return (y * w.to(F32)).to(dt)


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
                return_cache: bool = False):
    """Full-sequence forward. u: (B, L, d_model)."""
    bsz, l, _ = u.shape
    h, hd = cfg.ssm_num_heads, cfg.ssm_head_dim
    z = u @ p["wz"]
    x_in, b_in, c_in = u @ p["wx"], u @ p["wB"], u @ p["wC"]
    x = _causal_conv(x_in, p["conv_x"])
    b = _causal_conv(b_in, p["conv_B"])
    c = _causal_conv(c_in, p["conv_C"])
    dt = _softplus(u @ p["wdt"] + p["dt_bias"])          # (B, L, h)
    xh = x.reshape(bsz, l, h, hd)
    chunk = min(cfg.ssm_chunk, l)
    pad = (-l) % chunk
    if pad:
        # padded steps are exact no-ops: dt = 0 there (decay exp(0) = 1)
        # and B = 0 (no update), so the final state is the unpadded one
        xp = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dtp, bp, cp = (F.pad(t, (0, 0, 0, pad)) for t in (dt, b, c))
    else:
        xp, dtp, bp, cp = xh, dt, b, c
    y = ssd_chunked(xp, dtp, p["A_log"], bp, cp, chunk,
                    return_state=return_cache)
    if return_cache:
        y, final_state = y
    if pad:
        y = y[:, :l]
    y = y + p["D"][None, None, :, None] * xh
    y = y.reshape(bsz, l, h * hd)
    y = _gated_norm(y, z, p["norm_w"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if return_cache:
        k = cfg.conv_kernel
        xbc = torch.cat([x_in, b_in, c_in], -1)
        pad_w = F.pad(xbc, (0, 0, max(0, k - 1 - l), 0))
        conv_window = pad_w[:, -(k - 1):, :]
        return out, {"state": final_state,
                     "conv": conv_window.to(out.dtype)}
    return out


# ---------------------------------------------------------------- decode
def init_ssm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device: torch.device | str = "cpu") -> dict:
    h, hd, n, k = (cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state,
                   cfg.conv_kernel)
    return {
        "state": torch.zeros((batch, h, hd, n), dtype=F32, device=device),
        "conv": torch.zeros((batch, k - 1, cfg.ssm_d_inner + 2 * n),
                            dtype=dtype, device=device),
    }


def ssm_decode_step(cfg: ModelConfig, p: dict, u: torch.Tensor,
                    cache: dict):
    """One-token decode. u: (B, 1, d_model). Returns (y (B,1,d), cache).

    The conv window keeps the cache's dtype (the new xbc is rounded to it
    before it joins); jnp's einsum promotes the window against the conv
    weights, which ``torch.einsum`` does not, so the cast is explicit."""
    bsz = u.shape[0]
    h, hd, n = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state
    u0 = u[:, 0]
    z = u0 @ p["wz"]
    xbc = torch.cat([u0 @ p["wx"], u0 @ p["wB"], u0 @ p["wC"]], -1)
    conv_w = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], -1)
    window = torch.cat([cache["conv"],
                        xbc[:, None, :].to(cache["conv"].dtype)], 1)
    ct = torch.promote_types(window.dtype, conv_w.dtype)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window.to(ct),
                                   conv_w.to(ct)))
    di = cfg.ssm_d_inner
    x, b, c = conv_out[:, :di], conv_out[:, di:di + n], conv_out[:, di + n:]
    dt = _softplus(u0 @ p["wdt"] + p["dt_bias"]).to(F32)        # (B, h)
    a = torch.exp(dt * (-torch.exp(p["A_log"].to(F32))))         # (B, h)
    xh = x.reshape(bsz, h, hd).to(F32)
    outer = torch.einsum("bhp,bn->bhpn", xh * dt[..., None], b.to(F32))
    state = a[..., None, None] * cache["state"] + outer
    y = torch.einsum("bhpn,bn->bhp", state, c.to(F32))
    y = y + p["D"].to(F32)[None, :, None] * xh
    y = y.reshape(bsz, h * hd).to(u.dtype)
    y = _gated_norm(y, z, p["norm_w"], cfg.norm_eps)
    y = (y @ p["out_proj"])[:, None, :]
    return y, {"state": state, "conv": window[:, 1:]}
