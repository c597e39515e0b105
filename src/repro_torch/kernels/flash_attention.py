"""Causal (and sliding-window) attention forward for Hopper
(``repro.kernels.flash_attention``).

  s   = (q · kᵀ) · D^-½ in fp32;  s = −1e30 where key > query (causal) or
        key ≤ query − window
  out = softmax(s) · v, as acc / max(l, 1e-30), in q's dtype

``flash_attention`` takes (BH, S, D) operands as the reference's kernel
does; ``ops.mha_flash`` takes (B, S, H, D) queries and (B, S, KVH, D) keys
and values and reaches the same kernel through ``attend_bshd`` with their
strides, so neither the GQA repeat nor the head-major copy is made.  For a
CUDA tensor the wrapper launches ``csrc/flash_attention.cu`` (built at first
use by ``kernels/build``) or raises; for a CPU tensor it runs the plain
version, ``flash_attention_ref``.  ``LAUNCHES`` counts kernel launches (a
CPU call is not a launch).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
# the kernel's instantiated widths; any head dim up to MAX_HEAD_DIM runs on
# the narrowest one at least as wide (zero columns past it)
INSTANCE_DIMS = (16, 32, 64, 80, 96, 112, 128, 256)
MAX_HEAD_DIM = INSTANCE_DIMS[-1]
DTYPES = (torch.float32, torch.bfloat16)
LAUNCHES = {"flash_attention": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ plain versions
def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """The Pallas kernel's function over (BH, S, D), in one softmax: inputs
    read as fp32, fp32 throughout, masked scores −1e30, acc / max(l, 1e-30)
    rounded to q's dtype.  (``repro.kernels.ref.flash_attention_ref``
    differs for bf16 only: it multiplies in the input dtype.)"""
    qf, kf, vf = (x.to(torch.float32) for x in (q, k, v))
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * q.shape[-1] ** -0.5
    qi = torch.arange(q.shape[1], device=q.device)[:, None]
    ki = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones_like(s, dtype=torch.bool)
    if causal:
        mask = mask & (ki <= qi)
    if window is not None:
        mask = mask & (ki > qi - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    acc = torch.einsum("bqk,bkd->bqd", p, vf)
    return (acc / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)


def mha_flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """``ops.mha_flash``'s plain version, the reference wrapper's layout
    step by step: KV heads repeated, (B·H, S, D) head-major, S padded with
    zeros to a multiple of max(block_q, block_k), the padding sliced off."""
    b, s, h, d = q.shape
    group = gqa_group(q, k, v)
    if group > 1:
        k = torch.repeat_interleave(k, group, dim=2)
        v = torch.repeat_interleave(v, group, dim=2)
    pad = (-s) % max(block_q, block_k)
    check_blocks(s + pad, block_q, block_k)
    qt, kt, vt = (torch.movedim(x, 2, 1).reshape(b * h, s, d)
                  for x in (q, k, v))
    if pad:
        qt, kt, vt = (torch.nn.functional.pad(x, (0, 0, 0, pad))
                      for x in (qt, kt, vt))
    out = flash_attention_ref(qt, kt, vt, causal=causal, window=window)
    return torch.movedim(out[:, :s].reshape(b, h, s, d), 1, 2)


# ----------------------------------------------------------------- checks
def head_dim_supported(d: int) -> bool:
    """True for the head dims the kernel takes: 1 ≤ d ≤ MAX_HEAD_DIM (256).
    Past 256 the fp32 instantiation's Q tile and two-stage K/V ring would
    not fit an SM block's 227 KB of shared memory."""
    return 1 <= d <= MAX_HEAD_DIM


def check_head_dim(name: str, d: int) -> None:
    if not head_dim_supported(d):
        raise ValueError(
            f"{name}: head dim {d}; the kernel takes 1 ≤ D ≤ {MAX_HEAD_DIM} "
            f"(past {MAX_HEAD_DIM} the fp32 Q tile and K/V ring of a block "
            f"of 64 queries would not fit an SM's 227 KB of shared memory)")


def check_blocks(s: int, block_q: int, block_k: int) -> None:
    """The reference kernel's assert: S divides into both block sizes."""
    assert s % block_q == 0 and s % block_k == 0, (s, block_q, block_k)


def gqa_group(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """Query heads per KV head of (B, S, H, D) q and (B, S, KVH, D) k, v."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"mha_flash: q (B, S, H, D) and k, v (B, S, KVH, "
                         f"D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    (b, s, h, d), kvh = q.shape, k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d) or kvh == 0 \
            or h % kvh:
        raise ValueError(f"mha_flash: k, v {tuple(k.shape)} do not serve q "
                         f"{tuple(q.shape)} (KVH must divide H)")
    return h // kvh


_PTR = ctypes.c_void_p


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    i64, cint = ctypes.c_int64, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [
        _PTR, _PTR, _PTR, _PTR, cint, i64, cint, cint, cint, cint, cint,
        ctypes.POINTER(i64), cint, cint, cint, ctypes.c_float, _PTR]
    lib.flash_attention_fwd.restype = cint
    return lib


def _loadable(x: torch.Tensor) -> torch.Tensor:
    """x itself where the kernel's 16-byte copies may read it in place (D
    contiguous, strides and address multiples of 16 bytes), else a
    contiguous copy."""
    per = 16 // x.element_size()
    ok = (x.stride(-1) == 1 and all(st % per == 0 for st in x.stride()[:-1])
          and x.data_ptr() % 16 == 0)
    return x if ok else torch.empty_like(
        x, memory_format=torch.contiguous_format).copy_(x)


# Replaces repro/kernels/flash_attention.py:82 flash_attention (Pallas, TPU).
# Bound: operations — 4·D flops per kept (query, key) pair of q·k and p·v on
# the tensor cores, each fp32 product as three TF32 products (a split that
# keeps them fp32-accurate; bf16: one product for q·k, two for p·v), beside
# exp and the masks on the CUDA cores (beside it chip_smoke.py keeps the
# first port's bound, 4·D flops a pair at the CUDA cores' fp32 rate); the
# bytes, read once per 64 queries, weigh far less.  Design:
# FlashAttention-2 on mma.sync — one block of 4 warps per (b·h, 64
# queries), a warp per 16 rows, Q split once into registers, K/V tiles
# through a two-stage cp.async ring, the online softmax on the accumulator
# fragments, P kept in registers for P·V, fully masked key tiles skipped
# (exact); the KV head h // group read in place through the caller's
# strides (csrc/flash_attention.cu, csrc/split_mma.cuh).  Head dims 1 to
# 256: instantiations at 16, 32, 64, 80, 96, 112, 128 and 256 (two passes
# of 128 output columns), a width between them zero-padded in shared
# memory to the next.
def attend_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, window: Optional[int],
                s_pad: int) -> torch.Tensor:
    """The kernel over (B, S, H, D) q and (B, S, KVH, D) k, v on the card:
    keys in [S, s_pad) are zeros, queries there are not computed.  Returns
    a new (B, S, H, D) tensor in q's dtype."""
    name = "flash_attention"
    group = gqa_group(q, k, v)
    b, s, h, d = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{q.device}")
    for key, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name}: {key} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, q {q.dtype}; the "
                            f"kernel takes one dtype for all three")
    if q.dtype not in DTYPES:
        raise TypeError(f"{name}: {q.dtype}; the kernel takes torch.float32 "
                        f"or torch.bfloat16")
    check_head_dim(name, d)
    if not s <= s_pad < 2 ** 30:
        raise ValueError(f"{name}: s_pad {s_pad} for S = {s}")
    # rows of 16-byte multiples for the kernel's copies: a head dim off
    # that is padded with zero columns into a copy (sliced off the output)
    pad = -d % (16 // q.element_size())
    if pad:
        q, k, v = (torch.nn.functional.pad(x, (0, pad)) for x in (q, k, v))
    else:
        q, k, v = (_loadable(x) for x in (q, k, v))
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out[..., :d]
    strides = (ctypes.c_int64 * 12)(*(st for x in (q, k, v, out)
                                      for st in x.stride()[:-1]))
    has_window = window is not None
    # a window past ±(s_pad + 1) keeps (or masks) what ±(s_pad + 1) does
    win = max(-(s_pad + 1), min(s_pad + 1, window)) if has_window else 0
    with torch.cuda.device(q.device):
        err = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), b, h, group, d + pad, s, s_pad,
            strides, int(causal), int(has_window), win, d ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error "
                           f"{err}") from torch.cuda.CudaError(err)
    LAUNCHES[name] += 1
    return out[..., :d].contiguous() if pad else out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q, k, v: (BH, S, D) -> (BH, S, D) in q's dtype.  S must divide into
    both block sizes (``ops.mha_flash`` pads); the blocks set only that,
    the kernel tiles as it needs."""
    bh, s, d = q.shape
    check_blocks(s, block_q, block_k)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q, k, v must share their shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    return attend_bshd(q[:, :, None], k[:, :, None], v[:, :, None],
                       causal=causal, window=window, s_pad=s)[:, :, 0]
