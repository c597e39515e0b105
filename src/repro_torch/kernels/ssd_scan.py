"""Mamba2 SSD chunked scan for Hopper (``repro.kernels.ssd_scan``).

Per (batch·head), over chunks of Q steps, with a (P, N) fp32 state carried
from chunk to chunk (zero before the first):

  a   = −exp(a_log);  xd = x·dt;  cum = cumsum(dt·a) within the chunk
  y   = (C·Bᵀ ∘ exp(cum_i − cum_j)[j ≤ i]) xd + exp(cum)·(C·stateᵀ)
  state' = exp(cum_Q)·state + Σ_j exp(cum_Q − cum_j) xd_j B_jᵀ

inputs (each fp32 or bf16, in any mix) read up to fp32 exactly, fp32
throughout, y in x's dtype: the Pallas kernel's function (no D·x skip, no
final state: the model's own ``models.ssm.ssd_chunked`` gives those).  B
and C are shared across heads (n_groups = 1): head h of batch b is row
b·H + h and reads B, C at row // H.

``ssd_scan`` takes the reference kernel's (BH, L, P) layout;
``ops.ssd_chunk_scan`` takes (B, L, H, P) and reaches the same kernel
through ``scan_blhp`` with its strides, so no head-major copy and no
padded copy is made on the card.  For a CUDA tensor the wrapper launches
``csrc/ssd_scan.cu`` (built at first use by ``kernels/build``) or raises;
for a CPU tensor it runs the plain version, ``ssd_scan_ref``.  ``ssd_ref``
is the sequential recurrence (``repro.kernels.ref.ssd_ref``), the oracle
of both.  ``LAUNCHES`` counts kernel launches (a CPU call is not a launch).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

F32 = torch.float32
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128          # P: padded to 16, 32 or 64; past 64, 64-wide slices
MAX_STATE = 256             # N: padded to a multiple of 16
MAX_CHUNK = 4096            # Q: cum and dt of a chunk sit in shared memory
SMEM_LIMIT = 227 * 1024     # bytes of shared memory an SM block may hold
LAUNCHES = {"ssd_scan": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ plain versions
def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, *, chunk: int,
                 num_heads: int) -> torch.Tensor:
    """The Pallas kernel's function in its layout, all (batch·head) rows at
    once, chunk by chunk: x (BH, L, P), dt (BH, L), a_log (BH, 1), b, c
    (B, L, N) -> y (BH, L, P) in x's dtype."""
    bh, l, p = x.shape
    q = chunk
    assert l % q == 0, (l, q)
    rows = torch.arange(bh, device=x.device) // num_heads
    bb, cc = b.to(F32)[rows], c.to(F32)[rows]             # (BH, L, N)
    a = -torch.exp(a_log.to(F32).reshape(bh, 1))
    ar = torch.arange(q, device=x.device)
    mask = ar[None, :] <= ar[:, None]                     # j <= i
    state = torch.zeros((bh, p, b.shape[-1]), dtype=F32, device=x.device)
    ys = []
    for z in range(l // q):
        t = slice(z * q, (z + 1) * q)
        d = dt[:, t].to(F32)
        xd = x[:, t].to(F32) * d[..., None]               # (BH, Q, P)
        cum = torch.cumsum(d * a, dim=1)                  # (BH, Q)
        bz, cz = bb[:, t], cc[:, t]
        decay = torch.exp(torch.where(
            mask, cum[:, :, None] - cum[:, None, :], -1e30))
        y = (torch.einsum("bin,bjn->bij", cz, bz) * decay) @ xd
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "bin,bpn->bip", cz, state)
        w = torch.exp(cum[:, -1:] - cum)                  # (BH, Q)
        s_new = torch.einsum("bjp,bjn->bpn", xd * w[..., None], bz)
        state = torch.exp(cum[:, -1])[:, None, None] * state + s_new
        ys.append(y)
    return torch.cat(ys, dim=1).to(x.dtype)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Sequential SSD recurrence oracle (``repro.kernels.ref.ssd_ref``).

    x: (B, L, H, P); dt: (B, L, H); a_log: (H,); b, c: (B, L, N).
    S_t = exp(dt_t A) S_{t-1} + dt_t x_t ⊗ B_t ;  y_t = S_t · C_t
    """
    bsz, l, h, p = x.shape
    a = -torch.exp(a_log.to(F32))
    xs, dts, bs, cs = (t.to(F32) for t in (x, dt, b, c))
    state = torch.zeros((bsz, h, p, b.shape[-1]), dtype=F32, device=x.device)
    ys = []
    for i in range(l):
        d = dts[:, i]                                     # (B, H)
        upd = torch.einsum("bhp,bn->bhpn", xs[:, i] * d[..., None], bs[:, i])
        state = torch.exp(d * a)[..., None, None] * state + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, cs[:, i]))
    return torch.stack(ys, dim=1).to(x.dtype)             # (B, L, H, P)


def ssd_chunk_scan_ref(x: torch.Tensor, dt: torch.Tensor,
                       a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                       *, chunk: int = 256) -> torch.Tensor:
    """``ops.ssd_chunk_scan``'s plain version, the reference wrapper's
    layout steps: chunk = min(chunk, L), L zero-padded to a chunk multiple,
    (B·H, L, P) head-major, a_log tiled per batch, the padding sliced off.
    x (B, L, H, P), dt (B, L, H), a_log (H,), b, c (B, L, N)."""
    bsz, l, h, p = x.shape
    chunk = min(chunk, l)
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, b, c = (F.pad(t, (0, 0, 0, pad)) for t in (dt, b, c))
    lp = l + pad
    xt = torch.movedim(x, 2, 1).reshape(bsz * h, lp, p)
    dtt = torch.movedim(dt, 2, 1).reshape(bsz * h, lp)
    alog = a_log[None, :].expand(bsz, h).reshape(bsz * h, 1)
    y = ssd_scan_ref(xt, dtt, alog, b, c, chunk=chunk, num_heads=h)
    return torch.movedim(y[:, :l].reshape(bsz, h, l, p), 1, 2)


# ----------------------------------------------------------------- checks
def smem_bytes(p: int, n: int, chunk: int, x_itemsize: int = 4,
               bc_itemsize: int = 4) -> int:
    """Shared memory of the largest block ``csrc/ssd_scan.cu`` launches at
    head dim ``p``, state ``n`` and ``chunk`` (x and B, C of these element
    sizes; fp32, the default, is the largest): C·Bᵀ's two tiles (stage a),
    the state pass's prefix sums and two-stage ring (b), and the output's
    prefix sums, C rows or C·Bᵀ tiles, and state or x tiles (d).  The
    source's ``ssd_scan_smem_bytes`` computes the same."""
    t, rows = 64, 128                           # kT, kRows
    xs, bcs = x_itemsize, bc_itemsize
    npad = -(-n // 16) * 16
    pt = 16 if p <= 16 else 32 if p <= 32 else 64

    def ld_b(w, size):
        return w + (8 if size == 2 else 4)

    lda = npad + 8
    ldx = ld_b(pt, xs)
    q2 = (chunk + 1) & ~1
    stage_a = 2 * t * lda * bcs
    stage_b = (8 * q2 + 4 * 2 * (-(-chunk // t) * t)
               + 2 * t * (ldx * xs + ld_b(npad, bcs) * bcs))
    stage_d = (8 * q2 + 4 * ((chunk + 3) & ~3)
               + max(rows * lda * bcs, 2 * rows * (t + 8) * 4)
               + max(pt * lda * 4, 2 * t * ldx * xs))
    return max(stage_a, stage_b, stage_d)


def shape_supported(p: int, n: int, chunk: int = 256) -> bool:
    """True where the kernel takes head dim ``p`` and state ``n`` at
    ``chunk`` in every dtype: 1 ≤ p ≤ MAX_HEAD_DIM (128), 1 ≤ n ≤
    MAX_STATE (256), 1 ≤ chunk ≤ MAX_CHUNK, and its largest block's shared
    memory (fp32, the largest) within SMEM_LIMIT — at N = 256 chunks up to
    2474 steps."""
    return (1 <= p <= MAX_HEAD_DIM and 1 <= n <= MAX_STATE
            and 1 <= chunk <= MAX_CHUNK
            and smem_bytes(p, n, chunk) <= SMEM_LIMIT)


def widest_state(p: int, chunk: int, x_itemsize: int = 4,
                 bc_itemsize: int = 4) -> int:
    """The largest N (a multiple of 16, at most MAX_STATE) whose blocks fit
    SMEM_LIMIT at head dim ``p`` and ``chunk``; 0 if none does."""
    for n in range(MAX_STATE, 0, -16):
        if smem_bytes(p, n, chunk, x_itemsize, bc_itemsize) <= SMEM_LIMIT:
            return n
    return 0


def check_shape(name: str, p: int, n: int, chunk: int, x_itemsize: int = 4,
                bc_itemsize: int = 4) -> None:
    """Raise where the kernel does not take (P, N, chunk) in these element
    sizes, naming the limit and, for shared memory, the bytes and the
    widest N that fits."""
    if not 0 < p <= MAX_HEAD_DIM or not 0 < n <= MAX_STATE:
        raise ValueError(f"{name}: head dim {p}, state {n}; the kernel takes "
                         f"P ≤ {MAX_HEAD_DIM} and N ≤ {MAX_STATE}")
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"{name}: chunk {chunk}; the kernel takes 1 to "
                         f"{MAX_CHUNK}")
    need = smem_bytes(p, n, chunk, x_itemsize, bc_itemsize)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"{name}: state {n} at chunk {chunk} needs {need} bytes of "
            f"shared memory in one block, past the {SMEM_LIMIT} an SM block "
            f"may hold; the widest N that fits at this chunk is "
            f"{widest_state(p, chunk, x_itemsize, bc_itemsize)}")


def check_operands(name: str, x: torch.Tensor, dt: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor) -> None:
    """What the kernel takes: x, dt, b, c on one CUDA device, each fp32 or
    bf16 (in any mix: each is read up to fp32); the sizes are
    ``check_shape``'s."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{x.device}")
    for key, t in (("x", x), ("dt", dt), ("b", b), ("c", c)):
        if t.device != x.device:
            raise ValueError(f"{name}: {key} on {t.device}, x on {x.device}")
        if t.dtype not in DTYPES:
            raise TypeError(f"{name}: {key} is {t.dtype}; the kernel takes "
                            f"torch.float32 or torch.bfloat16")


_PTR = ctypes.c_void_p


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    i64, cint = ctypes.c_int64, ctypes.c_int
    lib.ssd_scan_fwd.argtypes = [
        _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, cint, cint, cint, i64, cint,
        cint, cint, cint, cint, ctypes.POINTER(i64), _PTR, _PTR]
    lib.ssd_scan_fwd.restype = cint
    lib.ssd_scan_workspace_bytes.argtypes = [i64, cint, cint, cint, cint,
                                             cint]
    lib.ssd_scan_workspace_bytes.restype = i64
    lib.ssd_scan_smem_bytes.argtypes = [cint] * 5
    lib.ssd_scan_smem_bytes.restype = cint
    return lib


# Replaces repro/kernels/ssd_scan.py:74 ssd_scan (Pallas, TPU; pallas_call
# at :86).  Bound: operations — the chunked form's matrix products (C·Bᵀ
# once per batch and chunk, B and C being shared by its heads; per head the
# decayed C·Bᵀ times x, C·stateᵀ and the state update) on the tensor
# cores, each fp32 product as three TF32 products (two where x or C is
# bf16, exact in TF32), which keeps them fp32-accurate; the decays on the
# CUDA cores (beside it chip_smoke.py keeps the first port's bound, all of
# it at the CUDA cores' fp32 rate); the bytes (x, y, dt, B, C once) weigh
# less.  Design: the chunked SSD's parallel stages, four launches a call
# on mma.sync — C·Bᵀ per (batch, chunk), each chunk's state contribution
# per head, the state passed over the chunks, then y per (batch, chunk,
# head, 128 rows) — with fp32 scratch allocated here (csrc/ssd_scan.cu,
# csrc/split_mma.cuh).  P ≤ 128 (past 64 in 64-wide slices, a block each)
# and N ≤ 256 where the largest block fits 227 KB of shared memory
# (``shape_supported``).
def scan_blhp(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, *, chunk: int,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel on the card over x (B, L, H, P) and dt (B, L, H) with
    any strides (P contiguous), a_log (H,) or (B, H), b, c (B, L, N), in
    chunks of ``chunk`` steps; a last chunk that L leaves short is read as
    if zero-padded (padded steps are exact no-ops: dt = 0, B = 0).  Writes
    y into ``out`` (a (B, L, H, P) tensor or view, P contiguous) or a new
    tensor in x's dtype, and returns it.  One op call: four kernel
    launches (two when L fits one chunk), counted once in ``LAUNCHES``."""
    name = "ssd_scan"
    bsz, l, h, p = x.shape
    check_operands(name, x, dt, b, c)
    if tuple(dt.shape) != (bsz, l, h) or b.shape != c.shape or \
            tuple(b.shape[:2]) != (bsz, l) or l >= 2 ** 31:
        raise ValueError(f"{name}: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"b {tuple(b.shape)}, c {tuple(c.shape)}")
    x, b, c = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, b, c))
    if b.dtype != c.dtype:
        # the kernel reads B and C as one type: the bf16 one, read up to
        # fp32 exactly either way, is widened here ((B, L, N): small)
        b, c = b.float(), c.float()
    check_shape(name, p, b.shape[-1], chunk, x.element_size(),
                b.element_size())
    a = a_log.to(device=x.device, dtype=F32)
    a = a.expand(bsz, h) if a.dim() == 1 else a.reshape(bsz, h)
    if out is None:
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
    elif out.shape != x.shape or out.dtype != x.dtype or \
            out.device != x.device or out.stride(-1) != 1:
        raise ValueError(f"{name}: out {out.dtype} {tuple(out.shape)}")
    if out.numel() == 0:
        return out
    strides = (ctypes.c_int64 * 15)(
        *x.stride()[:3], *dt.stride(), *a.stride(), *b.stride()[:2],
        *c.stride()[:2], *out.stride()[:3])
    lib = _lib()
    n = b.shape[-1]
    size = lib.ssd_scan_workspace_bytes(bsz, h, p, n, l, chunk)
    if size < 0:
        raise ValueError(f"{name}: the kernel does not take {tuple(x.shape)}"
                         f", N = {n}, chunk {chunk}")
    work = torch.empty(size, dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), out.data_ptr(),
            *(int(t.dtype == torch.bfloat16) for t in (x, dt, b)),
            bsz, h, p, n, l, chunk, strides, work.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error "
                           f"{err}") from torch.cuda.CudaError(err)
    LAUNCHES[name] += 1
    return out


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int = 256,
             num_heads: int) -> torch.Tensor:
    """x: (BH, L, P); dt: (BH, L); a_log: (BH, 1); b, c: (B, L, N) with
    BH = B * num_heads.  Returns y: (BH, L, P) in x's dtype."""
    bh, l, p = x.shape
    assert l % chunk == 0, (l, chunk)
    h = num_heads
    bsz = b.shape[0]
    if bh != bsz * h or tuple(dt.shape) != (bh, l) or \
            a_log.numel() != bh or tuple(c.shape) != tuple(b.shape) or \
            b.shape[1] != l:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a_log {tuple(a_log.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)} for "
                         f"{h} heads")
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, a_log, b, c, chunk=chunk, num_heads=h)
    # (BH, L, P) read and written as (B, L, H, P) views: no copy
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    scan_blhp(*(t.unflatten(0, (bsz, h)).transpose(1, 2) for t in (x, dt)),
              a_log.reshape(bsz, h), b, c, chunk=chunk,
              out=y.unflatten(0, (bsz, h)).transpose(1, 2))
    return y
