"""The kernels' cost model: the bytes each engine kernel must move and the
operations it does, and the least time the card could take for them.

One model serves two readers:
  * ``chip_smoke.py`` prints each kernel's ``bound_ms`` beside its time on
    the card (PERF.md §6's bound column, at the main path's operands: the
    defaults below);
  * the dry run (``launch.dryrun``): a kernel wrapper given meta tensors
    charges its call here (``charge``: the name, the operands' shape and
    the work of that call, its options read from the call) instead of
    launching, so a step run on meta tensors reads its kernels' bytes and
    operations without a card.

A kernel's bytes count every input read once and every output written
once, each at its operand's element size (fp32 or bf16, the options
``pb``, ``gb``, ``db`` of the cost functions, which the wrappers read off
their operands); its operations are fp32 operations on the CUDA cores.
The rates are the NVIDIA H100 SXM5 (80GB HBM3, 700 W) data sheet's: 3.35
TB/s of HBM3, 67 TFLOP/s fp32 on the CUDA cores, 495 TFLOP/s TF32 and 989
TFLOP/s bf16 on the tensor cores (dense).  Pure Python: nothing here
imports torch.
"""
from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 80GB HBM3 (SXM5, 700 W), per GPU, from NVIDIA's H100 data
# sheet (the dense tensor-core rates, without sparsity); ``launch.mesh``
# re-exports them beside the grid's constants
HBM_BW = 3.35e12            # B/s of HBM3
PEAK_FLOPS_FP32 = 67e12     # FLOP/s on the CUDA cores: fp32 products with
#                             TF32 off, as the port trains
PEAK_FLOPS_TF32 = 495e12    # FLOP/s, TF32 tensor cores
PEAK_FLOPS_BF16 = 989e12    # FLOP/s, bf16 tensor cores


def bound_ms(nbytes: float, flops: float, rate: float = PEAK_FLOPS_FP32,
             core_flops: float = 0.0):
    """The least time for the work, the longest of: bytes over 3.35 TB/s,
    ``flops`` over ``rate`` (the CUDA cores' fp32 rate unless a
    tensor-core rate is given), and ``core_flops`` over the CUDA cores'
    rate — they run beside the tensor cores, so the two unit times do not
    add."""
    t_bytes = nbytes / HBM_BW
    t_ops = max(flops / rate, core_flops / PEAK_FLOPS_FP32)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# bytes each kernel must move and its fp32 operations; the defaults are
# the main path's operands (PERF.md §6's bounds: fp32 throughout), the
# options what another call reads or writes beside them (Δ, B, the
# moments' width, capture) and the element sizes of its operands: ``pb``
# the parameters and x̂ (4 fp32, 2 bf16), ``gb`` the gradient, ``db`` Δ
# and B (Δ1, Δ2); the EASGD center, pend, EF buffers and stats are fp32
def local_cost(w, r, c, use_d=True, wd=1e-4, use_b=False, pb=4, gb=4,
               db=4):
    n = w * r * c
    # read p, g [, Δ, B]; write p
    nbytes = n * (2 * pb + gb + db * (use_d + use_b))
    flops = n * (2 + use_d + use_b + (2 if wd else 0))
    return nbytes, flops


def sync_cost(w, r, c, pb=4, db=4):
    n = w * r * c
    # read p, Δ, x̂, kγ; write p, Δ
    nbytes = n * (2 * pb + 2 * db) + pb * r * c + 4
    return nbytes, 3 * n                # sub, div, add per element


def momentum_cost(w, r, c, wd=1e-4, use_d=False, use_b=False, m_bytes=4,
                  pb=4, gb=4, db=4):
    """easgd's path: no Δ, no B, fp32 m."""
    n = w * r * c
    # read p, g [, Δ, B], m; write p, m
    nbytes = n * (2 * pb + gb + db * (use_d + use_b)) + 2 * m_bytes * n
    return nbytes, n * (4 + use_d + use_b + (2 if wd else 0))


def adam_cost(w, r, c, wd=1e-4, use_d=True, use_b=True, m_bytes=4, pb=4,
              gb=4, db=4):
    """bvr_l_sgd's path: with Δ and B, fp32 mu and nu."""
    n = w * r * c
    # read p, g, Δ, B, mu, nu, [c1, c2]; write p, mu, nu
    nbytes = (n * (2 * pb + gb + db * (use_d + use_b)) + 4 * m_bytes * n
              + 8)
    return nbytes, n * (16 + use_d + use_b + (2 if wd else 0))


def bvr_cost(w, r, c, pb=4, db=4):
    n = w * r * c
    # read p, Δ, B, x̂, kγ; write p, Δ, B
    nbytes = n * (2 * pb + 4 * db) + pb * r * c + 4
    return nbytes, 6 * n


def easgd_cost(w, r, c, pb=4):
    n, rc = w * r * c, r * c
    # worker pass: read p, x̃, write p; center pass: read x̃, x̂, write x̃
    return 2 * pb * n + 4 * rc + 4 * 3 * rc, 3 * n + 3 * rc


def ef_int8_cost(w, r, c, use_ref=True, use_e=True, pb=4):
    """Path (c)'s operands: p, ref and e read, dec and e written."""
    n = w * r * c
    # sub, add, abs, max, div, rint, two clamps, mul, sub per element
    return (pb + 4 + 8 * use_e) * n + 4 * use_ref * r * c, 10 * n


def ef_topk_cost(w, r, c, use_ref=True, use_e=True, pb=4):
    """Path (d)'s operands (ref = x̂_stale, e, dec into pend): the bytes of
    int8; 31 rounds of one compare per element to find the threshold,
    then sub, add, abs, compare, select, sub."""
    n = w * r * c
    return (pb + 4 + 8 * use_e) * n + 4 * use_ref * r * c, 37 * n


def fold_cost(w, r, c, bufs, capture, flops, pb=4, db=4):
    """``bufs`` (W, R, C) buffers read and written in place (p, Δ, B),
    pend read (and written with ``capture``), x̂ and wscal read once."""
    n = w * r * c
    return (n * (2 * pb + 2 * db * (bufs - 1) + 4 * (1 + capture))
            + pb * r * c + 8 * w), flops * n


def _fold(bufs, capture, flops):
    """A fold kernel's cost, its main path's ``capture`` by default."""
    def cost(w, r, c, capture=capture, pb=4, db=4):
        return fold_cost(w, r, c, bufs, capture, flops, pb, db)
    return cost


# the hierarchy's, over (P, D, R, C) with n = P·D·R·C worker elements and
# m = P·R·C per-pod elements (Δ2, x̂_pod, pend2)
def hier_local_cost(pp, dd, r, c, wd=1e-4, pb=4, gb=4, db=4):
    """Read p, g, Δ1 and Δ2 once, write p; sub, sub, [mul, add], mul, sub."""
    n, m = pp * dd * r * c, pp * r * c
    return n * (2 * pb + gb + db) + db * m, n * (4 + (2 if wd else 0))


def hier_sync1_cost(pp, dd, r, c, pb=4, db=4):
    """Read p, Δ1, x̂_pod and kγ, write p and Δ1; sub, div, add."""
    n, m = pp * dd * r * c, pp * r * c
    return n * (2 * pb + 2 * db) + pb * m + 4, 3 * n


def hier_sync2_cost(pp, dd, r, c, pb=4, db=4):
    """Read the pod value (worker 0), Δ2, x̂ and kγ, write p and Δ2; sub,
    div, add per pod element."""
    n, m = pp * dd * r * c, pp * r * c
    return pb * (n + m + r * c) + 2 * db * m + 4, 3 * m


def hier_fold_cost(pp, dd, r, c, capture=True, pb=4, db=4):
    """Path (h): capture in the kernel.  Read p, x̂, pend2, Δ2 and wscal,
    write p, Δ2 and pend2; p + c per worker element, c, c·s₀ + Δ2 and
    km·pend2 + (1 − km)·p' per pod element."""
    n, m = pp * dd * r * c, pp * r * c
    return (2 * pb * n + (4 * (1 + capture) + 2 * db) * m + pb * r * c
            + 8 * pp, n + (4 + 2 * capture) * m)


def hier_ef_cost(pp, dd, r, c, flops=10, use_ref=True, use_e=True, pb=4):
    """Paths (m)-(o)'s level-1 round trip: read p and e (P·D·R·C each) and
    the per-pod ref (P·R·C) once, write dec and e; int8's 10 operations
    per element, top-k's 37 (``ef_int8_cost``, ``ef_topk_cost``)."""
    n, m = pp * dd * r * c, pp * r * c
    return (pb + 4 + 8 * use_e) * n + 4 * use_ref * m, flops * n


def adam_sm3_cost(w, r, c, use_d=True, mu_bytes=4, wd=1e-4, shards=1,
                  pods=0, use_b=False, pb=4, gb=4, db=4):
    """Path (i)'s operands (Δ, no B, fp32 mu; hier, ``pods`` > 0: Δ1 and Δ2
    once per pod, path (l)'s bf16 mu): read p, g, [Δ], mu, the row stat,
    the lane stat and [c1, c2]; write p, mu, the row stat and the new lane
    stat.  Per element: the corrections, mu's EMA (3), v̂ = min (1), nu's
    EMA (4), the step (6: two divisions, a sqrt) [wd·p (2)], p − step, the
    row and lane max (2)."""
    n = w * r * c
    nbytes = (n * (2 * pb + gb + db * (use_d + use_b)) + 2 * mu_bytes * n
              + 8 * w * r + 8 * w * shards * c + 8
              + (db * pods * r * c if pods else 0))
    return nbytes, n * (17 + use_d + use_b + (1 if pods else 0)
                        + (2 if wd else 0))


def hier_momentum_cost(pp, dd, r, c, wd=1e-4, m_bytes=4, pb=4, gb=4, db=4):
    """Path (j): read p, g, Δ1, m and Δ2 once per pod, write p and m; sub,
    sub, [mul, add], mul, add, mul, sub per element."""
    n, m = pp * dd * r * c, pp * r * c
    return (n * (2 * pb + gb + db) + db * m + 2 * m_bytes * n,
            n * (6 + (2 if wd else 0)))


def hier_adam_cost(pp, dd, r, c, wd=1e-4, m_bytes=4, pb=4, gb=4, db=4):
    """Path (k): read p, g, Δ1, mu, nu, Δ2 once per pod and [c1, c2], write
    p, mu, nu (fp32 moments)."""
    n, m = pp * dd * r * c, pp * r * c
    return (n * (2 * pb + gb + db) + db * m + 4 * m_bytes * n + 8,
            n * (19 + (2 if wd else 0)))


def _hier_sm3(pp, dd, r, c, **kw):
    """Path (l): the hierarchy's SM3 Adam, bf16 mu by default."""
    kw.setdefault("mu_bytes", 2)
    return adam_sm3_cost(pp * dd, r, c, pods=pp, **kw)


def _hier_topk(pp, dd, r, c, **kw):
    return hier_ef_cost(pp, dd, r, c, flops=37, **kw)


COSTS = {"fused_local_sgd": local_cost, "fused_sync_vrl": sync_cost,
         "fused_local_momentum": momentum_cost, "fused_local_adam": adam_cost,
         "fused_sync_bvr": bvr_cost, "fused_sync_easgd": easgd_cost,
         "fused_ef_int8": ef_int8_cost, "fused_ef_topk": ef_topk_cost,
         # path (e): capture in the kernel; c, p + c, Δ + c·s₀, km·pend +
         # (1 − km)·p'
         "fused_fold_overlap": _fold(2, 1, 9),
         # path (d): under compression the kernel does not capture
         "fused_fold_overlap_bvr": _fold(3, 0, 9),
         # path (f): capture in the kernel
         "fused_fold_overlap_avg": _fold(1, 1, 7),
         "fused_hier_local_sgd": hier_local_cost,
         "fused_sync_hier1": hier_sync1_cost,
         "fused_sync_hier2": hier_sync2_cost,
         "fused_fold_overlap_hier2": hier_fold_cost,
         "fused_local_adam_sm3": adam_sm3_cost,
         "fused_hier_local_momentum": hier_momentum_cost,
         "fused_hier_local_adam": hier_adam_cost,
         # path (l): bf16 mu
         "fused_hier_local_adam_sm3": _hier_sm3,
         "fused_ef_int8_grid": hier_ef_cost,
         "fused_ef_topk_grid": _hier_topk}


def leaf_cost(n, m, local, item=(4, 4, 4)):
    """Bytes and fp32 operations of one tree call over n worker elements
    (m = n/W x̂ elements): local reads p, g, Δ and writes p' (sub, mul,
    sub); sync reads p, Δ and x̂ once and writes p', Δ' (sub, mul, add).
    ``item``: the bytes of p, g (x̂), Δ."""
    ip, ig, idl = item
    if local:
        return n * (2 * ip + ig + idl), 3 * n
    return n * (2 * ip + 2 * idl) + m * ig, 3 * n


# CUDA-core operations per kept (query, key) pair beside the products:
# the scale, the running max, the subtraction, exp and the row sum
ATTN_CORE_OPS = 5


def attention_cost(b, s, h, kvh, d, window, itemsize):
    """Bytes (q, k, v read once, out written once, in their dtype) of one
    mha_flash and its operations per kept causal (query, key) pair:
    (bytes, fp32 flops, (tensor-core flops, their rate, CUDA-core ops)).
    fp32: 4·D flops of q·k and p·v; on the tensor cores three TF32 products
    each (both operands carry more than TF32's bits), 12·D at 495 TFLOP/s.
    bf16: q·k one bf16 product (both exact), p·v two (p split into two
    bf16 parts: p rounded once to bf16 fails the bf16 tolerance,
    tests/test_torch_split_products.py), 6·D at 989 TFLOP/s.  Beside them
    ATTN_CORE_OPS a pair on the CUDA cores."""
    w = s if window is None else min(window, s)
    pairs = (w * (w + 1) // 2 + (s - w) * w) * b * h
    tc = ((12 * d, PEAK_FLOPS_TF32) if itemsize == 4
          else (6 * d, PEAK_FLOPS_BF16))
    return (itemsize * (2 * b * s * h * d + 2 * b * s * kvh * d),
            4 * d * pairs, (tc[0] * pairs, tc[1], ATTN_CORE_OPS * pairs))


def ssd_cost(b, l, h, p, n, q, itemsize):
    """Bytes (x, dt, B, C read once, y written once, a_log) and operations
    of one ssd_chunk_scan, chunk by chunk: (bytes, fp32 flops,
    (tensor-core flops, their rate, CUDA-core ops)).  For a chunk of v
    valid rows, v(v+1)/2 kept (i, j) pairs, whose C_i·B_j (2N flops) B and
    C shared by a batch's heads give once per batch; then per (b·h) 2P
    flops a pair (the product with xd), 2·v·P·N for C·stateᵀ in every
    chunk but the first (its state is 0) and 2·v·P·N for the state update
    in every chunk but the last (its state is never read).  fp32: 2P + 1
    a pair and the rest on the CUDA cores.
    Tensor cores (TF32, 495 TFLOP/s): three products where both operands
    carry more than TF32's bits, two where one is exact (a bf16 x against
    the decayed C·Bᵀ and in the update, bf16 C in C·stateᵀ), one where both
    are (bf16 C·Bᵀ); beside them 3 CUDA-core operations a kept pair and
    head (the difference, exp, the product with C·Bᵀ)."""
    shared = pairs_bh = state_rows = 0
    nc = -(-l // q)
    for z in range(nc):
        v = min(q, l - z * q)
        pairs = v * (v + 1) // 2
        shared += pairs * 2 * n
        pairs_bh += pairs
        state_rows += v * ((z > 0) + (z < nc - 1))
    per_head = pairs_bh * (2 * p + 1) + 2 * state_rows * p * n
    exact = itemsize == 2                 # B and C in the dtype of the call
    tc = (shared * b * (1 if exact else 3)
          + b * h * (2 if exact else 3) * (2 * p * pairs_bh
                                           + 2 * state_rows * p * n))
    return ((itemsize * (2 * b * l * h * p + b * l * h + 2 * b * l * n)
             + 4 * h), shared * b + per_head * b * h,
            (tc, PEAK_FLOPS_TF32, 3 * pairs_bh * b * h))


# ------------------------------------------------------------ dry-run charges
# kernel -> {"calls", "bytes", "flops", "shapes": {shape: calls}}: what the
# wrappers were given on meta tensors since the last reset
CHARGES: Dict[str, dict] = {}


def reset_charges() -> None:
    CHARGES.clear()


def charge(name: str, shape: Tuple[int, ...], **opts) -> None:
    """Charge one call of kernel ``name`` on operands of ``shape`` ((W, R,
    C), or (P, D, R, C) for the hierarchy's; the leaf kernels: their
    ``leaf_cost`` arguments under ``opts``) with its cost under ``opts``."""
    if name in COSTS:
        nbytes, flops = COSTS[name](*shape, **opts)
    else:
        nbytes, flops = leaf_cost(**opts)
    rec = CHARGES.setdefault(name, {"calls": 0, "bytes": 0, "flops": 0,
                                    "shapes": {}})
    rec["calls"] += 1
    rec["bytes"] += nbytes
    rec["flops"] += flops
    key = "x".join(map(str, shape))
    rec["shapes"][key] = rec["shapes"].get(key, 0) + 1
