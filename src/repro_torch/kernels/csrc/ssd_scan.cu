// Mamba2 SSD chunked scan for Hopper (sm_90a), plain C interface: the kernel
// behind kernels/ssd_scan.py (ssd_scan over (BH, L, P), and
// ops.ssd_chunk_scan over (B, L, H, P)).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py:74 ssd_scan
// (pallas_call at :86).  Per (batch b, head h), over chunks of Q steps, with
// a (P, N) fp32 state that is zero before the first chunk:
//
//   a   = −exp(a_log[b, h]);  xd_t = x_t · dt_t;  cum = cumsum(dt · a)
//   y_i = Σ_{j ≤ i} (C_i · B_j) exp(cum_i − cum_j) xd_j
//         + exp(cum_i) (C_i · stateᵀ)
//   state' = exp(cum_Q) state + Σ_j exp(cum_Q − cum_j) xd_j B_jᵀ
//
// x, dt and B, C each fp32 or bf16 on their own (a bf16 x with an fp32 dt
// is Mamba2's usual mix), read up to fp32 exactly, products and sums in
// fp32, y rounded to x's dtype (bf16: to nearest even).  B and C are
// shared across heads (n_groups = 1): they are read at batch b = row / H
// of the (b·H + h) rows.
//
// Layout: x and y are (B, L, H, P) and dt (B, L, H), with any element
// strides over B, L and H and P contiguous; a_log is fp32 with strides over
// (B, H) (0 over B for a per-head vector); B and C are (B, L, N) with N
// contiguous.  So ops.ssd_chunk_scan passes its operands as the caller holds
// them and kernels/ssd_scan.ssd_scan passes (BH, L, P) as a view: no
// head-major copy is made.  A last chunk that L leaves short is read as if
// zero-padded (rows at or past L load as zeros and are not written): the
// reference pads dt, x, B and C with zeros, which makes those steps exact
// no-ops.
//
// Bound: operations.  Per (b, chunk): 2N flops of C·Bᵀ for each of the
// Q(Q+1)/2 kept (i, j) pairs, shared by the batch's heads; per (b·h,
// chunk): 2P for each kept pair's product with x and 2·Q·P·N each for
// C·stateᵀ and the state update, all matrix products; beside them the
// decay exp(cum_i − cum_j) of each kept pair on the CUDA cores.  On the
// tensor cores an fp32 product takes three TF32 products (split_mma.cuh),
// two where one operand is exact (bf16 x or C), one where both are (bf16
// C·Bᵀ), at 495 TFLOP/s, and the decays go at the CUDA cores' 67 TFLOP/s;
// the bytes (x, y, dt, B and C once, ~140 MB at the main path's width)
// weigh less.
// chip_smoke.py prints that tensor-core bound and the fp32 CUDA-core bound
// of the first port beside each time.
//
// Accuracy: the reference computes in fp32; one TF32 product keeps ~11 bits
// of each operand and fails the SSD tolerance below, so every product is
// split, x = hi + lo, and taken as lo·hi + hi·lo + hi·hi, fp32-accurate;
// bf16 x, B and C are exact in TF32 and need no lo term (split_mma.cuh).
//
// Design: the chunked SSD's parallel stages (Mamba2, arXiv:2405.21060
// §6-7), four launches on the caller's stream per call (two when L is one
// chunk: no state crosses a chunk), with fp32 scratch the wrapper allocates
// (ssd_scan_workspace_bytes):
//
//   (a) ssd_cb, per (b, chunk, 64 × 64 tile on or below the diagonal):
//       G = C·Bᵀ, once for the batch's H heads, into a (B, nc, Qp, Qp)
//       scratch (Qp: Q rounded up to 64; 8 MB at the main path's width,
//       L2-resident).
//   (b) ssd_state, per (b, chunk, head, slice of P), every chunk but the
//       last: the chunk's state contribution ΔS = Σ_j x_j (dt_j
//       exp(cum_Q − cum_j) B_j)ᵀ (P × N, K = Q), and λ = exp(cum_Q).
//   (c) ssd_pass, per (b, head, slice, 1024 state entries): S_0 = 0,
//       S_{c+1} = λ_c S_c + ΔS_c over the chunks, each S_c written over
//       ΔS_c.
//   (d) ssd_out, per (b, chunk, head, slice, 128 rows), heaviest rows
//       first:
//       y = exp(cum_i) C·S_cᵀ + (G ∘ decay ∘ mask ∘ dt_j)·x, the decay
//       exp(cum_i − cum_j) computed for each kept pair as its fragment is
//       made.
//
// Each block of (b) and (d) takes the prefix sums of its chunk itself.
// Stages (a), (b) and (d) run mma.sync on 4 or 8 warps, a warp owning a
// 16-row slab of its output.  Their operands reach shared memory as the
// caller stored them (fp32 or bf16) by cp.async copies of 16 bytes (element
// loads where a view is not 16-byte aligned), (b) and (d) through a
// two-stage ring of 64-step tiles, so the next tile's load overlaps the
// products on this one; rows are padded so that a warp's fragment loads
// fall in distinct banks.  dt (and the decay to the chunk's end, w_j)
// scale the other operand as its fragments are made — B's rows in (b),
// C·Bᵀ's columns in (d) — so that x itself is an operand, exact when it is
// bf16.  P pads to 16, 32 or 64 and N to a multiple of 16 with zeros (zero
// columns add nothing).  Shared memory above 48 KB is asked for with
// cudaFuncSetAttribute.
//
// Domain: 1 ≤ P ≤ 128, 1 ≤ N ≤ 256.  A P past 64 is cut into 64-wide
// slices, each its own block in (b), (c) and (d): column p of x drives
// only row p of the state and y's column p reads only that row, so the
// slices share nothing but C·Bᵀ (stage (a), once per batch and chunk) and
// the prefix sums (each block takes its own).  N is the reduction of C·Bᵀ
// and C·Sᵀ and the width of the state: (b) gives each warp up to four
// 8-column tiles of it (two where N ≤ 128), and the B and C tiles and the
// state in shared memory grow with it; the largest block must fit 227 KB
// (ssd_scan_smem_bytes), which at N = 256 holds chunks up to 2474 steps.
//
// Numerics: the decay is always exp(cum_i − cum_j), never exp(cum_i) ·
// exp(−cum_j): cum falls by Q · dt · exp(a_log), hundreds at Q = 256, and
// the factored form would overflow fp32.  The masked pairs j > i add
// nothing (selected to 0, never multiplied).  The prefix sums of the fp32
// products dt · a are taken in fp64 and each difference is rounded to fp32
// once, so the decay's argument is exact to fp32 rounding (an fp32 prefix
// sum would carry ulp(|cum|), 1.5e-5 at cum = −200, into every decay); expf
// is the accurate one (no fast math), and the CUDA-core arithmetic may
// contract into FMAs (this source is built without -fmad=false).  The sums
// run in another order than the reference's, so the kernel is held to its
// plain version within a tolerance, not bitwise (tests/test_torch_cuda.py,
// chip_smoke.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "split_mma.cuh"

namespace {

using namespace split_mma;
using bf16 = __nv_bfloat16;

constexpr int kT = 64;           // rows of a staged tile (steps j)
constexpr int kRows = 128;       // output rows of a stage-(d) block
constexpr int kMaxN = 256;
constexpr int kMaxP = 128;
constexpr int kSlice = 64;       // P columns of one block (P > 64: slices)
constexpr int kSmemMax = 227 * 1024;   // an SM block's shared memory

struct Params {
  const void* x;
  const void* dt;
  const float* a_log;
  const void* b;
  const void* c;
  void* y;
  float* g;                      // (batch, nc, qp, qp) C·Bᵀ
  float* ds;                     // (batch, nc, heads, ps, pt, np) ΔS, then S
  float* lam;                    // (batch, nc, heads) exp(cum_Q)
  // element strides: x, y over (batch, step, head); dt the same; a_log over
  // (batch, head); b, c over (batch, step).  P and N are contiguous.
  int64_t x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh, a_sb, a_sh;
  int64_t b_sb, b_sl, c_sb, c_sl, y_sb, y_sl, y_sh;
  int64_t batch;
  int heads, p, n, np, pt;       // np: n padded to 16; pt: p to 16, 32, 64
  int ps;                        // slices of P (pt = 64 when over one)
  int l, q, qp, nc;              // steps, chunk, chunk padded to 64, chunks
  int dt_bf16;
  // x, B, C: base and row strides 16-byte aligned (cp.async copies), or not
  // (element loads)
  bool x_vec, b_vec, c_vec;
};

template <typename T>
constexpr bool kBf16 = std::is_same<T, bf16>::value;

__device__ __forceinline__ float ld(const float* x) { return *x; }

__device__ __forceinline__ float ld(const bf16* x) {
  return __bfloat162float(*x);
}

__device__ __forceinline__ void st(float* x, float v) { *x = v; }

__device__ __forceinline__ void st(bf16* x, float v) {
  *x = __float2bfloat16_rn(v);
}

// the first `q` prefix sums of dt · a over the chunk starting at step t0,
// in fp64 (of the fp32 products), and dt itself, into shared memory; dt of
// the (batch, head) at `dt`, steps at or past L read as 0
__device__ void chunk_cum(double* cum, float* dts, const void* dt,
                          const Params& p, int64_t t0, int q, float a) {
  for (int i = threadIdx.x; i < q; i += blockDim.x) {
    const int64_t t = t0 + i;
    float d = 0.f;
    if (t < p.l)
      d = p.dt_bf16 ? ld(static_cast<const bf16*>(dt) + t * p.dt_sl)
                    : ld(static_cast<const float*>(dt) + t * p.dt_sl);
    dts[i] = d;
    cum[i] = (double)(d * a);
  }
  __syncthreads();
  if (threadIdx.x < 32) {          // prefix sums: a segment per lane
    const int lane = threadIdx.x;
    const int per = (q + 31) / 32;
    const int lo = min(q, lane * per), hi = min(q, lo + per);
    double s = 0.0;
    for (int i = lo; i < hi; ++i) {
      s += cum[i];
      cum[i] = s;
    }
    double incl = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    double excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0;
    for (int i = lo; i < hi; ++i) cum[i] += excl;
  }
  __syncthreads();
}

// rows [0, rows) × columns [0, wcols) of a tile into sm (row stride sld
// elements), from `base` (row stride row_stride): rows at or past row_lim
// and columns at or past cols read as zeros.  vec (base and row stride
// 16-byte aligned): 16-byte cp.async copies, in flight until the caller
// waits (a partial last chunk of a row is zero-filled past `cols`); else
// element loads.  wcols is a multiple of 16.
template <int THREADS, typename T>
__device__ __forceinline__ void stage(T* sm, int sld, const T* base,
                                      int64_t row_stride, int rows,
                                      int row_lim, int cols, int wcols,
                                      bool vec) {
  constexpr int CH = 16 / (int)sizeof(T);
  if (vec) {
    const int kc = wcols / CH;
    for (int e = threadIdx.x; e < rows * kc; e += THREADS) {
      const int r = e / kc, c = (e % kc) * CH;
      const int n = r < row_lim ? min(CH, cols - c) : 0;
      const T* src = n > 0 ? base + r * row_stride + c : base;
      cp_async16(sm + r * sld + c, src, n > 0 ? n * (int)sizeof(T) : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * wcols; e += THREADS) {
      const int r = e / wcols, c = e % wcols;
      sm[r * sld + c] = r < row_lim && c < cols ? base[r * row_stride + c]
                                                : T(0.f);
    }
  }
}

// two neighbouring elements of a tile in shared memory (an even column),
// as fp32
__device__ __forceinline__ float2 ld_pair(const float* x) {
  return *reinterpret_cast<const float2*>(x);
}

__device__ __forceinline__ float2 ld_pair(const bf16* x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x));
}

// row strides of raw tiles in shared memory, in elements, for fragment
// loads in distinct banks: tiles read as B operands one element a lane
// (rows 2t, 2t+1, column g) pad fp32 rows by 4 and bf16 rows by 8; tiles
// read two neighbouring elements a lane (row g, columns 2t, 2t+1) pad by 8
template <typename T>
__host__ __device__ constexpr int ld_b(int w) {
  return w + (kBf16<T> ? 8 : 4);
}
__host__ __device__ constexpr int ld_a(int w) { return w + 8; }

// ---------------------------------------------------------------- (a)
// G = C·Bᵀ over one 64 × 64 tile (it, jt ≤ it) of one (batch, chunk);
// 4 warps, a warp owning 16 rows × 64 columns
template <typename TBC>
__global__ void __launch_bounds__(128) ssd_cb(Params p) {
  constexpr bool kExact = kBf16<TBC>;
  extern __shared__ float4 smem4[];
  const int ldc = ld_a(p.np);
  TBC* cs = reinterpret_cast<TBC*>(smem4);
  TBC* bs = cs + kT * ldc;
  const int n_t = p.qp / kT;
  int tri = (int)(blockIdx.x % (n_t * (n_t + 1) / 2));
  const int64_t bz = blockIdx.x / (n_t * (n_t + 1) / 2);   // b·nc + z
  const int64_t bi = bz / p.nc;
  const int z = (int)(bz % p.nc);
  int it = 0;
  while (tri > it) tri -= ++it;
  const int jt = tri;
  const int64_t t0 = (int64_t)z * p.q;
  const int lim = (int)min((int64_t)p.q, p.l - t0);   // rows of the chunk
  stage<128>(cs, ldc,
             static_cast<const TBC*>(p.c) + bi * p.c_sb +
                 (t0 + it * kT) * p.c_sl,
             p.c_sl, kT, lim - it * kT, p.n, p.np, p.c_vec);
  stage<128>(bs, ldc,
             static_cast<const TBC*>(p.b) + bi * p.b_sb +
                 (t0 + jt * kT) * p.b_sl,
             p.b_sl, kT, lim - jt * kT, p.n, p.np, p.b_vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int kk = 0; kk < p.np / 8; ++kk) {
    const TBC* cr = cs + (16 * warp + g) * ldc + 8 * kk + 2 * t;
    const float2 c0 = ld_pair(cr), c1 = ld_pair(cr + 8 * ldc);
    const FragA a = split_a(c0.x, c1.x, c0.y, c1.y);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bv = ld_pair(bs + (8 * j + g) * ldc + 8 * kk + 2 * t);
      mma3<kExact, kExact>(acc[j], a, split_b(bv.x, bv.y));
    }
  }
  float* gt = p.g + bz * p.qp * p.qp;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* row = gt + (int64_t)(it * kT + 16 * warp + g + 8 * r) * p.qp +
                 jt * kT + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j) =
          make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

// ---------------------------------------------------------------- (b)
// ΔS = Σ_j x_j (dt_j w_j B_j)ᵀ (PT × np) of one (batch, chunk, head, slice
// of P) and λ = exp(cum_Q); 8 warps: warp w owns column tiles w + 8u (u <
// NU) of every row slab, so each of B's fragments is made once, by one
// warp.  x and B
// stream in 64-step tiles through a two-stage cp.async ring; dt_j w_j
// scales B's rows as its fragments are made, so a bf16 x is exact (two
// products, not three).
template <int PT, typename TX, typename TBC>
struct StateGeom {
  static constexpr int LDX = ld_b<TX>(PT);
  __host__ __device__ static int ldb(int np) { return ld_b<TBC>(np); }
  __host__ __device__ static int stage_bytes(int np) {
    return kT * (LDX * (int)sizeof(TX) + ldb(np) * (int)sizeof(TBC));
  }
  // cum (fp64), then dt·w (fp32, zero past q up to a tile), then the ring
  __host__ __device__ static int head_bytes(int q) {
    return (int)sizeof(double) * ((q + 1) & ~1) +
           (int)sizeof(float) * ((q + kT - 1) / kT * kT) * 2;
  }
  __host__ __device__ static int bytes(int q, int np) {
    return head_bytes(q) + 2 * stage_bytes(np);
  }
};

template <int PT, int NU, typename TX, typename TBC>
__global__ void __launch_bounds__(256) ssd_state(Params p) {
  using SG = StateGeom<PT, TX, TBC>;
  constexpr int MT = PT / 16;          // row slabs of the state
  constexpr int LDX = SG::LDX;
  const int ldb = SG::ldb(p.np);
  extern __shared__ float4 smem4[];
  double* cum = reinterpret_cast<double*>(smem4);
  const int qpad = (p.q + kT - 1) / kT * kT;
  float* dts = reinterpret_cast<float*>(cum + ((p.q + 1) & ~1));
  float* sw = dts + qpad;              // dt_j · exp(cum_Q − cum_j)
  char* ring = reinterpret_cast<char*>(smem4) + SG::head_bytes(p.q);

  const int64_t nz = p.nc - 1;         // chunks whose state is carried
  const int hs = (int)(blockIdx.x % (p.heads * p.ps));
  const int h = hs / p.ps, sl = hs % p.ps;
  const int64_t rest = blockIdx.x / (p.heads * p.ps);
  const int z = (int)(rest % nz);
  const int64_t bi = rest / nz;
  const int64_t t0 = (int64_t)z * p.q;
  const int lim = (int)min((int64_t)p.q, p.l - t0);
  const int pcols = min(PT, p.p - kSlice * sl);   // this slice's columns
  const TX* x = static_cast<const TX*>(p.x) + bi * p.x_sb + h * p.x_sh +
                t0 * p.x_sl + kSlice * sl;
  const TBC* bm = static_cast<const TBC*>(p.b) + bi * p.b_sb + t0 * p.b_sl;
  auto load = [&](int jc, int stg) {
    TX* xs = reinterpret_cast<TX*>(ring + stg * SG::stage_bytes(p.np));
    TBC* bs = reinterpret_cast<TBC*>(xs + kT * LDX);
    const int j0 = jc * kT;
    stage<256>(xs, LDX, x + j0 * p.x_sl, p.x_sl, kT, lim - j0, pcols, PT,
               p.x_vec);
    stage<256>(bs, ldb, bm + j0 * p.b_sl, p.b_sl, kT, lim - j0, p.n, p.np,
               p.b_vec);
  };
  load(0, 0);                      // in flight during the prefix sums
  cp_async_commit();

  const float a = -expf(p.a_log[bi * p.a_sb + h * p.a_sh]);
  const char* dtb = static_cast<const char*>(p.dt) +
                    (bi * p.dt_sb + h * p.dt_sh) * (p.dt_bf16 ? 2 : 4);
  chunk_cum(cum, dts, dtb, p, t0, p.q, a);
  for (int i = threadIdx.x; i < qpad; i += blockDim.x)
    sw[i] = i < p.q ? dts[i] * expf((float)(cum[p.q - 1] - cum[i])) : 0.f;
  if (threadIdx.x == 0 && sl == 0)
    p.lam[(bi * p.nc + z) * p.heads + h] = expf((float)cum[p.q - 1]);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_nt = p.np / 8;
  float acc[MT][NU][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][u][e] = 0.f;

  const int n_jc = qpad / kT;
  for (int jc = 0, stg = 0; jc < n_jc; ++jc, stg ^= 1) {
    if (jc + 1 < n_jc) load(jc + 1, stg ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();               // the tile has landed; sw is ready
    const TX* xs = reinterpret_cast<const TX*>(ring +
                                               stg * SG::stage_bytes(p.np));
    const TBC* bs = reinterpret_cast<const TBC*>(xs + kT * LDX);
    const int kmax = min(kT, p.q - jc * kT);
    if (warp < n_nt) {
      for (int kk = 0; kk < (kmax + 7) / 8; ++kk) {
        const float s0 = sw[jc * kT + 8 * kk + 2 * t];
        const float s1 = sw[jc * kT + 8 * kk + 2 * t + 1];
        FragB bf[NU];
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          const TBC* br = bs + (8 * kk + 2 * t) * ldb + 8 * (warp + 8 * u) + g;
          bf[u] = warp + 8 * u < n_nt ? split_b(ld(br) * s0, ld(br + ldb) * s1)
                                      : split_b(0.f, 0.f);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const TX* xr = xs + (8 * kk + 2 * t) * LDX + 16 * m + g;
          const FragA af = split_a(ld(xr), ld(xr + 8), ld(xr + LDX),
                                   ld(xr + LDX + 8));
          mma3<kBf16<TX>, false>(acc[m][0], af, bf[0]);
#pragma unroll
          for (int u = 1; u < NU; ++u)
            if (warp + 8 * u < n_nt)
              mma3<kBf16<TX>, false>(acc[m][u], af, bf[u]);
        }
      }
    }
    __syncthreads();               // this stage is free for the prefetch
  }
  float* out = p.ds + (((bi * p.nc + z) * p.heads + h) * p.ps + sl) *
                         (int64_t)PT * p.np;
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int jn = warp + 8 * u;
    if (jn >= n_nt) continue;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(out + (16 * m + g + 8 * r) * p.np +
                                   8 * jn + 2 * t) =
            make_float2(acc[m][u][2 * r], acc[m][u][2 * r + 1]);
  }
}

// ---------------------------------------------------------------- (c)
// S_0 = 0, S_{c+1} = λ_c S_c + ΔS_c, each S_c written over ΔS_c; four
// state entries of a (batch, head, slice of P) a thread, the chunks' ΔS loaded four at
// a time ahead of the products that need them
__global__ void __launch_bounds__(256) ssd_pass(Params p) {
  const int64_t per = (int64_t)p.pt * p.np / 4;     // float4 a thread
  const int64_t e = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (e >= per) return;
  const int hs = (int)(blockIdx.x % (p.heads * p.ps));
  const int h = hs / p.ps, sl = hs % p.ps;
  const int64_t bi = blockIdx.x / (p.heads * p.ps);
  float4* __restrict__ ds = reinterpret_cast<float4*>(p.ds);
  const float* __restrict__ lam = p.lam;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int z0 = 0; z0 < p.nc; z0 += 4) {
    float4 d[4];
    float l[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int64_t k = (bi * p.nc + z0 + u) * p.heads + h;
      const bool ok = z0 + u + 1 < p.nc;       // the last chunk adds none
      d[u] = ok ? ds[(k * p.ps + sl) * per + e]
                : make_float4(0.f, 0.f, 0.f, 0.f);
      l[u] = ok ? lam[k] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (z0 + u >= p.nc) break;
      const int64_t k = (bi * p.nc + z0 + u) * p.heads + h;
      ds[(k * p.ps + sl) * per + e] = s;
      s = make_float4(l[u] * s.x + d[u].x, l[u] * s.y + d[u].y,
                      l[u] * s.z + d[u].z, l[u] * s.w + d[u].w);
    }
  }
}

// ---------------------------------------------------------------- (d)
// y over 128 rows of one (batch, chunk, head, slice of P): 8 warps, a warp
// owning 16 rows × PT columns.  First the carried state, from C's rows and S_z in
// shared memory; then the chunk's 64-step tiles of C·Bᵀ (fp32, from the
// stage-(a) scratch) and x stream through a two-stage cp.async ring over
// the same memory; decay and dt_j scale C·Bᵀ as its fragments are made, so
// a bf16 x is exact (two products, not three).
template <int PT, typename TX, typename TBC>
struct OutGeom {
  static constexpr int LDX = ld_b<TX>(PT);
  static constexpr int LDG = ld_a(kT);
  __host__ __device__ static int ldc(int np) { return ld_a(np); }
  __host__ __device__ static int lds(int np) { return ld_a(np); }
  // region 1: C's rows, then the C·Bᵀ tiles; region 2: S_z, then x tiles
  __host__ __device__ static int r1_bytes(int np) {
    const int c = kRows * ldc(np) * (int)sizeof(TBC);
    const int g = 2 * kRows * LDG * (int)sizeof(float);
    return c > g ? c : g;
  }
  __host__ __device__ static int x_stage_bytes() {
    return kT * LDX * (int)sizeof(TX);
  }
  __host__ __device__ static int r2_bytes(int np) {
    const int st = PT * lds(np) * (int)sizeof(float);
    const int x = 2 * x_stage_bytes();
    return st > x ? st : x;
  }
  __host__ __device__ static int head_bytes(int qe) {
    return (int)sizeof(double) * ((qe + 1) & ~1) +
           (int)sizeof(float) * ((qe + 3) & ~3);
  }
  __host__ __device__ static int bytes(int qe, int np) {
    return head_bytes(qe) + r1_bytes(np) + r2_bytes(np);
  }
};

template <int PT, typename TX, typename TBC>
__global__ void __launch_bounds__(256) ssd_out(Params p) {
  using OG = OutGeom<PT, TX, TBC>;
  constexpr int NJ = PT / 8;
  constexpr int LDX = OG::LDX, LDG = OG::LDG;
  const int ldc = OG::ldc(p.np), lds = OG::lds(p.np);
  const int n_rc = (p.q + kRows - 1) / kRows;
  const int64_t n_bzh = p.batch * p.nc * p.heads * p.ps;
  const int rc = n_rc - 1 - (int)(blockIdx.x / n_bzh);   // heaviest first
  const int64_t bzh = blockIdx.x % n_bzh;
  const int hs = (int)(bzh % (p.heads * p.ps));
  const int h = hs / p.ps, sl = hs % p.ps;
  const int64_t bz = bzh / (p.heads * p.ps);
  const int z = (int)(bz % p.nc);
  const int64_t bi = bz / p.nc;
  const int64_t t0 = (int64_t)z * p.q;
  const int r0 = rc * kRows;                   // the block's first row
  const int qe = min(p.q, r0 + kRows);         // rows (and steps) needed
  const int lim = (int)min((int64_t)p.q, p.l - t0);

  extern __shared__ float4 smem4[];
  double* cum = reinterpret_cast<double*>(smem4);
  float* dts = reinterpret_cast<float*>(cum + ((qe + 1) & ~1));
  char* r1 = reinterpret_cast<char*>(smem4) + OG::head_bytes(qe);
  char* r2 = r1 + OG::r1_bytes(p.np);

  const int pcols = min(PT, p.p - kSlice * sl);   // this slice's columns
  const TX* x = static_cast<const TX*>(p.x) + bi * p.x_sb + h * p.x_sh +
                t0 * p.x_sl + kSlice * sl;
  const float* gt = p.g + bz * p.qp * p.qp;
  auto load = [&](int jc, int stg) {
    float* gs = reinterpret_cast<float*>(r1) + stg * kRows * LDG;
    TX* xs = reinterpret_cast<TX*>(r2 + stg * OG::x_stage_bytes());
    const int j0 = jc * kT;
    stage<256>(gs, LDG, gt + (int64_t)r0 * p.qp + j0, p.qp, kRows,
               p.q - r0, kT, kT, true);
    stage<256>(xs, LDX, x + j0 * p.x_sl, p.x_sl, kT, min(lim, qe) - j0,
               pcols, PT, p.x_vec);
  };
  if (z > 0) {                     // C's rows and S_z, in flight during
    stage<256>(reinterpret_cast<TBC*>(r1), ldc,      // the prefix sums
               static_cast<const TBC*>(p.c) + bi * p.c_sb +
                   (t0 + r0) * p.c_sl,
               p.c_sl, kRows, lim - r0, p.n, p.np, p.c_vec);
    stage<256>(reinterpret_cast<float*>(r2), lds,
               p.ds + (((bi * p.nc + z) * p.heads + h) * p.ps + sl) *
                          (int64_t)PT * p.np,
               p.np, PT, PT, p.np, p.np, true);
  }
  cp_async_commit();

  const float a = -expf(p.a_log[bi * p.a_sb + h * p.a_sh]);
  const char* dtb = static_cast<const char*>(p.dt) +
                    (bi * p.dt_sb + h * p.dt_sh) * (p.dt_bf16 ? 2 : 4);
  chunk_cum(cum, dts, dtb, p, t0, qe, a);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = r0 + 16 * warp;               // this warp's first row
  const bool active = i0 < p.q;
  int ir[2];
  double cum_i[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ir[r] = i0 + g + 8 * r;
    cum_i[r] = ir[r] < p.q ? cum[ir[r]] : 0.0;
  }
  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // the carried state: exp(cum_i) (C_i · S_zᵀ); S_0 = 0
  if (z > 0) {
    cp_async_wait<0>();
    __syncthreads();
    if (active) {
      const TBC* cs = reinterpret_cast<const TBC*>(r1) + (16 * warp + g) * ldc;
      const float* ss = reinterpret_cast<const float*>(r2) + g * lds;
      for (int kk = 0; kk < p.np / 8; ++kk) {
        const int col = 8 * kk + 2 * t;
        const float2 c0 = ld_pair(cs + col), c1 = ld_pair(cs + 8 * ldc + col);
        const FragA af = split_a(c0.x, c1.x, c0.y, c1.y);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float2 sv = ld_pair(ss + 8 * j * lds + col);
          mma3<kBf16<TBC>, false>(acc[j], af, split_b(sv.x, sv.y));
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float e = expf((float)cum_i[r]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc[j][2 * r] *= e;
          acc[j][2 * r + 1] *= e;
        }
      }
    }
    __syncthreads();               // regions 1 and 2 are free for the ring
  }

  // within the chunk: (C·Bᵀ ∘ decay ∘ mask ∘ dt_j) · x over steps j ≤ i
  const int n_jc = (qe + kT - 1) / kT;
  load(0, 0);
  cp_async_commit();
  for (int jc = 0, stg = 0; jc < n_jc; ++jc, stg ^= 1) {
    if (jc + 1 < n_jc) load(jc + 1, stg ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* gs = reinterpret_cast<const float*>(r1) + stg * kRows * LDG +
                      (16 * warp + g) * LDG;
    const TX* xs = reinterpret_cast<const TX*>(r2 + stg * OG::x_stage_bytes());
    const int j0 = jc * kT;
    if (active) {
      for (int kk = 0; kk < kT / 8; ++kk) {
        const int jb = j0 + 8 * kk;
        if (jb > i0 + 15 || jb >= qe) break;   // every pair masked
        const int jc2 = jb + 2 * t;
        float mv[2][2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 gv = ld_pair(gs + 8 * r * LDG + 8 * kk + 2 * t);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int j = jc2 + u;
            mv[r][u] = ir[r] < p.q && j <= ir[r]
                           ? (u ? gv.y : gv.x) *
                                 expf((float)(cum_i[r] - cum[j])) * dts[j]
                           : 0.f;
          }
        }
        const FragA af = split_a(mv[0][0], mv[1][0], mv[0][1], mv[1][1]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const TX* xr = xs + (8 * kk + 2 * t) * LDX + 8 * j + g;
          mma3<false, kBf16<TX>>(acc[j], af, split_b(ld(xr), ld(xr + LDX)));
        }
      }
    }
    __syncthreads();               // this stage is free for the prefetch
  }

  if (!active) return;
  TX* y = static_cast<TX*>(p.y) + bi * p.y_sb + h * p.y_sh + kSlice * sl;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (ir[r] >= p.q || t0 + ir[r] >= p.l) continue;
    TX* row = y + (t0 + ir[r]) * p.y_sl;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = 8 * j + 2 * t + u;
        if (col < pcols) st(row + col, acc[j][2 * r + u]);
      }
  }
}

// ------------------------------------------------------------- launches
int64_t align4(int64_t n) { return (n + 3) & ~(int64_t)3; }

// scratch floats: G, then ΔS / S, then λ
int64_t g_floats(const Params& p) {
  return p.batch * p.nc * (int64_t)p.qp * p.qp;
}
int64_t ds_floats(const Params& p) {
  return p.batch * p.nc * p.heads * (int64_t)p.ps * p.pt * p.np;
}
int64_t lam_floats(const Params& p) {
  return align4(p.batch * p.nc * p.heads);
}

template <typename K>
int prepare(K kernel, int smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// shared memory of each stage's blocks at these sizes: (a), (b) (only
// run when a state crosses a chunk), (d); the largest must fit kSmemMax
template <int PT, typename TX, typename TBC>
int smem_a(const Params& p) {
  return 2 * kT * ld_a(p.np) * (int)sizeof(TBC);
}
template <int PT, typename TX, typename TBC>
int smem_b(const Params& p) {
  return StateGeom<PT, TX, TBC>::bytes(p.q, p.np);
}
// (d): the last row chunk's (qe = q) serves every block
template <int PT, typename TX, typename TBC>
int smem_d(const Params& p) {
  return OutGeom<PT, TX, TBC>::bytes(p.q, p.np);
}
template <int PT, typename TX, typename TBC>
int smem_max(const Params& p) {
  const int a = smem_a<PT, TX, TBC>(p), d = smem_d<PT, TX, TBC>(p);
  const int b = p.nc > 1 ? smem_b<PT, TX, TBC>(p) : 0;
  const int ad = a > d ? a : d;
  return ad > b ? ad : b;
}

template <int PT, typename TX, typename TBC>
int run(const Params& p, cudaStream_t stream) {
  if (smem_max<PT, TX, TBC>(p) > kSmemMax) return (int)cudaErrorInvalidValue;
  const int64_t n_bzh = p.batch * p.nc * p.heads * p.ps;
  int err;
  // (a)
  const int n_t = p.qp / kT;
  const int64_t blocks_a = p.batch * p.nc * (int64_t)(n_t * (n_t + 1) / 2);
  const int sm_a = smem_a<PT, TX, TBC>(p);
  if ((err = prepare(ssd_cb<TBC>, sm_a))) return err;
  if (blocks_a > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  ssd_cb<TBC><<<(unsigned)blocks_a, 128, sm_a, stream>>>(p);
  if ((err = (int)cudaGetLastError())) return err;
  if (p.nc > 1) {
    // (b): NU column tiles of 8 a warp, over np ≤ 64 · NU
    const int sm_b = smem_b<PT, TX, TBC>(p);
    const int64_t blocks_b = p.batch * (p.nc - 1) * p.heads * p.ps;
    if (blocks_b > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    if (p.np <= 128) {
      if ((err = prepare(ssd_state<PT, 2, TX, TBC>, sm_b))) return err;
      ssd_state<PT, 2, TX, TBC><<<(unsigned)blocks_b, 256, sm_b, stream>>>(p);
    } else {
      if ((err = prepare(ssd_state<PT, 4, TX, TBC>, sm_b))) return err;
      ssd_state<PT, 4, TX, TBC><<<(unsigned)blocks_b, 256, sm_b, stream>>>(p);
    }
    if ((err = (int)cudaGetLastError())) return err;
    // (c)
    const dim3 grid_c((unsigned)(p.batch * p.heads * p.ps),
                      (unsigned)((PT * p.np / 4 + 255) / 256));
    if (p.batch * p.heads * p.ps > 0x7fffffffLL)
      return (int)cudaErrorInvalidConfiguration;
    ssd_pass<<<grid_c, 256, 0, stream>>>(p);
    if ((err = (int)cudaGetLastError())) return err;
  }
  // (d)
  const int sm_d = smem_d<PT, TX, TBC>(p);
  if ((err = prepare(ssd_out<PT, TX, TBC>, sm_d))) return err;
  const int64_t blocks_d = n_bzh * ((p.q + kRows - 1) / kRows);
  if (blocks_d > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  ssd_out<PT, TX, TBC><<<(unsigned)blocks_d, 256, sm_d, stream>>>(p);
  return (int)cudaGetLastError();
}

// the element types of x (and y) and of B, C are template arguments, not
// flags read in the loops (loads that branched on a runtime dtype flag made
// the first port's kernel about twice as slow, PERF.md §6); dt is read once
// per step, in the prefix sums, by its flag
template <typename TX, typename TBC>
int dispatch_p(const Params& p, cudaStream_t stream) {
  if (p.pt == 16) return run<16, TX, TBC>(p, stream);
  if (p.pt == 32) return run<32, TX, TBC>(p, stream);
  return run<64, TX, TBC>(p, stream);
}

template <typename TX, typename TBC>
int smem_p(const Params& p) {
  if (p.pt == 16) return smem_max<16, TX, TBC>(p);
  if (p.pt == 32) return smem_max<32, TX, TBC>(p);
  return smem_max<64, TX, TBC>(p);
}

// ptr and each of its n element strides 16-byte aligned
bool aligned16(const void* ptr, int elem, const int64_t* strides, int n) {
  bool ok = (uintptr_t)ptr % 16 == 0;
  for (int i = 0; i < n; ++i) ok = ok && (strides[i] * elem) % 16 == 0;
  return ok;
}

bool fill(Params& prm, int64_t batch, int heads, int p, int n, int l,
          int chunk) {
  if (p < 1 || p > kMaxP || n < 1 || n > kMaxN || chunk < 1 ||
      chunk > 4096 || heads < 1 || l < 0 || batch < 0)
    return false;
  prm.batch = batch;
  prm.heads = heads;
  prm.p = p;
  prm.n = n;
  prm.np = (n + 15) & ~15;
  prm.pt = p <= 16 ? 16 : p <= 32 ? 32 : 64;
  prm.ps = (p + kSlice - 1) / kSlice;
  prm.l = l;
  prm.q = chunk;
  prm.qp = (chunk + kT - 1) / kT * kT;
  prm.nc = (int)(((int64_t)l + chunk - 1) / chunk);
  return true;
}

}  // namespace

extern "C" {

// Bytes of shared memory that the largest block of ssd_scan_fwd asks for
// at these sizes and dtypes when a state crosses a chunk (more than 227
// KB: the call is refused), or −1 for sizes it does not take.
int ssd_scan_smem_bytes(int p, int n, int chunk, int x_bf16, int bc_bf16) {
  Params prm;
  if (!fill(prm, 1, 1, p, n, 2 * chunk, chunk)) return -1;
  if (x_bf16)
    return bc_bf16 ? smem_p<bf16, bf16>(prm) : smem_p<bf16, float>(prm);
  return bc_bf16 ? smem_p<float, bf16>(prm) : smem_p<float, float>(prm);
}

// Bytes of fp32 scratch that ssd_scan_fwd needs for these sizes (16-byte
// aligned: C·Bᵀ per (batch, chunk), the states per (batch, chunk, head),
// λ), or −1 for sizes it does not take.
int64_t ssd_scan_workspace_bytes(int64_t batch, int heads, int p, int n,
                                 int l, int chunk) {
  Params prm;
  if (!fill(prm, batch, heads, p, n, l, chunk)) return -1;
  return (int64_t)sizeof(float) *
         (g_floats(prm) + ds_floats(prm) + lam_floats(prm));
}

// x, y: (batch, l, heads, p); dt: (batch, l, heads); a_log: fp32 (batch,
// heads); b, c: (batch, l, n) — with the element strides strides[0..14] =
// x (batch, step, head), dt (batch, step, head), a_log (batch, head),
// b (batch, step), c (batch, step), y (batch, step, head); p and n
// contiguous.  x (and y), dt, and b and c (alike) are each fp32 (their
// *_bf16 = 0) or bf16 (1).  Chunks of `chunk` steps; a last chunk short of
// it is read as zero-padded.  1 ≤ p ≤ 128, 1 ≤ n ≤ 256, 1 ≤ chunk ≤ 4096,
// and ssd_scan_smem_bytes(...) ≤ 227 KB (at N = 256: chunks up to 2474).
// workspace: ssd_scan_workspace_bytes(...) bytes of device memory, 16-byte
// aligned, that the call may overwrite.  Launches four kernels on `stream`
// (two when l ≤ chunk).  Returns 0 (cudaSuccess), or the CUDA error of an
// attribute call or of a launch.
int ssd_scan_fwd(const void* x, const void* dt, const void* a_log,
                 const void* b, const void* c, void* y, int x_bf16,
                 int dt_bf16, int bc_bf16, int64_t batch, int heads, int p,
                 int n, int l, int chunk, const int64_t* strides,
                 void* workspace, void* stream) {
  Params prm;
  if (!fill(prm, batch, heads, p, n, l, chunk))
    return (int)cudaErrorInvalidValue;
  prm.x = x; prm.dt = dt; prm.a_log = static_cast<const float*>(a_log);
  prm.b = b; prm.c = c; prm.y = y;
  prm.x_sb = strides[0]; prm.x_sl = strides[1]; prm.x_sh = strides[2];
  prm.dt_sb = strides[3]; prm.dt_sl = strides[4]; prm.dt_sh = strides[5];
  prm.a_sb = strides[6]; prm.a_sh = strides[7];
  prm.b_sb = strides[8]; prm.b_sl = strides[9];
  prm.c_sb = strides[10]; prm.c_sl = strides[11];
  prm.y_sb = strides[12]; prm.y_sl = strides[13]; prm.y_sh = strides[14];
  prm.dt_bf16 = dt_bf16;
  prm.x_vec = aligned16(x, x_bf16 ? 2 : 4, strides, 3);
  prm.b_vec = aligned16(b, bc_bf16 ? 2 : 4, strides + 8, 2);
  prm.c_vec = aligned16(c, bc_bf16 ? 2 : 4, strides + 10, 2);
  prm.g = static_cast<float*>(workspace);
  prm.ds = prm.g + g_floats(prm);
  prm.lam = prm.ds + ds_floats(prm);
  if (batch == 0 || l == 0) return 0;
  cudaStream_t strm = (cudaStream_t)stream;
  if (x_bf16)
    return bc_bf16 ? dispatch_p<bf16, bf16>(prm, strm)
                   : dispatch_p<bf16, float>(prm, strm);
  return bc_bf16 ? dispatch_p<float, bf16>(prm, strm)
                 : dispatch_p<float, float>(prm, strm);
}

}  // extern "C"
