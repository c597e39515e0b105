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
// chunk): 2P + 1 for each kept pair (the decay, the product with xd) and
// 2·Q·P·N each for C·stateᵀ and the state update; against x, y, dt, B and
// C read or written once (~140 MB at the main path's width): the fp32
// rate of the CUDA cores, 67 TFLOP/s.  (This kernel recomputes C·Bᵀ for
// every head, so it does more than the bound counts.)  The
// reference computes in fp32; fp32 on the tensor cores would be TF32, which
// this repository keeps off, so the products run on the CUDA cores.
//
// Design: one block of 256 threads per (b·h) walks the chunks in order (the
// Pallas grid's sequential minor axis becomes a loop); the (P, N) state stays
// in shared memory across chunks.  The Pallas kernel holds the chunk's
// Q × Q C·Bᵀ in VMEM; at Q = 256 that is 256 KB of fp32, more than a block's
// 227 KB of shared memory, so query tiles of 64 rows stream key tiles of 64
// rows j ≤ i: each thread owns 4 × 4 of the tile's C·Bᵀ (decayed and masked,
// then staged in shared memory) and 4 rows × P/16 columns of y in
// registers.  The state update follows the chunk's query tiles: each thread
// owns P/16 × N/16 state entries and sums over the chunk's rows.  Shared
// rows are padded by 4 floats so that neighbouring threads' 16-byte loads
// fall in distinct banks; P pads to 16, 32 or 64 and N to a multiple of 16
// with zeros (zero columns add nothing).  Shared memory above 48 KB is asked
// for with cudaFuncSetAttribute.
//
// Numerics: the decay is always exp(cum_i − cum_j), never exp(cum_i) ·
// exp(−cum_j): cum falls by Q · dt · exp(a_log), hundreds at Q = 256, and
// the factored form would overflow fp32.  The masked pairs j > i add
// nothing.  The prefix sums of the fp32 products dt · a are taken in fp64
// and each difference is rounded to fp32 once, so the decay's argument is
// exact to fp32 rounding (an fp32 prefix sum would carry ulp(|cum|), 1.5e-5
// at cum = −200, into every decay); expf is the accurate one (no fast
// math), and the products may contract into FMAs (this source is built
// without -fmad=false).  The sums run in another order than the reference's,
// so the kernel is held to its plain version within a tolerance, not
// bitwise (tests/test_torch_cuda.py, chip_smoke.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // a 16 × 16 grid of threads
constexpr int kT = 64;          // rows of a query tile and of a key tile
constexpr int kLDG = kT + 4;    // row stride of the staged C·Bᵀ tile
constexpr int kMaxNc = 8;       // N / 16 at N = 128

struct Params {
  const void* x;
  const void* dt;
  const float* a_log;
  const void* b;
  const void* c;
  void* y;
  // element strides: x, y over (batch, step, head); dt the same; a_log over
  // (batch, head); b, c over (batch, step).  P and N are contiguous.
  int64_t x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh, a_sb, a_sh;
  int64_t b_sb, b_sl, c_sb, c_sl, y_sb, y_sl, y_sh;
  int heads, p, n, np;   // np: n padded to a multiple of 16
  int l, q, nc;          // steps, chunk, chunks
};

__device__ __forceinline__ float ld(const float* x) { return *x; }

__device__ __forceinline__ float ld(const __nv_bfloat16* x) {
  return __bfloat162float(*x);
}

__device__ __forceinline__ void st(float* x, float v) { *x = v; }

__device__ __forceinline__ void st(__nv_bfloat16* x, float v) {
  *x = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float4 lds4(const float* x) {
  return *reinterpret_cast<const float4*>(x);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc += a.x * b.x;
  acc += a.y * b.y;
  acc += a.z * b.z;
  acc += a.w * b.w;
  return acc;
}

// rows [r0, r0 + kT) of the chunk starting at step t0 of a (L, N) matrix
// at element `off` of `base` into sm (row stride lds) as fp32; rows past
// the chunk (q) or past L, and columns in [n, np), read as zeros.  Thread
// (ty, tx) loads rows ty + 16r, columns tx + 16c.
template <typename T>
__device__ __forceinline__ void load_bc(float* sm, int lds, const T* base,
                                        int64_t row_stride, int64_t t0,
                                        int r0, const Params& p) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int r = ty; r < kT; r += 16) {
    const int64_t t = t0 + r0 + r;
    const bool row = r0 + r < p.q && t < p.l;
    for (int col = tx; col < p.np; col += 16)
      sm[r * lds + col] =
          row && col < p.n ? ld(base + t * row_stride + col) : 0.f;
  }
}

// xd = x · dt (times w_j = exp(cum_Q − cum_j) with `decay_to_end`) for rows
// [r0, r0 + kT) of the chunk into sm (row stride PT); zeros past the chunk,
// past L and in columns [p, PT).  x_off: the (batch, head)'s first element.
template <int PT, typename T>
__device__ __forceinline__ void load_xd(float* sm, const T* x,
                                        const float* dts, const double* cum,
                                        int64_t t0, int r0, const Params& p,
                                        bool decay_to_end) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int r = ty; r < kT; r += 16) {
    const int i = r0 + r;
    const int64_t t = t0 + i;
    const bool row = i < p.q && t < p.l;
    float w = 1.f;
    if (row && decay_to_end) w = expf((float)(cum[p.q - 1] - cum[i]));
#pragma unroll
    for (int col = tx; col < PT; col += 16) {
      float v = 0.f;
      if (row && col < p.p) {
        v = ld(x + t * p.x_sl + col) * dts[i];
        if (decay_to_end) v *= w;
      }
      sm[r * PT + col] = v;
    }
  }
}

// TX: x's and y's element type, TD: dt's, TBC: B's and C's
template <int PT, typename TX, typename TD, typename TBC>
__global__ void __launch_bounds__(kThreads) ssd_fwd(Params p) {
  constexpr int RJ = PT / 16;      // y columns / state rows per thread
  const int ns = p.np + 4;         // row stride of C, B and the state
  extern __shared__ float4 smem4[];
  // q prefix sums of dt · a (fp64), rounded up to 16 bytes; then dt (q
  // floats, rounded up likewise), so every float tile below is 16-byte
  // aligned for lds4
  double* cum = reinterpret_cast<double*>(smem4);
  float* dts = reinterpret_cast<float*>(cum + ((p.q + 1) & ~1));
  float* ss = dts + ((p.q + 3) & ~3);   // state (PT, N): 16-byte aligned
  float* cs = ss + PT * ns;        // C rows of the query tile
  float* bs = cs + kT * ns;        // B rows of the key tile
  float* xs = bs + kT * ns;        // xd rows of the key tile
  float* gs = xs + kT * PT;        // decayed, masked C·Bᵀ tile

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t bh = blockIdx.x;
  const int64_t bi = bh / p.heads;
  const int h = (int)(bh % p.heads);
  const TX* x = static_cast<const TX*>(p.x) + bi * p.x_sb + h * p.x_sh;
  const TD* dt = static_cast<const TD*>(p.dt) + bi * p.dt_sb + h * p.dt_sh;
  const TBC* bm = static_cast<const TBC*>(p.b) + bi * p.b_sb;
  const TBC* cm = static_cast<const TBC*>(p.c) + bi * p.c_sb;
  TX* y = static_cast<TX*>(p.y) + bi * p.y_sb + h * p.y_sh;
  const float a = -expf(p.a_log[bi * p.a_sb + h * p.a_sh]);
  const int n_tiles = (p.q + kT - 1) / kT;
  const int nc16 = p.np / 16;

  for (int e = tid; e < PT * ns; e += kThreads) ss[e] = 0.f;

  for (int z = 0; z < p.nc; ++z) {
    const int64_t t0 = (int64_t)z * p.q;
    __syncthreads();               // the last chunk is done with all of it
    for (int i = tid; i < p.q; i += kThreads) {
      const int64_t t = t0 + i;
      const float d = t < p.l ? ld(dt + t * p.dt_sl) : 0.f;
      dts[i] = d;
      cum[i] = (double)(d * a);    // the fp32 product, summed in fp64
    }
    __syncthreads();
    if (tid < 32) {                // prefix sums: a segment per lane
      const int per = (p.q + 31) / 32;
      const int lo = min(p.q, tid * per), hi = min(p.q, lo + per);
      double s = 0.0;
      for (int i = lo; i < hi; ++i) {
        s += cum[i];
        cum[i] = s;
      }
      double incl = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      double excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.0;
      for (int i = lo; i < hi; ++i) cum[i] += excl;
    }
    __syncthreads();

    // ---- y, one query tile of 64 rows at a time
    for (int qt = 0; qt < n_tiles; ++qt) {
      const int q0 = qt * kT;
      load_bc(cs, ns, cm, p.c_sl, t0, q0, p);
      __syncthreads();
      double cum_i[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = q0 + ty + 16 * r;
        cum_i[r] = i < p.q ? cum[i] : 0.0;
      }
      // the carried state: exp(cum_i) (C_i · stateᵀ), rows ty + 16r,
      // columns tx + 16j
      float acc[4][RJ];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < RJ; ++j) acc[r][j] = 0.f;
      for (int k = 0; k < p.np; k += 4) {
        float4 cv[4], sv[RJ];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = lds4(cs + (ty + 16 * r) * ns + k);
#pragma unroll
        for (int j = 0; j < RJ; ++j) sv[j] = lds4(ss + (tx + 16 * j) * ns + k);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < RJ; ++j)
            acc[r][j] = dot4(cv[r], sv[j], acc[r][j]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = expf((float)cum_i[r]);
#pragma unroll
        for (int j = 0; j < RJ; ++j) acc[r][j] *= e;
      }

      // within the chunk: key tiles j ≤ i
      for (int kt = 0; kt <= qt; ++kt) {
        const int k0 = kt * kT;
        __syncthreads();           // the last key tile's reads are done
        load_bc(bs, ns, bm, p.b_sl, t0, k0, p);
        load_xd<PT>(xs, x, dts, cum, t0, k0, p, false);
        __syncthreads();
        float g[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) g[r][c] = 0.f;
        for (int k = 0; k < p.np; k += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            cv[r] = lds4(cs + (ty + 16 * r) * ns + k);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            bv[c] = lds4(bs + (tx + 16 * c) * ns + k);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              g[r][c] = dot4(cv[r], bv[c], g[r][c]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = k0 + tx + 16 * c;
          const double cum_j = j < p.q ? cum[j] : 0.0;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = q0 + ty + 16 * r;
            float v = 0.f;       // j > i (or past the chunk): masked
            if (j <= i && i < p.q)
              v = g[r][c] * expf((float)(cum_i[r] - cum_j));
            gs[(ty + 16 * r) * kLDG + tx + 16 * c] = v;
          }
        }
        __syncthreads();
        // acc += (C·Bᵀ ∘ decay) · xd
#pragma unroll 2
        for (int jj = 0; jj < kT; jj += 4) {
          float4 gv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            gv[r] = lds4(gs + (ty + 16 * r) * kLDG + jj);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float xv[RJ];
#pragma unroll
            for (int j = 0; j < RJ; ++j)
              xv[j] = xs[(jj + u) * PT + tx + 16 * j];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float gr = u == 0 ? gv[r].x : u == 1 ? gv[r].y
                             : u == 2 ? gv[r].z : gv[r].w;
#pragma unroll
              for (int j = 0; j < RJ; ++j) acc[r][j] += gr * xv[j];
            }
          }
        }
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = q0 + ty + 16 * r;
        const int64_t t = t0 + i;
        if (i >= p.q || t >= p.l) continue;
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          const int col = tx + 16 * j;
          if (col < p.p) st(y + t * p.y_sl + col, acc[r][j]);
        }
      }
    }

    // ---- state' = exp(cum_Q) state + Σ_j (xd_j w_j) B_jᵀ: rows ty + 16r,
    // columns tx + 16c of the (PT, np) state
    float sacc[RJ][kMaxNc];
#pragma unroll
    for (int r = 0; r < RJ; ++r)
#pragma unroll
      for (int c = 0; c < kMaxNc; ++c) sacc[r][c] = 0.f;
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * kT;
      __syncthreads();             // y is done with bs, xs (and the state)
      load_bc(bs, ns, bm, p.b_sl, t0, k0, p);
      load_xd<PT>(xs, x, dts, cum, t0, k0, p, true);
      __syncthreads();
      const int rows = min(kT, p.q - k0);
      for (int j = 0; j < rows; ++j) {
        float xv[RJ];
#pragma unroll
        for (int r = 0; r < RJ; ++r) xv[r] = xs[j * PT + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < kMaxNc; ++c) {
          if (c < nc16) {
            const float bv = bs[j * ns + tx + 16 * c];
#pragma unroll
            for (int r = 0; r < RJ; ++r) sacc[r][c] += xv[r] * bv;
          }
        }
      }
    }
    const float lam = expf((float)cum[p.q - 1]);
#pragma unroll
    for (int r = 0; r < RJ; ++r)
#pragma unroll
      for (int c = 0; c < kMaxNc; ++c) {
        if (c < nc16) {
          float* s = ss + (ty + 16 * r) * ns + tx + 16 * c;
          *s = lam * *s + sacc[r][c];
        }
      }
  }
}

template <int PT>
int smem_bytes(const Params& p) {
  const int ns = p.np + 4;
  return (int)(sizeof(double) * ((p.q + 1) & ~1) +
               sizeof(float) * (((p.q + 3) & ~3) + PT * ns + 2 * kT * ns +
                                kT * PT + kT * kLDG));
}

template <int PT, typename TX, typename TD, typename TBC>
int launch(const Params& p, int64_t blocks, cudaStream_t stream) {
  const int smem = smem_bytes<PT>(p);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<PT, TX, TD, TBC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  ssd_fwd<PT, TX, TD, TBC><<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

using bf16 = __nv_bfloat16;

// the element types are template arguments, not flags read in the loops:
// loads that branched on a runtime dtype flag made the kernel about twice
// as slow (PERF.md §6)
template <typename TX, typename TD, typename TBC>
int dispatch_p(const Params& p, int64_t blocks, cudaStream_t stream) {
  if (p.p <= 16) return launch<16, TX, TD, TBC>(p, blocks, stream);
  if (p.p <= 32) return launch<32, TX, TD, TBC>(p, blocks, stream);
  return launch<64, TX, TD, TBC>(p, blocks, stream);
}

template <typename TX>
int dispatch_rest(const Params& p, bool dt_bf16, bool bc_bf16,
                  int64_t blocks, cudaStream_t stream) {
  if (dt_bf16)
    return bc_bf16 ? dispatch_p<TX, bf16, bf16>(p, blocks, stream)
                   : dispatch_p<TX, bf16, float>(p, blocks, stream);
  return bc_bf16 ? dispatch_p<TX, float, bf16>(p, blocks, stream)
                 : dispatch_p<TX, float, float>(p, blocks, stream);
}

}  // namespace

extern "C" {

// x, y: (batch, l, heads, p); dt: (batch, l, heads); a_log: fp32 (batch,
// heads); b, c: (batch, l, n) — with the element strides strides[0..14] =
// x (batch, step, head), dt (batch, step, head), a_log (batch, head),
// b (batch, step), c (batch, step), y (batch, step, head); p and n
// contiguous.  x (and y), dt, and b and c (alike) are each fp32 (their
// *_bf16 = 0) or bf16 (1).  Chunks of `chunk` steps; a last chunk short of
// it is read as zero-padded.  1 ≤ p ≤ 64, 1 ≤ n ≤ 128, 1 ≤ chunk ≤ 4096.
// Returns 0 (cudaSuccess), or the CUDA error of the attribute call or of
// the launch.
int ssd_scan_fwd(const void* x, const void* dt, const void* a_log,
                 const void* b, const void* c, void* y, int x_bf16,
                 int dt_bf16, int bc_bf16, int64_t batch, int heads, int p,
                 int n, int l, int chunk,
                 const int64_t* strides, void* stream) {
  if (p < 1 || p > 64 || n < 1 || n > 16 * kMaxNc || chunk < 1 ||
      chunk > 4096 || heads < 1 || l < 0 || batch < 0)
    return (int)cudaErrorInvalidValue;
  Params prm;
  prm.x = x; prm.dt = dt; prm.a_log = static_cast<const float*>(a_log);
  prm.b = b; prm.c = c; prm.y = y;
  prm.x_sb = strides[0]; prm.x_sl = strides[1]; prm.x_sh = strides[2];
  prm.dt_sb = strides[3]; prm.dt_sl = strides[4]; prm.dt_sh = strides[5];
  prm.a_sb = strides[6]; prm.a_sh = strides[7];
  prm.b_sb = strides[8]; prm.b_sl = strides[9];
  prm.c_sb = strides[10]; prm.c_sl = strides[11];
  prm.y_sb = strides[12]; prm.y_sl = strides[13]; prm.y_sh = strides[14];
  prm.heads = heads;
  prm.p = p;
  prm.n = n;
  prm.np = (n + 15) & ~15;
  prm.l = l;
  prm.q = chunk;
  prm.nc = (int)(((int64_t)l + chunk - 1) / chunk);
  const int64_t blocks = batch * heads;
  if (blocks == 0 || l == 0) return 0;
  cudaStream_t strm = (cudaStream_t)stream;
  return x_bf16 ? dispatch_rest<bf16>(prm, dt_bf16, bc_bf16, blocks, strm)
                : dispatch_rest<float>(prm, dt_bf16, bc_bf16, blocks, strm);
}

}  // extern "C"
