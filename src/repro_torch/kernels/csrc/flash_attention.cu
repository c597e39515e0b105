// Causal (and sliding-window) attention forward for Hopper (sm_90a), plain
// C interface: the kernel behind kernels/flash_attention.py
// (flash_attention over (BH, S, D), and ops.mha_flash over (B, S, H, D)).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:82
// flash_attention (pallas_call at :97):
//
//   s   = (q · kᵀ) · D^-½, in fp32          (inputs read up to fp32 exactly)
//   s   = −1e30 where masked: key > query (causal), key ≤ query − window
//   m, l, acc: the online softmax over key tiles, all fp32
//   out = acc / max(l, 1e-30), rounded to q's dtype (bf16: to nearest even)
//
// Layout: q, k, v and out are (B, S, heads, D) with any element strides over
// B, S and heads and D contiguous, so ops.mha_flash passes its operands as
// the caller holds them: the KV head of query head h is h / group (GQA) and
// is read in place, never repeated, and no (B·H, S, D) copy is made.  Rows
// in [s, s_pad) are the wrapper's zero padding (keys read as zeros, as the
// reference's padded copy holds them; those queries are not written); keys
// at or past s_pad do not exist (score −inf: they add nothing, even to a row
// whose every score is masked).
//
// Bound: operations.  4·D flops per (query, key) pair that the masks keep,
// against bytes that are read once per block of 64 queries (q, k, v and out
// are under 0.3 GB at the main path's widths): the fp32 rate of the CUDA
// cores, 67 TFLOP/s.  The reference computes in fp32 throughout; fp32 on
// the tensor cores would be TF32, which this repository keeps off, so the
// products run on the CUDA cores (a bf16 wgmma design is later work).
//
// Design: one block of 256 threads per (b·h, tile of 64 queries), heaviest
// (causal: last) tiles first.  The loop over key tiles inside the block
// takes the place of the TPU's sequential k-grid axis; each key tile (64
// keys, 32 at D = 128) and its values are staged in shared memory as fp32
// beside the block's queries, rows padded by 4 floats so that the 16-byte
// loads of neighbouring threads fall in distinct banks.  A thread owns 4
// query rows × 4 (2) keys of the score tile and 4 rows × D/16 columns of the
// output, so m, l and acc stay in registers; a row's max and sum are
// reduced over its 16 threads with warp shuffles, and p goes through shared
// memory to the p·v product.  Key tiles that the masks empty for every query
// of the block are skipped, which is exact: a tile past the causal diagonal
// gives p = exp(−1e30 − m) = 0 and α = 1, and a tile before the window adds
// to l and acc only what the first tile holding a kept key wipes with
// α = exp(−1e30 − m) = 0.  With a window below 1 a query may keep no key at
// all; then nothing is skipped.  Shared memory above 48 KB is asked for
// with cudaFuncSetAttribute.
//
// Numerics: accurate expf (no fast math), IEEE division; the products may
// contract into FMAs (this source is built without -fmad=false).  The sums
// run in another order than the reference's (the key tile is 64 wide, not
// block_k, and row sums are shuffle trees), so the kernel is held to a
// tolerance, not bitwise: fp32 rtol 2e-4 / atol 2e-5, bf16 one ulp of the
// output (tests/test_torch_cuda.py, chip_smoke.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // a 16 × 16 grid of threads
constexpr int kBQ = 64;         // queries per block
constexpr float kMasked = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // element strides over (batch, seq, head) of q, k, v, o; D is contiguous
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int64_t n_bh;        // batch · heads
  int heads, group;    // query heads; query heads per KV head
  int s, s_pad;        // rows holding data; keys that exist
  int n_qt;            // query tiles
  int causal, has_window, window;
  float scale;
};

__device__ __forceinline__ float4 load4(const float* x) {
  return *reinterpret_cast<const float4*>(x);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* x) {
  const uint2 u = *reinterpret_cast<const uint2*>(x);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store(float* x, float v) { *x = v; }

__device__ __forceinline__ void store(__nv_bfloat16* x, float v) {
  *x = __float2bfloat16_rn(v);
}

// rows [row0, row0 + rows) of a (seq, D) slice into sm (row stride ld), fp32;
// rows at or past s read as zeros
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* sm, int ld, const T* base,
                                          int64_t row_stride, int row0,
                                          int rows, int s) {
  constexpr int kC4 = D / 4;
  for (int e = threadIdx.x; e < rows * kC4; e += kThreads) {
    const int r = e / kC4, c = (e % kC4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < s) x = load4(base + (int64_t)(row0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(sm + r * ld + c) = x;
  }
}

// N consecutive floats of shared memory (N·4 bytes aligned) into registers
template <int N>
__device__ __forceinline__ void lds(float (&dst)[N], const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int t = 0; t < N; t += 4) {
      const float4 x = *reinterpret_cast<const float4*>(src + t);
      dst[t] = x.x; dst[t + 1] = x.y; dst[t + 2] = x.z; dst[t + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    dst[0] = x.x; dst[1] = x.y;
  } else {
    dst[0] = src[0];
  }
}

// max / sum over the 16 threads of one query row (lanes differing in tx)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D, int BK, typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd(Params p) {
  constexpr int LD = D + 4;        // q, k, v row stride in shared memory
  constexpr int LDP = BK + 4;      // p row stride
  constexpr int KJ = BK / 16;      // keys per thread
  constexpr int CJ = D / 16;       // output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBQ * LD;
  float* vs = ks + BK * LD;
  float* ps = vs + BK * LD;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t bid = blockIdx.x;
  const int qt = p.n_qt - 1 - (int)(bid / p.n_bh);
  const int64_t bh = bid % p.n_bh;
  const int64_t b = bh / p.heads;
  const int h = (int)(bh % p.heads);
  const int kh = h / p.group;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int q0 = qt * kBQ;

  load_tile<D>(qs, LD, q, p.q_ss, q0, kBQ, p.s);

  // the key tiles that hold a kept key for some query of this block
  int kt_lo = 0, kt_hi = (p.s_pad + BK - 1) / BK;
  if (!(p.has_window && p.window < 1)) {
    const int qlast = min(q0 + kBQ, p.s) - 1;
    const int k_hi = p.causal ? min(p.s_pad, qlast + 1) : p.s_pad;
    const int k_lo = p.has_window ? max(0, q0 - p.window + 1) : 0;
    kt_lo = k_lo / BK;
    kt_hi = (k_hi + BK - 1) / BK;
  }

  float m[4], l[4], acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();               // the last tile's p·v is done with vs, ps
    load_tile<D>(ks, LD, k, p.k_ss, k0, BK, p.s);
    load_tile<D>(vs, LD, v, p.v_ss, k0, BK, p.s);
    __syncthreads();

    // scores: rows ty + 16i, keys tx + 16j
    float sc[4][KJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[KJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = load4(qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < KJ; ++j) kv[j] = load4(ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          sc[i][j] += qv[i].x * kv[j].x;
          sc[i][j] += qv[i].y * kv[j].y;
          sc[i][j] += qv[i].z * kv[j].z;
          sc[i][j] += qv[i].w * kv[j].w;
        }
    }

    // masks, then the online softmax, row by row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = sc[i][j] * p.scale;
        const bool kept = !(p.causal && kpos > qpos) &&
                          !(p.has_window && kpos <= qpos - p.window);
        x = kept ? x : kMasked;
        if (kpos >= p.s_pad) x = -INFINITY;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = row_max(mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float e = expf(sc[i][j] - m_new);
        sc[i][j] = e;
        sum += e;
      }
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        ps[(ty + 16 * i) * LDP + tx + 16 * j] = sc[i][j];
    }
    __syncthreads();

    // acc += p · v: rows ty + 16i, columns tx·CJ .. tx·CJ + CJ − 1
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) lds(pr[i], ps + (ty + 16 * i) * LDP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[CJ];
        lds(vv, vs + (c + cc) * LD + tx * CJ);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) acc[i][j] += pr[i][cc] * vv[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= p.s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* row = o + (int64_t)qpos * p.o_ss + tx * CJ;
#pragma unroll
    for (int j = 0; j < CJ; ++j) store(row + j, acc[i][j] / denom);
  }
}

template <int D, int BK, typename T>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = (int)sizeof(float) *
                       (kBQ * (D + 4) + 2 * BK * (D + 4) + kBQ * (BK + 4));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<D, BK, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (int64_t)p.n_qt * p.n_bh;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_fwd<D, BK, T><<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, const Params& p, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16, 64, T>(p, stream);
    case 32: return launch<32, 64, T>(p, stream);
    case 64: return launch<64, 64, T>(p, stream);
    case 128: return launch<128, 32, T>(p, stream);  // 77 KB: 2 per SM
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o: (batch, s, heads, d); k, v: (batch, ≥ s, heads / group, d), each
// with the element strides strides[0..11] = (batch, seq, head) of q, k, v, o
// and d contiguous; fp32 (bf16 = 0) or bf16 (bf16 = 1), all four alike.
// Rows [s, s_pad) are zero padding; window is read only where has_window
// is 1 (any value, also below 1).  Returns 0 (cudaSuccess), or the CUDA
// error of the attribute call or of the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int bf16, int64_t batch, int heads, int group, int d,
                        int s, int s_pad, const int64_t* strides, int causal,
                        int has_window, int window, float scale,
                        void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.n_bh = batch * heads;
  p.heads = heads;
  p.group = group;
  p.s = s;
  p.s_pad = s_pad;
  p.n_qt = (s + kBQ - 1) / kBQ;
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  p.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(d, p, st) : dispatch<float>(d, p, st);
}

}  // extern "C"
