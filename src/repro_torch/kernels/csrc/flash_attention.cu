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
// B, S and heads and D contiguous (16-byte aligned rows: the wrapper copies
// what is not), so ops.mha_flash passes its operands as the caller holds
// them: the KV head of query head h is h / group (GQA) and is read in place,
// never repeated, and no (B·H, S, D) copy is made.  Rows in [s, s_pad) are
// the wrapper's zero padding (keys read as zeros, as the reference's padded
// copy holds them; those queries are not written); keys at or past s_pad do
// not exist (score −inf: they add nothing, even to a row whose every score
// is masked).
//
// Head dims: any 1 ≤ D ≤ 256.  Instantiations at D = 16, 32, 64, 80, 96,
// 112, 128 and 256; a D between two runs on the wider one, its Q and K
// columns past D loaded as zeros (nothing in q·k) and its V columns past D
// neither used nor written.  The wrapper pads a D whose rows are not a
// multiple of 16 bytes into a copy.  The scale is the caller's (D^-½ of
// the true D).  Past 256 the fp32 instantiation's Q tile and K/V ring
// would not fit an SM block's 227 KB of shared memory.
//
// Bound: operations.  Per (query, key) pair that the masks keep, q·k and
// p·v take 2·D multiply-adds (4·D flops).  On the tensor cores fp32
// operands take three TF32 products each (split_mma.cuh), 12·D flops a
// pair at 495 TFLOP/s; bf16 operands one bf16 product for q·k (exact) and
// two for p·v (p split into two bf16 parts), 6·D flops at 989 TFLOP/s;
// beside them exp, the masks and the rescale on the CUDA cores (67
// TFLOP/s).  The bytes (q, k, v and out, under 0.3 GB at the main path's
// widths, each K/V tile read once per block of 64 queries) weigh less.
// chip_smoke.py prints that tensor-core bound and the fp32 CUDA-core bound
// of the first port (4·D a pair at 67 TFLOP/s) beside each time.
//
// Accuracy: the reference computes in fp32; one TF32 product per pair
// keeps ~11 bits of each operand and fails the fp32 tolerance below, so
// fp32 products are split, x = hi + lo, and taken as lo·hi + hi·lo +
// hi·hi (split_mma.cuh): fp32-accurate.  bf16 q and k are exact in bf16
// products; for p·v, p is split into a bf16 hi and a bf16 lo (about 2^-17
// relative, inside one bf16 ulp) against the exact bf16 v.
//
// Design (the FlashAttention-2 layout on mma.sync): one block of 4 warps
// per (b·h, tile of 64 queries), heaviest (causal: last) tiles first; each
// warp owns 16 query rows.  The Q tile is loaded once and split once into
// register fragments (fp32 past D = 64 keeps it in shared memory instead:
// its fragments would not fit beside the accumulators).  At D = 256 a
// block computes 128 of the output columns (two blocks a query tile, each
// taking q·k over all 256): all 256 would be 128 fp32 accumulators a
// thread, which spill.  K/V tiles of 64 keys (32 for fp32 past D = 64)
// stream through a two-stage cp.async ring in shared memory, so the load
// of tile j+1 overlaps the math on tile j;
// their rows are padded (K by 8, V by 4 fp32 or 8 bf16 elements) so the
// fragment loads of a warp fall in distinct banks.  S = Q·Kᵀ accumulates
// in registers; the online softmax runs on the accumulator fragments, a
// row's max reduced over its 4 lanes by shuffles, accurate expf, the
// row sum kept per lane and reduced once at the end.  P stays in registers:
// the k index of the P·V product is numbered so that the S fragment is
// already the A fragment (split_mma.cuh, `kperm`), with the values read
// in the same order, so P moves neither through shared memory nor through
// shuffles.  Key tiles that the masks empty for every query of the block
// are skipped, which is exact: a tile past the causal diagonal gives p =
// exp(−1e30 − m) = 0 and α = 1, and a tile before the window adds to l and
// acc only what the first tile holding a kept key wipes with α =
// exp(−1e30 − m) = 0.  With a window below 1 a query may keep no key at
// all; then nothing is skipped.  Tiles that no mask touches for a warp's
// rows skip the mask arithmetic.
//
// Numerics: accurate expf (no fast math), IEEE division; the CUDA-core
// arithmetic may contract into FMAs (this source is built without
// -fmad=false).  The sums run in another order than the reference's, so
// the kernel is held to a tolerance, not bitwise: fp32 rtol 2e-4 / atol
// 2e-5, bf16 one ulp of the output beyond that (tests/test_torch_cuda.py,
// chip_smoke.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "split_mma.cuh"

namespace {

using namespace split_mma;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;   // queries per block
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
  int d;               // columns holding data (≤ the instance's width)
  int n_qt;            // query tiles
  int causal, has_window, window;
  float scale;
};

// shared-memory geometry of one instantiation (elements of T): D columns
// of Q and K, DV of V and of the output (D / DV passes over the output
// columns, one block each)
template <int D, int DV, int BK, typename T>
struct Geom {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int LDK = D + 8;                   // K (and Q) rows
  static constexpr int LDV = kBf16 ? DV + 8 : DV + 4;  // V rows
  static constexpr int kStage = BK * (LDK + LDV);     // one K/V tile pair
  // Q in registers, staged first in the ring's second stage; else its
  // own region after the ring
  static constexpr bool kQReg = kBf16 || D <= 64;
  static constexpr int kElems = 2 * kStage + (kQReg ? 0 : kBQ * LDK);
  static constexpr int kBytes = kElems * (int)sizeof(T);
  static_assert(!kQReg || kBQ * LDK <= kStage, "Q must fit in a stage");
  static_assert(kBytes <= 227 * 1024, "over an SM block's shared memory");
  static_assert(D % DV == 0 && DV % 16 == 0, "DV tiles D");
  // blocks an SM should hold (the register cap): bf16 runs faster at 3
  // (≤ 168 registers a thread); fp32 at 2, where its Q fragments, S and
  // the output accumulators (220 registers at D = 64) need not spill.  At
  // D = 256 bf16 keeps 2 (its Q fragments and 128 output columns need
  // more than 168), and fp32 1 (its shared memory holds one block).
  static constexpr int kMinBlocks =
      kBf16 ? (D > 128 ? 2 : 3) : (D > 128 ? 1 : 2);
};

// rows [row0, row0 + rows) × columns [0, W) of a (seq, ·) slice into sm
// (row stride LD), 16 bytes a copy, asynchronously; rows at or past s and
// columns at or past cols (a multiple of 16 bytes) read as zeros
template <int W, int LD, typename T>
__device__ __forceinline__ void load_async(T* sm, const T* base,
                                           int64_t row_stride, int row0,
                                           int rows, int s, int cols) {
  constexpr int CH = 16 / (int)sizeof(T), kC = W / CH;
  for (int e = threadIdx.x; e < rows * kC; e += kThreads) {
    const int r = e / kC, c = (e % kC) * CH;
    const bool ok = row0 + r < s && c < cols;
    const T* src = ok ? base + (int64_t)(row0 + r) * row_stride + c : base;
    cp_async16(sm + r * LD + c, src, ok ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* x) {
  return *reinterpret_cast<const uint32_t*>(x);
}

// the split A fragment of an fp32 (16 × 8) tile at row r (row stride ld)
// and column c, under kperm
__device__ __forceinline__ FragA q_frag(const float* qs, int ld, int r,
                                        int c) {
  const float2 x0 = *reinterpret_cast<const float2*>(qs + r * ld + c);
  const float2 x1 = *reinterpret_cast<const float2*>(qs + (r + 8) * ld + c);
  return split_a(x0.x, x1.x, x0.y, x1.y);
}

__device__ __forceinline__ void store2(float* x, float a, float b) {
  *reinterpret_cast<float2*>(x) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* x, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(x) = __floats2bfloat162_rn(a, b);
}

template <int D, int DV, int BK, typename T>
__global__ void __launch_bounds__(kThreads, (Geom<D, DV, BK, T>::kMinBlocks))
    flash_fwd(Params p) {
  using G = Geom<D, DV, BK, T>;
  constexpr bool kBf16 = G::kBf16;
  constexpr int LDK = G::LDK, LDV = G::LDV;
  constexpr int NK = BK / 8;       // 8-key column tiles of S
  constexpr int ND = DV / 8;       // 8-column tiles of the output
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);
  T* qs = G::kQReg ? ring + G::kStage : ring + 2 * G::kStage;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  constexpr int kPasses = D / DV;
  const int dv0 = DV * (int)(blockIdx.x % kPasses);  // first output column
  const int64_t bid = blockIdx.x / kPasses;
  const int qt = p.n_qt - 1 - (int)(bid / p.n_bh);
  const int64_t bh = bid % p.n_bh;
  const int64_t b = bh / p.heads;
  const int h = (int)(bh % p.heads);
  const int kh = h / p.group;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh + dv0;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + dv0;
  const int vcols = p.d - dv0;     // V (and output) columns holding data
  const int q0 = qt * kBQ;
  const int w0 = q0 + 16 * warp;   // this warp's first query row

  // the key tiles that hold a kept key for some query of this block
  int kt_lo = 0, kt_hi = (p.s_pad + BK - 1) / BK;
  if (!(p.has_window && p.window < 1)) {
    const int qlast = min(q0 + kBQ, p.s) - 1;
    const int k_hi = p.causal ? min(p.s_pad, qlast + 1) : p.s_pad;
    const int k_lo = p.has_window ? max(0, q0 - p.window + 1) : 0;
    kt_lo = k_lo / BK;
    kt_hi = (k_hi + BK - 1) / BK;
  }

  // prologue: the Q tile and the first K/V tile
  load_async<D, LDK>(qs, q, p.q_ss, q0, kBQ, p.s, p.d);
  if (kt_lo < kt_hi) {
    load_async<D, LDK>(ring, k, p.k_ss, kt_lo * BK, BK, p.s, p.d);
    load_async<DV, LDV>(ring + BK * LDK, v, p.v_ss, kt_lo * BK, BK, p.s,
                        vcols);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Q fragments: fp32 split into hi and lo under kperm; bf16 as they are
  constexpr int QF = G::kQReg ? (kBf16 ? D / 16 : D / 8) : 1;
  FragA qa[QF];
  if constexpr (G::kQReg) {
#pragma unroll
    for (int kk = 0; kk < QF; ++kk) {
      if constexpr (kBf16) {
        const T* r0 = qs + (16 * warp + g) * LDK + 16 * kk + 2 * t;
        qa[kk].hi[0] = ld32(r0);
        qa[kk].hi[1] = ld32(r0 + 8 * LDK);
        qa[kk].hi[2] = ld32(r0 + 8);
        qa[kk].hi[3] = ld32(r0 + 8 * LDK + 8);
      } else {
        qa[kk] = q_frag(reinterpret_cast<const float*>(qs), LDK,
                        16 * warp + g, 8 * kk + 2 * t);
      }
    }
    __syncthreads();               // stage 1 is free for the ring
  }

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};

  for (int kt = kt_lo, st = 0; kt < kt_hi; ++kt, st ^= 1) {
    if (kt + 1 < kt_hi) {          // prefetch the next tile pair
      T* nx = ring + (st ^ 1) * G::kStage;
      load_async<D, LDK>(nx, k, p.k_ss, (kt + 1) * BK, BK, p.s, p.d);
      load_async<DV, LDV>(nx + BK * LDK, v, p.v_ss, (kt + 1) * BK, BK, p.s,
                          vcols);
    }
    cp_async_commit();
    cp_async_wait<1>();            // this tile pair has landed
    __syncthreads();
    const T* ks = ring + st * G::kStage;
    const T* vs = ks + BK * LDK;
    const int k0 = kt * BK;

    // S = Q·Kᵀ: rows w0 + g (+ 8), keys k0 + 8j + 2t (+ 1)
    float sc[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          const T* kr = ks + (8 * j + g) * LDK + 16 * kk + 2 * t;
          const uint32_t kb[2] = {ld32(kr), ld32(kr + 8)};
          mma_bf16(sc[j], qa[kk].hi, kb);
        }
    } else {
      const float* kf = reinterpret_cast<const float*>(ks);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        FragA a;
        if constexpr (G::kQReg) {
          a = qa[kk];
        } else {
          a = q_frag(reinterpret_cast<const float*>(qs), LDK, 16 * warp + g,
                     8 * kk + 2 * t);
        }
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          const float2 kv = *reinterpret_cast<const float2*>(
              kf + (8 * j + g) * LDK + 8 * kk + 2 * t);
          mma3(sc[j], a, split_b(kv.x, kv.y));
        }
      }
    }

    // scale, masks, then the online softmax on the fragments
    const bool masked = (p.causal && k0 + BK - 1 > w0) ||
                        (p.has_window && k0 <= w0 + 15 - p.window) ||
                        k0 + BK > p.s_pad;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * p.scale;
        if (masked) {
          const int qpos = w0 + g + 8 * (e >> 1);
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          const bool kept = !(p.causal && kpos > qpos) &&
                            !(p.has_window && kpos <= qpos - p.window);
          x = kept ? x : kMasked;
          if (kpos >= p.s_pad) x = -INFINITY;
        }
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(sc[j][e] - m[e >> 1]);
        sc[j][e] = pe;
        l[e >> 1] += pe;
      }
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];

    // acc += P·V, P from the S fragments
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t ph[4], pl[4];
        split_bf16(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
        split_bf16(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
        split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          const T* vc = vs + (16 * kk + 2 * t) * LDV + 8 * j + g;
          const uint32_t vb[2] = {pack_bf16(vc[0], vc[LDV]),
                                  pack_bf16(vc[8 * LDV], vc[9 * LDV])};
          mma_bf16(acc[j], pl, vb);
          mma_bf16(acc[j], ph, vb);
        }
      }
    } else {
      const float* vf = reinterpret_cast<const float*>(vs);
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const FragA a = split_a(sc[kk][0], sc[kk][2], sc[kk][1], sc[kk][3]);
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          const float* vc = vf + (8 * kk + 2 * t) * LDV + 8 * j + g;
          mma3(acc[j], a, split_b(vc[0], vc[LDV]));
        }
      }
    }
    __syncthreads();               // this stage is free for the prefetch
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = w0 + g + 8 * r;
    if (qpos >= p.s) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* row = o + (int64_t)qpos * p.o_ss + 2 * t;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      if (8 * j + 2 * t < vcols)   // pairs: vcols is even
        store2(row + 8 * j, acc[j][2 * r] / denom, acc[j][2 * r + 1] / denom);
  }
}

template <int D, int DV, int BK, typename T>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = Geom<D, DV, BK, T>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<D, DV, BK, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (int64_t)p.n_qt * p.n_bh * (D / DV);
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_fwd<D, DV, BK, T><<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// the narrowest instantiation at least d wide; its columns past d are
// zeros in shared memory (nothing in q·k, not written from p·v)
template <typename T>
int dispatch(int d, const Params& p, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  // fp32 past D = 64: 32-key tiles, so two blocks fit an SM beside Q in
  // shared memory (one at D = 256)
  constexpr int BKW = kBf16 ? 64 : 32;
  if (d <= 16) return launch<16, 16, 64, T>(p, stream);
  if (d <= 32) return launch<32, 32, 64, T>(p, stream);
  if (d <= 64) return launch<64, 64, 64, T>(p, stream);
  if (d <= 80) return launch<80, 80, BKW, T>(p, stream);
  if (d <= 96) return launch<96, 96, BKW, T>(p, stream);
  if (d <= 112) return launch<112, 112, BKW, T>(p, stream);
  if (d <= 128) return launch<128, 128, BKW, T>(p, stream);
  // two passes of 128 output columns (all 256 would be 128 fp32
  // accumulators a thread, which spill); each takes q·k over all 256
  if (d <= 256) return launch<256, 128, BKW, T>(p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, o: (batch, s, heads, d); k, v: (batch, ≥ s, heads / group, d), each
// with the element strides strides[0..11] = (batch, seq, head) of q, k, v, o
// and d contiguous (q, k, v: rows 16-byte aligned, strides multiples of 16
// bytes, d · sizeof(element) a multiple of 16; 1 ≤ d ≤ 256); fp32 (bf16 =
// 0) or bf16 (bf16 = 1), all four alike.
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
  p.d = d;
  p.n_qt = (s + kBQ - 1) / kBQ;
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  p.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(d, p, st) : dispatch<float>(d, p, st);
}

}  // extern "C"
