// Compressed and overlapped sync for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/vrl_update.py:
//   vrl_fused_ef    <- _ef_call (vrl_update.py:698), flat (W, R, C) form:
//                      fused_ef_int8 (:743) and fused_ef_topk (:755); and
//                      pod-major (P, D, R, C) form: fused_ef_int8_grid
//                      (:762) and fused_ef_topk_grid (:769)
//   vrl_fused_fold  <- _fold_call (vrl_update.py:476): fused_fold_overlap
//                      (:521), fused_fold_overlap_bvr (:537) and
//                      fused_fold_overlap_avg (:546)
//
// EF round trip.  payload x = (p − ref) + e per 256-lane row; int8: scale =
// max|x|/127, q = clip(round(x/safe), ±127), dec = q·scale; top-k: keep the
// lanes with |x| ≥ the row's kth-largest |x|.  resid' = x − dec, in place
// over e.  Bound: device-memory bandwidth — it reads p, e and the (R, C)
// ref once and writes dec and e (16 B per element plus ref), and does a
// few flops per element (top-k: 31 rounds of 8 compares and one warp sum
// per row and worker, still far below the byte time).  Design: one warp
// per row of the (R, C) plane, 8 floats per lane in two coalesced float4
// loads (for C = 256); the warp loads the ref row once and walks the W
// workers with it from registers, so ref is never expanded W times.  Row
// statistics stay in the warp: int8's max is a shuffle reduction with
// fmaxf (exact in any order, so bitwise torch.amax); top-k's threshold is
// found by a bitwise search over the uint32 bits of |x| (non-negative
// floats order as their bits): 31 steps, each counting the lanes ≥ the
// candidate with __reduce_add_sync.  dec may be the same buffer as p (the
// warp reads its whole row before it writes it).  The pod-major form is the
// same kernel over P pods of D workers with a (P, R, C) ref, one per pod:
// a warp owns a (pod, row), loads that pod's ref row once and walks the
// pod's D workers with it (the flat form is P = 1, D = W).  p's workers
// may lie a stride apart (the hierarchy's level 2 compresses the pod rows
// params[:, 0] of a (P, D, R, C) buffer in place, without a copy); e and
// dec are contiguous.  p is fp32 or bf16 (the parameters' type; read
// exactly, the payload is fp32 from there on); ref, e and dec are fp32.
//
// Overlap fold.  c = x̂_stale − pend; p' = p + c; Δ' = Δ + c·s₀;
// B' = (1−β)B + (β·c)·s₀; pend' = km·pend + (1−km)·p', with [s₀, km] read
// per worker from the (W, 2) device operand wscal.  Bound: device-memory
// bandwidth (a handful of flops per 10–36 B).  Design: as the syncs of
// vrl_update.cu — a grid-stride pass over groups of four, each x̂ group
// loaded once and applied to the W workers from registers, everything in
// place.  p and x̂ share one type (fp32 or bf16), Δ and B another; pend is
// fp32 and captures the folded position before its store's rounding.
//
// Numerics: the arithmetic is the plain PyTorch version's op for op
// (kernels/torch_update.py), built with -fmad=false (no FMA contraction)
// and without fast math (IEEE division), so the kernels are bitwise the
// plain versions.  rintf rounds half to even, like torch.round; the clamp
// keeps NaN, like torch.clamp.  1 − β is rounded from double by the caller.
// A bf16 operand loads exactly; a bf16 result is rounded once on store, to
// nearest even.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
// the C functions' dtype mask: a set bit = that operand is bf16
constexpr int kDtP = 1, kDtD = 4;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

int num_sms() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

int grid_for(int64_t items, int per_block) {
  // enough blocks to fill the card a few times over; the grid-stride
  // loops cover the rest
  int64_t want = (items + per_block - 1) / per_block;
  int64_t cap = (int64_t)num_sms() * 16;
  int64_t g = want < cap ? want : cap;
  return (int)(g > 0 ? g : 1);
}

// four-element loads and stores; i counts groups of four elements
__device__ __forceinline__ float4 load4(const float* x, int64_t i) {
  return reinterpret_cast<const float4*>(x)[i];
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* x, int64_t i) {
  const uint2 raw = reinterpret_cast<const uint2*>(x)[i];
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &raw.x, sizeof(lo));
  memcpy(&hi, &raw.y, sizeof(hi));
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* x, int64_t i, float4 v) {
  reinterpret_cast<float4*>(x)[i] = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* x, int64_t i,
                                       float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  memcpy(&raw.x, &lo, sizeof(lo));
  memcpy(&raw.y, &hi, sizeof(hi));
  reinterpret_cast<uint2*>(x)[i] = raw;
}

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<float>) or f(Tag<__nv_bfloat16>) by a dtype bit
template <typename F>
void by_type(bool bf16, F&& f) {
  if (bf16) {
    f(Tag<__nv_bfloat16>{});
  } else {
    f(Tag<float>{});
  }
}

#define VRL_TYPE(tag) typename decltype(tag)::type

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float clamp127(float q) {
  // torch.clamp(q, -127, 127): NaN stays NaN
  q = q < -127.0f ? -127.0f : q;
  return q > 127.0f ? 127.0f : q;
}

__device__ __forceinline__ float quant(float x, float safe, float scale) {
  return clamp127(rintf(x / safe)) * scale;
}

__device__ __forceinline__ unsigned count_ge(float4 v, unsigned cand) {
  return (__float_as_uint(fabsf(v.x)) >= cand) +
         (__float_as_uint(fabsf(v.y)) >= cand) +
         (__float_as_uint(fabsf(v.z)) >= cand) +
         (__float_as_uint(fabsf(v.w)) >= cand);
}

__device__ __forceinline__ float keep(float x, float thresh) {
  return fabsf(x) >= thresh ? x : 0.0f;
}

// One warp per (pod, row) of the (P, R, C) plane, walking the pod's D
// workers.  NV float4 groups per lane: lane t holds groups t, t + 32, ... of
// the row's c4 = C/4 (NV = ceil(c4 / 32)).  mode 0 = int8, 1 = top-k keeping
// k lanes.  ref ((pods, rows, c4), one row per pod) and e may be null; e,
// when given, receives resid' in place.  Worker w's rows start at w·ps4 in
// p and at w·rows·c4 in e and dec (in groups of four elements).
template <int NV, typename PT>
__global__ void ef_kernel(const PT* p, const float4* __restrict__ ref,
                          float4* __restrict__ e, float4* dec, int mode,
                          int k, int64_t pods, int64_t dper, int64_t rows,
                          int64_t c4, int64_t ps4) {
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = (int64_t)gridDim.x * kWarps;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const bool keep_all = (int64_t)k >= 4 * c4;
  for (int64_t item = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       item < pods * rows; item += nwarps) {
    const int64_t pod = item / rows, row = item - pod * rows;
    float4 rv[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int64_t j = lane + 32 * v;
      rv[v] = (ref != nullptr && j < c4) ? ref[item * c4 + j] : zero;
    }
    for (int64_t wi = pod * dper; wi < (pod + 1) * dper; ++wi) {
      const int64_t base = (wi * rows + row) * c4;
      const int64_t pbase = wi * ps4 + row * c4;
      float4 x[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int64_t j = lane + 32 * v;
        x[v] = zero;
        if (j < c4) {
          x[v] = load4(p, pbase + j);
          if (ref != nullptr) x[v] = sub4(x[v], rv[v]);
          if (e != nullptr) x[v] = add4(x[v], e[base + j]);
        }
      }
      float4 dv[NV];
      if (mode == 0) {
        float m = 0.0f;
        bool nan = false;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const float a[4] = {fabsf(x[v].x), fabsf(x[v].y), fabsf(x[v].z),
                              fabsf(x[v].w)};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            m = fmaxf(m, a[q]);
            nan |= a[q] != a[q];
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
        }
        if (__any_sync(kFull, nan)) m = __int_as_float(0x7fffffff);
        const float scale = m / 127.0f;
        const float safe = m > 0.0f ? scale : 1.0f;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          dv[v] = make_float4(quant(x[v].x, safe, scale),
                              quant(x[v].y, safe, scale),
                              quant(x[v].z, safe, scale),
                              quant(x[v].w, safe, scale));
        }
      } else if (keep_all) {
#pragma unroll
        for (int v = 0; v < NV; ++v) dv[v] = x[v];
      } else {
        // the kth-largest |x| of the row: the largest t with
        // #{lanes: bits(|x|) ≥ t} ≥ k, built bit by bit from the top
        unsigned thr = 0;
        for (int bit = 30; bit >= 0; --bit) {
          const unsigned cand = thr | (1u << bit);
          unsigned cnt = 0;
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            if (lane + 32 * v < c4) cnt += count_ge(x[v], cand);
          }
          if (__reduce_add_sync(kFull, cnt) >= (unsigned)k) thr = cand;
        }
        const float thresh = __uint_as_float(thr);
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          dv[v] = make_float4(keep(x[v].x, thresh), keep(x[v].y, thresh),
                              keep(x[v].z, thresh), keep(x[v].w, thresh));
        }
      }
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int64_t j = lane + 32 * v;
        if (j < c4) {
          dec[base + j] = dv[v];
          if (e != nullptr) {
            // top-k with k ≥ C keeps everything: the residual is zero
            e[base + j] = (mode == 1 && keep_all) ? zero : sub4(x[v], dv[v]);
          }
        }
      }
    }
  }
}

// The stale fold over (w, rc) buffers, rc4 = rc/4 groups of four per
// worker; x̂ in p's type, pend fp32.  d, b null ⇒ no Δ, no B; capture = 0
// leaves pend as it is.
template <typename PT, typename DT>
__global__ void fold_kernel(PT* __restrict__ p, const PT* __restrict__ xbar,
                            float4* __restrict__ pend, DT* __restrict__ d,
                            DT* __restrict__ b,
                            const float* __restrict__ wscal, float omb,
                            float beta, int capture, int64_t w, int64_t rc4) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < rc4;
       i += stride) {
    const float4 xb = load4(xbar, i);
    for (int64_t k = 0; k < w; ++k) {
      const float inv = wscal[2 * k], km = wscal[2 * k + 1];
      const float omkm = 1.0f - km;
      const int64_t j = k * rc4 + i;
      const float4 pe = pend[j];
      const float4 c = sub4(xb, pe);
      const float4 pn = add4(load4(p, j), c);
      store4(p, j, pn);
      if (d != nullptr) {
        float4 dv = load4(d, j);
        dv.x = dv.x + c.x * inv;
        dv.y = dv.y + c.y * inv;
        dv.z = dv.z + c.z * inv;
        dv.w = dv.w + c.w * inv;
        store4(d, j, dv);
      }
      if (b != nullptr) {
        float4 bv = load4(b, j);
        bv.x = omb * bv.x + (beta * c.x) * inv;
        bv.y = omb * bv.y + (beta * c.y) * inv;
        bv.z = omb * bv.z + (beta * c.z) * inv;
        bv.w = omb * bv.w + (beta * c.w) * inv;
        store4(b, j, bv);
      }
      if (capture) {
        pend[j] = make_float4(km * pe.x + omkm * pn.x, km * pe.y + omkm * pn.y,
                              km * pe.z + omkm * pn.z,
                              km * pe.w + omkm * pn.w);
      }
    }
  }
}

template <int NV>
void launch_ef(const void* p, int p_bf16, const void* ref, void* e,
               void* dec, int mode, int k, int64_t pods, int64_t dper,
               int64_t rows, int64_t c4, int64_t ps4, cudaStream_t s) {
  by_type(p_bf16, [&](auto pt) {
    using PT = VRL_TYPE(pt);
    ef_kernel<NV, PT><<<grid_for(pods * rows, kWarps), kThreads, 0, s>>>(
        (const PT*)p, (const float4*)ref, (float4*)e, (float4*)dec, mode, k,
        pods, dper, rows, c4, ps4);
  });
}

}  // namespace

extern "C" {

// p (fp32, or bf16 with kDtP in dtypes), e, dec (fp32): (pods·dper, rows,
// c), worker w of pod w / dper; ref:
// (pods, rows, c) fp32 or null, pod p's row shared by its dper workers (the
// flat form: pods = 1, dper = W, ref (rows, c)); e null ⇒ no error
// feedback.  p_stride: elements between consecutive workers of p (a
// multiple of 4, at least rows·c); e and dec are contiguous.  c is a
// multiple of 4, at most 1024.  mode 0 = int8, 1 = top-k (k lanes).
// Returns cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue)
// for a lane count or stride it does not take.
int vrl_fused_ef(const void* p, const void* ref, void* e, void* dec,
                 int dtypes, int mode, int k, int64_t pods, int64_t dper,
                 int64_t rows, int64_t c, int64_t p_stride, void* stream) {
  const int64_t c4 = c / 4;
  if (c % 4 || c4 > 32 * 8 || p_stride % 4 || p_stride < rows * c) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows > 0 && pods > 0 && dper > 0 && c4 > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int64_t ps4 = p_stride / 4;
    if (c4 <= 32) {
      launch_ef<1>(p, dtypes & kDtP, ref, e, dec, mode, k, pods, dper,
                    rows, c4, ps4, s);
    } else if (c4 <= 64) {
      launch_ef<2>(p, dtypes & kDtP, ref, e, dec, mode, k, pods, dper,
                    rows, c4, ps4, s);
    } else if (c4 <= 128) {
      launch_ef<4>(p, dtypes & kDtP, ref, e, dec, mode, k, pods, dper,
                    rows, c4, ps4, s);
    } else {
      launch_ef<8>(p, dtypes & kDtP, ref, e, dec, mode, k, pods, dper,
                    rows, c4, ps4, s);
    }
  }
  return (int)cudaGetLastError();
}

// p, pend, d, b: (w, rc) (d, b may be null); xbar: (rc,); p and xbar
// bf16 with kDtP in dtypes, d and b with kDtD, else fp32; pend fp32;
// wscal: (w, 2) fp32 on the device, [1/(pend_k·γ), km] per worker; omb =
// 1 − β.  rc is a multiple of 4.
int vrl_fused_fold(void* p, const void* xbar, void* pend, void* d, void* b,
                   const void* wscal, int dtypes, float omb, float beta,
                   int capture, int64_t w, int64_t rc, void* stream) {
  const int64_t rc4 = rc / 4;
  if (rc4 > 0 && w > 0) {
    by_type(dtypes & kDtP, [&](auto pt) {
      by_type(dtypes & kDtD, [&](auto dt) {
        using PT = VRL_TYPE(pt);
        using DT = VRL_TYPE(dt);
        fold_kernel<PT, DT><<<grid_for(rc4, kThreads), kThreads, 0,
                              (cudaStream_t)stream>>>(
            (PT*)p, (const PT*)xbar, (float4*)pend, (DT*)d, (DT*)b,
            (const float*)wscal, omb, beta, capture, w, rc4);
      });
    });
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
