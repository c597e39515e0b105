// Per-leaf VRL-SGD updates for Hopper (sm_90a), plain C interface: the
// kernels behind the tree-update API (kernels/ops.py
// vrl_local_update_tree, vrl_sync_update_tree).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/vrl_update.py:
//   leaf_local_update <- vrl_local_update (vrl_update.py:73)
//   leaf_sync_update  <- vrl_sync_update  (vrl_update.py:91)
//
//   local:  p' = p − γ·(g − Δ)                       (eq. 5 + 6)
//   sync:   Δ' = Δ + (x̂ − p)·inv_kg;  p' = x̂          (eq. 4 + line 6)
//
// Each works over one whole parameter leaf of n elements: no padding to a
// tile multiple (the Pallas kernels take (R, 256) blocks of a padded
// copy), the tail is handled here.  Every operand is fp32 or bf16 (chosen
// per operand at run time), read up to fp32 exactly; the math is fp32 in
// registers, and each output is rounded to nearest even in its own dtype
// (p' in p's, Δ' in Δ's), as Tensor.to(torch.bfloat16) rounds.  The local
// step rounds Δ to p's dtype first (fp32 Δ → bf16 → fp32 when p is bf16),
// as the tree wrapper's Δ.astype(p.dtype) does, inside this pass.  The
// sync's x̂ may be the leaf's shape without its leading (worker) axes: it
// is then read with a stride of 0 over them — each thread loads its x̂
// elements once and walks the m-element copies with them from registers —
// and never materialised.
//
// Bound: device-memory bandwidth — a few flops per 12–24 bytes.  Design: a
// grid-stride pass over groups of 8 elements, each operand loaded with one
// 16-byte load per group of bf16 or two of fp32, when every pointer is
// 16-byte aligned (and, for the sync, x̂'s element count a multiple of 8);
// otherwise, and for the tail, one element at a time.  Outputs are new
// buffers (the Pallas kernels do not alias their inputs either).
//
// Numerics: the plain PyTorch version's arithmetic op for op
// (kernels/torch_update.py), built with -fmad=false so that no multiply
// and add are contracted into an FMA: the kernels are bitwise their plain
// versions (and so the eager oracles of src/repro/kernels/ref.py), and
// within one fp32 ulp of interpret-mode Pallas, which contracts both
// updates into one FMA.  γ and inv_kg arrive as fp32, rounded once from
// the host's doubles, as the Pallas kernels' weak-typed scalars are.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;

int grid_for(int64_t n) {
  // enough blocks to fill the card a few times over; the grid-stride loop
  // covers the rest
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int64_t want = (n + kThreads - 1) / kThreads;
  int64_t cap = (int64_t)sms * 16;
  int64_t g = want < cap ? want : cap;
  return (int)(g > 0 ? g : 1);
}

// ---- one element: fp32 or bf16 in, fp32 in registers, rounded out
__device__ __forceinline__ float ld(const float* x, int64_t i) { return x[i]; }

__device__ __forceinline__ float ld(const __nv_bfloat16* x, int64_t i) {
  return __bfloat162float(x[i]);
}

__device__ __forceinline__ void st(float* x, int64_t i, float v) { x[i] = v; }

__device__ __forceinline__ void st(__nv_bfloat16* x, int64_t i, float v) {
  x[i] = __float2bfloat16_rn(v);
}

// v rounded to T's precision and read back (fp32: v itself)
__device__ __forceinline__ float round_to(float v, const float*) { return v; }

__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---- eight elements (group i), 16-byte aligned: two float4 or one uint4
__device__ __forceinline__ void ld8(const float* x, int64_t i, float* v) {
  const float4 a = reinterpret_cast<const float4*>(x)[2 * i];
  const float4 b = reinterpret_cast<const float4*>(x)[2 * i + 1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void ld8(const __nv_bfloat16* x, int64_t i,
                                    float* v) {
  const uint4 raw = reinterpret_cast<const uint4*>(x)[i];
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 h;
    memcpy(&h, &w[j], sizeof(h));
    const float2 f = __bfloat1622float2(h);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void st8(float* x, int64_t i, const float* v) {
  reinterpret_cast<float4*>(x)[2 * i] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(x)[2 * i + 1] =
      make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void st8(__nv_bfloat16* x, int64_t i,
                                    const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    memcpy(&w[j], &h, sizeof(h));
  }
  reinterpret_cast<uint4*>(x)[i] = make_uint4(w[0], w[1], w[2], w[3]);
}

// p' = p − lr·(g − Δ), Δ first rounded to p's dtype; out in p's dtype.
template <typename PT, typename GT, typename DT, bool VEC>
__global__ void local_kernel(PT* __restrict__ out, const PT* __restrict__ p,
                             const GT* __restrict__ g,
                             const DT* __restrict__ d, float lr, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n8 = VEC ? n / 8 : 0;
  for (int64_t i = tid; i < n8; i += stride) {
    float pv[8], gv[8], dv[8];
    ld8(p, i, pv);
    ld8(g, i, gv);
    ld8(d, i, dv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pv[j] = pv[j] - lr * (gv[j] - round_to(dv[j], p));
    }
    st8(out, i, pv);
  }
  for (int64_t i = 8 * n8 + tid; i < n; i += stride) {
    st(out, i, ld(p, i) - lr * (ld(g, i) - round_to(ld(d, i), p)));
  }
}

// Δ' = Δ + (x̂ − p)·inv_kg;  p' = x̂, over lead copies of m elements: x̂
// (m elements) is read once per thread and applied to every copy.
template <typename PT, typename XT, typename DT, bool VEC>
__global__ void sync_kernel(PT* __restrict__ po, DT* __restrict__ dout,
                            const PT* __restrict__ p,
                            const XT* __restrict__ xbar,
                            const DT* __restrict__ d, float inv_kg, int64_t m,
                            int64_t lead) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t m8 = VEC ? m / 8 : 0;
  for (int64_t j = tid; j < m8; j += stride) {
    float xb[8];
    ld8(xbar, j, xb);
    for (int64_t k = 0; k < lead; ++k) {
      const int64_t i = k * m8 + j;
      float pv[8], dv[8];
      ld8(p, i, pv);
      ld8(d, i, dv);
#pragma unroll
      for (int e = 0; e < 8; ++e) dv[e] = dv[e] + (xb[e] - pv[e]) * inv_kg;
      st8(dout, i, dv);
      st8(po, i, xb);
    }
  }
  for (int64_t j = 8 * m8 + tid; j < m; j += stride) {
    const float xb = ld(xbar, j);
    for (int64_t k = 0; k < lead; ++k) {
      const int64_t i = k * m + j;
      st(dout, i, ld(d, i) + (xb - ld(p, i)) * inv_kg);
      st(po, i, xb);
    }
  }
}

bool aligned16(const void* x) { return ((uintptr_t)x & 15u) == 0; }

template <typename PT, typename GT, typename DT>
void launch_local(void* out, const void* p, const void* g, const void* d,
                  float lr, int64_t n, cudaStream_t s) {
  const bool vec = aligned16(out) && aligned16(p) && aligned16(g) &&
                   aligned16(d) && n >= 8;
  const int grid = grid_for(vec ? n / 8 : n);
  if (vec) {
    local_kernel<PT, GT, DT, true><<<grid, kThreads, 0, s>>>(
        (PT*)out, (const PT*)p, (const GT*)g, (const DT*)d, lr, n);
  } else {
    local_kernel<PT, GT, DT, false><<<grid, kThreads, 0, s>>>(
        (PT*)out, (const PT*)p, (const GT*)g, (const DT*)d, lr, n);
  }
}

template <typename PT, typename XT, typename DT>
void launch_sync(void* po, void* dout, const void* p, const void* xbar,
                 const void* d, float inv_kg, int64_t n, int64_t m,
                 cudaStream_t s) {
  const int64_t lead = m > 0 ? n / m : 0;
  const bool vec = aligned16(po) && aligned16(dout) && aligned16(p) &&
                   aligned16(xbar) && aligned16(d) && m % 8 == 0 && m > 0;
  const int grid = grid_for(vec ? m / 8 : m);
  if (vec) {
    sync_kernel<PT, XT, DT, true><<<grid, kThreads, 0, s>>>(
        (PT*)po, (DT*)dout, (const PT*)p, (const XT*)xbar, (const DT*)d,
        inv_kg, m, lead);
  } else {
    sync_kernel<PT, XT, DT, false><<<grid, kThreads, 0, s>>>(
        (PT*)po, (DT*)dout, (const PT*)p, (const XT*)xbar, (const DT*)d,
        inv_kg, m, lead);
  }
}

using bf16 = __nv_bfloat16;

// the eight (fp32 | bf16)^3 instantiations, picked by three flags
template <template <typename, typename, typename> class F, typename... A>
void dispatch3(int a, int b, int c, A... args) {
  const int key = (a ? 4 : 0) | (b ? 2 : 0) | (c ? 1 : 0);
  switch (key) {
    case 0: F<float, float, float>::run(args...); break;
    case 1: F<float, float, bf16>::run(args...); break;
    case 2: F<float, bf16, float>::run(args...); break;
    case 3: F<float, bf16, bf16>::run(args...); break;
    case 4: F<bf16, float, float>::run(args...); break;
    case 5: F<bf16, float, bf16>::run(args...); break;
    case 6: F<bf16, bf16, float>::run(args...); break;
    default: F<bf16, bf16, bf16>::run(args...); break;
  }
}

template <typename PT, typename GT, typename DT>
struct Local {
  static void run(void* out, const void* p, const void* g, const void* d,
                  float lr, int64_t n, cudaStream_t s) {
    launch_local<PT, GT, DT>(out, p, g, d, lr, n, s);
  }
};

template <typename PT, typename XT, typename DT>
struct Sync {
  static void run(void* po, void* dout, const void* p, const void* xbar,
                  const void* d, float inv_kg, int64_t n, int64_t m,
                  cudaStream_t s) {
    launch_sync<PT, XT, DT>(po, dout, p, xbar, d, inv_kg, n, m, s);
  }
};

}  // namespace

extern "C" {

// out, p: n elements of p's dtype; g, d: n elements each.  *_bf16 = 1
// marks a bf16 operand, 0 fp32.  Returns cudaGetLastError() after the
// launch (0 = cudaSuccess).
int leaf_local_update(void* out, const void* p, const void* g, const void* d,
                      int p_bf16, int g_bf16, int d_bf16, float lr, int64_t n,
                      void* stream) {
  dispatch3<Local>(p_bf16, g_bf16, d_bf16, out, p, g, d, lr, n,
                   (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// po, p: n elements of p's dtype; dout, d: n of Δ's; xbar: m elements, n a
// multiple of m (x̂ repeats over the n/m leading copies).
int leaf_sync_update(void* po, void* dout, const void* p, const void* xbar,
                     const void* d, int p_bf16, int x_bf16, int d_bf16,
                     float inv_kg, int64_t n, int64_t m, void* stream) {
  dispatch3<Sync>(p_bf16, x_bf16, d_bf16, po, dout, p, xbar, d, inv_kg, n, m,
                  (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
