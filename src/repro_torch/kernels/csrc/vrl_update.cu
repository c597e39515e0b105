// Fused VRL-SGD engine updates for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/vrl_update.py:
//   vrl_fused_local_sgd       <- fused_local_sgd       (vrl_update.py:152)
//   vrl_fused_local_momentum  <- fused_local_momentum  (vrl_update.py:188)
//   vrl_fused_local_adam      <- fused_local_adam      (vrl_update.py:230)
//   vrl_fused_local_adam_sm3  <- fused_local_adam_sm3  (vrl_update.py:302)
//                             and fused_hier_local_adam_sm3
//                                                      (vrl_update.py:927)
//   vrl_fused_sync_vrl        <- fused_sync_vrl        (vrl_update.py:351)
//   vrl_fused_sync_bvr        <- fused_sync_bvr        (vrl_update.py:388)
//   vrl_fused_sync_easgd      <- fused_sync_easgd      (vrl_update.py:618)
//   vrl_fused_hier_local_sgd  <- fused_hier_local_sgd  (vrl_update.py:803)
//   vrl_fused_hier_local_momentum <- fused_hier_local_momentum
//                                                      (vrl_update.py:833)
//   vrl_fused_hier_local_adam <- fused_hier_local_adam (vrl_update.py:871)
//   vrl_fused_sync_hier1      <- fused_sync_hier1      (vrl_update.py:971)
//   vrl_fused_sync_hier2      <- fused_sync_hier2      (vrl_update.py:1003)
//   vrl_fused_fold_hier2      <- fused_fold_overlap_hier2
//                                                      (vrl_update.py:570)
//
// Bound: all are single elementwise passes over model-sized buffers (a few
// flops per 10+ bytes), so device-memory bandwidth is the only limit.
// Design: one streaming pass over groups of four elements, 16-byte (float4)
// loads and stores of fp32 and 8-byte ones of bf16, a grid-stride loop
// over 64-bit indices (W*R*C reaches 2^31 at full width), results written
// in place over the state buffers as the Pallas kernels'
// input_output_aliases do.
//
// Operand types, as the reference's kernels take them (each operand read
// through _f32, each result cast to its buffer's dtype): the parameters p
// and the mean x̂ share one type PT, fp32 or bf16; the drift buffers Δ and
// B (Δ1, Δ2 in the hierarchy) one type DT; the moments one type MT; the
// gradient may be either.  A buffer a kernel writes is a template
// parameter; one it only reads (g, and Δ/B in a local step) is an In, a
// pointer with a warp-uniform bf16 flag.  The C functions take the types
// as one bit mask (kDtP | kDtG | kDtD | kDtM); the EASGD center, the
// overlap pend, the SM3 stats and the step scalars are fp32 always.
// The syncs read each x̂ (and EASGD center) element once and apply it to
// all W workers from a register, so it is never expanded W times.  Nothing
// is allocated here; the caller passes PyTorch's stream.  Runtime scalars
// that change every step (k_eff*γ, Adam's bias corrections) are read from
// small device tensors, so a step never needs a host round trip.
//
// The hierarchy's kernels run over pod-major (P, D, R, C) buffers with
// per-pod operands (Δ2, x̂_pod, pend2) of shape (P, 1, R, C).  One thread
// owns one (pod, float4 of R*C) — the pod is blockIdx.y — and walks the
// pod's D workers from registers, so every per-pod operand is read and
// written once, not D times.  The Pallas kernels revisit the per-pod
// block D times and therefore refuse to donate it; here one thread owns
// each element, so Δ2 and pend2 are updated in place with no hazard.
//
// SM3-factored Adam keeps no dense nu: a row stat (one value per row) and a
// lane stat (one row of C values per shard's row span) rebuild
// v̂ = min(row, col) per element, and the step re-factors nu into both.
// Statistics span a whole row, so one warp owns a (worker, row): the row
// max is a warp reduction and the row stat is updated in place by its
// owning warp.  Every row of a span reads the OLD lane stat, so the new
// one goes to a separate zeroed buffer: each block (whose rows never
// straddle a span) takes its lanes' max over its rows in shared memory and
// folds it in with one atomicMax per lane.  nu = b2·v̂ + (1 − b2)·v² is
// +0 or above (or NaN), where the uint order of the bits is the float
// order with every NaN above +inf, so the integer max is exact,
// order-free and propagates NaN as the plain version's max does.
//
// Numerics: the arithmetic is the plain PyTorch version's op for op
// (kernels/torch_update.py), in the same association order, and the
// library is built with -fmad=false so that no multiply-add is contracted
// into an FMA, and without fast math so that divisions and sqrtf are IEEE
// — which keeps the kernels bitwise equal to the plain versions.  Scalar
// constants such as 1 − β1 are computed by the caller in double and
// rounded to fp32 once, as JAX's weak-typed Python scalars are.  Every
// value is fp32 in registers; a bf16 operand loads exactly, and a bf16
// result is rounded once on store to nearest even (__floats2bfloat162_rn),
// as Tensor.to(torch.bfloat16) and XLA's convert do.  NaN payloads are not
// part of the contract: a bf16 NaN may carry other bits than the plain
// version's (compare NaN as NaN).


#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
// the C functions' dtype mask: a set bit = that operand is bf16
constexpr int kDtP = 1, kDtG = 2, kDtD = 4, kDtM = 8;

int grid_for(int64_t n) {
  // enough blocks to fill the card a few times over; the grid-stride
  // loop covers the rest
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int64_t want = (n + kThreads - 1) / kThreads;
  int64_t cap = (int64_t)sms * 16;
  int64_t g = want < cap ? want : cap;
  return (int)(g > 0 ? g : 1);
}

// ---- four-element loads and stores: fp32 (float4) or bf16 (8 bytes);
// i counts groups of four elements
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

// A read-only operand: fp32 or bf16 (the flag is the same for every thread,
// so the branch never diverges), or absent (null).
struct In {
  const void* ptr;
  bool bf16;
  __device__ __forceinline__ bool on() const { return ptr != nullptr; }
  __device__ __forceinline__ float4 at(int64_t i) const {
    return bf16 ? load4(static_cast<const __nv_bfloat16*>(ptr), i)
                : load4(static_cast<const float*>(ptr), i);
  }
  __device__ __forceinline__ float4 or_zero(int64_t i) const {
    return ptr != nullptr ? at(i) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
};

In in(const void* ptr, int dtypes, int bit) {
  return In{ptr, (dtypes & bit) != 0};
}

// f(Tag<float>) or f(Tag<__nv_bfloat16>) by a dtype bit: one template
// instance per buffer type a kernel writes
template <typename T>
struct Tag {
  using type = T;
};

template <typename F>
void by_type(bool bf16, F&& f) {
  if (bf16) {
    f(Tag<__nv_bfloat16>{});
  } else {
    f(Tag<float>{});
  }
}

#define VRL_TYPE(tag) typename decltype(tag)::type

// v = g − [Δ] − [B] (+ wd·p), the corrected gradient of every local step
__device__ __forceinline__ float corrected(float p, float g, float d, float b,
                                          bool has_d, bool has_b, float wd) {
  float v = g;
  if (has_d) v = v - d;
  if (has_b) v = v - b;
  if (wd != 0.0f) v = v + wd * p;
  return v;
}

__device__ __forceinline__ float local_one(float p, float g, float d,
                                           float b, bool has_d, bool has_b,
                                           float lr, float wd) {
  return p - lr * corrected(p, g, d, b, has_d, has_b, wd);
}

// p <- p − lr·((g − [Δ] − [B]) + wd·p) over n4 groups of four.
template <typename PT>
__global__ void local_sgd_kernel(PT* __restrict__ p, In g, In d, In b,
                                 float lr, float wd, int64_t n4) {
  const bool has_d = d.on(), has_b = b.on();
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 pv = load4(p, i);
    const float4 gv = g.at(i);
    const float4 dv = d.or_zero(i);
    const float4 bv = b.or_zero(i);
    pv.x = local_one(pv.x, gv.x, dv.x, bv.x, has_d, has_b, lr, wd);
    pv.y = local_one(pv.y, gv.y, dv.y, bv.y, has_d, has_b, lr, wd);
    pv.z = local_one(pv.z, gv.z, dv.z, bv.z, has_d, has_b, lr, wd);
    pv.w = local_one(pv.w, gv.w, dv.w, bv.w, has_d, has_b, lr, wd);
    store4(p, i, pv);
  }
}

__device__ __forceinline__ float4 vrl_delta(float4 dv, float4 xb, float4 pv,
                                            float kg) {
  dv.x = dv.x + (xb.x - pv.x) / kg;
  dv.y = dv.y + (xb.y - pv.y) / kg;
  dv.z = dv.z + (xb.z - pv.z) / kg;
  dv.w = dv.w + (xb.w - pv.w) / kg;
  return dv;
}

// Δ_w <- Δ_w + (x̂ − p_w)/kg;  p_w <- x̂  for every worker w, where kg =
// scal[0] = k_eff·γ is read on the device (no host round trip).
// rc4 = R*C/4 groups per worker; x̂ in p's type.
template <typename PT, typename DT>
__global__ void sync_vrl_kernel(PT* __restrict__ p, DT* __restrict__ d,
                                const PT* __restrict__ xbar,
                                const float* __restrict__ scal, int64_t w,
                                int64_t rc4) {
  const float kg = scal[0];
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < rc4;
       i += stride) {
    const float4 xb = load4(xbar, i);
    for (int64_t k = 0; k < w; ++k) {
      const int64_t j = k * rc4 + i;
      store4(d, j, vrl_delta(load4(d, j), xb, load4(p, j), kg));
      store4(p, j, xb);
    }
  }
}

struct MomentumArgs {
  float lr, beta, wd;
  bool nesterov;
};

__device__ __forceinline__ void momentum_one(float& p, float& m, float g,
                                             float d, float b, bool has_d,
                                             bool has_b,
                                             const MomentumArgs& a) {
  const float v = corrected(p, g, d, b, has_d, has_b, a.wd);
  const float m_new = a.beta * m + v;
  const float dir = a.nesterov ? v + a.beta * m_new : m_new;
  p = p - a.lr * dir;
  m = m_new;
}

// v = g − [Δ] − [B] + wd·p;  m' = βm + v;  p' = p − γ·(nesterov ? v + βm'
// : m'), in place over p and m.
template <typename PT, typename MT>
__global__ void local_momentum_kernel(PT* __restrict__ p, In g, In d, In b,
                                      MT* __restrict__ m, MomentumArgs a,
                                      int64_t n4) {
  const bool has_d = d.on(), has_b = b.on();
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 pv = load4(p, i);
    const float4 gv = g.at(i);
    const float4 dv = d.or_zero(i);
    const float4 bv = b.or_zero(i);
    float4 mv = load4(m, i);
    momentum_one(pv.x, mv.x, gv.x, dv.x, bv.x, has_d, has_b, a);
    momentum_one(pv.y, mv.y, gv.y, dv.y, bv.y, has_d, has_b, a);
    momentum_one(pv.z, mv.z, gv.z, dv.z, bv.z, has_d, has_b, a);
    momentum_one(pv.w, mv.w, gv.w, dv.w, bv.w, has_d, has_b, a);
    store4(p, i, pv);
    store4(m, i, mv);
  }
}

struct AdamArgs {
  float lr, b1, one_minus_b1, b2, one_minus_b2, eps, wd, lr_wd;
};

// One Adam step from the old second moment nu_old (dense, or SM3's v̂):
// updates p and mu, returns nu' = b2·nu_old + (1 − b2)·v².
__device__ __forceinline__ float adam_step(float& p, float& mu, float nu_old,
                                           float g, float d, float b,
                                           bool has_d, bool has_b, float c1,
                                           float c2, const AdamArgs& a) {
  const float v = corrected(p, g, d, b, has_d, has_b, 0.0f);
  const float mu_new = a.b1 * mu + a.one_minus_b1 * v;
  const float nu_new = a.b2 * nu_old + a.one_minus_b2 * v * v;
  float step = a.lr * (mu_new / c1) / (sqrtf(nu_new / c2) + a.eps);
  if (a.wd != 0.0f) step = step + a.lr_wd * p;
  p = p - step;
  mu = mu_new;
  return nu_new;
}

__device__ __forceinline__ void adam_one(float& p, float& mu, float& nu,
                                         float g, float d, float b,
                                         bool has_d, bool has_b, float c1,
                                         float c2, const AdamArgs& a) {
  nu = adam_step(p, mu, nu, g, d, b, has_d, has_b, c1, c2, a);
}

// Adam on v = g − [Δ] − [B]: mu, nu EMAs (stored fp32 or bf16);
// p' = p − γ(mu'/c1)/(√(nu'/c2) + eps) − (γ·wd)·p, with [c1, c2] = scal
// read on the device.  In place over p, mu and nu.
template <typename PT, typename MT>
__global__ void local_adam_kernel(PT* __restrict__ p, In g, In d, In b,
                                  MT* __restrict__ mu, MT* __restrict__ nu,
                                  const float* __restrict__ scal, AdamArgs a,
                                  int64_t n4) {
  const bool has_d = d.on(), has_b = b.on();
  const float c1 = scal[0], c2 = scal[1];
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 pv = load4(p, i);
    const float4 gv = g.at(i);
    const float4 dv = d.or_zero(i);
    const float4 bv = b.or_zero(i);
    float4 mv = load4(mu, i);
    float4 nv = load4(nu, i);
    adam_one(pv.x, mv.x, nv.x, gv.x, dv.x, bv.x, has_d, has_b, c1, c2, a);
    adam_one(pv.y, mv.y, nv.y, gv.y, dv.y, bv.y, has_d, has_b, c1, c2, a);
    adam_one(pv.z, mv.z, nv.z, gv.z, dv.z, bv.z, has_d, has_b, c1, c2, a);
    adam_one(pv.w, mv.w, nv.w, gv.w, dv.w, bv.w, has_d, has_b, c1, c2, a);
    store4(p, i, pv);
    store4(mu, i, mv);
    store4(nu, i, nv);
  }
}

__device__ __forceinline__ void bvr_one(float xb, float p, float& d, float& b,
                                        float kg, float omb, float beta) {
  const float u = (xb - p) / kg;
  d = d + u;
  b = omb * b + beta * u;
}

// u = (x̂ − p_w)/kg;  Δ_w += u;  B_w = (1−β)B_w + β·u;  p_w = x̂, for every
// worker w, with kg = scal[0] = k_eff·γ read on the device.  omb = 1 − β
// (rounded once from double by the caller).  rc4 = R*C/4 per worker.
template <typename PT, typename DT>
__global__ void sync_bvr_kernel(PT* __restrict__ p, DT* __restrict__ d,
                                DT* __restrict__ b,
                                const PT* __restrict__ xbar,
                                const float* __restrict__ scal, float omb,
                                float beta, int64_t w, int64_t rc4) {
  const float kg = scal[0];
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < rc4;
       i += stride) {
    const float4 xb = load4(xbar, i);
    for (int64_t k = 0; k < w; ++k) {
      const int64_t j = k * rc4 + i;
      const float4 pv = load4(p, j);
      float4 dv = load4(d, j);
      float4 bv = load4(b, j);
      bvr_one(xb.x, pv.x, dv.x, bv.x, kg, omb, beta);
      bvr_one(xb.y, pv.y, dv.y, bv.y, kg, omb, beta);
      bvr_one(xb.z, pv.z, dv.z, bv.z, kg, omb, beta);
      bvr_one(xb.w, pv.w, dv.w, bv.w, kg, omb, beta);
      store4(d, j, dv);
      store4(b, j, bv);
      store4(p, j, xb);
    }
  }
}

// EASGD worker pass: p_w <- p_w − a·(p_w − x̃) for every worker, reading
// the OLD fp32 center x̃ (the center pass runs after it on the same stream).
template <typename PT>
__global__ void easgd_worker_kernel(PT* __restrict__ p,
                                    const float4* __restrict__ center,
                                    float a, int64_t w, int64_t rc4) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < rc4;
       i += stride) {
    const float4 c = center[i];
    for (int64_t k = 0; k < w; ++k) {
      const int64_t j = k * rc4 + i;
      float4 pv = load4(p, j);
      pv.x = pv.x - a * (pv.x - c.x);
      pv.y = pv.y - a * (pv.y - c.y);
      pv.z = pv.z - a * (pv.z - c.z);
      pv.w = pv.w - a * (pv.w - c.w);
      store4(p, j, pv);
    }
  }
}

// EASGD center pass: x̃ <- (1 − na)·x̃ + na·x̂ in place; omna = 1 − na.
// Both fp32 (x̂ is the mean of the fp32-cast parameters).
__global__ void easgd_center_kernel(float4* __restrict__ center,
                                    const float4* __restrict__ xbar,
                                    float omna, float na, int64_t rc4) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < rc4;
       i += stride) {
    float4 c = center[i];
    const float4 xb = xbar[i];
    c.x = omna * c.x + na * xb.x;
    c.y = omna * c.y + na * xb.y;
    c.z = omna * c.z + na * xb.z;
    c.w = omna * c.w + na * xb.w;
    center[i] = c;
  }
}

// ---------------------------------------------------- hierarchy (P, D, R, C)
// In every kernel below: pod = blockIdx.y; e walks the pod's rc4 groups of
// four; worker k of the pod is at (pod*dper + k)*rc4 + e; the per-pod
// operand is at pod*rc4 + e.

// p <- p − lr·((g − Δ1 − Δ2) + wd·p): local_one with Δ1 as Δ and Δ2 as the
// second correction, Δ2 loaded once per pod.
template <typename PT>
__global__ void hier_local_sgd_kernel(PT* __restrict__ p, In g, In d1, In d2,
                                      float lr, float wd, int64_t dper,
                                      int64_t rc4) {
  const int64_t pod = blockIdx.y;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < rc4;
       e += stride) {
    const float4 bv = d2.at(pod * rc4 + e);
    for (int64_t k = 0; k < dper; ++k) {
      const int64_t j = (pod * dper + k) * rc4 + e;
      float4 pv = load4(p, j);
      const float4 gv = g.at(j);
      const float4 dv = d1.at(j);
      pv.x = local_one(pv.x, gv.x, dv.x, bv.x, true, true, lr, wd);
      pv.y = local_one(pv.y, gv.y, dv.y, bv.y, true, true, lr, wd);
      pv.z = local_one(pv.z, gv.z, dv.z, bv.z, true, true, lr, wd);
      pv.w = local_one(pv.w, gv.w, dv.w, bv.w, true, true, lr, wd);
      store4(p, j, pv);
    }
  }
}

// Level-1 sync: Δ1 <- Δ1 + (x̂_pod − p)/kg; p <- x̂_pod for every worker of
// the pod, kg = scal[0] = k1_eff·γ; x̂_pod loaded once per pod.
template <typename PT, typename DT>
__global__ void sync_hier1_kernel(PT* __restrict__ p, DT* __restrict__ d1,
                                  const PT* __restrict__ xbar_pod,
                                  const float* __restrict__ scal,
                                  int64_t dper, int64_t rc4) {
  const float kg = scal[0];
  const int64_t pod = blockIdx.y;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < rc4;
       e += stride) {
    const float4 xb = load4(xbar_pod, pod * rc4 + e);
    for (int64_t k = 0; k < dper; ++k) {
      const int64_t j = (pod * dper + k) * rc4 + e;
      store4(d1, j, vrl_delta(load4(d1, j), xb, load4(p, j), kg));
      store4(p, j, xb);
    }
  }
}

// Level-2 sync: Δ2 <- Δ2 + (x̂ − p_pod)/kg once per pod, p_pod read off
// worker 0 (after a level-1 sync every worker holds the pod average); then
// p <- x̂ for every worker.  kg = scal[0] = k2_eff·γ.
template <typename PT, typename DT>
__global__ void sync_hier2_kernel(PT* __restrict__ p, DT* __restrict__ d2,
                                  const PT* __restrict__ glob,
                                  const float* __restrict__ scal,
                                  int64_t dper, int64_t rc4) {
  const float kg = scal[0];
  const int64_t pod = blockIdx.y;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < rc4;
       e += stride) {
    const float4 gl = load4(glob, e);
    const float4 pv = load4(p, pod * dper * rc4 + e);
    const int64_t i = pod * rc4 + e;
    store4(d2, i, vrl_delta(load4(d2, i), gl, pv, kg));
    for (int64_t k = 0; k < dper; ++k) {
      store4(p, (pod * dper + k) * rc4 + e, gl);
    }
  }
}

// Level-2 stale fold: c = x̂_stale − pend2_pod; p <- p + c for every worker
// of the pod; Δ2 <- Δ2 + c·s₀; with capture, pend2 <- km·pend2 + (1 − km)·
// (worker 0's folded p, in fp32 before its store).  [s₀, km] =
// wscal[2*pod], wscal[2*pod + 1]; pend2 fp32.
template <typename PT, typename DT>
__global__ void fold_hier2_kernel(PT* __restrict__ p,
                                  const PT* __restrict__ glob,
                                  float4* __restrict__ pend2,
                                  DT* __restrict__ d2,
                                  const float* __restrict__ wscal,
                                  int capture, int64_t dper, int64_t rc4) {
  const int64_t pod = blockIdx.y;
  const float inv = wscal[2 * pod], km = wscal[2 * pod + 1];
  const float omkm = 1.0f - km;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < rc4;
       e += stride) {
    const int64_t i = pod * rc4 + e;
    const float4 gl = load4(glob, e);
    const float4 pe = pend2[i];
    const float4 c = make_float4(gl.x - pe.x, gl.y - pe.y, gl.z - pe.z,
                                 gl.w - pe.w);
    float4 pod_new = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int64_t k = 0; k < dper; ++k) {
      const int64_t j = (pod * dper + k) * rc4 + e;
      const float4 pv = load4(p, j);
      const float4 pn = make_float4(pv.x + c.x, pv.y + c.y, pv.z + c.z,
                                    pv.w + c.w);
      store4(p, j, pn);
      if (k == 0) pod_new = pn;
    }
    float4 dv = load4(d2, i);
    dv.x = dv.x + c.x * inv;
    dv.y = dv.y + c.y * inv;
    dv.z = dv.z + c.z * inv;
    dv.w = dv.w + c.w * inv;
    store4(d2, i, dv);
    if (capture) {
      pend2[i] = make_float4(
          km * pe.x + omkm * pod_new.x, km * pe.y + omkm * pod_new.y,
          km * pe.z + omkm * pod_new.z, km * pe.w + omkm * pod_new.w);
    }
  }
}

// Momentum on v = g − Δ1 − Δ2 (+ wd·p): momentum_one with Δ1 as Δ and Δ2
// as the second correction, Δ2 loaded once per pod.
template <typename PT, typename MT>
__global__ void hier_local_momentum_kernel(PT* __restrict__ p, In g, In d1,
                                           In d2, MT* __restrict__ m,
                                           MomentumArgs a, int64_t dper,
                                           int64_t rc4) {
  const int64_t pod = blockIdx.y;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < rc4;
       e += stride) {
    const float4 bv = d2.at(pod * rc4 + e);
    for (int64_t k = 0; k < dper; ++k) {
      const int64_t j = (pod * dper + k) * rc4 + e;
      float4 pv = load4(p, j);
      const float4 gv = g.at(j);
      const float4 dv = d1.at(j);
      float4 mv = load4(m, j);
      momentum_one(pv.x, mv.x, gv.x, dv.x, bv.x, true, true, a);
      momentum_one(pv.y, mv.y, gv.y, dv.y, bv.y, true, true, a);
      momentum_one(pv.z, mv.z, gv.z, dv.z, bv.z, true, true, a);
      momentum_one(pv.w, mv.w, gv.w, dv.w, bv.w, true, true, a);
      store4(p, j, pv);
      store4(m, j, mv);
    }
  }
}

// Adam on v = g − Δ1 − Δ2, dense nu: adam_one with Δ2 loaded once per pod;
// [c1, c2] = scal read on the device.
template <typename PT, typename MT>
__global__ void hier_local_adam_kernel(PT* __restrict__ p, In g, In d1,
                                       In d2, MT* __restrict__ mu,
                                       MT* __restrict__ nu,
                                       const float* __restrict__ scal,
                                       AdamArgs a, int64_t dper,
                                       int64_t rc4) {
  const float c1 = scal[0], c2 = scal[1];
  const int64_t pod = blockIdx.y;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < rc4;
       e += stride) {
    const float4 bv = d2.at(pod * rc4 + e);
    for (int64_t k = 0; k < dper; ++k) {
      const int64_t j = (pod * dper + k) * rc4 + e;
      float4 pv = load4(p, j);
      const float4 gv = g.at(j);
      const float4 dv = d1.at(j);
      float4 mv = load4(mu, j);
      float4 nv = load4(nu, j);
      adam_one(pv.x, mv.x, nv.x, gv.x, dv.x, bv.x, true, true, c1, c2, a);
      adam_one(pv.y, mv.y, nv.y, gv.y, dv.y, bv.y, true, true, c1, c2, a);
      adam_one(pv.z, mv.z, nv.z, gv.z, dv.z, bv.z, true, true, c1, c2, a);
      adam_one(pv.w, mv.w, nv.w, gv.w, dv.w, bv.w, true, true, c1, c2, a);
      store4(p, j, pv);
      store4(mu, j, mv);
      store4(nu, j, nv);
    }
  }
}

// ------------------------------------------------ SM3-factored Adam
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLaneGroups = 8;   // C ≤ 32 lanes × 8 groups of 4 = 1,024

// min that returns NaN when either operand is NaN, as torch.minimum does
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ unsigned max_bits(unsigned m, float x) {
  const unsigned u = __float_as_uint(x);
  return u > m ? u : m;
}

struct Sm3Shape {
  int64_t workers;   // leading buffers: workers × rows × lanes
  int64_t b_div;     // b is indexed by worker / b_div (hier: Δ2 per pod)
  int64_t rows, shards, span, rpc, cps;
};

// One block: rows [r0, r1) of one shard span s of worker w, with w the
// fastest-varying block index (a pod's workers run side by side and share
// Δ2 through L2).  Warp i takes rows r0 + i, r0 + i + kWarps, ...; lane l
// holds groups q·32 + l (q < G) of each row, so the old lane stat of its
// columns stays in registers for the whole block.  G = C/128.
template <int G, typename PT, typename MT>
__global__ void __launch_bounds__(kThreads)
    adam_sm3_kernel(PT* __restrict__ p, In g, In d, In b,
                    MT* __restrict__ mu, float* __restrict__ row,
                    const float* __restrict__ col, float* __restrict__ col_out,
                    const float* __restrict__ scal, AdamArgs a, Sm3Shape sh) {
  constexpr int C = G * 128, C4 = G * 32;
  __shared__ unsigned red[kWarps][C];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t w = blockIdx.x % sh.workers;
  const int64_t rest = blockIdx.x / sh.workers;
  const int64_t s = rest / sh.cps, c = rest % sh.cps;
  const int64_t r0 = s * sh.span + c * sh.rpc;
  int64_t r1 = r0 + sh.rpc;
  if (r1 > (s + 1) * sh.span) r1 = (s + 1) * sh.span;
  const bool has_d = d.on(), has_b = b.on();
  const float c1 = scal[0], c2 = scal[1];
  const float4* col4 = reinterpret_cast<const float4*>(col);

  float4 cv[G];
  unsigned cmax[G][4];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    cv[q] = col4[(w * sh.shards + s) * C4 + q * 32 + lane];
    cmax[q][0] = cmax[q][1] = cmax[q][2] = cmax[q][3] = 0u;
  }
  for (int64_t r = r0 + warp; r < r1; r += kWarps) {
    const float rs = row[w * sh.rows + r];
    const int64_t base = (w * sh.rows + r) * C4 + lane;
    const int64_t bbase = ((w / sh.b_div) * sh.rows + r) * C4 + lane;
    unsigned rmax = 0u;
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int64_t i = base + q * 32;
      float4 pv = load4(p, i);
      const float4 gv = g.at(i);
      const float4 dv = d.or_zero(i);
      const float4 bv = b.or_zero(bbase + q * 32);
      float4 mv = load4(mu, i);
      float4 nv;
      nv.x = adam_step(pv.x, mv.x, min_nan(rs, cv[q].x), gv.x, dv.x, bv.x,
                       has_d, has_b, c1, c2, a);
      nv.y = adam_step(pv.y, mv.y, min_nan(rs, cv[q].y), gv.y, dv.y, bv.y,
                       has_d, has_b, c1, c2, a);
      nv.z = adam_step(pv.z, mv.z, min_nan(rs, cv[q].z), gv.z, dv.z, bv.z,
                       has_d, has_b, c1, c2, a);
      nv.w = adam_step(pv.w, mv.w, min_nan(rs, cv[q].w), gv.w, dv.w, bv.w,
                       has_d, has_b, c1, c2, a);
      store4(p, i, pv);
      store4(mu, i, mv);
      rmax = max_bits(max_bits(max_bits(max_bits(rmax, nv.x), nv.y), nv.z),
                      nv.w);
      cmax[q][0] = max_bits(cmax[q][0], nv.x);
      cmax[q][1] = max_bits(cmax[q][1], nv.y);
      cmax[q][2] = max_bits(cmax[q][2], nv.z);
      cmax[q][3] = max_bits(cmax[q][3], nv.w);
    }
    rmax = __reduce_max_sync(0xffffffffu, rmax);
    if (lane == 0) row[w * sh.rows + r] = __uint_as_float(rmax);
  }
#pragma unroll
  for (int q = 0; q < G; ++q) {
#pragma unroll
    for (int t = 0; t < 4; ++t) red[warp][(q * 32 + lane) * 4 + t] = cmax[q][t];
  }
  __syncthreads();
  unsigned* out = reinterpret_cast<unsigned*>(col_out) +
                  (w * sh.shards + s) * C;
  for (int k = threadIdx.x; k < C; k += kThreads) {
    unsigned m = 0u;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) m = red[i][k] > m ? red[i][k] : m;
    if (m) atomicMax(out + k, m);
  }
}

template <typename PT, typename MT>
int launch_adam_sm3(int groups, dim3 grid, cudaStream_t st, void* p, In g,
                    In d, In b, void* mu, void* row, const void* col,
                    void* col_out, const void* scal, const AdamArgs& a,
                    const Sm3Shape& sh) {
#define VRL_SM3_CASE(G)                                                     \
  case G:                                                                   \
    adam_sm3_kernel<G, PT, MT><<<grid, kThreads, 0, st>>>(                  \
        (PT*)p, g, d, b, (MT*)mu, (float*)row, (const float*)col,           \
        (float*)col_out, (const float*)scal, a, sh);                        \
    break;
  switch (groups) {
    VRL_SM3_CASE(1)
    VRL_SM3_CASE(2)
    VRL_SM3_CASE(3)
    VRL_SM3_CASE(4)
    VRL_SM3_CASE(5)
    VRL_SM3_CASE(6)
    VRL_SM3_CASE(7)
    VRL_SM3_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VRL_SM3_CASE
  return (int)cudaGetLastError();
}

// The hierarchy's launch shape: blockIdx.y = pod (at most 65,535 pods),
// the x blocks of all pods together about grid_for(pods*rc4).
bool hier_grid(int64_t pods, int64_t rc4, dim3* grid) {
  if (pods < 1 || pods > 65535 || rc4 < 1) return false;
  int64_t gx = grid_for(pods * rc4) / pods;
  *grid = dim3((unsigned)(gx > 0 ? gx : 1), (unsigned)pods);
  return true;
}

}  // namespace

extern "C" {

// Every function: ``dtypes`` marks the bf16 operands (kDtP: p and x̂,
// kDtG: g, kDtD: Δ and B / Δ1 and Δ2, kDtM: the moments); an operand
// without its bit is fp32.  Returns cudaGetLastError() after the launch
// (0 = cudaSuccess).

// n: element count of p (a multiple of 4); d and b may be null.
int vrl_fused_local_sgd(void* p, const void* g, const void* d, const void* b,
                        int dtypes, float lr, float wd, int64_t n,
                        void* stream) {
  int64_t n4 = n / 4;
  if (n4 > 0) {
    by_type(dtypes & kDtP, [&](auto pt) {
      using PT = VRL_TYPE(pt);
      local_sgd_kernel<PT>
          <<<grid_for(n4), kThreads, 0, (cudaStream_t)stream>>>(
              (PT*)p, in(g, dtypes, kDtG), in(d, dtypes, kDtD),
              in(b, dtypes, kDtD), lr, wd, n4);
    });
  }
  return (int)cudaGetLastError();
}

// p, d: (w, rc); xbar: (rc,) in p's type; scal: one fp32 (k_eff·γ) on the
// device.  rc is a multiple of 4.
int vrl_fused_sync_vrl(void* p, void* d, const void* xbar, const void* scal,
                       int dtypes, int64_t w, int64_t rc, void* stream) {
  int64_t rc4 = rc / 4;
  if (rc4 > 0 && w > 0) {
    by_type(dtypes & kDtP, [&](auto pt) {
      by_type(dtypes & kDtD, [&](auto dt) {
        using PT = VRL_TYPE(pt);
        using DT = VRL_TYPE(dt);
        sync_vrl_kernel<PT, DT>
            <<<grid_for(rc4), kThreads, 0, (cudaStream_t)stream>>>(
                (PT*)p, (DT*)d, (const PT*)xbar, (const float*)scal, w, rc4);
      });
    });
  }
  return (int)cudaGetLastError();
}

// n: element count of p (a multiple of 4); d and b may be null.
int vrl_fused_local_momentum(void* p, const void* g, const void* d,
                             const void* b, void* m, int dtypes, float lr,
                             float beta, float wd, int nesterov, int64_t n,
                             void* stream) {
  int64_t n4 = n / 4;
  const MomentumArgs a{lr, beta, wd, nesterov != 0};
  if (n4 > 0) {
    by_type(dtypes & kDtP, [&](auto pt) {
      by_type(dtypes & kDtM, [&](auto mt) {
        using PT = VRL_TYPE(pt);
        using MT = VRL_TYPE(mt);
        local_momentum_kernel<PT, MT>
            <<<grid_for(n4), kThreads, 0, (cudaStream_t)stream>>>(
                (PT*)p, in(g, dtypes, kDtG), in(d, dtypes, kDtD),
                in(b, dtypes, kDtD), (MT*)m, a, n4);
      });
    });
  }
  return (int)cudaGetLastError();
}

// As vrl_fused_local_momentum, with mu and nu of one storage type and
// scal: two fp32 on the device, [1 − b1^t, 1 − b2^t].  one_minus_b1,
// one_minus_b2 and lr_wd are computed by the caller in double.
int vrl_fused_local_adam(void* p, const void* g, const void* d,
                         const void* b, void* mu, void* nu, int dtypes,
                         const void* scal, float lr, float b1,
                         float one_minus_b1, float b2, float one_minus_b2,
                         float eps, float wd, float lr_wd, int64_t n,
                         void* stream) {
  int64_t n4 = n / 4;
  const AdamArgs a{lr, b1, one_minus_b1, b2, one_minus_b2, eps, wd, lr_wd};
  if (n4 > 0) {
    by_type(dtypes & kDtP, [&](auto pt) {
      by_type(dtypes & kDtM, [&](auto mt) {
        using PT = VRL_TYPE(pt);
        using MT = VRL_TYPE(mt);
        local_adam_kernel<PT, MT>
            <<<grid_for(n4), kThreads, 0, (cudaStream_t)stream>>>(
                (PT*)p, in(g, dtypes, kDtG), in(d, dtypes, kDtD),
                in(b, dtypes, kDtD), (MT*)mu, (MT*)nu, (const float*)scal, a,
                n4);
      });
    });
  }
  return (int)cudaGetLastError();
}

// p, d, b: (w, rc); xbar: (rc,) in p's type; scal: one fp32 (k_eff·γ) on
// the device; omb = 1 − β.  rc is a multiple of 4.
int vrl_fused_sync_bvr(void* p, void* d, void* b, const void* xbar,
                       const void* scal, int dtypes, float omb, float beta,
                       int64_t w, int64_t rc, void* stream) {
  int64_t rc4 = rc / 4;
  if (rc4 > 0 && w > 0) {
    by_type(dtypes & kDtP, [&](auto pt) {
      by_type(dtypes & kDtD, [&](auto dt) {
        using PT = VRL_TYPE(pt);
        using DT = VRL_TYPE(dt);
        sync_bvr_kernel<PT, DT>
            <<<grid_for(rc4), kThreads, 0, (cudaStream_t)stream>>>(
                (PT*)p, (DT*)d, (DT*)b, (const PT*)xbar, (const float*)scal,
                omb, beta, w, rc4);
      });
    });
  }
  return (int)cudaGetLastError();
}

// p: (w, rc); center, xbar: (rc,) fp32; omna = 1 − na.  Two launches
// on one stream: the worker pass reads the old center, then the center
// pass updates it in place.
int vrl_fused_sync_easgd(void* p, void* center, const void* xbar, int dtypes,
                         float a, float omna, float na, int64_t w, int64_t rc,
                         void* stream) {
  int64_t rc4 = rc / 4;
  if (rc4 > 0 && w > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    by_type(dtypes & kDtP, [&](auto pt) {
      using PT = VRL_TYPE(pt);
      easgd_worker_kernel<PT><<<grid_for(rc4), kThreads, 0, s>>>(
          (PT*)p, (const float4*)center, a, w, rc4);
    });
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    easgd_center_kernel<<<grid_for(rc4), kThreads, 0, s>>>(
        (float4*)center, (const float4*)xbar, omna, na, rc4);
  }
  return (int)cudaGetLastError();
}

// The hierarchy: p, g, d1 (pods, dper, rc); d2, xbar_pod, pend2 (pods, 1,
// rc), pend2 fp32; glob (rc,); xbar_pod and glob in p's type; scal one fp32
// (k_eff·γ) and wscal (pods, 2) fp32 on the device.  rc is a multiple of
// 4.  More than 65,535 pods is refused (cudaErrorInvalidValue); zero
// workers launch nothing.
int vrl_fused_hier_local_sgd(void* p, const void* g, const void* d1,
                             const void* d2, int dtypes, float lr, float wd,
                             int64_t pods, int64_t dper, int64_t rc,
                             void* stream) {
  dim3 grid;
  if (dper < 1 || rc < 4) return (int)cudaGetLastError();
  if (!hier_grid(pods, rc / 4, &grid)) return (int)cudaErrorInvalidValue;
  by_type(dtypes & kDtP, [&](auto pt) {
    using PT = VRL_TYPE(pt);
    hier_local_sgd_kernel<PT><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (PT*)p, in(g, dtypes, kDtG), in(d1, dtypes, kDtD),
        in(d2, dtypes, kDtD), lr, wd, dper, rc / 4);
  });
  return (int)cudaGetLastError();
}

int vrl_fused_sync_hier1(void* p, void* d1, const void* xbar_pod,
                         const void* scal, int dtypes, int64_t pods,
                         int64_t dper, int64_t rc, void* stream) {
  dim3 grid;
  if (dper < 1 || rc < 4) return (int)cudaGetLastError();
  if (!hier_grid(pods, rc / 4, &grid)) return (int)cudaErrorInvalidValue;
  by_type(dtypes & kDtP, [&](auto pt) {
    by_type(dtypes & kDtD, [&](auto dt) {
      using PT = VRL_TYPE(pt);
      using DT = VRL_TYPE(dt);
      sync_hier1_kernel<PT, DT><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          (PT*)p, (DT*)d1, (const PT*)xbar_pod, (const float*)scal, dper,
          rc / 4);
    });
  });
  return (int)cudaGetLastError();
}

int vrl_fused_sync_hier2(void* p, void* d2, const void* glob,
                         const void* scal, int dtypes, int64_t pods,
                         int64_t dper, int64_t rc, void* stream) {
  dim3 grid;
  if (dper < 1 || rc < 4) return (int)cudaGetLastError();
  if (!hier_grid(pods, rc / 4, &grid)) return (int)cudaErrorInvalidValue;
  by_type(dtypes & kDtP, [&](auto pt) {
    by_type(dtypes & kDtD, [&](auto dt) {
      using PT = VRL_TYPE(pt);
      using DT = VRL_TYPE(dt);
      sync_hier2_kernel<PT, DT><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          (PT*)p, (DT*)d2, (const PT*)glob, (const float*)scal, dper,
          rc / 4);
    });
  });
  return (int)cudaGetLastError();
}

int vrl_fused_fold_hier2(void* p, const void* glob, void* pend2, void* d2,
                         const void* wscal, int capture, int dtypes,
                         int64_t pods, int64_t dper, int64_t rc,
                         void* stream) {
  dim3 grid;
  if (dper < 1 || rc < 4) return (int)cudaGetLastError();
  if (!hier_grid(pods, rc / 4, &grid)) return (int)cudaErrorInvalidValue;
  by_type(dtypes & kDtP, [&](auto pt) {
    by_type(dtypes & kDtD, [&](auto dt) {
      using PT = VRL_TYPE(pt);
      using DT = VRL_TYPE(dt);
      fold_hier2_kernel<PT, DT><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          (PT*)p, (const PT*)glob, (float4*)pend2, (DT*)d2,
          (const float*)wscal, capture, dper, rc / 4);
    });
  });
  return (int)cudaGetLastError();
}

// The hierarchy's momentum and Adam steps: p, g, d1, m (or mu, nu) (pods,
// dper, rc), d2 (pods, 1, rc).
int vrl_fused_hier_local_momentum(void* p, const void* g, const void* d1,
                                  const void* d2, void* m, int dtypes,
                                  float lr, float beta, float wd,
                                  int nesterov, int64_t pods, int64_t dper,
                                  int64_t rc, void* stream) {
  dim3 grid;
  if (dper < 1 || rc < 4) return (int)cudaGetLastError();
  if (!hier_grid(pods, rc / 4, &grid)) return (int)cudaErrorInvalidValue;
  const MomentumArgs a{lr, beta, wd, nesterov != 0};
  by_type(dtypes & kDtP, [&](auto pt) {
    by_type(dtypes & kDtM, [&](auto mt) {
      using PT = VRL_TYPE(pt);
      using MT = VRL_TYPE(mt);
      hier_local_momentum_kernel<PT, MT>
          <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
              (PT*)p, in(g, dtypes, kDtG), in(d1, dtypes, kDtD),
              in(d2, dtypes, kDtD), (MT*)m, a, dper, rc / 4);
    });
  });
  return (int)cudaGetLastError();
}

int vrl_fused_hier_local_adam(void* p, const void* g, const void* d1,
                              const void* d2, void* mu, void* nu, int dtypes,
                              const void* scal, float lr, float b1,
                              float one_minus_b1, float b2,
                              float one_minus_b2, float eps, float wd,
                              float lr_wd, int64_t pods, int64_t dper,
                              int64_t rc, void* stream) {
  dim3 grid;
  if (dper < 1 || rc < 4) return (int)cudaGetLastError();
  if (!hier_grid(pods, rc / 4, &grid)) return (int)cudaErrorInvalidValue;
  const AdamArgs a{lr, b1, one_minus_b1, b2, one_minus_b2, eps, wd, lr_wd};
  by_type(dtypes & kDtP, [&](auto pt) {
    by_type(dtypes & kDtM, [&](auto mt) {
      using PT = VRL_TYPE(pt);
      using MT = VRL_TYPE(mt);
      hier_local_adam_kernel<PT, MT>
          <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
              (PT*)p, in(g, dtypes, kDtG), in(d1, dtypes, kDtD),
              in(d2, dtypes, kDtD), (MT*)mu, (MT*)nu, (const float*)scal, a,
              dper, rc / 4);
    });
  });
  return (int)cudaGetLastError();
}

// SM3-factored Adam, flat and hierarchical: p, g, [d], mu (workers, rows,
// lanes); b (workers / b_div, rows, lanes) or null (flat: B per worker,
// b_div = 1; hier: Δ2 per pod, b_div = D, with d = Δ1); row (workers,
// rows, 1) fp32 updated in place; col (workers, shards, lanes) fp32 read;
// col_out of the same shape receives the new lane stat (zeroed here
// first).  lanes a multiple of 128 up to 1,024; rows a multiple of shards.
int vrl_fused_local_adam_sm3(void* p, const void* g, const void* d,
                             const void* b, void* mu, void* row,
                             const void* col, void* col_out, int dtypes,
                             const void* scal, float lr, float b1,
                             float one_minus_b1, float b2,
                             float one_minus_b2, float eps, float wd,
                             float lr_wd, int64_t workers, int64_t b_div,
                             int64_t rows, int64_t lanes, int64_t shards,
                             void* stream) {
  if (workers < 1 || rows < 1) return (int)cudaGetLastError();
  if (lanes % 128 || lanes < 128 || lanes > 128 * kMaxLaneGroups ||
      shards < 1 || rows % shards || b_div < 1 || workers % b_div)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      col_out, 0, (size_t)(workers * shards * lanes) * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  Sm3Shape sh;
  sh.workers = workers;
  sh.b_div = b_div;
  sh.rows = rows;
  sh.shards = shards;
  sh.span = rows / shards;
  // about one wave of blocks in all, each at least kWarps rows of one span
  int64_t want = (int64_t)grid_for((int64_t)1 << 40) / (workers * shards);
  int64_t most = (sh.span + kWarps - 1) / kWarps;
  sh.cps = want < 1 ? 1 : (want > most ? most : want);
  sh.rpc = (sh.span + sh.cps - 1) / sh.cps;
  sh.cps = (sh.span + sh.rpc - 1) / sh.rpc;
  const int64_t blocks = workers * shards * sh.cps;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const AdamArgs a{lr, b1, one_minus_b1, b2, one_minus_b2, eps, wd, lr_wd};
  const int groups = (int)(lanes / 128);
  dim3 grid((unsigned)blocks);
  int rc = 0;
  by_type(dtypes & kDtP, [&](auto pt) {
    by_type(dtypes & kDtM, [&](auto mt) {
      rc = launch_adam_sm3<VRL_TYPE(pt), VRL_TYPE(mt)>(
          groups, grid, st, p, in(g, dtypes, kDtG), in(d, dtypes, kDtD),
          in(b, dtypes, kDtD), mu, row, col, col_out, scal, a, sh);
    });
  });
  return rc;
}

}  // extern "C"
