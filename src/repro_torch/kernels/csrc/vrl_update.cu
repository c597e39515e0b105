// Fused VRL-SGD engine updates for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/vrl_update.py:
//   vrl_fused_local_sgd  <- fused_local_sgd  (vrl_update.py:152)
//   vrl_fused_sync_vrl   <- fused_sync_vrl   (vrl_update.py:351)
//
// Bound: both are single elementwise passes over model-sized fp32 buffers
// (a few flops per 16+ bytes), so device-memory bandwidth is the only
// limit.  Design: one streaming pass, 16-byte (float4) loads and stores,
// a grid-stride loop over 64-bit indices (W*R*C reaches 2^31 at full
// width), results written in place over p (and Δ) as the Pallas kernels'
// input_output_aliases do.  The sync reads each x̂ element once and
// applies it to all W workers from a register, so x̂ is never expanded W
// times.  Nothing is allocated here; the caller passes PyTorch's stream.
//
// Numerics: the arithmetic is the plain PyTorch version's op for op
// (kernels/torch_update.py), and the library is built with -fmad=false so
// that no multiply-add is contracted into an FMA, and without fast math so
// that the sync divides by k_eff*γ with IEEE division — which keeps the
// kernels bitwise equal to the plain versions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

__device__ __forceinline__ float local_one(float p, float g, float d,
                                           float b, bool has_d, bool has_b,
                                           float lr, float wd) {
  float v = g;
  if (has_d) v = v - d;
  if (has_b) v = v - b;
  if (wd != 0.0f) v = v + wd * p;
  return p - lr * v;
}

// p <- p − lr·((g − [Δ] − [B]) + wd·p) over n4 float4 groups.
__global__ void local_sgd_kernel(float4* __restrict__ p,
                                 const float4* __restrict__ g,
                                 const float4* __restrict__ d,
                                 const float4* __restrict__ b, float lr,
                                 float wd, int64_t n4) {
  const bool has_d = d != nullptr, has_b = b != nullptr;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 pv = p[i];
    float4 gv = g[i];
    float4 dv = has_d ? d[i] : zero;
    float4 bv = has_b ? b[i] : zero;
    pv.x = local_one(pv.x, gv.x, dv.x, bv.x, has_d, has_b, lr, wd);
    pv.y = local_one(pv.y, gv.y, dv.y, bv.y, has_d, has_b, lr, wd);
    pv.z = local_one(pv.z, gv.z, dv.z, bv.z, has_d, has_b, lr, wd);
    pv.w = local_one(pv.w, gv.w, dv.w, bv.w, has_d, has_b, lr, wd);
    p[i] = pv;
  }
}

// Δ_w <- Δ_w + (x̂ − p_w)/kg;  p_w <- x̂  for every worker w, where kg =
// scal[0] = k_eff·γ is read on the device (no host round trip).
// rc4 = R*C/4 float4 groups per worker.
__global__ void sync_vrl_kernel(float4* __restrict__ p, float4* __restrict__ d,
                                const float4* __restrict__ xbar,
                                const float* __restrict__ scal, int64_t w,
                                int64_t rc4) {
  const float kg = scal[0];
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < rc4;
       i += stride) {
    const float4 xb = xbar[i];
    for (int64_t k = 0; k < w; ++k) {
      const int64_t j = k * rc4 + i;
      float4 pv = p[j];
      float4 dv = d[j];
      dv.x = dv.x + (xb.x - pv.x) / kg;
      dv.y = dv.y + (xb.y - pv.y) / kg;
      dv.z = dv.z + (xb.z - pv.z) / kg;
      dv.w = dv.w + (xb.w - pv.w) / kg;
      d[j] = dv;
      p[j] = xb;
    }
  }
}

}  // namespace

extern "C" {

// n: element count of p (a multiple of 4); d and b may be null.
// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
int vrl_fused_local_sgd(void* p, const void* g, const void* d, const void* b,
                        float lr, float wd, int64_t n, void* stream) {
  int64_t n4 = n / 4;
  if (n4 > 0) {
    local_sgd_kernel<<<grid_for(n4), kThreads, 0, (cudaStream_t)stream>>>(
        (float4*)p, (const float4*)g, (const float4*)d, (const float4*)b, lr,
        wd, n4);
  }
  return (int)cudaGetLastError();
}

// p, d: (w, rc) fp32; xbar: (rc,) fp32; scal: one fp32 (k_eff·γ) on the
// device.  rc is a multiple of 4.
int vrl_fused_sync_vrl(void* p, void* d, const void* xbar, const void* scal,
                       int64_t w, int64_t rc, void* stream) {
  int64_t rc4 = rc / 4;
  if (rc4 > 0 && w > 0) {
    sync_vrl_kernel<<<grid_for(rc4), kThreads, 0, (cudaStream_t)stream>>>(
        (float4*)p, (float4*)d, (const float4*)xbar, (const float*)scal, w,
        rc4);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
