// RG-LRU linear recurrence h_t = a_t * h_{t-1} + gx_t for Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernel `rglru_scan_pallas`
// (src/repro/kernels/rglru_scan.py:48, body `_kernel` :25). Inputs: a (B,S,W)
// in f32 or bf16 (the model's activation type: the gates are cast to it
// before the scan, rglru_scan.py:101), gx (B,S,W) f32, h0 (B,W) f32. Outputs:
// h_seq (B,S,W) f32 (gx's type) and h_last (B,W) f32. The state is f32.
//
// Design. The recurrence is sequential in t and independent across (b, w).
// The TPU kernel steps (1, 512) lane vectors through 128-step time blocks
// with the state in VMEM. Here one thread owns one (b, w) column and walks
// t; neighbouring threads hold neighbouring w, so every load and store of a
// step is coalesced. Loads do not depend on h, so UNROLL steps of a and gx
// are issued together before the dependent multiply-adds. Each step is
// rounded as the reference rounds it: a product, then a sum (no fused
// multiply-add).
//
// Bound. At the serving shape (B 4, S 2048, W 4096, a in bf16) the function
// reads a (2 B) and gx (4 B) and writes h_seq (4 B) per element: 336 MB, 0.100
// ms at 3.35 TB/s; its 2 operations per element are negligible. It is bytes-
// bound. B * W = 16,384 columns give 128 blocks of 128 threads, about one per
// SM, so the loads in flight per SM, not the bandwidth, limit it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_fwd(const T* __restrict__ a, const float* __restrict__ gx,
          const float* __restrict__ h0, float* __restrict__ y,
          float* __restrict__ h_last, int B, int S, int W) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= B * W) return;
  const int b = col / W, w = col % W;
  const size_t base = (size_t)b * S * W + w;
  float h = h0[col];
  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float av[UNROLL], gv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const size_t i = base + (size_t)(t + u) * W;
      av[u] = to_f32(a[i]);
      gv[u] = gx[i];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), gv[u]);
      y[base + (size_t)(t + u) * W] = h;
    }
  }
  for (; t < S; ++t) {
    const size_t i = base + (size_t)t * W;
    h = __fadd_rn(__fmul_rn(to_f32(a[i]), h), gx[i]);
    y[i] = h;
  }
  h_last[col] = h;
}

template <typename T>
int launch(const void* a, const float* gx, const float* h0, float* y,
           float* h_last, int B, int S, int W, cudaStream_t stream) {
  const int blocks = (B * W + THREADS - 1) / THREADS;
  rglru_fwd<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(a), gx, h0, y, h_last, B, S, W);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of a: 0 = float32, 1 = bfloat16. Returns 0, a cudaError_t code, or -1
// for an unsupported dtype. Launches on `stream`; does not synchronise.
extern "C" int rglru_scan_fwd(const void* a, const float* gx, const float* h0,
                              float* y, float* h_last, int dtype, int B, int S,
                              int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, gx, h0, y, h_last, B, S, W, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, gx, h0, y, h_last, B, S, W, s);
  return -1;
}
