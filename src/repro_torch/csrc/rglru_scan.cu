// RG-LRU linear recurrence h_t = a_t * h_{t-1} + gx_t for Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernel `rglru_scan_pallas`
// (src/repro/kernels/rglru_scan.py:48, body `_kernel` :25). Inputs: a (B,S,W)
// in f32 or bf16 (the model's activation type: the gates are cast to it
// before the scan, rglru_scan.py:101), gx (B,S,W) f32, h0 (B,W) f32. Outputs:
// h_seq (B,S,W) f32 (gx's type) and h_last (B,W) f32. The state is f32.
//
// The recurrence is sequential in t and independent across (b, w). The TPU
// kernel steps (1, 512) lane vectors through 128-step time blocks with the
// state in VMEM. Here one thread owns one (b, w) column and walks t, and each
// step is rounded as the plain version rounds it: a product, then a sum (no
// fused multiply-add), so both routes give the plain version's bits.
//
// Bound. At the serving shape (B 4, S 2048, W 4096, a in bf16) the function
// reads a (2 B) and gx (4 B) and writes h_seq (4 B) per element: 336 MB, 0.100
// ms at 3.35 TB/s; its 2 operations per element are negligible. It is bytes-
// bound, and the serial chain of 2,048 dependent steps (~10 us) is not the
// limit: the bytes in flight are. At ~0.7 us of memory latency an SM needs
// ~18 KB of loads in flight to keep its share of the bandwidth busy.
//
// Routes (the wrapper chooses, kernels/rglru_scan.py `ROUTES`):
//   ring:   W a multiple of 8, a and gx 16-byte aligned (TMA's strides and
//           addresses). One block takes one b and 128 adjacent w (128 blocks
//           at the serving shape, one an SM): four consumer warps, one thread
//           a column, and a producer warp whose one thread streams (64 steps
//           x 128 columns) tiles of a and gx by TMA into a ring of 3 stages in
//           shared memory, one mbarrier pair (full, empty) a stage. A stage
//           is 16 KB of bf16 a and 32 KB of f32 gx, so an SM has up to 144 KB
//           of loads in flight, 8x what the bandwidth needs. y leaves through
//           coalesced stores (a warp writes 128 B a step). The ragged end of S
//           and of W reads as zeros from TMA and is not stored. The walk is
//           unrolled by 8: by 16, ptxas spills.
//   column: the first design, for any W: one thread a column, 128-thread
//           blocks, UNROLL steps of a and gx loaded before their dependent
//           multiply-adds; at the serving shape 128 blocks hold ~6 KB in
//           flight an SM, a third of what the bandwidth needs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 8;

constexpr int RING_W = 128;                 // columns of a block
constexpr int RING_T = 64;                  // steps of a tile
constexpr int STAGES = 3;
constexpr int RING_THREADS = RING_W + 32;   // four consumer warps + a producer

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
struct Ring {
  static constexpr int A_BYTES = RING_T * RING_W * (int)sizeof(T);
  static constexpr int G_BYTES = RING_T * RING_W * 4;
  static constexpr int STAGE = A_BYTES + G_BYTES;
  static constexpr int BYTES = STAGES * STAGE;
};

// Grid (ceil(W / 128), B). ma, mg: (W, S, B) maps of a and gx, boxes of
// 128 columns x 64 steps, unswizzled (a thread reads its own column, so the
// rows of a tile are read without bank conflicts).
template <typename T>
__global__ void __launch_bounds__(RING_THREADS)
rglru_ring(const __grid_constant__ CUtensorMap ma,
           const __grid_constant__ CUtensorMap mg, const float* __restrict__ h0,
           float* __restrict__ y, float* __restrict__ h_last, int S, int W) {
  using L = Ring<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const int b = blockIdx.y, w0 = blockIdx.x * RING_W;
  const int tiles = (S + RING_T - 1) / RING_T;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, RING_W);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= RING_W) {              // the producer warp
    if (threadIdx.x == RING_W) {
      for (int k = 0; k < tiles; ++k) {
        const int s = k % STAGES;
        if (k >= STAGES) hopper::mbar_wait(empty + s, ((k / STAGES) - 1) & 1);
        hopper::mbar_expect_tx(full + s, L::STAGE);
        unsigned char* st = smem + s * L::STAGE;
        hopper::tma_load_3d(st, &ma, full + s, w0, k * RING_T, b);
        hopper::tma_load_3d(st + L::A_BYTES, &mg, full + s, w0, k * RING_T, b);
      }
    }
    return;
  }

  const int w = w0 + threadIdx.x;
  const bool live = w < W;
  float h = live ? h0[(size_t)b * W + w] : 0.f;
  float* yc = y + (size_t)b * S * W + w;
  for (int k = 0; k < tiles; ++k) {
    const int s = k % STAGES;
    hopper::mbar_wait(full + s, (k / STAGES) & 1);
    const T* at = reinterpret_cast<const T*>(smem + s * L::STAGE) + threadIdx.x;
    const float* gt =
        reinterpret_cast<const float*>(smem + s * L::STAGE + L::A_BYTES) + threadIdx.x;
    float* yt = yc + (size_t)k * RING_T * W;
    if (k * RING_T + RING_T <= S) {
#pragma unroll 8
      for (int j = 0; j < RING_T; ++j) {
        h = __fadd_rn(__fmul_rn(to_f32(at[j * RING_W]), h), gt[j * RING_W]);
        if (live) yt[(size_t)j * W] = h;
      }
    } else {
      for (int j = 0; j < S - k * RING_T; ++j) {
        h = __fadd_rn(__fmul_rn(to_f32(at[j * RING_W]), h), gt[j * RING_W]);
        if (live) yt[(size_t)j * W] = h;
      }
    }
    hopper::mbar_arrive(empty + s);
  }
  if (live) h_last[(size_t)b * W + w] = h;
}

template <typename T>
int launch(const void* a, const float* gx, const float* h0, float* y,
           float* h_last, int B, int S, int W, cudaStream_t stream) {
  const int blocks = (B * W + THREADS - 1) / THREADS;
  rglru_fwd<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(a), gx, h0, y, h_last, B, S, W);
  return (int)cudaGetLastError();
}

// A (B, S, W) tensor of `type` (elements of `bytes`) as a (W, S, B) map with
// boxes of 128 columns x 64 steps x 1; out-of-range elements read as zeros.
int make_map(CUtensorMap* map, CUtensorMapDataType type, int bytes,
             const void* ptr, int B, int S, int W) {
  hopper::EncodeTiledFn fn = hopper::encode_tiled();
  if (fn == nullptr) return -2;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * bytes, (cuuint64_t)S * W * bytes};
  const cuuint32_t box[3] = {RING_W, RING_T, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

template <typename T>
int launch_ring(const void* a, CUtensorMapDataType type, const float* gx,
                const float* h0, float* y, float* h_last, int B, int S, int W,
                cudaStream_t stream) {
  CUtensorMap ma, mg;
  int err = make_map(&ma, type, sizeof(T), a, B, S, W);
  if (!err) err = make_map(&mg, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, gx, B, S, W);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      rglru_ring<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<T>::BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + RING_W - 1) / RING_W, B);
  rglru_ring<T><<<grid, RING_THREADS, Ring<T>::BYTES, stream>>>(ma, mg, h0, y,
                                                                 h_last, S, W);
  return (int)cudaGetLastError();
}

}  // namespace

// The column route. dtype of a: 0 = float32, 1 = bfloat16. Returns 0, a
// cudaError_t code, or -1 for an unsupported dtype. Launches on `stream`;
// does not synchronise.
extern "C" int rglru_scan_fwd(const void* a, const float* gx, const float* h0,
                              float* y, float* h_last, int dtype, int B, int S,
                              int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, gx, h0, y, h_last, B, S, W, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, gx, h0, y, h_last, B, S, W, s);
  return -1;
}

// The ring route: W a multiple of 8, a and gx contiguous and 16-byte
// aligned. Returns 0, a cudaError_t code, -1 for an unsupported dtype, -2 if
// cuTensorMapEncodeTiled cannot be found, -3 if it refuses a tensor map.
extern "C" int rglru_scan_fwd_ring(const void* a, const float* gx,
                                   const float* h0, float* y, float* h_last,
                                   int dtype, int B, int S, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_ring<float>(a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, gx, h0, y,
                              h_last, B, S, W, s);
  if (dtype == 1)
    return launch_ring<__nv_bfloat16>(a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, gx, h0,
                                      y, h_last, B, S, W, s);
  return -1;
}
