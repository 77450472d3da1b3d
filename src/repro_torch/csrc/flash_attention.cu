// Forward GQA flash attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py:78, body `_kernel` :28): causal and
// sliding-window masks, a ragged kv tail, an online softmax kept in f32,
// q scaled in f32 before the dot, masked scores `s + NEG_INF` with the
// reference's finite NEG_INF, and a finaliser that divides by max(l, 1e-37).
//
// Layout: q (B, Sq, Hq, Dh), k and v (B, Skv, Hkv, Dh), o (B, Sq, Hq, Dh),
// all contiguous, f32 or bf16 (o in q's type). GQA maps q head h to kv head
// h / (Hq / Hkv).
//
// Design ("simple and right"; CUDA cores, f32 arithmetic throughout):
//   - one block of WARPS warps per (b, q head, tile of BQ = WARPS * ROWS
//     q rows); each warp owns ROWS q rows;
//   - K/V tiles of BK = 32 * KPL keys are staged through shared memory as
//     f32 (K rows padded by 4 floats so the lanes' float4 reads of
//     different rows hit different banks);
//   - QK^T: each lane scores KPL keys of the tile against the warp's rows;
//     the row max and sum are warp shuffles; the probabilities go to a small
//     per-warp shared buffer, and for P.V each lane owns the output columns
//     lane, lane + 32, ... ;
//   - tiles that the causal or window limits exclude for every row of the
//     block are skipped; keys at or past Skv read as zero and are masked.
// Bound: at the serving shapes (Dh = 128, S = 2048) the work is
// 4 * B * Hq * Dh * S^2 / 2 flops against ~(q + k + v + o) bytes, so the
// tensor cores' rate bounds it; this kernel runs on the f32 CUDA cores and
// reads shared memory about once per two multiply-adds, so it is bounded by
// shared-memory bandwidth well above that bound. Tensor-core tiles (mma.sync
// or wgmma) are the later redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int ROWS = 4;              // q rows per warp
constexpr int BQ = WARPS * ROWS;     // q rows per block
constexpr int KPL = 2;               // keys per lane in a tile
constexpr int BK = 32 * KPL;         // keys per tile
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -2.3819765e38f;  // -0.7 * FLT_MAX, as the reference

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <int DH>
struct Tile {
  static constexpr int KS = DH + 4;                 // padded K row, floats
  static constexpr int Q = 0;                       // [BQ][DH] scaled q
  static constexpr int K = Q + BQ * DH;             // [BK][KS]
  static constexpr int V = K + BK * KS;             // [BK][DH]
  static constexpr int P = V + BK * DH;             // [WARPS][ROWS][BK]
  static constexpr int floats = P + WARPS * ROWS * BK;
  static constexpr int bytes = floats * (int)sizeof(float);
};

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv, int Hq,
          int Hkv, int causal, int window, float scale) {
  using L = Tile<DH>;
  constexpr int NC = (DH + 31) / 32;  // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + L::Q;
  float* ks = smem + L::K;
  float* vs = smem + L::V;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t qstride = (size_t)Hq * DH;   // between q positions
  const size_t kstride = (size_t)Hkv * DH;  // between kv positions
  const T* qb = q + (size_t)b * Sq * qstride + (size_t)h * DH;
  const T* kb = k + (size_t)b * Skv * kstride + (size_t)hk * DH;
  const T* vb = v + (size_t)b * Skv * kstride + (size_t)hk * DH;
  float* ps = smem + L::P + warp * ROWS * BK;

  // q tile, scaled in f32 before the dot (rows past Sq repeat the last row)
  for (int e = tid; e < BQ * DH; e += THREADS) {
    const int r = e / DH, d = e % DH;
    const int i = min(q0 + r, Sq - 1);
    qs[e] = to_f32(qb[(size_t)i * qstride + d]) * scale;
  }

  float m[ROWS], l[ROWS], acc[ROWS][NC];
  int qpos[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
    qpos[r] = q0 + warp * ROWS + r;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  // tiles any row of this block may need
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kt_end = causal ? min(Skv, q_last + 1) : Skv;
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = ((q0 - window + 1) / BK) * BK;

  const float* qw = qs + warp * ROWS * DH;
  for (int k0 = kt_begin; k0 < kt_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed; the q tile is written
    for (int e = tid; e < BK * DH; e += THREADS) {
      const int j = e / DH, d = e % DH;
      const int kp = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kp < Skv) {
        kx = to_f32(kb[(size_t)kp * kstride + d]);
        vx = to_f32(vb[(size_t)kp * kstride + d]);
      }
      ks[j * L::KS + d] = kx;
      vs[j * DH + d] = vx;
    }
    __syncthreads();

    // scores of this lane's keys against the warp's rows
    float s[ROWS][KPL];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) s[r][kk] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 kf[KPL];
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk)
        kf[kk] = *reinterpret_cast<const float4*>(ks + (kk * 32 + lane) * L::KS + d);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qf = *reinterpret_cast<const float4*>(qw + r * DH + d);
#pragma unroll
        for (int kk = 0; kk < KPL; ++kk) {
          float t = s[r][kk];
          t = fmaf(qf.x, kf[kk].x, t);
          t = fmaf(qf.y, kf[kk].y, t);
          t = fmaf(qf.z, kf[kk].z, t);
          t = fmaf(qf.w, kf[kk].w, t);
          s[r][kk] = t;
        }
      }
    }

    // mask, online softmax; probabilities to the warp's buffer
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float mt = NEG_INF;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        const int kp = k0 + kk * 32 + lane;
        bool ok = kp < Skv;
        if (causal) ok = ok && kp <= qpos[r];
        if (window > 0) ok = ok && kp > qpos[r] - window;
        s[r][kk] += ok ? 0.f : NEG_INF;
        mt = fmaxf(mt, s[r][kk]);
      }
      const float m_new = fmaxf(m[r], warp_max(mt));
      const float corr = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        const float p = expf(s[r][kk] - m_new);
        ps[r * BK + kk * 32 + lane] = p;
        psum += p;
      }
      l[r] = l[r] * corr + warp_sum(psum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
    }
    __syncwarp();

    // P.V: this lane's columns, four keys at a time
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float vv[4][NC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = lane + 32 * c;
          vv[jj][c] = (col < DH) ? vs[(j + jj) * DH + col] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(ps + r * BK + j);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float t = acc[r][c];
          t = fmaf(p4.x, vv[0][c], t);
          t = fmaf(p4.y, vv[1][c], t);
          t = fmaf(p4.z, vv[2][c], t);
          t = fmaf(p4.w, vv[3][c], t);
          acc[r][c] = t;
        }
      }
    }
    __syncwarp();  // ps is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (qpos[r] >= Sq) continue;
    const float den = fmaxf(l[r], 1e-37f);
    T* orow = o + ((size_t)b * Sq + qpos[r]) * qstride + (size_t)h * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < DH) store(orow + col, acc[r][c] / den);
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Skv, int Hq, int Hkv, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr int bytes = Tile<DH>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd<T, DH><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, Hq, Hkv, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int Dh, const void* q, const void* k, const void* v, void* o,
             int B, int Sq, int Skv, int Hq, int Hkv, int causal, int window,
             float scale, cudaStream_t s) {
  switch (Dh) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, scale, s);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns 0, a cudaError_t code, or -1
// for an unsupported Dh or dtype. Launches on `stream`; does not synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int B, int Sq, int Skv,
                                   int Hq, int Hkv, int Dh, int causal,
                                   int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(Dh, q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(Dh, q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, scale, s);
  return -1;
}
