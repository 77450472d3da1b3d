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
// Both routes optionally write each row's log-sum-exp, lse (B, Hq, Sq) f32
// (a null pointer writes nothing): m + log(max(l, 1e-37)) with m the row's
// running max of the scaled scores and l its sum of exp(s - m), the natural
// log of the sum of exp(scale q.k) over the row's kept keys, as the
// reference's `_flash_fwd_inner` (src/repro/kernels/ref.py:141) returns it
// for its recomputing backward. Both routes keep m in natural units (scores
// times `scale`, exponentials by expf / __expf), so no base-2 conversion is
// needed before the write.
//
// Two routes, chosen by the wrapper from a table of (dtype, Dh):
//
// wgmma (bf16, Dh 64 / 128 / 256): `flash_fwd_wgmma`, one block per (b, q
// head, 128 q rows): two consumer warpgroups of 64 q rows each and a
// producer warpgroup, of which one warp works. The producer loads the block's Q once and the K/V tiles of
// 64 keys through TMA (128-byte swizzle, 64-column boxes, rows past Sq or
// Skv filled with zeros) into a two-stage ring, signalled by mbarriers
// (K and V full per stage, "empty" when both warpgroups are done with it).
// Each consumer warpgroup runs S = Q K^T with wgmma (m64n64k16, A and B in
// shared memory, f32 accumulators), scales S in f32 after the bf16 dot (the
// reference scales q in f32 first: the same up to f32 rounding), adds the
// finite NEG_INF to masked scores, keeps the online max and sum in f32,
// rounds P to bf16 in registers, and runs O += P V with wgmma (A = P from
// registers, V MN-major in shared memory), one 64-column slice of Dh per
// instruction. The one rounding the reference does not make is P in bf16
// for the P.V product, as PyTorch's SDPA does: |dP| <= 2^-9 P, so |dO| <=
// 2^-9 max|v| against the 2e-2 bar. The finaliser divides by max(l, 1e-37)
// and rounds once to bf16. Tiles outside the causal and window limits of
// the block are not loaded; a warpgroup skips the products of a tile that
// is masked for all its rows. Blocks are issued from the last q tile down,
// so the longest causal rows start first. The producer warpgroup gives up
// its registers (setmaxnreg) so that the consumers hold O (up to 128 f32 a
// thread at Dh 256), S and P without spilling.
// Bound: 4 B Hq Dh (causal pairs) flops on the bf16 tensor cores (989
// TFLOP/s); at the serving shapes the bytes (q, k, v, o once) are ~40x
// smaller, so the tensor cores' rate bounds it.
//
// CUDA cores (float32 at every Dh, bf16 at Dh 16 / 32): `flash_fwd`,
// f32 arithmetic throughout:
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
// This route reads shared memory about once per two multiply-adds, so it is
// bounded by shared-memory bandwidth well above the tensor cores' bound; it
// keeps float32 exact (TF32 would break the 2e-5 bar).
#include "hopper.cuh"

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
          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
          int Sq, int Skv, int Hq, int Hkv, int causal, int window,
          float scale) {
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
    if (lse != nullptr && lane == 0)
      lse[((size_t)b * Hq + h) * Sq + qpos[r]] = m[r] + logf(den);
    T* orow = o + ((size_t)b * Sq + qpos[r]) * qstride + (size_t)h * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < DH) store(orow + col, acc[r][c] / den);
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Skv, int Hq, int Hkv, int causal, int window,
           float scale, cudaStream_t stream) {
  constexpr int bytes = Tile<DH>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd<T, DH><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Skv, Hq, Hkv,
      causal, window, scale);
  return (int)cudaGetLastError();
}

// float32 at Dh 16..256; bf16 only at Dh 16 and 32 (the wgmma route serves
// bf16 at 64, 128 and 256).
template <typename T>
int dispatch(int Dh, const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int Sq, int Skv, int Hq, int Hkv, int causal,
             int window, float scale, cudaStream_t s) {
  constexpr bool f32 = sizeof(T) == 4;
  switch (Dh) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, causal, window, scale, s);
    default: break;
  }
  if constexpr (f32) {
    switch (Dh) {
      case 64: return launch<T, 64>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, causal, window, scale, s);
      case 128: return launch<T, 128>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, causal, window, scale, s);
      case 256: return launch<T, 256>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, causal, window, scale, s);
      default: break;
    }
  }
  return -1;
}

}  // namespace

// The CUDA-core route. dtype: 0 = float32 (Dh 16..256), 1 = bfloat16 (Dh 16
// or 32). `lse`: (B, Hq, Sq) float32, or null for none. Returns 0, a
// cudaError_t code, or -1 for an unsupported Dh or dtype. Launches on
// `stream`; does not synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int dtype, int B,
                                   int Sq, int Skv, int Hq, int Hkv, int Dh,
                                   int causal, int window, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch<float>(Dh, q, k, v, o, l, B, Sq, Skv, Hq, Hkv, causal, window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(Dh, q, k, v, o, l, B, Sq, Skv, Hq, Hkv, causal, window, scale, s);
  return -1;
}

// ---------------------------------------------------------------------------
// wgmma route (bf16, Dh 64 / 128 / 256)
// ---------------------------------------------------------------------------

namespace {

constexpr int WG_ROWS = 64;                  // q rows per consumer warpgroup
constexpr int WG_BM = 2 * WG_ROWS;           // q rows per block
constexpr int WG_BN = 64;                    // keys per K/V tile
constexpr int WG_STAGES = 2;
constexpr int WG_THREADS = 3 * 128;          // two consumer warpgroups + the producer's
constexpr int CHUNK_BYTES = 64 * 64 * 2;     // one TMA box: 64 rows x 64 bf16

template <int DH>
struct WgLayout {                            // dynamic shared memory, bytes
  static constexpr int NCH = DH / 64;        // 64-column slices of Dh
  static constexpr int Q = 0;                          // [2 wg][NCH] boxes
  static constexpr int K = Q + 2 * NCH * CHUNK_BYTES;  // [STAGES][NCH]
  static constexpr int V = K + WG_STAGES * NCH * CHUNK_BYTES;
  static constexpr int BAR = V + WG_STAGES * NCH * CHUNK_BYTES;
  static constexpr int NBAR = 2 + 3 * WG_STAGES;       // q[2], kfull, vfull, empty
  static constexpr int bytes = BAR + NBAR * 8 + 1024;  // + slack for 1 KB alignment
};

template <int DH>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wgmma(__grid_constant__ const CUtensorMap mq,
                __grid_constant__ const CUtensorMap mk,
                __grid_constant__ const CUtensorMap mv,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int Sq,
                int Skv, int Hq, int Hkv, int causal, int window, float scale) {
  using L = WgLayout<DH>;
  constexpr int NCH = L::NCH;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* qfull = bars;
  uint64_t* kfull = bars + 2;
  uint64_t* vfull = kfull + WG_STAGES;
  uint64_t* empty = vfull + WG_STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qt = gridDim.x - 1 - blockIdx.x;          // longest rows first
  const int q0 = qt * WG_BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);

  // the keys any row of this block may need, in tiles of WG_BN
  const int q_last = min(q0 + WG_BM, Sq) - 1;
  const int kt_end = causal ? min(Skv, q_last + 1) : Skv;
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = ((q0 - window + 1) / WG_BN) * WG_BN;
  const int n_tiles = kt_end > kt_begin ? (kt_end - kt_begin + WG_BN - 1) / WG_BN : 0;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) hopper::mbar_init(qfull + i, 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      hopper::mbar_init(kfull + s, 1);
      hopper::mbar_init(vfull + s, 1);
      hopper::mbar_init(empty + s, 256);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // producer warpgroup: one thread of warp 8 keeps the TMA loads in
    // flight; the warpgroup hands its registers to the consumers (168 a
    // thread at launch; 128 x (168 - 24) = 256 x (240 - 168))
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      for (int g = 0; g < 2; ++g) {
        hopper::mbar_expect_tx(qfull + g, NCH * CHUNK_BYTES);
        for (int c = 0; c < NCH; ++c)
          hopper::tma_load_4d(smem + L::Q + (g * NCH + c) * CHUNK_BYTES, &mq,
                              qfull + g, c * 64, h, q0 + g * WG_ROWS, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % WG_STAGES;
        if (i >= WG_STAGES) hopper::mbar_wait(empty + s, ((i / WG_STAGES) - 1) & 1);
        const int k0 = kt_begin + i * WG_BN;
        hopper::mbar_expect_tx(kfull + s, NCH * CHUNK_BYTES);
        for (int c = 0; c < NCH; ++c)
          hopper::tma_load_4d(smem + L::K + (s * NCH + c) * CHUNK_BYTES, &mk,
                              kfull + s, c * 64, hk, k0, b);
        hopper::mbar_expect_tx(vfull + s, NCH * CHUNK_BYTES);
        for (int c = 0; c < NCH; ++c)
          hopper::tma_load_4d(smem + L::V + (s * NCH + c) * CHUNK_BYTES, &mv,
                              vfull + s, c * 64, hk, k0, b);
      }
    }
  } else {
    // consumers: warpgroup g owns q rows q0 + 64 g ..; this thread rows r0, r0 + 8
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int g = warp >> 2;
    const int gid = lane >> 2, t4 = lane & 3;
    const int row_first = q0 + g * WG_ROWS;
    const int r0 = row_first + (warp & 3) * 16 + gid;
    const int rows[2] = {r0, r0 + 8};
    const uint8_t* qs = smem + L::Q + g * NCH * CHUNK_BYTES;

    float acc[NCH][32];
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // l: this thread's part

    hopper::mbar_wait(qfull + g, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % WG_STAGES;
      const uint32_t par = (i / WG_STAGES) & 1;
      const int k0 = kt_begin + i * WG_BN;
      // masked for every row of this warpgroup?
      bool skip = row_first >= Sq;
      if (causal) skip = skip || k0 > row_first + WG_ROWS - 1;
      if (window > 0) skip = skip || k0 + WG_BN - 1 <= row_first - window;
      hopper::mbar_wait(kfull + s, par);
      if (!skip) {
        const uint8_t* ks = smem + L::K + s * NCH * CHUNK_BYTES;
        float sc[32];
        hopper::fence_regs(sc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const int off = (kk >> 2) * CHUNK_BYTES + (kk & 3) * 32;
          hopper::wgmma_ss_m64n64k16(sc, hopper::desc_sw128(qs + off),
                                     hopper::desc_sw128(ks + off), kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait0();
        hopper::fence_regs(sc);

        // mask, online softmax (rows r0 and r0 + 8; columns 8j + 2 t4 + e)
        float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = rows[e >> 1];
            const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
            bool ok = kp < Skv;
            if (causal) ok = ok && kp <= r;
            if (window > 0) ok = ok && kp > r - window;
            const float x = sc[4 * j + e] * scale + (ok ? 0.f : NEG_INF);
            sc[4 * j + e] = x;
            mt[e >> 1] = fmaxf(mt[e >> 1], x);
          }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mt[r] = fmaxf(mt[r], __shfl_xor_sync(FULL, mt[r], 1));
          mt[r] = fmaxf(mt[r], __shfl_xor_sync(FULL, mt[r], 2));
          const float m_new = fmaxf(m[r], mt[r]);
          corr[r] = __expf(m[r] - m_new);
          m[r] = m_new;
          l[r] *= corr[r];
        }
        uint32_t pa[4][4];      // P in bf16 as wgmma's A operand, 16 keys each
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[e] = __expf(sc[4 * j + e] - m[e >> 1]);
            l[e >> 1] += p[e];
          }
          pa[j >> 1][(j & 1) * 2 + 0] = hopper::pack_bf16(p[0], p[1]);
          pa[j >> 1][(j & 1) * 2 + 1] = hopper::pack_bf16(p[2], p[3]);
        }
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[c][4 * j + 0] *= corr[0];
            acc[c][4 * j + 1] *= corr[0];
            acc[c][4 * j + 2] *= corr[1];
            acc[c][4 * j + 3] *= corr[1];
          }

        hopper::mbar_wait(vfull + s, par);
        const uint8_t* vs = smem + L::V + s * NCH * CHUNK_BYTES;
#pragma unroll
        for (int c = 0; c < NCH; ++c) hopper::fence_regs(acc[c]);
        hopper::wgmma_fence();
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hopper::wgmma_rs_m64n64k16_tb(
                acc[c], pa[kk],
                hopper::desc_sw128(vs + c * CHUNK_BYTES + kk * 16 * 128));
        hopper::wgmma_commit();
        hopper::wgmma_wait0();
#pragma unroll
        for (int c = 0; c < NCH; ++c) hopper::fence_regs(acc[c]);
      } else {
        hopper::mbar_wait(vfull + s, par);
      }
      hopper::mbar_arrive(empty + s);
    }

    // finalise: this thread's part of l summed over the quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(FULL, l[r], 1);
      l[r] += __shfl_xor_sync(FULL, l[r], 2);
    }
    const size_t qstride = (size_t)Hq * DH;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= Sq) continue;
      if (lse != nullptr && t4 == 0)
        lse[((size_t)b * Hq + h) * Sq + rows[r]] = m[r] + logf(fmaxf(l[r], 1e-37f));
      const float inv_den = 1.f / fmaxf(l[r], 1e-37f);
      __nv_bfloat16* orow = o + ((size_t)b * Sq + rows[r]) * qstride + (size_t)h * DH;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c * 64 + 8 * j + 2 * t4;
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
              acc[c][4 * j + 2 * r] * inv_den, acc[c][4 * j + 2 * r + 1] * inv_den);
        }
    }
  }
}

// A (B, S, H, Dh) bf16 tensor cut into boxes of 64 rows x 64 columns of one
// head, 128-byte swizzled; rows past S read as zeros.
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int Dh) {
  hopper::EncodeTiledFn fn = hopper::encode_tiled();
  if (fn == nullptr) return -2;
  const cuuint64_t dims[4] = {(cuuint64_t)Dh, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)Dh * 2, (cuuint64_t)H * Dh * 2,
                                 (cuuint64_t)S * H * Dh * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                  dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                 int causal, int window, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, B, Sq, Hq, DH);
  if (!err) err = make_map(&mk, k, B, Skv, Hkv, DH);
  if (!err) err = make_map(&mv, v, B, Skv, Hkv, DH);
  if (err) return err;
  constexpr int bytes = WgLayout<DH>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + WG_BM - 1) / WG_BM, Hq, B);
  flash_fwd_wgmma<DH><<<grid, WG_THREADS, bytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, Sq, Skv, Hq, Hkv,
      causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q, k, v, o, contiguous, 16-byte aligned; Dh 64, 128 or 256. `lse`:
// (B, Hq, Sq) float32, or null for none. Returns 0, a cudaError_t code, -1
// for an unsupported Dh, -2 if cuTensorMapEncodeTiled cannot be found, -3
// if it refuses a tensor map. Launches on `stream`; does not synchronise.
extern "C" int flash_attention_fwd_wgmma(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         int B, int Sq, int Skv, int Hq,
                                         int Hkv, int Dh, int causal,
                                         int window, float scale,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (Dh) {
    case 64: return launch_wgmma<64>(q, k, v, o, l, B, Sq, Skv, Hq, Hkv, causal, window, scale, s);
    case 128: return launch_wgmma<128>(q, k, v, o, l, B, Sq, Skv, Hq, Hkv, causal, window, scale, s);
    case 256: return launch_wgmma<256>(q, k, v, o, l, B, Sq, Skv, Hq, Hkv, causal, window, scale, s);
    default: return -1;
  }
}
