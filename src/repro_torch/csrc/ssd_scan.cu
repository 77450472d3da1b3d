// Mamba-2 SSD chunked scan (G = 1 group, zero initial state) for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `ssd_pallas` (src/repro/kernels/ssd_scan.py:67,
// body `_kernel` :24). Inputs: x (B,S,H,P) and b, c (B,S,N) in f32 or bf16,
// dt (B,S,H) f32, a_log and d (H,) f32 (the wrapper casts them, as the kernel
// body does). Outputs: y (B,S,H,P) in x's type and h_final (B,H,P,N) f32.
// Per chunk of Q steps, with a = -exp(a_log) and cum the inclusive cumsum of
// dt * a within the chunk:
//   y[q]    = sum_{k<=q} (C_q.B_k) exp(cum_q - cum_k) dt_k x_k      (y_diag)
//           + exp(cum_q) C_q . h_in                                 (y_off)
//           + d x_q
//   h_out   = h_in exp(cum_end) + sum_k exp(cum_end - cum_k) dt_k x_k B_k^T
//
// Design. One TPU grid step holds a whole 256-row chunk, its Q x Q decay
// matrix and the (heads, P, N) state, and walks the chunks of one (b, head
// block) in order. That is far more than a block's 227 KB of shared memory,
// and B * H = 320 sequential walks would leave the card idle. So the scan is
// three launches on the caller's stream:
//   1. ssd_states, one block per (b, chunk, head, 64 state columns): the
//      chunk's own state S_c = sum_k w_k x_k B_k^T, w_k = exp(cum_end -
//      cum_k) dt_k, from 64-step tiles of x and B in shared memory; block 0
//      also writes cum_end;
//   2. ssd_carry, one thread per (b, head, state element): walks the chunks,
//      h <- h exp(cum_end) + S_c, overwriting S_c with the state entering the
//      chunk, and writes h_final;
//   3. ssd_out, one block per (b, chunk, head, 64 rows q): y_diag over the
//      64-key tiles at or below the diagonal, then y_off from the entering
//      state and the skip term.
// Every block computes cum for its chunk with the same block scan, so all
// three launches see the same values. The decay exp(cum_q - cum_k) is formed
// only for k <= q: above the diagonal the exponent is large and positive
// (|a| dt summed over up to 256 steps) and would overflow to inf, and inf * 0
// is NaN; the masked entries are selected as 0, never multiplied by a mask.
// All arithmetic is f32 on the CUDA cores.
//
// Bound. At the serving shape (B 4, S 2048, H 80, P 64, N 128, Q 256, bf16)
// the function moves ~185 MB (x, b, c, y in bf16; dt, h_final in f32): 0.055
// ms at 3.35 TB/s, and the chunked form's products are ~43 GFLOP (0.044 ms on
// the bf16 tensor cores). This kernel also writes and reads the (B, nc, H, P,
// N) f32 chunk states (84 MB, three passes) and runs its ~54 GFLOP of f32
// products on the CUDA cores from shared memory, so it is bound by the CUDA
// cores' f32 rate and shared-memory bandwidth, far above the bound. Tensor-
// core tiles (mma.sync or wgmma, bf16 operands) are the later redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;     // 8 warps; the block scan takes Q <= 256
constexpr int MAX_Q = THREADS;
constexpr int TQ = 64;           // rows q per output block
constexpr int TK = 64;           // steps k per tile
constexpr int NB = 64;           // state columns n per state block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Inclusive cumsum of dt * a over the chunk's Q <= 256 steps into cum[];
// dt into dts[]. dt points at (b, chunk start, head); steps are H apart.
// All threads of the block take part; ends with the block synchronised.
__device__ void chunk_cumsum(const float* __restrict__ dt, int H, float a,
                             int Q, float* cum, float* dts, float* warp_tot) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  float v = 0.f;
  if (t < Q) {
    const float d = dt[(size_t)t * H];
    dts[t] = d;
    v = d * a;
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  float off = 0.f;
  for (int w = 0; w < warp; ++w) off += warp_tot[w];
  if (t < Q) cum[t] = v + off;
  __syncthreads();
}

// Launch 1: the chunk's own state S_c[p, n] for 64 columns n.
template <typename T, int P>
__global__ void __launch_bounds__(THREADS)
ssd_states(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a_log, const T* __restrict__ bm,
           float* __restrict__ states, float* __restrict__ cum_end, int S,
           int H, int N, int Q, int nc) {
  __shared__ float cum[MAX_Q], w[MAX_Q], warp_tot[THREADS / 32];
  __shared__ float xs[TK][P];       // x_k * w_k
  __shared__ float bs[TK][NB];
  constexpr int PI = P / 16;        // rows p per thread
  const int tid = threadIdx.x, tp = tid >> 4, tn = tid & 15;
  const int n0 = blockIdx.x * NB, h = blockIdx.y;
  const int b = blockIdx.z / nc, c = blockIdx.z % nc;
  const size_t s0 = (size_t)b * S + (size_t)c * Q;   // first step of the chunk

  chunk_cumsum(dt + s0 * H + h, H, -expf(a_log[h]), Q, cum, w, warp_tot);
  const float cend = cum[Q - 1];
  if (tid < Q) w[tid] = expf(cend - cum[tid]) * w[tid];   // exponent <= 0
  if (blockIdx.x == 0 && tid == 0) cum_end[(size_t)blockIdx.z * H + h] = cend;

  float acc[PI][4];
#pragma unroll
  for (int i = 0; i < PI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Q; k0 += TK) {
    __syncthreads();  // w is written; the previous tile is consumed
    for (int e = tid; e < TK * P; e += THREADS) {
      const int k = e / P, p = e % P;
      xs[k][p] = (k0 + k < Q)
          ? to_f32(x[((s0 + k0 + k) * H + h) * P + p]) * w[k0 + k] : 0.f;
    }
    for (int e = tid; e < TK * NB; e += THREADS) {
      const int k = e / NB, n = n0 + e % NB;
      bs[k][e % NB] = (k0 + k < Q && n < N)
          ? to_f32(bm[(s0 + k0 + k) * N + n]) : 0.f;
    }
    __syncthreads();
    const int kn = min(TK, Q - k0);
    for (int k = 0; k < kn; ++k) {
      float bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[k][tn + 16 * j];
#pragma unroll
      for (int i = 0; i < PI; ++i) {
        const float xv = xs[k][tp + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv, bv[j], acc[i][j]);
      }
    }
  }

  float* out = states + ((size_t)blockIdx.z * H + h) * P * N;
#pragma unroll
  for (int i = 0; i < PI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn + 16 * j;
      if (n < N) out[(size_t)(tp + 16 * i) * N + n] = acc[i][j];
    }
}

// Launch 2: the carry over chunks. states[b, c] becomes the state entering
// chunk c; h_final gets the state after the last chunk.
__global__ void __launch_bounds__(THREADS)
ssd_carry(float* __restrict__ states, const float* __restrict__ cum_end,
          float* __restrict__ h_final, int H, int PN, int nc) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  float hc = 0.f;
  for (int c = 0; c < nc; ++c) {
    const size_t bc = ((size_t)b * nc + c) * H + h;
    float* s = states + bc * PN + e;
    const float own = *s;
    *s = hc;
    hc = hc * expf(cum_end[bc]) + own;
  }
  h_final[((size_t)b * H + h) * PN + e] = hc;
}

struct OutTile {   // dynamic shared memory of ssd_out, in floats
  int cum, dts, warp, cs, bs, xs, ms, floats;
  __host__ __device__ OutTile(int N, int P) {
    const int ns = N + 1;                 // padded rows: lanes hit distinct banks
    const int brows = TK > P ? TK : P;    // the B tile, then the entering state
    cum = 0;
    dts = cum + MAX_Q;
    warp = dts + MAX_Q;
    cs = warp + THREADS / 32;
    bs = cs + TQ * ns;
    xs = bs + brows * ns;
    ms = xs + TK * P;
    floats = ms + TQ * (TK + 1);
  }
};

// Launch 3: y for 64 rows q of one (b, chunk, head).
template <typename T, int P>
__global__ void __launch_bounds__(THREADS)
ssd_out(const T* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ a_log, const T* __restrict__ bm,
        const T* __restrict__ cm, const float* __restrict__ d,
        const float* __restrict__ states, T* __restrict__ y, int S, int H,
        int N, int Q, int nc) {
  extern __shared__ __align__(16) float smem[];
  const OutTile L(N, P);
  const int ns = N + 1;
  float* cum = smem + L.cum;
  float* dts = smem + L.dts;
  float* cs = smem + L.cs;     // [TQ][ns]  C rows of this tile
  float* bs = smem + L.bs;     // [TK][ns]  B tile; later [P][ns] entering state
  float* xs = smem + L.xs;     // [TK][P]   x tile
  float* ms = smem + L.ms;     // [TQ][TK + 1] decayed scores
  constexpr int PJ = P / 16;   // columns p per thread
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int q0 = blockIdx.x * TQ, h = blockIdx.y;
  const int b = blockIdx.z / nc, c = blockIdx.z % nc;
  const size_t s0 = (size_t)b * S + (size_t)c * Q;

  chunk_cumsum(dt + s0 * H + h, H, -expf(a_log[h]), Q, cum, dts,
               smem + L.warp);
  for (int e = tid; e < TQ * N; e += THREADS) {
    const int r = e / N, n = e % N;
    cs[r * ns + n] = (q0 + r < Q) ? to_f32(cm[(s0 + q0 + r) * N + n]) : 0.f;
  }

  float acc[4][PJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;

  const int k_end = min(q0 + TQ, Q);     // causal: no key past the last row
  for (int k0 = 0; k0 < k_end; k0 += TK) {
    __syncthreads();  // C is loaded; the previous tile is consumed
    for (int e = tid; e < TK * N; e += THREADS) {
      const int k = e / N, n = e % N;
      bs[k * ns + n] = (k0 + k < Q) ? to_f32(bm[(s0 + k0 + k) * N + n]) : 0.f;
    }
    for (int e = tid; e < TK * P; e += THREADS) {
      const int k = e / P, p = e % P;
      xs[e] = (k0 + k < Q) ? to_f32(x[((s0 + k0 + k) * H + h) * P + p]) : 0.f;
    }
    __syncthreads();
    // scores of rows 4 tr + i against keys tc + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = cs[(4 * tr + i) * ns + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[(tc + 16 * j) * ns + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + 4 * tr + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + tc + 16 * j;
        float m = 0.f;   // selected, not multiplied: exp above the diagonal overflows
        if (k <= q && q < Q) m = s[i][j] * expf(cum[q] - cum[k]) * dts[k];
        ms[(4 * tr + i) * (TK + 1) + tc + 16 * j] = m;
      }
    }
    __syncthreads();
    const int kn = min(TK, Q - k0);
    for (int k = 0; k < kn; ++k) {
      float xv[PJ];
#pragma unroll
      for (int j = 0; j < PJ; ++j) xv[j] = xs[k * P + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float mv = ms[(4 * tr + i) * (TK + 1) + k];
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(mv, xv[j], acc[i][j]);
      }
    }
  }

  // the state entering the chunk, into the B tile's place
  __syncthreads();
  const float* hin = states + ((size_t)blockIdx.z * H + h) * P * N;
  for (int e = tid; e < P * N; e += THREADS) bs[(e / N) * ns + e % N] = hin[e];
  __syncthreads();
  const float dh = d[h];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * tr + i, q = q0 + r;
    if (q >= Q) continue;
    float off[PJ];
#pragma unroll
    for (int j = 0; j < PJ; ++j) off[j] = 0.f;
    for (int n = 0; n < N; ++n) {
      const float cv = cs[r * ns + n];
#pragma unroll
      for (int j = 0; j < PJ; ++j)
        off[j] = fmaf(cv, bs[(tc + 16 * j) * ns + n], off[j]);
    }
    const float eq = expf(cum[q]);                 // exponent <= 0
    const size_t row = ((s0 + q) * H + h) * P;
#pragma unroll
    for (int j = 0; j < PJ; ++j) {
      const int p = tc + 16 * j;
      store(y + row + p, acc[i][j] + eq * off[j] + to_f32(x[row + p]) * dh);
    }
  }
}

template <typename T, int P>
int launch(const void* x, const float* dt, const float* a_log, const void* bm,
           const void* cm, const float* d, void* y, float* h_final,
           float* states, float* cum_end, int B, int S, int H, int N, int Q,
           cudaStream_t stream) {
  const int nc = S / Q;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bm);
  ssd_states<T, P><<<dim3((N + NB - 1) / NB, H, B * nc), THREADS, 0, stream>>>(
      xt, dt, a_log, bt, states, cum_end, S, H, N, Q, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_carry<<<dim3((P * N + THREADS - 1) / THREADS, H, B), THREADS, 0, stream>>>(
      states, cum_end, h_final, H, P * N, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int bytes = OutTile(N, P).floats * (int)sizeof(float);
  err = cudaFuncSetAttribute(ssd_out<T, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_out<T, P><<<dim3((Q + TQ - 1) / TQ, H, B * nc), THREADS, bytes, stream>>>(
      xt, dt, a_log, bt, static_cast<const T*>(cm), d, states,
      static_cast<T*>(y), S, H, N, Q, nc);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int P, const void* x, const float* dt, const float* a_log,
             const void* bm, const void* cm, const float* d, void* y,
             float* h_final, float* states, float* cum_end, int B, int S,
             int H, int N, int Q, cudaStream_t s) {
  switch (P) {
    case 16: return launch<T, 16>(x, dt, a_log, bm, cm, d, y, h_final, states, cum_end, B, S, H, N, Q, s);
    case 32: return launch<T, 32>(x, dt, a_log, bm, cm, d, y, h_final, states, cum_end, B, S, H, N, Q, s);
    case 64: return launch<T, 64>(x, dt, a_log, bm, cm, d, y, h_final, states, cum_end, B, S, H, N, Q, s);
    default: return -1;
  }
}

}  // namespace

// dtype of x, b, c and y: 0 = float32, 1 = bfloat16. states (B, S/Q, H, P, N)
// and cum_end (B, S/Q, H) are f32 scratch. Returns 0, a cudaError_t code, or
// -1 for an unsupported P (16, 32 or 64), dtype or Q (1..256, dividing S).
// Launches on `stream`; does not synchronise.
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* a_log,
                            const void* bm, const void* cm, const float* d,
                            void* y, float* h_final, float* states,
                            float* cum_end, int dtype, int B, int S, int H,
                            int P, int N, int Q, void* stream) {
  if (Q < 1 || Q > MAX_Q || S % Q) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(P, x, dt, a_log, bm, cm, d, y, h_final, states, cum_end, B, S, H, N, Q, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(P, x, dt, a_log, bm, cm, d, y, h_final, states, cum_end, B, S, H, N, Q, s);
  return -1;
}
