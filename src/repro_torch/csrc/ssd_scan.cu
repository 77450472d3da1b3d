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
//   1. chunk states: the chunk's own state S_c = sum_k w_k x_k B_k^T, w_k =
//      exp(cum_end - cum_k) dt_k, per (b, chunk, head, 64 state columns),
//      from 64-step tiles of x and B in shared memory; block 0 also writes
//      cum_end;
//   2. ssd_carry, one thread per (b, head, state element): walks the chunks,
//      h <- h exp(cum_end) + S_c, overwriting S_c with the state entering the
//      chunk, and writes h_final (the loads of eight chunks are issued before
//      the dependent multiply-adds);
//   3. outputs: y_diag over the keys at or below the diagonal, then y_off
//      from the entering state, and the skip term.
// Every block computes cum for its chunk and head with the same block scan,
// so all three launches see the same values. The decay exp(cum_q - cum_k) is
// formed only for k <= q: above the diagonal the exponent is large and
// positive (|a| dt summed over up to 256 steps) and would overflow to inf,
// and inf * 0 is NaN; the masked entries are selected as 0, never multiplied
// by a mask. x, b and c are read through their strides (unit inner stride):
// the model passes strided views of its conv output, uncopied.
//
// Two routes for launches 1 and 3, chosen by the wrapper from the dtype:
//
// mma.sync (bf16): `ssd_states_mma` and `ssd_out_mma` run their products on
// the tensor cores (mma.sync.m16n8k16, bf16 operands, f32 accumulators, fed
// by ldmatrix from tiles that cp.async brings in). B, C and x are exact bf16
// operands. The f32 intermediates (x_k w_k of the chunk state, the decayed
// score matrix M = (C B^T o decay) dt, the entering state h_in) go in as a
// bf16 hi + lo pair, hi = bf16(v), lo = bf16(v - hi), with two products
// each: the other operand being exact, each product keeps ~16 bits of the
// f32 value (relative error <= 2^-16 against the 1e-1 bf16 and 5e-3
// h_final bars). `ssd_out_mma` takes one block of 16 warps per (b, chunk,
// 64 q rows, 8 heads): C.B^T depends only on (b, chunk) since G = 1, so the block forms
// the 64 x (keys <= diagonal) score tile once into shared memory (f32, 66 KB
// at Q 256), as the Pallas kernel shares it across its head block, and
// loops over its heads: all threads form that head's M as bf16 hi + lo in
// shared memory (each element once, four at a time), the warps run y_diag
// and y_off from ldmatrix fragments, and the entering state's and the next
// head's x loads are issued behind the products. The per-head cumsums are
// formed together at the start, one warp per head, in chunk_cumsum's order
// of additions. mma.sync rather than wgmma: Q, P and N go down to
// 16 in the tested cases, and the floor of this design is the bytes of the
// f32 chunk states (84 MB at the serving shape, written, then read and
// written by the carry, then read: ~0.1 ms), which the tensor cores' last
// factor of rate would not move.
//
// CUDA cores (float32): `ssd_states` and `ssd_out`, all arithmetic in f32
// (tensor cores in TF32 would break the 5e-3 bars), one output block per
// (b, chunk, head, 64 rows).
//
// Bound. At the serving shape (B 4, S 2048, H 80, P 64, N 128, Q 256, bf16)
// the function moves ~185 MB (x, b, c, y in bf16; dt, h_final in f32): 0.055
// ms at 3.35 TB/s, and the chunked form's products are ~43 GFLOP (0.044 ms on
// the bf16 tensor cores). This kernel also writes and reads the (B, nc, H, P,
// N) f32 chunk states (84 MB, three passes) and runs the f32 intermediates'
// products twice (hi and lo).
#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;     // 8 warps; the block scan takes Q <= 256
constexpr int MAX_Q = THREADS;
constexpr int TQ = 64;           // rows q per output block
constexpr int TK = 64;           // steps k per tile
constexpr int NB = 64;           // state columns n per state block
constexpr unsigned FULL = 0xffffffffu;

// Element strides of x (B, S, H, P) and of b, c (B, S, 1, N); inner stride 1.
struct Strides {
  long long xb, xs, xh, bb, bs, cb, cs;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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
           int H, int N, int Q, int nc, Strides st) {
  __shared__ float cum[MAX_Q], w[MAX_Q], warp_tot[THREADS / 32];
  __shared__ float xs[TK][P];       // x_k * w_k
  __shared__ float bs[TK][NB];
  constexpr int PI = P / 16;        // rows p per thread
  const int tid = threadIdx.x, tp = tid >> 4, tn = tid & 15;
  const int n0 = blockIdx.x * NB, h = blockIdx.y;
  const int b = blockIdx.z / nc, c = blockIdx.z % nc;
  const size_t s0 = (size_t)b * S + (size_t)c * Q;   // first step of the chunk
  const T* xc = x + b * st.xb + (long long)c * Q * st.xs + h * st.xh;
  const T* bc = bm + b * st.bb + (long long)c * Q * st.bs;

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
          ? to_f32(xc[(k0 + k) * st.xs + p]) * w[k0 + k] : 0.f;
    }
    for (int e = tid; e < TK * NB; e += THREADS) {
      const int k = e / NB, n = n0 + e % NB;
      bs[k][e % NB] = (k0 + k < Q && n < N)
          ? to_f32(bc[(k0 + k) * st.bs + n]) : 0.f;
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
// chunk c; h_final gets the state after the last chunk. Each thread carries
// four consecutive state elements (P N is a multiple of 4).
__global__ void __launch_bounds__(THREADS)
ssd_carry(float* __restrict__ states, const float* __restrict__ cum_end,
          float* __restrict__ h_final, int H, int PN, int nc) {
  const int e = blockIdx.x * THREADS + threadIdx.x;   // a float4 of the state
  const int h = blockIdx.y, b = blockIdx.z;
  const int PN4 = PN / 4;
  if (e >= PN4) return;
  constexpr int AHEAD = 8;                 // chunks whose loads are issued together
  float4* st4 = reinterpret_cast<float4*>(states);
  float4 hc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += AHEAD) {
    float4 own[AHEAD];
    float decay[AHEAD];
#pragma unroll
    for (int j = 0; j < AHEAD; ++j) {
      if (c0 + j < nc) {
        const size_t bc = ((size_t)b * nc + c0 + j) * H + h;
        own[j] = st4[bc * PN4 + e];
        decay[j] = cum_end[bc];
      }
    }
#pragma unroll
    for (int j = 0; j < AHEAD; ++j) {
      if (c0 + j < nc) {
        st4[(((size_t)b * nc + c0 + j) * H + h) * PN4 + e] = hc;
        const float f = expf(decay[j]);
        hc = make_float4(hc.x * f + own[j].x, hc.y * f + own[j].y,
                         hc.z * f + own[j].z, hc.w * f + own[j].w);
      }
    }
  }
  reinterpret_cast<float4*>(h_final)[((size_t)b * H + h) * PN4 + e] = hc;
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
        int N, int Q, int nc, Strides st) {
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
  const T* xc = x + b * st.xb + (long long)c * Q * st.xs + h * st.xh;
  const T* bc = bm + b * st.bb + (long long)c * Q * st.bs;
  const T* cc = cm + b * st.cb + (long long)c * Q * st.cs;

  chunk_cumsum(dt + s0 * H + h, H, -expf(a_log[h]), Q, cum, dts,
               smem + L.warp);
  for (int e = tid; e < TQ * N; e += THREADS) {
    const int r = e / N, n = e % N;
    cs[r * ns + n] = (q0 + r < Q) ? to_f32(cc[(q0 + r) * st.cs + n]) : 0.f;
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
      bs[k * ns + n] = (k0 + k < Q) ? to_f32(bc[(k0 + k) * st.bs + n]) : 0.f;
    }
    for (int e = tid; e < TK * P; e += THREADS) {
      const int k = e / P, p = e % P;
      xs[e] = (k0 + k < Q) ? to_f32(xc[(k0 + k) * st.xs + p]) : 0.f;
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
      store(y + row + p, acc[i][j] + eq * off[j] + to_f32(xc[q * st.xs + p]) * dh);
    }
  }
}

// ---------------------------------------------------------------------------
// mma.sync route (bf16)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int HG = THREADS / 32; // heads per ssd_out_mma block, one warp's cumsum each
constexpr int NB2 = 128;         // state columns n per ssd_states_mma block
constexpr int NBS = NB2 + 8;     // its padded B tile row, bf16

__device__ __forceinline__ void zero16(void* p) {
  *reinterpret_cast<uint4*>(p) = make_uint4(0, 0, 0, 0);
}

// Launch 1: the chunk's own state S_c[p, n] for 128 columns n, as
// (x w)^T . B with x w split into bf16 hi + lo. Warp w owns rows p of
// 16 (w % 4) and the columns 64 (w / 4) .. + 64 of the block's 128. The
// next 64-step tile's B (cp.async, second buffer) and x (registers) are
// loaded while the current tile's products run.
template <int P>
struct StatesTile {                 // dynamic shared memory of ssd_states_mma
  static constexpr int XS = P + 8;  // padded x row, bf16: ldmatrix rows hit distinct banks
  static constexpr int XH = 0;                                   // [TK][XS] bf16
  static constexpr int XL = XH + TK * XS * 2;
  static constexpr int BS = XL + TK * XS * 2;                    // [2][TK][NBS] bf16
  static constexpr int CUM = BS + 2 * TK * NBS * 2;              // f32
  static constexpr int W = CUM + MAX_Q * 4;
  static constexpr int WT = W + MAX_Q * 4;
  static constexpr int bytes = WT + (THREADS / 32) * 4;
};

template <int P>
__global__ void __launch_bounds__(THREADS)
ssd_states_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a_log, const bf16* __restrict__ bm,
               float* __restrict__ states, float* __restrict__ cum_end, int S,
               int H, int N, int Q, int nc, Strides st) {
  using L = StatesTile<P>;
  constexpr int XS = L::XS;
  constexpr int XI = (TK * P / 8 + THREADS - 1) / THREADS;   // x uint4 a thread
  extern __shared__ __align__(16) uint8_t smem_st[];
  bf16* xh = reinterpret_cast<bf16*>(smem_st + L::XH);
  bf16* xl = reinterpret_cast<bf16*>(smem_st + L::XL);
  bf16* bsb = reinterpret_cast<bf16*>(smem_st + L::BS);
  float* cum = reinterpret_cast<float*>(smem_st + L::CUM);
  float* w = reinterpret_cast<float*>(smem_st + L::W);
  float* warp_tot = reinterpret_cast<float*>(smem_st + L::WT);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * NB2, h = blockIdx.y;
  const int b = blockIdx.z / nc, c = blockIdx.z % nc;
  const size_t s0 = (size_t)b * S + (size_t)c * Q;
  const bf16* xc = x + b * st.xb + (long long)c * Q * st.xs + h * st.xh;
  const bf16* bc = bm + b * st.bb + (long long)c * Q * st.bs;

  // B rows k0 .. k0 + TK into buffer `buf` (zeros past Q and N)
  auto issue_b = [&](int k0, int buf) {
    bf16* bs = bsb + buf * TK * NBS;
    for (int e = tid; e < TK * (NB2 / 8); e += THREADS) {
      const int k = e >> 4, c8 = (e & 15) * 8, n = n0 + c8;
      if (k0 + k < Q && n < N) hopper::cp_async16(bs + k * NBS + c8, bc + (k0 + k) * st.bs + n);
      else zero16(bs + k * NBS + c8);
    }
    hopper::cp_async_commit();
  };
  uint4 xr[XI];
  auto load_x = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XI; ++i) {
      const int e = tid + i * THREADS, k = e / (P / 8), p8 = (e % (P / 8)) * 8;
      xr[i] = (e < TK * P / 8 && k0 + k < Q)
                  ? *reinterpret_cast<const uint4*>(xc + (k0 + k) * st.xs + p8)
                  : make_uint4(0, 0, 0, 0);
    }
  };
  issue_b(0, 0);
  load_x(0);

  chunk_cumsum(dt + s0 * H + h, H, -expf(a_log[h]), Q, cum, w, warp_tot);
  const float cend = cum[Q - 1];
  if (tid < Q) w[tid] = expf(cend - cum[tid]) * w[tid];   // exponent <= 0
  if (blockIdx.x == 0 && tid == 0) cum_end[(size_t)blockIdx.z * H + h] = cend;

  const int mi = warp & 3, nh = warp >> 2;
  const bool active = mi < P / 16;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0, t = 0; k0 < Q; k0 += TK, ++t) {
    __syncthreads();  // w is written; the previous tile is consumed
    // this tile's x w as bf16 hi + lo (zeros past Q)
#pragma unroll
    for (int i = 0; i < XI; ++i) {
      const int e = tid + i * THREADS, k = e / (P / 8), p8 = (e % (P / 8)) * 8;
      if (e >= TK * P / 8) continue;
      __align__(16) bf16 hi[8], lo[8];
      const bf16* xv = reinterpret_cast<const bf16*>(&xr[i]);
      const float wk = k0 + k < Q ? w[k0 + k] : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) hopper::split_bf16(__bfloat162float(xv[j]) * wk, hi[j], lo[j]);
      *reinterpret_cast<uint4*>(xh + k * XS + p8) = *reinterpret_cast<const uint4*>(hi);
      *reinterpret_cast<uint4*>(xl + k * XS + p8) = *reinterpret_cast<const uint4*>(lo);
    }
    if (k0 + TK < Q) {           // the next tile's loads, behind this tile's products
      issue_b(k0 + TK, (t + 1) & 1);
      load_x(k0 + TK);
      hopper::cp_async_wait_one();
    } else {
      hopper::cp_async_wait_all();
    }
    __syncthreads();
    if (active) {
      const bf16* bs = bsb + (t & 1) * TK * NBS;
      const int kn = min(TK, Q - k0);
      for (int ks = 0; ks < kn; ks += 16) {
        uint32_t ah[4], al[4];
        hopper::load_a_t(ah, xh, XS, mi * 16, ks, lane);
        hopper::load_a_t(al, xl, XS, mi * 16, ks, lane);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bf[4];
          hopper::load_b2_t(bf, bs, NBS, nh * 64 + np * 16, ks, lane);
          hopper::mma_bf16(acc[2 * np], ah, bf[0], bf[1]);
          hopper::mma_bf16(acc[2 * np], al, bf[0], bf[1]);
          hopper::mma_bf16(acc[2 * np + 1], ah, bf[2], bf[3]);
          hopper::mma_bf16(acc[2 * np + 1], al, bf[2], bf[3]);
        }
      }
    }
  }

  if (!active) return;
  float* out = states + ((size_t)blockIdx.z * H + h) * P * N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = n0 + nh * 64 + nt * 8 + 2 * t4;
    if (n >= N) continue;
    const int p = mi * 16 + g;
    *reinterpret_cast<float2*>(out + (size_t)p * N + n) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(out + (size_t)(p + 8) * N + n) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// Inclusive cumsum of dt * a over the chunk's Q <= 256 steps for one head,
// by one warp, into cum[] (dt into dts[]): the additions of chunk_cumsum in
// the same order (a shuffle scan of each 32 steps, plus the earlier
// segments' totals summed in order), so launches 1 and 3 agree bit for bit.
__device__ void warp_cumsum(const float* __restrict__ dt, int H, float a, int Q,
                            float* cum, float* dts) {
  const int lane = threadIdx.x & 31;
  float d[MAX_Q / 32];
#pragma unroll
  for (int seg = 0; seg < MAX_Q / 32; ++seg) {   // all loads in flight at once
    const int t = seg * 32 + lane;
    d[seg] = t < Q ? dt[(size_t)t * H] : 0.f;
  }
  float off = 0.f;
#pragma unroll
  for (int seg = 0; seg < MAX_Q / 32; ++seg) {
    const int t = seg * 32 + lane;
    float v = 0.f;
    if (t < Q) {
      dts[t] = d[seg];
      v = d[seg] * a;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v += n;
    }
    if (t < Q) cum[t] = v + off;
    off += __shfl_sync(FULL, v, 31);
  }
}

__device__ __forceinline__ void put_state(bf16* hh, bf16* hl, int ns, int N, int e,
                                          float4 v) {
  const int p = (4 * e) / N, n = (4 * e) % N;
  __align__(8) bf16 vh[4], vl[4];
  hopper::split_bf16(v.x, vh[0], vl[0]);
  hopper::split_bf16(v.y, vh[1], vl[1]);
  hopper::split_bf16(v.z, vh[2], vl[2]);
  hopper::split_bf16(v.w, vh[3], vl[3]);
  *reinterpret_cast<uint2*>(hh + p * ns + n) = *reinterpret_cast<const uint2*>(vh);
  *reinterpret_cast<uint2*>(hl + p * ns + n) = *reinterpret_cast<const uint2*>(vl);
}

struct OutMmaTile {   // dynamic shared memory of ssd_out_mma, in bytes
  int scs, ns, xstr, kx, ms, sc, cs, mh, ml, hh, hl, bt, xs, cum, dts, bytes;
  __host__ __device__ OutMmaTile(int N, int P, int Q) {
    scs = (Q + 63) / 64 * 64 + 8;     // f32 score row: == 8 mod 32, no bank conflicts
    ns = N + 8;                       // padded bf16 rows of C, B, h_in
    xstr = P + 8;                     // padded bf16 row of x
    kx = (Q + 15) / 16 * 16;          // keys a block may read
    ms = kx + 8;                      // padded bf16 row of M
    sc = 0;
    cs = sc + TQ * scs * 4;
    mh = cs + TQ * ns * 2;            // M hi + lo; after y_diag, h_in hi + lo
    ml = mh + TQ * ms * 2;
    hh = mh;
    hl = hh + P * ns * 2;
    const int m_end = ml + TQ * ms * 2, h_end = hl + P * ns * 2;
    bt = m_end > h_end ? m_end : h_end;   // the B tile, then x
    xs = bt;
    const int b_end = bt + TK * ns * 2, x_end = xs + kx * xstr * 2;
    cum = b_end > x_end ? b_end : x_end;
    dts = cum + HG * MAX_Q * 4;
    bytes = dts + HG * MAX_Q * 4;
  }
};

constexpr int OUT_THREADS = 512;   // 16 warps: 4 row tiles x 4 column groups of p
constexpr int HV = 4;              // float4 of h_in per thread that a block prefetches

// Launch 3: y for 64 rows q of one (b, chunk) and HG heads. The C.B^T tile
// of the rows against the keys at or below the diagonal is formed once, in
// f32. Per head, all threads form M = (C.B^T) exp(cum_q - cum_k) dt_k as
// bf16 hi + lo in shared memory; then y_diag = (M hi + M lo) . x and y_off
// = C . (h_in hi + h_in lo)^T, warp w owning rows 16 (w % 4) .. + 16 and
// the columns p 16 (w / 4) .. + 16. The entering state's loads are issued
// before y_diag and the next head's x during y_off.
template <int P>
__global__ void __launch_bounds__(OUT_THREADS, 1)
ssd_out_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ a_log, const bf16* __restrict__ bm,
            const bf16* __restrict__ cm, const float* __restrict__ d,
            const float* __restrict__ states, bf16* __restrict__ y, int S,
            int H, int N, int Q, int nc, Strides st) {
  constexpr int NTW = 2;               // n8 tiles of p per warp
  extern __shared__ __align__(16) uint8_t smem_mma[];
  const OutMmaTile L(N, P, Q);
  float* sc = reinterpret_cast<float*>(smem_mma + L.sc);
  bf16* cs = reinterpret_cast<bf16*>(smem_mma + L.cs);
  bf16* mh = reinterpret_cast<bf16*>(smem_mma + L.mh);
  bf16* ml = reinterpret_cast<bf16*>(smem_mma + L.ml);
  bf16* hh = reinterpret_cast<bf16*>(smem_mma + L.hh);
  bf16* hl = reinterpret_cast<bf16*>(smem_mma + L.hl);
  bf16* bt = reinterpret_cast<bf16*>(smem_mma + L.bt);
  bf16* xs = reinterpret_cast<bf16*>(smem_mma + L.xs);
  float* cumg = reinterpret_cast<float*>(smem_mma + L.cum);   // [HG][MAX_Q]
  float* dtsg = reinterpret_cast<float*>(smem_mma + L.dts);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int mi = warp & 3, wq = warp >> 2;
  const int q0 = blockIdx.x * TQ, h0 = blockIdx.y * HG;
  const int b = blockIdx.z / nc, c = blockIdx.z % nc;
  const int n_heads = min(HG, H - h0);
  const size_t s0 = (size_t)b * S + (size_t)c * Q;
  const bf16* bc = bm + b * st.bb + (long long)c * Q * st.bs;
  const bf16* cc = cm + b * st.cb + (long long)c * Q * st.cs;
  const int k_end = min(q0 + TQ, Q);   // causal: no key past the last row
  const int kx = (k_end + 15) / 16 * 16;
  const int n8 = N / 8, n4 = P * N / 4;

  // the cumsums of the group's heads, one warp each
  if (warp < n_heads)
    warp_cumsum(dt + s0 * H + h0 + warp, H, -expf(a_log[h0 + warp]), Q,
                cumg + warp * MAX_Q, dtsg + warp * MAX_Q);
  // C rows of this tile
  for (int e = tid; e < TQ * n8; e += OUT_THREADS) {
    const int r = e / n8, c8 = (e % n8) * 8;
    if (q0 + r < Q) hopper::cp_async16(cs + r * L.ns + c8, cc + (q0 + r) * st.cs + c8);
    else zero16(cs + r * L.ns + c8);
  }
  // scores C.B^T, 64 keys at a time; warp: rows 16 mi, keys 16 wq .. + 16
  for (int kt = 0; kt < k_end; kt += TK) {
    for (int e = tid; e < TK * n8; e += OUT_THREADS) {
      const int r = e / n8, c8 = (e % n8) * 8;
      if (kt + r < Q) hopper::cp_async16(bt + r * L.ns + c8, bc + (kt + r) * st.bs + c8);
      else zero16(bt + r * L.ns + c8);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait_all();
    __syncthreads();
    float s4[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s4[i][j] = 0.f;
    for (int kn = 0; kn < N; kn += 16) {
      uint32_t a[4], bf[4];
      hopper::load_a(a, cs, L.ns, mi * 16, kn, lane);
      hopper::load_b2(bf, bt, L.ns, wq * 16, kn, lane);
      hopper::mma_bf16(s4[0], a, bf[0], bf[1]);
      hopper::mma_bf16(s4[1], a, bf[2], bf[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = kt + wq * 16 + nt * 8 + 2 * t4;
      const int r = mi * 16 + g;
      *reinterpret_cast<float2*>(sc + r * L.scs + col) = make_float2(s4[nt][0], s4[nt][1]);
      *reinterpret_cast<float2*>(sc + (r + 8) * L.scs + col) = make_float2(s4[nt][2], s4[nt][3]);
    }
    __syncthreads();  // the B tile is consumed (its space holds x next)
  }

  // x rows 0 .. kx of head h (zeros past the diagonal tile)
  auto issue_x = [&](int h) {
    const bf16* xc = x + b * st.xb + (long long)c * Q * st.xs + h * st.xh;
    for (int e = tid; e < kx * (P / 8); e += OUT_THREADS) {
      const int k = e / (P / 8), p8 = (e % (P / 8)) * 8;
      if (k < k_end) hopper::cp_async16(xs + k * L.xstr + p8, xc + k * st.xs + p8);
      else zero16(xs + k * L.xstr + p8);
    }
    hopper::cp_async_commit();
  };

  const int row_lo = q0 + mi * 16;               // the warp's first row
  const int k_lim = min(row_lo + 16, k_end);     // keys <= the warp's last row
  const int qa = row_lo + g, qb = qa + 8;
  const int pc0 = wq * 16;                       // the warp's first column p
  const bool active = pc0 < P;                   // P / 16 column groups work
  auto state_of = [&](int h) {
    return reinterpret_cast<const float4*>(states + ((size_t)blockIdx.z * H + h) * P * N);
  };
  // the entering state of a head: loaded a whole head ahead of its use
  float4 hv[HV];
  auto load_state = [&](int h) {
    const float4* hin = state_of(h);
#pragma unroll
    for (int j = 0; j < HV; ++j) {
      const int e = tid + j * OUT_THREADS;
      if (e < n4) hv[j] = hin[e];
    }
  };
  issue_x(h0);
  load_state(h0);
  for (int hi = 0; hi < n_heads; ++hi) {
    const int h = h0 + hi;
    const float* cum = cumg + hi * MAX_Q;
    const float* dts = dtsg + hi * MAX_Q;
    // M = (C.B^T) exp(cum_q - cum_k) dt_k for k <= q, else 0 (selected, not
    // multiplied: above the diagonal the exponential overflows); a warp per
    // row, four keys a lane. __expf's relative error (~2^-21) is far below
    // that of the hi + lo pair (2^-16).
#pragma unroll
    for (int rw = 0; rw < TQ / (OUT_THREADS / 32); ++rw) {
      const int r = warp + rw * (OUT_THREADS / 32), q = q0 + r;
      const float cq = q < Q ? cum[q] : 0.f;
#pragma unroll
      for (int k = 4 * lane; k < 4 * 32 * (MAX_Q / 128); k += 128) {
        if (k >= kx) break;
        float m[4] = {0.f, 0.f, 0.f, 0.f};
        if (q < Q && k <= q) {
          const float4 s = *reinterpret_cast<const float4*>(sc + r * L.scs + k);
          const float4 ck = *reinterpret_cast<const float4*>(cum + k);
          const float4 dk = *reinterpret_cast<const float4*>(dts + k);
          m[0] = s.x * __expf(cq - ck.x) * dk.x;
          m[1] = k + 1 <= q ? s.y * __expf(cq - ck.y) * dk.y : 0.f;
          m[2] = k + 2 <= q ? s.z * __expf(cq - ck.z) * dk.z : 0.f;
          m[3] = k + 3 <= q ? s.w * __expf(cq - ck.w) * dk.w : 0.f;
        }
        uint2 vh, vl;
        hopper::split_pack(m[0], m[1], vh.x, vl.x);
        hopper::split_pack(m[2], m[3], vh.y, vl.y);
        *reinterpret_cast<uint2*>(mh + r * L.ms + k) = vh;
        *reinterpret_cast<uint2*>(ml + r * L.ms + k) = vl;
      }
    }
    hopper::cp_async_wait_all();
    __syncthreads();
    // the skip term's x, in flight behind the products
    const bf16* xc = x + b * st.xb + (long long)c * Q * st.xs + h * st.xh;
    float2 xv[2][NTW];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int q = rr ? qb : qa;
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
        xv[rr][nt] = (active && q < Q) ? __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xc + q * st.xs + pc0 + nt * 8 + 2 * t4))
            : make_float2(0.f, 0.f);
    }

    float yd[NTW][4], yo[NTW][4];
#pragma unroll
    for (int i = 0; i < NTW; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) yd[i][j] = yo[i][j] = 0.f;
    // y_diag = (M hi + M lo) . x over the keys <= the warp's last row
#pragma unroll 2
    for (int ks = 0; active && ks < k_lim; ks += 16) {
      uint32_t ah[4], al[4], bf[4];
      hopper::load_a(ah, mh, L.ms, mi * 16, ks, lane);
      hopper::load_a(al, ml, L.ms, mi * 16, ks, lane);
      hopper::load_b2_t(bf, xs, L.xstr, pc0, ks, lane);
      hopper::mma_bf16(yd[0], ah, bf[0], bf[1]);
      hopper::mma_bf16(yd[0], al, bf[0], bf[1]);
      hopper::mma_bf16(yd[1], ah, bf[2], bf[3]);
      hopper::mma_bf16(yd[1], al, bf[2], bf[3]);
    }
    __syncthreads();  // M and x are consumed
    if (hi + 1 < n_heads) issue_x(h + 1);
    // the entering state as bf16 hi + lo, in M's place
#pragma unroll
    for (int j = 0; j < HV; ++j) {
      const int e = tid + j * OUT_THREADS;
      if (e < n4) put_state(hh, hl, L.ns, N, e, hv[j]);
    }
    for (int e = tid + HV * OUT_THREADS; e < n4; e += OUT_THREADS)
      put_state(hh, hl, L.ns, N, e, state_of(h)[e]);
    if (hi + 1 < n_heads) load_state(h + 1);   // in flight until the next staging
    __syncthreads();
    // y_off = C . h_in^T, the state's f32 values as hi + lo
    for (int kn = 0; active && kn < N; kn += 16) {
      uint32_t a[4], bh[4], bl[4];
      hopper::load_a(a, cs, L.ns, mi * 16, kn, lane);
      hopper::load_b2(bh, hh, L.ns, pc0, kn, lane);
      hopper::load_b2(bl, hl, L.ns, pc0, kn, lane);
      hopper::mma_bf16(yo[0], a, bh[0], bh[1]);
      hopper::mma_bf16(yo[0], a, bl[0], bl[1]);
      hopper::mma_bf16(yo[1], a, bh[2], bh[3]);
      hopper::mma_bf16(yo[1], a, bl[2], bl[3]);
    }
    // y = y_diag + exp(cum_q) y_off + d x (x of the skip term from memory:
    // the x buffer already holds the next head's)
    const float dh = d[h];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int q = rr ? qb : qa;
      if (!active || q >= Q) continue;
      const float eq = expf(cum[q]);             // exponent <= 0
      bf16* yrow = y + ((s0 + q) * H + h) * P;
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        const int p = pc0 + nt * 8 + 2 * t4;
        *reinterpret_cast<__nv_bfloat162*>(yrow + p) = __floats2bfloat162_rn(
            yd[nt][2 * rr] + eq * yo[nt][2 * rr] + xv[rr][nt].x * dh,
            yd[nt][2 * rr + 1] + eq * yo[nt][2 * rr + 1] + xv[rr][nt].y * dh);
      }
    }
    __syncthreads();  // h_in's space holds the next head's M
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void *x, *bm, *cm;
  const float *dt, *a_log, *d;
  void* y;
  float *h_final, *states, *cum_end;
  int B, S, H, N, Q;
  Strides st;
};

int carry(const Args& a, int P, int nc, cudaStream_t stream) {
  ssd_carry<<<dim3((P * a.N / 4 + THREADS - 1) / THREADS, a.H, a.B), THREADS, 0, stream>>>(
      a.states, a.cum_end, a.h_final, a.H, P * a.N, nc);
  return (int)cudaGetLastError();
}

template <int P>
int launch_f32(const Args& a, cudaStream_t stream) {
  const int nc = a.S / a.Q;
  const float* xt = static_cast<const float*>(a.x);
  const float* bt = static_cast<const float*>(a.bm);
  ssd_states<float, P><<<dim3((a.N + NB - 1) / NB, a.H, a.B * nc), THREADS, 0, stream>>>(
      xt, a.dt, a.a_log, bt, a.states, a.cum_end, a.S, a.H, a.N, a.Q, nc, a.st);
  int err = (int)cudaGetLastError();
  if (!err) err = carry(a, P, nc, stream);
  if (err) return err;
  const int bytes = OutTile(a.N, P).floats * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(ssd_out<float, P>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  ssd_out<float, P><<<dim3((a.Q + TQ - 1) / TQ, a.H, a.B * nc), THREADS, bytes, stream>>>(
      xt, a.dt, a.a_log, bt, static_cast<const float*>(a.cm), a.d, a.states,
      static_cast<float*>(a.y), a.S, a.H, a.N, a.Q, nc, a.st);
  return (int)cudaGetLastError();
}

template <int P>
int launch_mma(const Args& a, cudaStream_t stream) {
  const int nc = a.S / a.Q;
  const bf16* xt = static_cast<const bf16*>(a.x);
  const bf16* bt = static_cast<const bf16*>(a.bm);
  cudaError_t e = cudaFuncSetAttribute(ssd_states_mma<P>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       StatesTile<P>::bytes);
  if (e != cudaSuccess) return (int)e;
  ssd_states_mma<P><<<dim3((a.N + NB2 - 1) / NB2, a.H, a.B * nc), THREADS,
                      StatesTile<P>::bytes, stream>>>(
      xt, a.dt, a.a_log, bt, a.states, a.cum_end, a.S, a.H, a.N, a.Q, nc, a.st);
  int err = (int)cudaGetLastError();
  if (!err) err = carry(a, P, nc, stream);
  if (err) return err;
  const int bytes = OutMmaTile(a.N, P, a.Q).bytes;
  e = cudaFuncSetAttribute(ssd_out_mma<P>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  ssd_out_mma<P><<<dim3((a.Q + TQ - 1) / TQ, (a.H + HG - 1) / HG, a.B * nc),
                   OUT_THREADS, bytes, stream>>>(
      xt, a.dt, a.a_log, bt, static_cast<const bf16*>(a.cm), a.d, a.states,
      static_cast<bf16*>(a.y), a.S, a.H, a.N, a.Q, nc, a.st);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B,S,H,P) and b, c (B,S,1,N) through their element strides (inner stride
// 1); dt (B,S,H), a_log and d (H,) f32 contiguous; y (B,S,H,P) contiguous in
// x's type; states (B, S/Q, H, P, N) and cum_end (B, S/Q, H) f32 scratch.
// `ssd_scan_fwd`: float32 x, b, c (CUDA cores). `ssd_scan_fwd_mma`: bf16 x,
// b, c (tensor cores; 16-byte aligned rows, N a multiple of 16). Return 0, a
// cudaError_t code, or -1 for an unsupported P (16, 32 or 64), N or Q
// (1..256, dividing S). Launch on `stream`; do not synchronise.
#define SSD_ARGS                                                              \
  const void *x, const float *dt, const float *a_log, const void *bm,         \
      const void *cm, const float *d, void *y, float *h_final, float *states, \
      float *cum_end, int B, int S, int H, int P, int N, int Q, long long xb, \
      long long xs, long long xh, long long bb, long long bs, long long cb,   \
      long long cs, void *stream

static Args pack_args(SSD_ARGS) {
  return Args{x, bm, cm, dt, a_log, d, y, h_final, states, cum_end, B, S, H, N, Q,
              Strides{xb, xs, xh, bb, bs, cb, cs}};
}

extern "C" int ssd_scan_fwd(SSD_ARGS) {
  if (Q < 1 || Q > MAX_Q || S % Q) return -1;
  const Args a = pack_args(x, dt, a_log, bm, cm, d, y, h_final, states, cum_end, B,
                           S, H, P, N, Q, xb, xs, xh, bb, bs, cb, cs, stream);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 16: return launch_f32<16>(a, s);
    case 32: return launch_f32<32>(a, s);
    case 64: return launch_f32<64>(a, s);
    default: return -1;
  }
}

extern "C" int ssd_scan_fwd_mma(SSD_ARGS) {
  if (Q < 1 || Q > MAX_Q || S % Q || N % 16 || N < 16) return -1;
  const Args a = pack_args(x, dt, a_log, bm, cm, d, y, h_final, states, cum_end, B,
                           S, H, P, N, Q, xb, xs, xh, bb, bs, cb, cs, stream);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 16: return launch_mma<16>(a, s);
    case 32: return launch_mma<32>(a, s);
    case 64: return launch_mma<64>(a, s);
    default: return -1;
  }
}
