// Backward of GQA flash attention for Hopper (sm_90a), bf16, plain C
// interface: dq, dk, dv from the saved (q, k, v, o, lse) and dout.
//
// Replaces no Pallas kernel: the reference differentiates its flash
// attention outside Pallas, by the custom VJP's recomputing backward
// (`_flash_bwd_inner`, src/repro/kernels/ref.py:192), which the port keeps
// as plain float32 torch (`ref.flash_bwd_torch`). That version stays for
// float32 inputs, bf16 at Dh 16 / 32 / 256 and CPU tensors; this kernel
// serves bf16 at Dh 64 and 128, the attention of every bf16 training run.
//
// Layout: q, o, dout, dq (B, Sq, Hq, Dh); k, v, dk, dv (B, Skv, Hkv, Dh);
// all contiguous bf16; lse (B, Hq, Sq) float32 as the forward writes it
// (the natural log of each row's sum of exp(scale q.k) over its kept
// keys). q and key positions both start at 0; causal and sliding-window
// masks and a ragged kv tail, as the forward kernel serves them.
//
// Three launches:
//   1. `flash_bwd_pre`: delta = rowsum(dout * o) in f32 and lse log2(e),
//      both into (B, Hq, Sq_pad) with Sq_pad a multiple of 64 (padded rows
//      0), and zeros into the f32 dq accumulator (B, Hq, Sq_pad, Dh) and
//      into the dQ order counters (B, Hq, Sq_pad / 64).
//   2. `flash_bwd_wgmma`: one block per (b, kv head, tile of 128 keys),
//      issued from the first key tile on, so that the longest causal
//      columns start first. A producer warpgroup (one thread working)
//      loads the block's K and V once by TMA (128-byte swizzle, boxes of
//      64 rows x 64 columns, rows past Skv read as zeros), then streams the
//      q tiles of 64 rows through a two-stage ring: Q and dout by TMA,
//      lse and delta by bulk copies, signalled by mbarriers. It covers
//      the G = Hq / Hkv q heads of the kv head and the q tiles that the
//      causal and window limits keep for these keys (the others are not
//      loaded), from the last q tile down, the q heads inside each tile.
//      Two consumer warpgroups each own 64 of the keys and run,
//      per q tile, on wgmma (bf16 operands, f32 accumulators):
//        S^T  = K Q^T  and  dP^T = V dO^T            (A, B in shared memory)
//        P^T  = exp(scale S^T - lse) (0 where masked), dS^T = P^T (dP^T - delta)
//        dV  += P^T dO  and  dK += dS^T Q            (A from registers)
//        dQ   = dS K over the block's 128 keys        (A = dS^T from shared
//               memory, transposed; each warpgroup half of Dh's columns)
//      with the exponential as 2^(S^T scale log2(e) - lse log2(e)) and a
//      masked P exactly 0, as the forward's finite NEG_INF makes it (the
//      mask is applied only in tiles that hold a masked pair). dQ is added
//      in f32 to the accumulator by TMA reduce-adds of the tile, staged in
//      shared memory (per-element atomics took 40 % of the kernel at
//      SmolLM's shape), in a fixed order: a second thread of the producer
//      warpgroup adds a q tile's dQ only when the tile's counter says that
//      every key tile before this one (of those whose keys the tile's rows
//      keep: a contiguous run) has added its own, waits for its add to
//      land, and then counts it. So dq is the same, bit for bit, from run
//      to run. The waits point only at blocks with a lower index, which
//      were issued earlier, and the q tiles run from the last down, so
//      that blocks of one wave add each tile in step; dK and dV sum the
//      whole GQA group inside the block, need no atomics and are written
//      once in bf16 (dK times scale). The producer warpgroup gives up its
//      registers (setmaxnreg)
//      so that each consumer thread holds dK and dV (up to 128 f32 at Dh
//      128) beside S^T, dP^T and dQ. Dh 256 would need 256 f32 of dK and
//      dV a thread: it stays on the plain version.
//   3. `flash_bwd_post`: dq = scale * accumulator, rounded to bf16 into
//      (B, Sq, Hq, Dh).
//
// Arithmetic: the float32 backward's, but for bf16 operands into the
// tensor cores. The roundings it does not make are P and dS in bf16
// before their products (the forward already rounds P so for P.V), and
// the scores scaled after the bf16 dot rather than q before it.
//
// Bound: 8 B Hq Dh (kept pairs) flops for the dV, dP, dQ and dK products
// (the recomputed S adds 2 more) on the bf16 tensor cores (989 TFLOP/s),
// against the bytes of q, k, v, o, dout and lse read and dq, dk, dv
// written once (3.35 TB/s; the f32 dq accumulator adds its zeroing,
// reductions and read). At SmolLM-135M's 4,096-token microbatch the
// operations bound it (0.313 ms against 0.060 ms for the bytes); at its
// 512-token one, the bytes (0.060 against 0.039 ms).
#include "hopper.cuh"

namespace {

constexpr int BN = 128;                      // keys per block
constexpr int BM = 64;                       // q rows per tile
constexpr int STAGES = 2;                    // q tiles in flight
constexpr int THREADS = 3 * 128;             // two consumer warpgroups + the producer's
constexpr int CHUNK = 64 * 64 * 2;           // one TMA box: 64 rows x 64 bf16
constexpr int DS_BYTES = BN * BM * 2;        // dS^T: 128 key rows of 64 bf16
constexpr int DQ_BOX = 64 * 32 * 4;          // one f32 TMA box: 64 rows x 32 floats
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct Layout {                              // dynamic shared memory, bytes
  static constexpr int NCH = DH / 64;        // 64-column slices of Dh
  static constexpr int K = 0;                          // [2 key halves][NCH] boxes
  static constexpr int V = K + 2 * NCH * CHUNK;
  static constexpr int Q = V + 2 * NCH * CHUNK;        // [STAGES][NCH]
  static constexpr int DO = Q + STAGES * NCH * CHUNK;  // [STAGES][NCH]
  static constexpr int DS = DO + STAGES * NCH * CHUNK; // [2 buffers] dS^T
  static constexpr int DQ = DS + 2 * DS_BYTES;         // [2 buffers][2 wg][NQ / 32] f32 boxes
  static constexpr int LSE = DQ + 2 * 2 * (DH / 64) * DQ_BOX;  // [STAGES][BM] f32
  static constexpr int DELTA = LSE + STAGES * BM * 4;  // [STAGES][BM] f32
  static constexpr int BAR = DELTA + STAGES * BM * 4;
  static constexpr int NBAR = 1 + 2 * STAGES + 4;      // kv, full[], empty[], dq full[2], dq empty[2]
  static constexpr int bytes = BAR + NBAR * 8 + 1024;  // + slack for 1 KB alignment
};

// `bytes` contiguous bytes global -> shared; completion counts on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(hopper::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(hopper::smem_addr(bar))
      : "memory");
}

// Makes this thread's shared-memory writes visible to wgmma's reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The two consumer warpgroups (barrier 1; 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// Adds one box of shared memory (as `map` lays it out) into global memory
// at coordinates (c0 innermost .. c2), asynchronously (a bulk group).
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map,
                                                  const void* src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(hopper::smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until every committed bulk group has completed, its writes done.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's generic-proxy accesses of global memory with its
// async-proxy (TMA) ones.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release_inc(unsigned* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(p) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define BWD_ACC16(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define BWD_REGS16                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// d (64 x 32, f32) = a . b (+ d when accumulate): A and B both MN-major
// in shared memory (descriptors), bf16.
__device__ __forceinline__ void wgmma_tt_m64n32k16(float (&d)[16], uint64_t da,
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " BWD_REGS16
      ", %16, %17, p, 1, 1, 1, 1;\n"
      "}\n"
      : BWD_ACC16(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) = a . b (+ d when accumulate): A and B both MN-major.
__device__ __forceinline__ void wgmma_tt_m64n64k16(float (&d)[32], uint64_t da,
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_REGS32
      ", %32, %33, p, 1, 1, 1, 1;\n"
      "}\n"
      : HOPPER_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// 2^x, flushing subnormals (as __expf does).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// P^T and dS^T of one tile in bf16, as wgmma's A operand (16 q columns
// each): this thread's key rows kr[0], kr[1] and q columns q0 + 8 j +
// 2 t4 (+ 1). p = 2^(S^T scale log2(e) - lse log2(e)); with MASK, a
// masked p is 0 (the forward's NEG_INF gives exactly 0 there too).
template <bool MASK>
__device__ __forceinline__ void probs(const float (&st)[32], const float (&dpt)[32],
                                      const float* lse2, const float* del,
                                      float sl2, int q0, int t4, const int (&kr)[2],
                                      int Sq, int Skv, int causal, int window,
                                      uint32_t (&pa)[4][4], uint32_t (&da)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int qc = 8 * j + 2 * t4;
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + qc);
    const float2 d2 = *reinterpret_cast<const float2*>(del + qc);
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = exp2_approx(fmaf(st[4 * j + e], sl2, -((e & 1) ? l2.y : l2.x)));
      if constexpr (MASK) {
        const int key = kr[e >> 1], qp = q0 + qc + (e & 1);
        bool ok = key < Skv && qp < Sq;
        if (causal) ok = ok && key <= qp;
        if (window > 0) ok = ok && key > qp - window;
        p[e] = ok ? p[e] : 0.f;
      }
      ds[e] = p[e] * (dpt[4 * j + e] - ((e & 1) ? d2.y : d2.x));
    }
    pa[j >> 1][(j & 1) * 2 + 0] = hopper::pack_bf16(p[0], p[1]);
    pa[j >> 1][(j & 1) * 2 + 1] = hopper::pack_bf16(p[2], p[3]);
    da[j >> 1][(j & 1) * 2 + 0] = hopper::pack_bf16(ds[0], ds[1]);
    da[j >> 1][(j & 1) * 2 + 1] = hopper::pack_bf16(ds[2], ds[3]);
  }
}

// --- 1. delta, lse and the zeroed dq accumulator ------------------------------

template <int DH>
__global__ void __launch_bounds__(256)
flash_bwd_pre(const __nv_bfloat16* __restrict__ o,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ lse_pad,
              float* __restrict__ delta, float* __restrict__ dq_acc,
              unsigned* __restrict__ order, int B, int Sq, int Hq, int Sq_pad) {
  constexpr int T = DH / 8;                  // threads a row, 8 values each
  // rows x T is a multiple of 32 (Sq_pad is of 64), and so is the stride:
  // a warp's lanes run the loop the same number of times
  const long long n = (long long)B * Hq * Sq_pad * T;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x; x < n;
       x += stride) {
    const long long r = x / T;               // ((b Hq + h) Sq_pad + q)
    const int part = (int)(x % T);
    const int q = (int)(r % Sq_pad);
    const long long bh = r / Sq_pad;
    const int h = (int)(bh % Hq), b = (int)(bh / Hq);
    float sum = 0.f;
    if (q < Sq) {
      const size_t off = (((size_t)b * Sq + q) * Hq + h) * DH + part * 8;
      const uint4 ov = *reinterpret_cast<const uint4*>(o + off);
      const uint4 dv = *reinterpret_cast<const uint4*>(dout + off);
      const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = __bfloat1622float2(op[i]), c = __bfloat1622float2(dp[i]);
        sum = fmaf(a.x, c.x, sum);
        sum = fmaf(a.y, c.y, sum);
      }
    }
#pragma unroll
    for (int w = T / 2; w > 0; w >>= 1) sum += __shfl_xor_sync(FULL, sum, w);
    if (part == 0) {
      delta[r] = sum;
      lse_pad[r] = q < Sq ? lse[bh * Sq + q] * LOG2E : 0.f;
      if (q % BM == 0) order[r / BM] = 0u;
    }
    float4* acc = reinterpret_cast<float4*>(dq_acc + r * DH + part * 8);
    acc[0] = make_float4(0.f, 0.f, 0.f, 0.f);
    acc[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// --- 2. the products ----------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_wgmma(__grid_constant__ const CUtensorMap mq,
                __grid_constant__ const CUtensorMap mk,
                __grid_constant__ const CUtensorMap mv,
                __grid_constant__ const CUtensorMap mdo,
                __grid_constant__ const CUtensorMap macc,
                const float* __restrict__ lse_pad,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                unsigned* __restrict__ order, int Sq, int Skv, int Hq, int Hkv,
                int Sq_pad, int causal, int window, float scale) {
  using L = Layout<DH>;
  constexpr int NCH = L::NCH;
  constexpr int NQ = DH / 2;                 // dQ columns a warpgroup
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* kvfull = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + STAGES;
  uint64_t* dqfull = empty + STAGES;         // a dQ tile staged (256 arrivals)
  uint64_t* dqempty = dqfull + 2;            // its adds landed (1 arrival)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = Hq / Hkv;
  const int b = blockIdx.x / Hkv, hkv = blockIdx.x % Hkv;
  const int k0 = blockIdx.y * BN;
  const int k_last = min(k0 + BN, Skv) - 1;
  // the q tiles whose rows may keep any of these keys
  const int nqt = (Sq + BM - 1) / BM;
  const int qt_begin = causal ? k0 / BM : 0;
  const int qt_end = window > 0 ? min(nqt, (k_last + window - 1) / BM + 1) : nqt;
  const int ntq = max(qt_end - qt_begin, 0);
  const int n_items = G * ntq;               // (q tile, q head): item i is
  // q tile qt_begin + ntq - 1 - i / G, q head hkv G + i % G

  if (tid == 0) {
    hopper::mbar_init(kvfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 256);
    }
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(dqfull + s, 256);
      hopper::mbar_init(dqempty + s, 1);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // producer warpgroup: one thread keeps the loads in flight, another
    // adds the dQ tiles in order; the warpgroup hands its registers to
    // the consumers (168 a thread at launch; 128 x (168 - 24) = 256 x
    // (240 - 168))
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 8 && lane == 0 && n_items > 0) {
      hopper::mbar_expect_tx(kvfull, 4 * NCH * CHUNK);
      for (int hr = 0; hr < 2; ++hr)
        for (int c = 0; c < NCH; ++c) {
          hopper::tma_load_4d(smem + L::K + (hr * NCH + c) * CHUNK, &mk, kvfull,
                              c * 64, hkv, k0 + 64 * hr, b);
          hopper::tma_load_4d(smem + L::V + (hr * NCH + c) * CHUNK, &mv, kvfull,
                              c * 64, hkv, k0 + 64 * hr, b);
        }
      for (int i = 0; i < n_items; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) hopper::mbar_wait(empty + s, ((i / STAGES) - 1) & 1);
        const int h = hkv * G + i % G, q0 = (qt_begin + ntq - 1 - i / G) * BM;
        hopper::mbar_expect_tx(full + s, 2 * NCH * CHUNK + 2 * BM * 4);
        for (int c = 0; c < NCH; ++c) {
          hopper::tma_load_4d(smem + L::Q + (s * NCH + c) * CHUNK, &mq, full + s,
                              c * 64, h, q0, b);
          hopper::tma_load_4d(smem + L::DO + (s * NCH + c) * CHUNK, &mdo,
                              full + s, c * 64, h, q0, b);
        }
        const size_t row = ((size_t)b * Hq + h) * Sq_pad + q0;
        bulk_load(smem + L::LSE + s * BM * 4, lse_pad + row, BM * 4, full + s);
        bulk_load(smem + L::DELTA + s * BM * 4, delta + row, BM * 4, full + s);
      }
    } else if (warp == 9 && lane == 0 && n_items > 0) {
      // this block's rank among the key tiles that add into q tile qt: the
      // tiles that keep any of its rows are a run from lo (the window's
      // first) up, and every tile after lo up to this one is in it
      const int n = blockIdx.y;
      for (int i = 0; i < n_items; ++i) {
        const int buf = i & 1;
        const int h = hkv * G + i % G, qt = qt_begin + ntq - 1 - i / G;
        int lo = 0;
        if (window > 0)
          while ((min(lo * BN + BN, Skv) - 1 + window - 1) / BM + 1 <= qt) ++lo;
        unsigned* cnt = order + ((size_t)b * Hq + h) * (Sq_pad / BM) + qt;
        hopper::mbar_wait(dqfull + buf, (i >> 1) & 1);
        while (ld_acquire(cnt) != (unsigned)(n - lo)) {
        }
        fence_proxy_async_global();
        const uint8_t* dqs = smem + L::DQ + buf * 2 * (NQ / 32) * DQ_BOX;
#pragma unroll
        for (int bx = 0; bx < 2 * (NQ / 32); ++bx)
          tma_reduce_add_3d(&macc, dqs + bx * DQ_BOX, 32 * bx, qt * BM, b * Hq + h);
        bulk_commit();
        bulk_wait_all();
        fence_proxy_async_global();
        red_release_inc(cnt);
        hopper::mbar_arrive(dqempty + buf);
      }
    }
  } else {
    // consumers: warpgroup g owns keys k0 + 64 g ..; this thread key rows
    // kr[0], kr[1] of S^T and, in dQ, q rows 16 (warp % 4) + gid (+ 8)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int g = warp >> 2, wq = warp & 3;
    const int gid = lane >> 2, t4 = lane & 3;
    const int row0 = 64 * g + 16 * wq + gid;             // of the block's 128
    const int kr[2] = {k0 + row0, k0 + row0 + 8};
    const uint8_t* kg = smem + L::K + g * NCH * CHUNK;
    const uint8_t* vg = smem + L::V + g * NCH * CHUNK;
    const float sl2 = scale * LOG2E;

    float dvacc[NCH][32], dkacc[NCH][32];
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) dvacc[c][e] = dkacc[c][e] = 0.f;

    if (n_items > 0) hopper::mbar_wait(kvfull, 0);
    for (int i = 0; i < n_items; ++i) {
      const int s = i % STAGES;
      const uint32_t par = (i / STAGES) & 1;
      const int q0 = (qt_begin + ntq - 1 - i / G) * BM;
      const uint8_t* qs = smem + L::Q + s * NCH * CHUNK;
      const uint8_t* dos = smem + L::DO + s * NCH * CHUNK;
      hopper::mbar_wait(full + s, par);

      // S^T = K Q^T, dP^T = V dO^T (64 keys x 64 q rows each)
      float st[32], dpt[32];
      fence_acc(st);
      fence_acc(dpt);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int off = (kk >> 2) * CHUNK + (kk & 3) * 32;
        hopper::wgmma_ss_m64n64k16(st, hopper::desc_sw128(kg + off),
                                   hopper::desc_sw128(qs + off), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int off = (kk >> 2) * CHUNK + (kk & 3) * 32;
        hopper::wgmma_ss_m64n64k16(dpt, hopper::desc_sw128(vg + off),
                                   hopper::desc_sw128(dos + off), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait0();
      fence_acc(st);
      fence_acc(dpt);

      // P^T and dS^T; the mask only where the tile has a masked pair
      const float* lse_s = reinterpret_cast<const float*>(smem + L::LSE + s * BM * 4);
      const float* del_s = reinterpret_cast<const float*>(smem + L::DELTA + s * BM * 4);
      const int key_lo = k0 + 64 * g, q_hi = q0 + BM - 1;
      const bool masked = key_lo + 63 >= Skv || q_hi >= Sq ||
                          (causal && key_lo + 63 > q0) ||
                          (window > 0 && key_lo <= q_hi - window);
      uint32_t pa[4][4], da[4][4];
      if (masked)
        probs<true>(st, dpt, lse_s, del_s, sl2, q0, t4, kr, Sq, Skv, causal,
                    window, pa, da);
      else
        probs<false>(st, dpt, lse_s, del_s, sl2, q0, t4, kr, Sq, Skv, causal,
                     window, pa, da);

      // dS^T into shared memory (128-byte swizzle: 16-byte chunk j of row
      // r at chunk j ^ (r % 8)), for dQ's A operand; two buffers, so one
      // barrier a tile keeps a buffer until both warpgroups' dQ read it
      uint8_t* dsb = smem + L::DS + (i & 1) * DS_BYTES;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = row0 + 8 * hf;
          *reinterpret_cast<uint32_t*>(dsb + r * 128 + (((j ^ r) & 7) << 4) + 4 * t4) =
              da[j >> 1][(j & 1) * 2 + hf];
        }
      fence_async_shared();
      consumers_sync();

      // dV += P^T dO, dK += dS^T Q (B = dO, Q MN-major); dQ = dS K over
      // the 128 keys, this warpgroup's NQ columns of Dh
      float dq[NQ / 2];
      fence_acc(dq);
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        fence_acc(dvacc[c]);
        fence_acc(dkacc[c]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_rs_m64n64k16_tb(
              dvacc[c], pa[kk],
              hopper::desc_sw128(dos + c * CHUNK + kk * 16 * 128));
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_rs_m64n64k16_tb(
              dkacc[c], da[kk],
              hopper::desc_sw128(qs + c * CHUNK + kk * 16 * 128));
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        // keys 16 kk ..: key half kk / 4, its rows 16 (kk % 4) ..; columns
        // NQ g .. (Dh 128: box g; Dh 64: bytes 64 g of the one box)
        const uint8_t* kb = smem + L::K +
                            ((kk >> 2) * NCH + (NCH == 2 ? g : 0)) * CHUNK +
                            (kk & 3) * 16 * 128 + (NCH == 1 ? 64 * g : 0);
        if constexpr (NQ == 32)
          wgmma_tt_m64n32k16(dq, hopper::desc_sw128(dsb + kk * 16 * 128),
                             hopper::desc_sw128(kb), kk > 0);
        else
          wgmma_tt_m64n64k16(dq, hopper::desc_sw128(dsb + kk * 16 * 128),
                             hopper::desc_sw128(kb), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait0();
      fence_acc(dq);
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        fence_acc(dvacc[c]);
        fence_acc(dkacc[c]);
      }
      hopper::mbar_arrive(empty + s);        // stage s is read

      // dQ into the f32 accumulator: this warpgroup's boxes of 64 rows x 32
      // columns into shared memory (as the accumulator's map swizzles
      // them: 16-byte chunk c of row r at c ^ (r % 8)), for the adding
      // thread's reduce-adds; a buffer is written again two tiles later,
      // once those have landed
      uint8_t* dqs = smem + L::DQ + ((i & 1) * 2 + g) * (NQ / 32) * DQ_BOX;
      if (i >= 2) hopper::mbar_wait(dqempty + (i & 1), ((i >> 1) - 1) & 1);
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = 16 * wq + gid + 8 * hf;
          const int chunk = 2 * (j & 3) + (t4 >> 1);
          *reinterpret_cast<float2*>(dqs + (j >> 2) * DQ_BOX + r * 128 +
                                     ((chunk ^ (r & 7)) << 4) + (t4 & 1) * 8) =
              make_float2(dq[4 * j + 2 * hf], dq[4 * j + 2 * hf + 1]);
        }
      fence_async_shared();
      hopper::mbar_arrive(dqfull + (i & 1));
    }

    // dK (times scale) and dV, once, in bf16
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (kr[hf] >= Skv) continue;
      const size_t off = (((size_t)b * Skv + kr[hf]) * Hkv + hkv) * DH;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c * 64 + 8 * j + 2 * t4;
          *reinterpret_cast<__nv_bfloat162*>(dv + off + col) = __floats2bfloat162_rn(
              dvacc[c][4 * j + 2 * hf], dvacc[c][4 * j + 2 * hf + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dk + off + col) = __floats2bfloat162_rn(
              dkacc[c][4 * j + 2 * hf] * scale, dkacc[c][4 * j + 2 * hf + 1] * scale);
        }
    }
  }
}

// --- 3. dq in bf16 ------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(256)
flash_bwd_post(const float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dq,
               int B, int Sq, int Hq, int Sq_pad, float scale) {
  constexpr int T = DH / 8;
  const long long n = (long long)B * Sq * Hq * T;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x; x < n;
       x += stride) {
    const long long r = x / T;               // ((b Sq + q) Hq + h)
    const int part = (int)(x % T);
    const int h = (int)(r % Hq);
    const long long bq = r / Hq;
    const int q = (int)(bq % Sq), b = (int)(bq / Sq);
    const float4* src = reinterpret_cast<const float4*>(
        dq_acc + (((size_t)b * Hq + h) * Sq_pad + q) * DH + part * 8);
    const float4 a = src[0], c = src[1];
    uint4 out;
    out.x = hopper::pack_bf16(a.x * scale, a.y * scale);
    out.y = hopper::pack_bf16(a.z * scale, a.w * scale);
    out.z = hopper::pack_bf16(c.x * scale, c.y * scale);
    out.w = hopper::pack_bf16(c.z * scale, c.w * scale);
    *reinterpret_cast<uint4*>(dq + r * DH + part * 8) = out;
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

// The f32 dq accumulator (B Hq, Sq_pad, Dh) in boxes of 64 rows x 32
// columns, 128-byte swizzled, for the reduce-adds.
int make_acc_map(CUtensorMap* map, float* acc, int BH, int Sq_pad, int Dh) {
  hopper::EncodeTiledFn fn = hopper::encode_tiled();
  if (fn == nullptr) return -2;
  const cuuint64_t dims[3] = {(cuuint64_t)Dh, (cuuint64_t)Sq_pad, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)Dh * 4, (cuuint64_t)Sq_pad * Dh * 4};
  const cuuint32_t box[3] = {32, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, acc, dims, strides,
                  box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

// Blocks of 256 threads for a grid-stride loop over n threads' work.
unsigned blocks_for(long long n) {
  const long long blocks = (n + 255) / 256;
  return (unsigned)(blocks < 132LL * 64 ? blocks : 132LL * 64);
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           float* dq_acc, float* lse_pad, float* delta, unsigned* order, int B,
           int Sq, int Skv, int Hq, int Hkv, int causal, int window, float scale,
           cudaStream_t stream) {
  const int Sq_pad = (Sq + BM - 1) / BM * BM;
  CUtensorMap mq, mk, mv, mdo, macc;
  int err = make_map(&mq, q, B, Sq, Hq, DH);
  if (!err) err = make_map(&mk, k, B, Skv, Hkv, DH);
  if (!err) err = make_map(&mv, v, B, Skv, Hkv, DH);
  if (!err) err = make_map(&mdo, dout, B, Sq, Hq, DH);
  if (!err) err = make_acc_map(&macc, dq_acc, B * Hq, Sq_pad, DH);
  if (err) return err;
  using bf = __nv_bfloat16;

  flash_bwd_pre<DH><<<blocks_for((long long)B * Hq * Sq_pad * (DH / 8)), 256, 0,
                      stream>>>(static_cast<const bf*>(o), static_cast<const bf*>(dout),
                                lse, lse_pad, delta, dq_acc, order, B, Sq, Hq,
                                Sq_pad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  constexpr int bytes = Layout<DH>::bytes;
  e = cudaFuncSetAttribute(flash_bwd_wgmma<DH>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * Hkv, (Skv + BN - 1) / BN);
  flash_bwd_wgmma<DH><<<grid, THREADS, bytes, stream>>>(
      mq, mk, mv, mdo, macc, lse_pad, delta, static_cast<bf*>(dk),
      static_cast<bf*>(dv), order, Sq, Skv, Hq, Hkv, Sq_pad, causal, window,
      scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  flash_bwd_post<DH><<<blocks_for((long long)B * Sq * Hq * (DH / 8)), 256, 0,
                       stream>>>(dq_acc, static_cast<bf*>(dq), B, Sq, Hq, Sq_pad,
                                 scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q, k, v, o, dout (contiguous, 16-byte aligned) and float32 lse
// (B, Hq, Sq) -> bf16 dq, dk, dv; Dh 64 or 128. Scratch from the caller:
// dq_acc (B, Hq, Sq_pad, Dh), lse_pad and delta (B, Hq, Sq_pad), float32,
// and order (B, Hq, Sq_pad / 64), 32-bit, Sq_pad = Sq rounded up to a
// multiple of 64 (written before they are read). Three launches on
// `stream`; does not synchronise. The same inputs give the same bits. Returns 0, a
// cudaError_t code, -1 for an unsupported Dh, -2 if cuTensorMapEncodeTiled
// cannot be found, -3 if it refuses a tensor map.
extern "C" int flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* dq_acc, void* lse_pad, void* delta, void* order, int B, int Sq,
    int Skv, int Hq, int Hkv, int Dh, int causal, int window, float scale,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* acc = static_cast<float*>(dq_acc);
  float* lp = static_cast<float*>(lse_pad);
  float* de = static_cast<float*>(delta);
  unsigned* od = static_cast<unsigned*>(order);
  switch (Dh) {
    case 64:
      return launch<64>(q, k, v, o, l, dout, dq, dk, dv, acc, lp, de, od, B, Sq,
                        Skv, Hq, Hkv, causal, window, scale, s);
    case 128:
      return launch<128>(q, k, v, o, l, dout, dq, dk, dv, acc, lp, de, od, B, Sq,
                         Skv, Hq, Hkv, causal, window, scale, s);
    default:
      return -1;
  }
}
