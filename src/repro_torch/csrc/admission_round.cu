// The capacity-admission preference rounds of one planner epoch, for Hopper
// (sm_90a), in one launch. Built by nvcc into a shared library with a plain C
// interface and called through ctypes (repro_torch/cluster/placement_kernel.py).
//
// Replaces the Pallas TPU kernel `admission_round` / `_round_kernel`
// (src/repro/cluster/placement_pallas.py:120 and :66), called once per round.
// Semantics of one round:
//   - each container takes the argmax of its f64 net-saving row over the
//     regions not yet struck in its bitmask; strict > keeps the first max;
//   - want = eligible & unplaced (dst < 0) & net_best > 0 & best != assign;
//   - the first remaining[r] wanters of region r, in container-index order,
//     are admitted (dst' = best); a denied wanter strikes its choice
//     (struck' = struck | 1 << best);
//   - want_total[r] counts the wanters of region r.
// Between rounds the planner's own update runs here:
//   remaining -= min(want_total, remaining).
//
// Design. One persistent cooperative launch (cudaLaunchCooperativeKernel)
// runs all the rounds of an epoch, with one grid barrier per round:
//   - the grid is no larger than the blocks the card holds at once
//     (occupancy x SMs); block b owns the adjacent 1,024-container tiles
//     [b K, (b + 1) K), one container per thread per tile, so that a block's
//     containers are in index order;
//   - each thread keeps the state of its containers in registers across the
//     rounds (KT > 0; KT >= K): `pref` (the region it wants this round, or
//     -1), dst and struck. A container that does not want stays so: only a
//     denied wanter changes its preference, and only it re-reads its net row.
//     Past 4 tiles a block (KT = 0) keeps the same state in global memory;
//   - per round each block counts its wanters per region (warp ballots and
//     popcounts) into slice `round` of a (rounds, NB, R) scratch: one slice
//     per round, so the next round's counts never overwrite counts another
//     block is still reading, and one barrier per round suffices;
//   - after the barrier every block sums the counts of the blocks before it
//     (its exclusive offset) and of all (want_total), ranks its wanters tile
//     by tile (ballot prefix + exclusive scan over warps), admits iff
//     offset + rank <= remaining[best], and updates `remaining` itself.
// No atomics: the result is identical run to run and equal to the plain
// version. A refused cooperative launch is returned as an error; there is no
// fallback.
//
// Bound. Per epoch call the bytes are one pass: the (N, R) f64 net table and
// four (N,) vectors read, two (N,) vectors written, (rounds, R) counts; at
// N = 100,000 and R = 3 that is 4,500,048 B, 1.34 us at the H100's
// 3.35 TB/s. The arithmetic (N R compares) is negligible. The latency floor
// is one launch plus R grid barriers, each a round trip through L2, so at
// that size the launch and the barriers, not the bytes, set the time.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRegions = 31;            // the strike mask is an int32
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const double* net;
  const int* assign;
  const unsigned char* elig;
  const int* dst;
  const int* struck;
  const int* remaining;
  int n, R, rounds, tiles_per_block;
  int* counts;                             // (rounds, gridDim.x, R) scratch
  int* dst_out;
  int* struck_out;
  int* pref;                               // (n,) scratch, KT = 0 only
  int* want;                               // (rounds, R)
};

// The region container i wants this round, or -1: the best un-struck region
// by net saving, if the container is eligible, unplaced, gains by moving and
// is not there already. Branch-free over its loads, so that all of them are
// in flight at once: one memory round trip, not one per dependent read.
__device__ __forceinline__ int prefer(const Args& a, int i, int dst,
                                      int struck) {
  const bool elig = a.elig[i] != 0;
  const int assign = a.assign[i];
  const double* row = a.net + static_cast<size_t>(i) * a.R;
  int best = 0;
  double nb = (struck & 1) ? -CUDART_INF : row[0];
#pragma unroll 4
  for (int r = 1; r < a.R; ++r) {
    const double v = ((struck >> r) & 1) ? -CUDART_INF : row[r];
    if (v > nb) {
      nb = v;
      best = r;
    }
  }
  return (dst < 0 && elig && nb > 0.0 && best != assign) ? best : -1;
}

// A thread's containers: the k-th of its block's tiles. KT > 0 keeps them in
// registers (k is a constant once the loops are unrolled); KT = 0 in global
// memory, indexed by container.
template <int KT>
struct State {
  int pref_[KT], dst_[KT], struck_[KT];
  __device__ State(const Args&) {}
  __device__ int& pref(int k, int) { return pref_[k]; }
  __device__ int& dst(int k, int) { return dst_[k]; }
  __device__ int& struck(int k, int) { return struck_[k]; }
  __device__ void store(const Args& a, int k, int i) {
    a.dst_out[i] = dst_[k];
    a.struck_out[i] = struck_[k];
  }
};

template <>
struct State<0> {
  int* p;
  int* d;
  int* s;
  __device__ State(const Args& a) : p(a.pref), d(a.dst_out), s(a.struck_out) {}
  __device__ int& pref(int, int i) { return p[i]; }
  __device__ int& dst(int, int i) { return d[i]; }
  __device__ int& struck(int, int i) { return s[i]; }
  __device__ void store(const Args&, int, int) {}
};

template <int KT>
__global__ void __launch_bounds__(kThreads, 1)
admission_rounds_kernel(Args a) {
  static_assert(kWarps == 32 && kMaxRegions < 32,
                "a warp scans the warps' counts; a lane or a warp per region");
  __shared__ int warp_cnt[kWarps][kMaxRegions];
  __shared__ int off[kMaxRegions];         // wanters before this block / tile
  __shared__ int total[kMaxRegions];
  __shared__ int rem[kMaxRegions];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int R = a.R;
  const int tile0 = blockIdx.x * a.tiles_per_block;
  const int n_tiles = (a.n + kThreads - 1) / kThreads;
  const int nk = max(0, min(a.tiles_per_block, n_tiles - tile0));
  // the loops over a thread's tiles: unrolled to KT when held in registers
  const int kLoop = KT > 0 ? KT : nk;
  auto index = [&](int k) { return (tile0 + k) * kThreads + threadIdx.x; };

  State<KT> st(a);
  if (threadIdx.x < R) rem[threadIdx.x] = a.remaining[threadIdx.x];
#pragma unroll
  for (int k = 0; k < kLoop; ++k) {
    if (k >= nk) break;
    const int i = index(k);
    if (i < a.n) {
      const int d = a.dst[i], s = a.struck[i];
      st.pref(k, i) = prefer(a, i, d, s);
      st.dst(k, i) = d;
      st.struck(k, i) = s;
    }
  }

  for (int round = 0; round < a.rounds; ++round) {
    // 1. this block's wanters per region: lane r of each warp counts
    //    region r, then warp r sums region r over the warps
    int mine = 0;
#pragma unroll
    for (int k = 0; k < kLoop; ++k) {
      if (k >= nk) break;
      const int i = index(k);
      const int p = i < a.n ? st.pref(k, i) : -1;
      for (int r = 0; r < R; ++r) {
        const int c = __popc(__ballot_sync(kFull, p == r));
        if (lane == r) mine += c;
      }
    }
    if (lane < R) warp_cnt[warp][lane] = mine;
    __syncthreads();
    int* counts = a.counts + static_cast<size_t>(round) * gridDim.x * R;
    if (warp < R) {
      int c = warp_cnt[lane][warp];
      for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(kFull, c, o);
      if (lane == 0) counts[blockIdx.x * R + warp] = c;
    }
    grid.sync();

    // 2. exclusive offset of this block and the round's totals, one warp
    //    per region
    for (int r = warp; r < R; r += kWarps) {
      int below = 0, all = 0;
      for (int b = lane; b < static_cast<int>(gridDim.x); b += 32) {
        const int c = counts[b * R + r];
        all += c;
        if (b < static_cast<int>(blockIdx.x)) below += c;
      }
      for (int o = 16; o > 0; o >>= 1) {
        below += __shfl_down_sync(kFull, below, o);
        all += __shfl_down_sync(kFull, all, o);
      }
      if (lane == 0) {
        off[r] = below;
        total[r] = all;
      }
    }
    __syncthreads();

    // 3. rank and admit, tile by tile in container order
#pragma unroll
    for (int k = 0; k < kLoop; ++k) {
      if (k >= nk) break;
      const int i = index(k);
      const int p = i < a.n ? st.pref(k, i) : -1;
      int rank_in_warp = 0;                // inclusive, among lanes <= lane
      mine = 0;
      for (int r = 0; r < R; ++r) {
        const unsigned m = __ballot_sync(kFull, p == r);
        if (p == r) rank_in_warp = __popc(m & ((2u << lane) - 1u));
        if (lane == r) mine = __popc(m);
      }
      if (lane < R) warp_cnt[warp][lane] = mine;
      __syncthreads();
      if (warp < R) {                      // exclusive scan over warps
        const int c = warp_cnt[lane][warp];
        int incl = c;
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += v;
        }
        const int base = off[warp];
        __syncwarp();
        warp_cnt[lane][warp] = base + incl - c;
        if (lane == 31) off[warp] = base + incl;   // the next tile's offset
      }
      __syncthreads();
      if (p >= 0) {
        if (warp_cnt[warp][p] + rank_in_warp <= rem[p]) {
          st.dst(k, i) = p;
          st.pref(k, i) = -1;
        } else {
          const int s = st.struck(k, i) | (1 << p);
          st.struck(k, i) = s;
          st.pref(k, i) = prefer(a, i, -1, s);
        }
      }
      __syncthreads();                     // warp_cnt is reused
    }
    if (threadIdx.x < R) {
      const int t = total[threadIdx.x];
      if (blockIdx.x == 0) a.want[round * R + threadIdx.x] = t;
      rem[threadIdx.x] -= min(t, rem[threadIdx.x]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kLoop; ++k) {
    if (k >= nk) break;
    const int i = index(k);
    if (i < a.n) st.store(a, k, i);
  }
}

// The variants by the tiles a block holds in registers (0: any number, in
// global memory), and their kernels.
constexpr int kVariants[] = {1, 4, 0};
constexpr int kNumVariants = 3;

void* variant(int v) {
  switch (v) {
    case 0: return reinterpret_cast<void*>(admission_rounds_kernel<1>);
    case 1: return reinterpret_cast<void*>(admission_rounds_kernel<4>);
    default: return reinterpret_cast<void*>(admission_rounds_kernel<0>);
  }
}

// Blocks of variant v the current device holds at once; cached per device.
int max_blocks(int v, int& err) {
  static int cache[64][kNumVariants];
  int dev = 0;
  err = static_cast<int>(cudaGetDevice(&dev));
  if (err) return 0;
  if (dev < 64 && cache[dev][v]) return cache[dev][v];
  int per_sm = 0, sms = 0;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, variant(v), kThreads, 0));
  if (!err)
    err = static_cast<int>(cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, dev));
  if (err) return 0;
  if (dev < 64) cache[dev][v] = per_sm * sms;
  return per_sm * sms;
}

}  // namespace

extern "C" {

// The launch plan for n containers: the smallest variant whose blocks fit
// at once. Writes the grid (blocks) and returns the variant index or a
// negative cudaError_t. The caller sizes the (rounds, blocks, R) counts
// scratch from it.
int admission_rounds_plan(int n, int* blocks) {
  if (n <= 0) return -static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (n + kThreads - 1) / kThreads;
  for (int v = 0; v < kNumVariants; ++v) {
    int err = 0;
    const int g = max_blocks(v, err);
    if (err) return -err;
    if (g <= 0) continue;
    const int k = (tiles + g - 1) / g;     // tiles per block
    if (kVariants[v] == 0 || k <= kVariants[v]) {
      *blocks = (tiles + k - 1) / k;
      return v;
    }
  }
  return -static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
}

// All `rounds` rounds of one epoch in one cooperative launch, with the plan
// of admission_rounds_plan (variant, blocks). counts: (rounds, blocks, R)
// int32 scratch; pref: (n,) int32 scratch (used where the state is held in
// global memory); want: (rounds, R) int32. Returns cudaGetLastError() or the
// launch's error; a refused cooperative launch is not retried.
int admission_rounds(const double* net, const int* assign,
                     const unsigned char* elig, const int* dst,
                     const int* struck, const int* remaining, int n, int R,
                     int rounds, int variant_index, int blocks, int* counts,
                     int* dst_out, int* struck_out, int* pref, int* want,
                     void* stream) {
  if (n <= 0 || R < 1 || R > kMaxRegions || rounds < 1 || blocks < 1 ||
      variant_index < 0 || variant_index >= kNumVariants)
    return cudaErrorInvalidValue;
  const int tiles = (n + kThreads - 1) / kThreads;
  Args a{net, assign, elig, dst, struck, remaining, n, R, rounds,
         (tiles + blocks - 1) / blocks, counts, dst_out, struck_out, pref,
         want};
  void* params[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      variant(variant_index), dim3(blocks), dim3(kThreads), params, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
