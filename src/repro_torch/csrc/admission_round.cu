// One capacity-admission preference round of the placement planner, for
// Hopper (sm_90a). Built by nvcc into a shared library with a plain C
// interface and called through ctypes (repro_torch/cluster/placement_kernel.py).
//
// Replaces the Pallas TPU kernel `admission_round` / `_round_kernel`
// (src/repro/cluster/placement_pallas.py:120 and :66). Semantics:
//   - each container takes the argmax of its f64 net-saving row over the
//     regions not yet struck in its bitmask; strict > keeps the first max;
//   - want = eligible & unplaced (dst < 0) & net_best > 0 & best != assign;
//   - the first remaining[r] wanters of region r, in container-index order,
//     are admitted (dst' = best); a denied wanter strikes its choice
//     (struck' = struck | 1 << best);
//   - want_total[r] counts the wanters of region r.
//
// Design. The Pallas kernel carries "wanters seen so far" in SMEM across a
// sequential grid. Blocks on the H100 run concurrently and in no order, so
// the cross-block rank takes two launches instead:
//   pass A: one thread per container computes (best, want); each block
//           writes its per-region wanter counts to a (NB, R) scratch, using
//           warp ballots + popcounts and a shared-memory sum over warps;
//   pass B: each block sums the counts of the blocks before it (its
//           exclusive offset, NB ~ 100 at N = 100k), recomputes (best, want),
//           ranks its wanters by a warp-ballot prefix plus an exclusive scan
//           over warps, and admits iff offset + rank <= remaining[best]. The
//           last block publishes want_total = its offset + its own count.
// No atomics: the result is identical run to run. Both passes launch on the
// caller's stream and do not synchronise.
//
// Bound. Bytes: each round reads the (N, R) f64 net table and four (N,)
// vectors and writes two (N,) vectors; at N = 100k, R = 3 that is ~4 MB, a
// bit over 1 us at the H100's 3.35 TB/s. The arithmetic (N*R compares) is
// negligible. At that size the two launches, not the bytes, set the time.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRegions = 31;            // the strike mask is an int32
constexpr unsigned kFull = 0xffffffffu;

// Preference of container i this round: best un-struck region and whether
// it wants to move there. Threads past the end want nothing.
__device__ __forceinline__ void prefer(const double* __restrict__ net,
                                       const int* __restrict__ assign,
                                       const unsigned char* __restrict__ elig,
                                       const int* __restrict__ dst,
                                       const int* __restrict__ struck,
                                       int i, int n, int R,
                                       bool& want, int& best) {
  want = false;
  best = 0;
  if (i >= n) return;
  const int s = struck[i];
  const double* row = net + static_cast<size_t>(i) * R;
  double nb = (s & 1) ? -CUDART_INF : row[0];
  for (int r = 1; r < R; ++r) {
    const double v = ((s >> r) & 1) ? -CUDART_INF : row[r];
    if (v > nb) {
      nb = v;
      best = r;
    }
  }
  want = elig[i] != 0 && dst[i] < 0 && nb > 0.0 && best != assign[i];
}

__global__ void __launch_bounds__(kThreads)
count_wanters(const double* __restrict__ net, const int* __restrict__ assign,
              const unsigned char* __restrict__ elig,
              const int* __restrict__ dst, const int* __restrict__ struck,
              int n, int R, int* __restrict__ counts) {
  __shared__ int warp_cnt[kWarps][kMaxRegions];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  bool want;
  int best;
  prefer(net, assign, elig, dst, struck, i, n, R, want, best);
  for (int r = 0; r < R; ++r) {
    const unsigned m = __ballot_sync(kFull, want && best == r);
    if (lane == 0) warp_cnt[warp][r] = __popc(m);
  }
  __syncthreads();
  if (threadIdx.x < R) {
    int c = 0;
    for (int w = 0; w < kWarps; ++w) c += warp_cnt[w][threadIdx.x];
    counts[blockIdx.x * R + threadIdx.x] = c;
  }
}

__global__ void __launch_bounds__(kThreads)
admit_ranked(const double* __restrict__ net, const int* __restrict__ assign,
             const unsigned char* __restrict__ elig,
             const int* __restrict__ dst, const int* __restrict__ struck,
             const int* __restrict__ remaining, int n, int R,
             const int* __restrict__ counts, int* __restrict__ dst_out,
             int* __restrict__ struck_out, int* __restrict__ want_total) {
  __shared__ int warp_off[kWarps][kMaxRegions];
  __shared__ int block_off[kMaxRegions];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // exclusive offset of this block: wanters of the blocks before it,
  // one warp per region
  for (int r = warp; r < R; r += kWarps) {
    int s = 0;
    for (int b = lane; b < static_cast<int>(blockIdx.x); b += 32)
      s += counts[b * R + r];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(kFull, s, o);
    if (lane == 0) block_off[r] = s;
  }

  bool want;
  int best;
  prefer(net, assign, elig, dst, struck, i, n, R, want, best);
  int rank_in_warp = 0;                    // inclusive, among lanes <= lane
  for (int r = 0; r < R; ++r) {
    const unsigned m = __ballot_sync(kFull, want && best == r);
    if (want && best == r) rank_in_warp = __popc(m & ((2u << lane) - 1u));
    if (lane == 0) warp_off[warp][r] = __popc(m);
  }
  __syncthreads();
  if (threadIdx.x < R) {                   // exclusive scan over warps
    int s = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_off[w][threadIdx.x];
      warp_off[w][threadIdx.x] = s;
      s += c;
    }
    if (blockIdx.x == gridDim.x - 1)
      want_total[threadIdx.x] = block_off[threadIdx.x] + s;
  }
  __syncthreads();
  if (i < n) {
    int d = dst[i];
    int s = struck[i];
    if (want) {
      const int rank = block_off[best] + warp_off[warp][best] + rank_in_warp;
      if (rank <= remaining[best]) {
        d = best;
      } else {
        s |= 1 << best;
      }
    }
    dst_out[i] = d;
    struck_out[i] = s;
  }
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// Pass A. counts: (ceil(n / 1024), R) int32 scratch. Returns cudaGetLastError().
int admission_count(const double* net, const int* assign,
                    const unsigned char* elig, const int* dst,
                    const int* struck, int n, int R, int* counts,
                    void* stream) {
  if (n <= 0 || R < 1 || R > kMaxRegions) return cudaErrorInvalidValue;
  count_wanters<<<blocks_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      net, assign, elig, dst, struck, n, R, counts);
  return static_cast<int>(cudaGetLastError());
}

// Pass B, on the same stream after pass A. Returns cudaGetLastError().
int admission_admit(const double* net, const int* assign,
                    const unsigned char* elig, const int* dst,
                    const int* struck, const int* remaining, int n, int R,
                    const int* counts, int* dst_out, int* struck_out,
                    int* want_total, void* stream) {
  if (n <= 0 || R < 1 || R > kMaxRegions) return cudaErrorInvalidValue;
  admit_ranked<<<blocks_for(n), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      net, assign, elig, dst, struck, remaining, n, R, counts, dst_out,
      struck_out, want_total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
